"""JSON-lines metrics logger: a trimmed copy of ``deepfm_tpu/utils/logging.py``.

Every ``log_steps`` steps one line ``{"kind": "train", "step", "examples_per_sec",
"step_ms", <metrics>}`` goes to the stream (stdout by default); ``event``
writes one line of any other kind.  Metric values are read with ``float()``
only on the lines written, so device scalars cost a wait for the card only
there.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Any, Mapping


class MetricLogger:
    def __init__(self, *, log_steps: int = 100, stream: IO | None = None,
                 prefix: str = "train"):
        self.log_steps = max(1, log_steps)
        self._stream = stream or sys.stdout
        self._prefix = prefix
        self._t_last = time.perf_counter()
        self._examples_since = 0
        self._step_at_last_log = 0

    def step(self, step: int, batch_size: int, metrics: Mapping[str, Any]) -> None:
        """Count ``batch_size`` examples for ``step``; write a line when a
        ``log_steps`` boundary was crossed since the last one."""
        self._examples_since += batch_size
        if step // self.log_steps <= self._step_at_last_log // self.log_steps:
            return
        now = time.perf_counter()
        dt = max(now - self._t_last, 1e-9)
        record = {
            "kind": self._prefix,
            "step": int(step),
            "examples_per_sec": round(self._examples_since / dt, 1),
            "step_ms": round(1000 * dt / max(1, step - self._step_at_last_log), 3),
        }
        for k, v in metrics.items():
            record[k] = round(float(v), 6)
        self._emit(record)
        self._t_last = now
        self._examples_since = 0
        self._step_at_last_log = step

    def event(self, kind: str, **fields: Any) -> None:
        record: dict[str, Any] = {"kind": kind}
        for k, v in fields.items():
            # numpy and torch scalars are not int/float instances
            if isinstance(v, (bool, int, str)) or v is None:
                record[k] = v
                continue
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        self._emit(record)

    def _emit(self, record: dict) -> None:
        print(json.dumps(record), file=self._stream, flush=True)
