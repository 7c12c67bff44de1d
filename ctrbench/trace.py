"""The traced segment: ``torch.profiler`` over a fixed number of steps,
its Chrome trace written under ``TMPDIR``, read back and deleted, and
reduced to what the per-layer readers take: the device operations
(kernels, copies, fills) inside the window, the union of their
intervals, the idle gaps labelled by what the main thread was doing,
and the sums by name.

The window is the span of the harness's own ``ctrbench.window``
annotation, which closes after a synchronize."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

WINDOW = "ctrbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class Trace:
    """One traced window.  Times in seconds; ``ops`` are ``(name, start,
    duration)`` of the device operations inside it."""

    window_s: float
    busy_s: float
    steps: int
    ops: list = field(default_factory=list)
    gaps: dict = field(default_factory=dict)

    def device_seconds(self, pred) -> float:
        """Device time of the operations whose name satisfies ``pred``."""
        return sum(d for n, _, d in self.ops if pred(n))

    def count(self, pred) -> int:
        return sum(1 for n, _, _ in self.ops if pred(n))

    def top_ops(self) -> list:
        sums: dict = {}
        for n, _, d in self.ops:
            sums[short(n)] = sums.get(short(n), 0.0) + d
        return [[n, s] for n, s in sorted(sums.items(), key=lambda x: -x[1])[:TOP]]

    def top_gaps(self) -> list:
        return [[n, s] for n, s in sorted(self.gaps.items(), key=lambda x: -x[1])[:TOP]]


def short(name: str, width: int = 120) -> str:
    """A kernel's or host span's name without its return type, its final
    argument list and the ``at::native::`` and anonymous namespaces, at
    most ``width`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0 and name[i - 1] != " ":  # a signature, not "Memcpy HtoD (...)"
                    name = name[:i]
                break
    name = name.removeprefix("void ").replace("at::native::", "")
    return name.replace("(anonymous namespace)::", "")[:width]


@contextlib.contextmanager
def profiled(device: torch.device):
    """A profiler session over the block: CPU and, on a card, CUDA."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def reduce(prof, steps: int) -> Trace:
    """The session's trace reduced to a :class:`Trace` (the Chrome trace
    goes through one file under ``TMPDIR``, deleted at once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events, steps)


def reduce_events(events: list, steps: int) -> Trace:
    win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} {WINDOW} spans, not one")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    ops = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            a, d = float(e["ts"]), float(e.get("dur", 0.0))
            if a < w1 and a + d > w0:
                lo, hi = max(a, w0), min(a + d, w1)
                ops.append((e["name"], lo * 1e-6, (hi - lo) * 1e-6))
    spans = sorted((a, a + d) for _, a, d in ops)
    busy, gaps_at = 0.0, []
    cur_a = cur_b = None
    last = w0 * 1e-6
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > last:
                gaps_at.append((last, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last = max(last, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if w1 * 1e-6 > last:
        gaps_at.append((last, w1 * 1e-6))
    host = sorted(((float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e.get("dur", 0.0))) * 1e-6,
                    e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e.get("name") != WINDOW and e.get("ph") == "X"))
    starts = [a for a, _, _ in host]
    gaps: dict = {}
    for a, b in gaps_at:
        name = _doing(host, starts, a)
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy, steps=steps, ops=ops, gaps=gaps)


def _doing(host: list, starts: list, t: float) -> str:
    """The innermost host span of the main thread that covers ``t`` (the
    latest-starting one), or ``"host: none"``."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        a, b, name = host[i]
        if b >= t:
            return short(name, 80)
    return "host: none"
