"""Flywheel record codecs and the sampling gate: the port's copy of
``deepfm_tpu/flywheel/records.py``.

Impressions and clicks ride the ``tf.train.Example`` wire format of the
training stream (data/example_proto.py) but are not the trainer's CTR
schema; only the join's output is (plain ``serialize_ctr_example``
records).  Timestamps are int64 milliseconds on the wire: a float32 would
quantize epoch seconds to about a minute.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from ..data.example_proto import parse_example, serialize_example
from ..fleet.split import sampled

# its own salt: the flywheel's slice stays put however a shadow split is tuned
FLYWHEEL_SALT = "flywheel"


def impression_sampled(impression_id: str, sample_rate: float) -> bool:
    """Hash-stable keep/drop decision for one impression id: a pure function
    of the id, so the logger and the join take the same decision."""
    return sampled(impression_id, float(sample_rate) * 100.0, salt=FLYWHEEL_SALT)


class Impression(NamedTuple):
    impression_id: str
    trace_id: str
    tenant: str
    model_version: int
    ids: np.ndarray  # [F] int64
    values: np.ndarray  # [F] float32
    score: float
    deadline_class: str
    ts_ms: int


class Click(NamedTuple):
    impression_id: str
    ts_ms: int


def serialize_impression(*, impression_id: str, trace_id: str, tenant: str,
                         model_version: int, ids: Sequence[int], values: Sequence[float],
                         score: float, deadline_class: str, ts_ms: int) -> bytes:
    return serialize_example({
        "impression_id": ("bytes", [impression_id.encode()]),
        "trace_id": ("bytes", [trace_id.encode()]),
        "tenant": ("bytes", [tenant.encode()]),
        "model_version": ("int64", [int(model_version)]),
        "ids": ("int64", [int(i) for i in ids]),
        "values": ("float", [float(v) for v in values]),
        "score": ("float", [float(score)]),
        "deadline_class": ("bytes", [deadline_class.encode()]),
        "ts_ms": ("int64", [int(ts_ms)]),
    })


def _one_bytes(doc: dict, name: str) -> str:
    vals = doc.get(name)
    if not isinstance(vals, list) or len(vals) != 1:
        raise ValueError(f"record missing bytes field {name!r}")
    return vals[0].decode()


def _one_scalar(doc: dict, name: str) -> float:
    vals = doc.get(name)
    if vals is None or len(vals) != 1:
        raise ValueError(f"record missing scalar field {name!r}")
    return float(vals[0])


def parse_impression(buf: bytes) -> Impression:
    doc = parse_example(buf)
    ids = np.asarray(doc.get("ids", ()), np.int64)
    values = np.asarray(doc.get("values", ()), np.float32)
    if ids.shape != values.shape:
        raise ValueError(f"impression ids/values shape mismatch: {ids.shape} vs {values.shape}")
    return Impression(
        impression_id=_one_bytes(doc, "impression_id"),
        trace_id=_one_bytes(doc, "trace_id"),
        tenant=_one_bytes(doc, "tenant"),
        model_version=int(_one_scalar(doc, "model_version")),
        ids=ids,
        values=values,
        score=_one_scalar(doc, "score"),
        deadline_class=_one_bytes(doc, "deadline_class"),
        ts_ms=int(_one_scalar(doc, "ts_ms")),
    )


def serialize_click(*, impression_id: str, ts_ms: int) -> bytes:
    return serialize_example({
        "impression_id": ("bytes", [impression_id.encode()]),
        "ts_ms": ("int64", [int(ts_ms)]),
    })


def parse_click(buf: bytes) -> Click:
    doc = parse_example(buf)
    return Click(impression_id=_one_bytes(doc, "impression_id"),
                 ts_ms=int(_one_scalar(doc, "ts_ms")))
