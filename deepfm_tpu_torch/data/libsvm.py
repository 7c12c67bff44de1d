"""libsvm lines and synthetic Criteo-shaped TFRecords:
``parse_libsvm_line`` (the stdin scorer's reader) and
``generate_synthetic_ctr``, copied from ``deepfm_tpu/data/libsvm.py``
(same records for the same arguments)."""

from __future__ import annotations

import os

import numpy as np

from .example_proto import serialize_ctr_example
from .tfrecord import TFRecordWriter


def parse_libsvm_line(line: str) -> tuple[float, list[int], list[float]]:
    """``label id:val id:val ...`` -> (label, ids, values)."""
    data = line.split()
    label = float(data[0])
    ids, values = [], []
    for fea in data[1:]:
        i, v = fea.split(":")
        ids.append(int(i))
        values.append(float(v))
    return label, ids, values


def generate_synthetic_ctr(
    path: str | os.PathLike,
    *,
    num_records: int,
    feature_size: int = 117_581,
    field_size: int = 39,
    seed: int = 0,
) -> None:
    """Write synthetic Criteo-shaped records: 13 numeric fields whose ids
    are always 1..13 (values uniform in [0, 1)), and categorical fields
    with Zipf(1.3)-skewed ids (value 1.0); labels are 1 with probability
    0.25."""
    rng = np.random.default_rng(seed)
    num_numeric = min(13, field_size)
    if feature_size <= num_numeric + 1:
        raise ValueError(
            f"feature_size={feature_size} must exceed num_numeric+1="
            f"{num_numeric + 1} to leave room for categorical ids"
        )
    with TFRecordWriter(path) as w:
        for _ in range(num_records):
            label = float(rng.random() < 0.25)
            numeric_ids = np.arange(1, num_numeric + 1, dtype=np.int64)
            cat = rng.zipf(1.3, size=field_size - num_numeric).astype(np.int64)
            cat = num_numeric + 1 + (cat % (feature_size - num_numeric - 1))
            ids = np.concatenate([numeric_ids, cat])
            values = np.concatenate(
                [
                    rng.random(num_numeric).astype(np.float32),
                    np.ones(field_size - num_numeric, dtype=np.float32),
                ]
            )
            w.write(serialize_ctr_example(label, ids.tolist(), values.tolist()))
