"""libsvm <-> TFRecord conversion and synthetic Criteo-shaped TFRecords,
copied from ``deepfm_tpu/data/libsvm.py`` (the same bytes for the same
input and arguments): ``parse_libsvm_line`` (also the stdin scorer's
reader), ``libsvm_to_tfrecord`` (the reference's
tools/libsvm_to_tfrecord.py, paths as arguments), ``tfrecord_to_libsvm``
and ``generate_synthetic_ctr``.  The module is the converter's command
line:

    python -m deepfm_tpu_torch.data.libsvm in.libsvm out.tfrecords \
        [--pad-to-field-size N]
    python -m deepfm_tpu_torch.data.libsvm --reverse in.tfrecords out.libsvm

Each prints ``{"records": N, "output": path}``."""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from .example_proto import parse_example, serialize_ctr_example
from .tfrecord import TFRecordWriter, read_records


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


def libsvm_to_tfrecord(input_filename: str | os.PathLike, output_filename: str | os.PathLike,
                       *, pad_to_field_size: int | None = None) -> int:
    """Convert a libsvm file to one TFRecord file, a record a non-blank
    line; returns the record count.  ``pad_to_field_size`` pads shorter
    lines with (id 0, value 0.0) pairs up to that many (a longer line
    raises); None writes each line as it is, as the reference does."""
    count = 0
    # the input opens first: a bad input path leaves no truncated output
    with open(input_filename, "r") as f, TFRecordWriter(output_filename) as w:
        for line in f:
            line = line.strip()
            if not line:
                continue
            label, ids, values = parse_libsvm_line(line)
            if pad_to_field_size is not None:
                pad = pad_to_field_size - len(ids)
                if pad < 0:
                    raise ValueError(f"line has {len(ids)} features > field_size "
                                     f"{pad_to_field_size}")
                ids += [0] * pad
                values += [0.0] * pad
            w.write(serialize_ctr_example(label, ids, values))
            count += 1
    return count


def tfrecord_to_libsvm(input_filename: str | os.PathLike) -> Iterator[str]:
    """The inverse: one ``label id:val ...`` line a record (``%g``
    values)."""
    for rec in read_records(input_filename):
        parsed = parse_example(rec)
        label = float(np.asarray(parsed["label"])[0])
        pairs = " ".join(f"{i}:{v:g}" for i, v in zip(np.asarray(parsed["ids"]),
                                                       np.asarray(parsed["values"])))
        yield f"{label:g} {pairs}"


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


def main(argv: list[str] | None = None) -> int:
    """The converter's command line (module docstring)."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m deepfm_tpu_torch.data.libsvm",
                                description="libsvm <-> TFRecord CTR converter")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--pad-to-field-size", type=int, default=None)
    p.add_argument("--reverse", action="store_true",
                   help="TFRecord -> libsvm text instead")
    args = p.parse_args(argv)
    if args.reverse:
        if args.pad_to_field_size is not None:
            p.error("--pad-to-field-size applies to libsvm->TFRecord only")
        # the first record is read before the output opens, so a bad
        # input path cannot truncate an existing output
        lines = tfrecord_to_libsvm(args.input)
        first = next(lines, None)
        count = 0
        with open(args.output, "w") as f:
            if first is not None:
                f.write(first + "\n")
                count = 1
            for line in lines:
                f.write(line + "\n")
                count += 1
    else:
        count = libsvm_to_tfrecord(args.input, args.output,
                                   pad_to_field_size=args.pad_to_field_size)
    print(json.dumps({"records": count, "output": args.output}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
