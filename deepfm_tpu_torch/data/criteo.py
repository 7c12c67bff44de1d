"""Criteo click logs (Kaggle / Terabyte TSV) -> TFRecord shards: copy of
``deepfm_tpu/data/criteo.py`` (the same shards, byte for byte, for the
same input and arguments).

The reference ships only a libsvm converter and assumes the Criteo data
was already encoded offline: numeric fields keep the ids 1..13 with a
scaled value, categorical fields get ids >= 14 with value 1.0.  This
module is that encoding for the raw TSV format:

    label \\t I1..I13 \\t C1..C26          (fields may be empty)

Two encoders, both writing the reference schema (label f32, ids i64[39],
values f32[39]):

- :class:`CriteoHashEncoder` - stateless feature hashing: a categorical id
  is 14 + blake2b64(f"{field}:{token}") % (feature_size - 14).  One pass,
  any scale; the collision rate is set by ``feature_size``.
- :class:`CriteoVocabEncoder` - dictionary encoding with a min-count
  threshold from a counting pass (:func:`build_criteo_vocab`): a rare or
  unseen token takes its field's OOV id.

Numeric values: log1p(x) for x >= 0, a negative value kept as it is,
missing -> 0.0.  A missing categorical field is the token '' (a stable
per-field id), so every record has 39 fields.

:func:`convert_criteo_to_tfrecords` writes ``{prefix}-NNNNN.tfrecords``
shards.  With a hash encoder it runs the C++ encoder
(``native.criteo_hash_encode_file``) unless ``DEEPFM_NO_NATIVE`` is set,
as the record reader does: a failed build raises with g++'s output, and
nothing falls back to Python.  The module is the converter's command
line:

    python -m deepfm_tpu_torch.data.criteo TSV OUT_DIR [--encoder hash|vocab]
        [--feature_size N] [--min_count N] [--vocab_json PATH]
        [--records_per_shard N] [--prefix tr]

which prints ``{"shards", "feature_size", "encoder"}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from collections import Counter
from typing import Iterable

from .example_proto import serialize_ctr_example
from .tfrecord import TFRecordWriter

NUM_NUMERIC = 13
NUM_CATEGORICAL = 26
FIELD_SIZE = NUM_NUMERIC + NUM_CATEGORICAL
# ids 0..13: id 0 is the pad id (libsvm's pad_to_field_size), 1..13 numeric
FIRST_CAT_ID = NUM_NUMERIC + 1


def parse_criteo_line(line: str) -> tuple[float, list[str], list[str]]:
    """One TSV line as (label, 13 numeric strings, 26 categorical strings);
    an empty field stays ''."""
    parts = line.rstrip("\n").split("\t")
    if len(parts) != 1 + FIELD_SIZE:
        raise ValueError(f"expected {1 + FIELD_SIZE} tab-separated fields, got {len(parts)}")
    return float(parts[0]), parts[1:1 + NUM_NUMERIC], parts[1 + NUM_NUMERIC:]


def numeric_value(raw: str) -> float:
    """log1p of a count, a negative value as it is, missing -> 0.0."""
    if not raw:
        return 0.0
    x = float(raw)
    return math.log1p(x) if x >= 0 else x


def _hash64(field: int, token: str) -> int:
    h = hashlib.blake2b(f"{field}:{token}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little")


class CriteoHashEncoder:
    """The stateless hashing encoder: one pass, any scale."""

    def __init__(self, feature_size: int):
        if feature_size <= FIRST_CAT_ID + NUM_CATEGORICAL:
            raise ValueError(f"feature_size {feature_size} leaves no categorical hash space")
        self.feature_size = feature_size
        self._buckets = feature_size - FIRST_CAT_ID

    def encode(self, line: str) -> tuple[float, list[int], list[float]]:
        label, numeric, cats = parse_criteo_line(line)
        ids = list(range(1, NUM_NUMERIC + 1))
        values = [numeric_value(x) for x in numeric]
        for j, tok in enumerate(cats):
            ids.append(FIRST_CAT_ID + _hash64(j, tok) % self._buckets)
            values.append(1.0)
        return label, ids, values


def build_criteo_vocab(lines: Iterable[str], *, min_count: int = 10) -> dict:
    """The counting pass: ``{"mapping": [per field {token: id}], "oov": [per
    field OOV id], "feature_size": int}``.  Ids: numeric 1..13, then per
    field its kept tokens (sorted, at least ``min_count`` occurrences) and
    its OOV id."""
    counters = [Counter() for _ in range(NUM_CATEGORICAL)]
    for line in lines:
        _, _, cats = parse_criteo_line(line)
        for j, tok in enumerate(cats):
            counters[j][tok] += 1
    next_id = FIRST_CAT_ID
    mapping: list[dict[str, int]] = []
    oov: list[int] = []
    for j in range(NUM_CATEGORICAL):
        field_map = {}
        for tok, cnt in sorted(counters[j].items()):
            if cnt >= min_count:
                field_map[tok] = next_id
                next_id += 1
        mapping.append(field_map)
        oov.append(next_id)
        next_id += 1
    return {"mapping": mapping, "oov": oov, "feature_size": next_id}


class CriteoVocabEncoder:
    """The dictionary encoder of a :func:`build_criteo_vocab` result."""

    def __init__(self, vocab: dict):
        self.mapping = vocab["mapping"]
        self.oov = vocab["oov"]
        self.feature_size = vocab["feature_size"]

    @classmethod
    def from_json(cls, path: str | os.PathLike) -> "CriteoVocabEncoder":
        with open(path) as f:
            return cls(json.load(f))

    def save(self, path: str | os.PathLike) -> None:
        with open(path, "w") as f:
            json.dump({"mapping": self.mapping, "oov": self.oov,
                       "feature_size": self.feature_size}, f)

    def encode(self, line: str) -> tuple[float, list[int], list[float]]:
        label, numeric, cats = parse_criteo_line(line)
        ids = list(range(1, NUM_NUMERIC + 1))
        values = [numeric_value(x) for x in numeric]
        for j, tok in enumerate(cats):
            ids.append(self.mapping[j].get(tok, self.oov[j]))
            values.append(1.0)
        return label, ids, values


def convert_criteo_to_tfrecords(input_path: str | os.PathLike, output_dir: str | os.PathLike,
                                encoder, *, records_per_shard: int = 1_000_000,
                                prefix: str = "tr") -> list[str]:
    """Encode a Criteo TSV into ``{prefix}-NNNNN.tfrecords`` shards of
    ``records_per_shard`` records in ``output_dir`` (blank lines skipped);
    returns the paths this call wrote, never an older shard left in the
    directory.  A hash encoder runs in C++ unless ``DEEPFM_NO_NATIVE`` is
    set (module docstring)."""
    from .. import native

    if isinstance(encoder, CriteoHashEncoder) and native.enabled():
        n = native.criteo_hash_encode_file(input_path, output_dir,
                                           feature_size=encoder.feature_size,
                                           records_per_shard=records_per_shard,
                                           prefix=prefix)
        n_shards = -(-n // records_per_shard)
        return [os.path.join(os.fspath(output_dir), f"{prefix}-{i:05d}.tfrecords")
                for i in range(n_shards)]
    os.makedirs(output_dir, exist_ok=True)
    paths: list[str] = []
    writer: TFRecordWriter | None = None
    in_shard = 0
    with open(input_path) as f:
        for line in f:
            if not line.strip():
                continue
            if writer is None or in_shard >= records_per_shard:
                if writer is not None:
                    writer.close()
                path = os.path.join(output_dir, f"{prefix}-{len(paths):05d}.tfrecords")
                paths.append(path)
                writer = TFRecordWriter(path)
                in_shard = 0
            label, ids, values = encoder.encode(line)
            writer.write(serialize_ctr_example(label, ids, values))
            in_shard += 1
    if writer is not None:
        writer.close()
    return paths


def main(argv: list[str] | None = None) -> int:
    """The converter's command line (module docstring)."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m deepfm_tpu_torch.data.criteo",
                                description="Convert raw Criteo TSV to DeepFM TFRecords")
    p.add_argument("input", help="Criteo TSV file (label + 13 ints + 26 cats)")
    p.add_argument("output_dir")
    p.add_argument("--encoder", choices=["hash", "vocab"], default="hash")
    p.add_argument("--feature_size", type=int, default=117_581,
                   help="hash space size (hash encoder)")
    p.add_argument("--min_count", type=int, default=10,
                   help="vocab min token count (vocab encoder)")
    p.add_argument("--vocab_json", help="reuse/save the vocab here")
    p.add_argument("--records_per_shard", type=int, default=1_000_000)
    p.add_argument("--prefix", default="tr")
    args = p.parse_args(argv)

    if args.encoder == "hash":
        enc = CriteoHashEncoder(args.feature_size)
    elif args.vocab_json and os.path.exists(args.vocab_json):
        enc = CriteoVocabEncoder.from_json(args.vocab_json)
    else:
        with open(args.input) as f:
            vocab = build_criteo_vocab(f, min_count=args.min_count)
        enc = CriteoVocabEncoder(vocab)
        if args.vocab_json:
            enc.save(args.vocab_json)
    paths = convert_criteo_to_tfrecords(args.input, args.output_dir, enc,
                                        records_per_shard=args.records_per_shard,
                                        prefix=args.prefix)
    print(json.dumps({"shards": len(paths), "feature_size": enc.feature_size,
                      "encoder": args.encoder}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
