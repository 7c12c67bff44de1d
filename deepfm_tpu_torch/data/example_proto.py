"""Minimal ``tf.train.Example`` protobuf wire-format codec (no TF, no protoc).

Copy of ``deepfm_tpu/data/example_proto.py``.  One ``tf.train.Example`` per
TFRecord with features ``label`` (FloatList[1]), ``ids`` (Int64List[F]) and
``values`` (FloatList[F]); ``decode_ctr_batch`` decodes a whole batch.

Wire schema (proto3 field numbers):
    Example   { Features features = 1; }
    Features  { map<string, Feature> feature = 1; }   // repeated entry{key=1,value=2}
    Feature   { oneof { BytesList bytes_list = 1; FloatList float_list = 2;
                        Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed]; }
    Int64List { repeated int64 value = 1 [packed]; }
"""

from __future__ import annotations

import struct
from typing import Iterable, Mapping, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# varint
# ---------------------------------------------------------------------------


def encode_varint(n: int) -> bytes:
    if n < 0:
        # proto int64: negative values occupy the full 10-byte two's-complement
        n &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _uvarint_to_i64(n: int) -> int:
    """Interpret an unsigned varint as two's-complement int64 (proto int64)."""
    return n - (1 << 64) if n >= (1 << 63) else n


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------


def _len_delimited(field_num: int, payload: bytes) -> bytes:
    return encode_varint((field_num << 3) | 2) + encode_varint(len(payload)) + payload


def _float_list(values: Sequence[float]) -> bytes:
    packed = struct.pack(f"<{len(values)}f", *values)
    return _len_delimited(1, packed)  # FloatList.value, packed


def _int64_list(values: Sequence[int]) -> bytes:
    # int(v): numpy int64 scalars overflow on the 64-bit mask; plain ints don't
    packed = b"".join(encode_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in values)
    return _len_delimited(1, packed)  # Int64List.value, packed


def _bytes_list(values: Sequence[bytes]) -> bytes:
    return b"".join(_len_delimited(1, v) for v in values)


def make_feature(value, kind: str) -> bytes:
    if kind == "float":
        return _len_delimited(2, _float_list(value))
    if kind == "int64":
        return _len_delimited(3, _int64_list(value))
    if kind == "bytes":
        return _len_delimited(1, _bytes_list(value))
    raise ValueError(f"unknown feature kind {kind!r}")


def serialize_example(features: Mapping[str, tuple[str, Sequence]]) -> bytes:
    """``features`` maps name -> (kind, values); kinds: float|int64|bytes."""
    # map entry = message{key=1 (string), value=2 (Feature)}
    entries = []
    for name, (kind, values) in features.items():
        nk = name.encode()
        entry = (
            encode_varint((1 << 3) | 2) + encode_varint(len(nk)) + nk
            + _len_delimited(2, make_feature(values, kind))
        )
        entries.append(_len_delimited(1, entry))  # Features.feature
    features_msg = b"".join(entries)
    return _len_delimited(1, features_msg)  # Example.features


def serialize_ctr_example(label: float, ids: Sequence[int], values: Sequence[float]) -> bytes:
    """One CTR record: label, ids and values."""
    return serialize_example(
        {
            "label": ("float", [label]),
            "ids": ("int64", list(ids)),
            "values": ("float", list(values)),
        }
    )


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


def _iter_fields(buf: bytes, start: int, end: int):
    pos = start
    while pos < end:
        tag, pos = decode_varint(buf, pos)
        field_num, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = decode_varint(buf, pos)
            yield field_num, wire, val
        elif wire == 2:
            ln, pos = decode_varint(buf, pos)
            yield field_num, wire, (pos, pos + ln)
            pos += ln
        elif wire == 5:
            yield field_num, wire, struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wire == 1:
            yield field_num, wire, struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_float_list(buf: bytes, start: int, end: int) -> np.ndarray:
    out: list[float] = []
    for fn, wire, val in _iter_fields(buf, start, end):
        if fn != 1:
            continue
        if wire == 2:  # packed
            s, e = val
            out.extend(struct.unpack_from(f"<{(e - s) // 4}f", buf, s))
        elif wire == 5:  # unpacked fixed32 float
            out.append(struct.unpack("<f", struct.pack("<I", val))[0])
    return np.asarray(out, dtype=np.float32)


def _parse_int64_list(buf: bytes, start: int, end: int) -> np.ndarray:
    out: list[int] = []
    for fn, wire, val in _iter_fields(buf, start, end):
        if fn != 1:
            continue
        if wire == 2:  # packed varints
            s, e = val
            pos = s
            while pos < e:
                v, pos = decode_varint(buf, pos)
                out.append(_uvarint_to_i64(v))
        elif wire == 0:
            out.append(_uvarint_to_i64(val))
    return np.asarray(out, dtype=np.int64)


def _parse_bytes_list(buf: bytes, start: int, end: int) -> list[bytes]:
    out = []
    for fn, wire, val in _iter_fields(buf, start, end):
        if fn == 1 and wire == 2:
            s, e = val
            out.append(buf[s:e])
    return out


def parse_example(buf: bytes) -> dict[str, np.ndarray | list[bytes]]:
    """Parse a serialized ``tf.train.Example`` into {name: values}."""
    result: dict[str, np.ndarray | list[bytes]] = {}
    for fn, wire, span in _iter_fields(buf, 0, len(buf)):
        if fn != 1 or wire != 2:
            continue  # Example.features
        fs, fe = span
        for efn, ewire, espan in _iter_fields(buf, fs, fe):
            if efn != 1 or ewire != 2:
                continue  # Features.feature map entry
            es, ee = espan
            name = None
            feature_span = None
            for mfn, mwire, mspan in _iter_fields(buf, es, ee):
                if mfn == 1 and mwire == 2:
                    ks, ke = mspan
                    name = buf[ks:ke].decode()
                elif mfn == 2 and mwire == 2:
                    feature_span = mspan
            if name is None or feature_span is None:
                continue
            vs, ve = feature_span
            for kfn, kwire, kspan in _iter_fields(buf, vs, ve):
                if kwire != 2:
                    continue
                ss, se = kspan
                if kfn == 1:
                    result[name] = _parse_bytes_list(buf, ss, se)
                elif kfn == 2:
                    result[name] = _parse_float_list(buf, ss, se)
                elif kfn == 3:
                    result[name] = _parse_int64_list(buf, ss, se)
    return result


def decode_ctr_batch(
    records: Iterable[bytes], field_size: int
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Batch decode of the CTR schema: returns
    ``({'feat_ids': int64 [B,F], 'feat_vals': f32 [B,F]}, labels f32 [B])``.
    """
    labels, ids_rows, val_rows = [], [], []
    for rec in records:
        parsed = parse_example(rec)
        label = parsed["label"]
        ids = parsed["ids"]
        vals = parsed["values"]
        if len(ids) != field_size or len(vals) != field_size:
            raise ValueError(
                f"record has {len(ids)} ids / {len(vals)} values, "
                f"expected field_size={field_size}"
            )
        labels.append(np.float32(label[0]))
        ids_rows.append(ids)
        val_rows.append(vals)
    batch = len(labels)
    feats = {
        "feat_ids": np.stack(ids_rows) if batch else np.zeros((0, field_size), np.int64),
        "feat_vals": np.stack(val_rows) if batch else np.zeros((0, field_size), np.float32),
    }
    return feats, np.asarray(labels, dtype=np.float32)
