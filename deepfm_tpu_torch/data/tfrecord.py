"""TFRecord container format: reader and writer with CRC32C checks.

Copy of ``deepfm_tpu/data/tfrecord.py`` (pure Python, no TensorFlow): the
on-disk format ``tf.python_io.TFRecordWriter`` writes and
``tf.data.TFRecordDataset`` reads.

Framing (per record):
    uint64  length          (little-endian)
    uint32  masked_crc32c(length bytes)
    byte    data[length]
    uint32  masked_crc32c(data)
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Iterable, Iterator

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), slice-by-8 for tolerable pure-Python throughput.
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78  # reflected 0x1EDC6F41


def _make_tables() -> list[list[int]]:
    t0 = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([t0[prev[n] & 0xFF] ^ (prev[n] >> 8) for n in range(256)])
    return tables


_T = _make_tables()
_T0, _T1, _T2, _T3, _T4, _T5, _T6, _T7 = _T


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data``, processing 8 bytes per iteration."""
    crc = ~crc & 0xFFFFFFFF
    n = len(data)
    i = 0
    end8 = n - (n % 8)
    while i < end8:
        crc ^= int.from_bytes(data[i : i + 4], "little")
        hi = int.from_bytes(data[i + 4 : i + 8], "little")
        crc = (
            _T7[crc & 0xFF]
            ^ _T6[(crc >> 8) & 0xFF]
            ^ _T5[(crc >> 16) & 0xFF]
            ^ _T4[(crc >> 24) & 0xFF]
            ^ _T3[hi & 0xFF]
            ^ _T2[(hi >> 8) & 0xFF]
            ^ _T1[(hi >> 16) & 0xFF]
            ^ _T0[(hi >> 24) & 0xFF]
        )
        i += 8
    while i < n:
        crc = _T0[(crc ^ data[i]) & 0xFF] ^ (crc >> 8)
        i += 1
    return ~crc & 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")


class TFRecordCorruptError(IOError):
    pass


def frame_record(data: bytes) -> bytes:
    """Serialize one record with framing + CRCs (the writer hot path)."""
    header = _U64.pack(len(data))
    return b"".join(
        (header, _U32.pack(masked_crc32c(header)), data, _U32.pack(masked_crc32c(data)))
    )


def read_records(
    path_or_file: str | os.PathLike | BinaryIO,
    *,
    verify: bool = True,
) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file or stream.

    Works on any readable binary stream (regular file, FIFO).
    When given a path, the file is closed on exhaustion or generator
    close/GC; partially-consumed generators should be ``.close()``d (or
    wrapped in ``contextlib.closing``) to release the fd promptly.
    """
    own = False
    if isinstance(path_or_file, (str, os.PathLike)):
        f: BinaryIO = open(path_or_file, "rb")
        own = True
    else:
        f = path_or_file

    def read_exactly(n: int) -> bytes:
        # Unbuffered pipes/sockets may return short reads before EOF.
        chunks = []
        got = 0
        while got < n:
            chunk = f.read(n - got)
            if not chunk:
                break
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    try:
        while True:
            header = read_exactly(12)
            if not header:
                return
            if len(header) < 12:
                raise TFRecordCorruptError("truncated record header")
            (length,) = _U64.unpack_from(header, 0)
            (len_crc,) = _U32.unpack_from(header, 8)
            if verify and masked_crc32c(header[:8]) != len_crc:
                raise TFRecordCorruptError("length CRC mismatch")
            body = read_exactly(length + 4)
            if len(body) < length + 4:
                raise TFRecordCorruptError("truncated record body")
            data, (data_crc,) = body[:length], _U32.unpack_from(body, length)
            if verify and masked_crc32c(data) != data_crc:
                raise TFRecordCorruptError("data CRC mismatch")
            yield data
    finally:
        if own:
            f.close()


class TFRecordWriter:
    """Writes framed records, as ``tf.python_io.TFRecordWriter``."""

    def __init__(self, path: str | os.PathLike):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        self._f.write(frame_record(record))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path: str | os.PathLike, records: Iterable[bytes]) -> None:
    """Write ``records`` as one TFRecord file at ``path``."""
    with TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
