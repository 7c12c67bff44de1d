"""Native (C++) record reader and Criteo hash encoder: counterpart of
``deepfm_tpu/native``.

``src/tfrecord_reader.cc`` is the JAX package's reader, copied as it is:
TFRecord framing, masked CRC32C (SSE4.2 when the CPU has it), round-robin
record sharding (record i to shard i % n) and the CTR Example decode
(label f32[1], ids i64[F], values f32[F]) straight into numpy buffers,
behind a plain C interface.  It is host code: the train loop's reader
thread runs it, and ``ctypes`` releases the interpreter lock for each
call, so decoding does not hold the step up.

``src/criteo_encoder.cc``, also the JAX package's file as it is, encodes
a raw Criteo TSV into TFRecord shards with the hash encoder
(``data/criteo.py``), shard for shard byte-equal to the Python encoder:
:func:`criteo_hash_encode_file`, and its hash, :func:`blake2b64`.  It
frames records with the reader's CRC, so both sources make one library.

The library is built on first use with the system ``g++`` into
``_build/`` (git-ignored), again whenever a source is newer.  Each
process compiles to a file of its own and publishes it with
``os.replace``, so processes that build at once do not clash.  There is
no quiet fallback: a failed build raises :class:`NativeBuildError` with
the compiler's output.  The pure-Python decoder (``data/tfrecord.py``,
``data/example_proto.py``) runs only where the caller asks for it:
``DEEPFM_NO_NATIVE=1`` (:func:`enabled`) or ``native=False`` in the
pipeline's functions.

:class:`NativeCtrReader` streams whole decoded batches; :func:`read_records`
the raw records; :func:`masked_crc32c` and :func:`have_hw_crc` expose the
checksum.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Iterator, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "tfrecord_reader.cc")
ENCODER_SOURCE = os.path.join(_HERE, "src", "criteo_encoder.cc")
LIB = os.path.join(_HERE, "_build", "libdeepfm_tfrecord.so")
NO_NATIVE_ENV = "DEEPFM_NO_NATIVE"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """``g++`` could not build the reader; the message holds its output."""


class NativeReaderError(IOError):
    """A framing, checksum, decode or open error from the C++ reader."""


def enabled() -> bool:
    """Whether the pipeline reads through the C++ reader: always, unless
    ``DEEPFM_NO_NATIVE`` is set (to anything but the empty string), as in
    the JAX package."""
    return not os.environ.get(NO_NATIVE_ENV)


def _needs_build(sources: Sequence[str], lib: str) -> bool:
    """Whether ``lib`` is missing or older than any of ``sources``."""
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(built < os.path.getmtime(src) for src in sources)


def build(sources: str | Sequence[str] | None = None, lib: str | None = None) -> float:
    """Compile ``sources`` (default: the reader and the encoder) into the
    shared library ``lib`` (default :data:`LIB`) when it is missing or
    older than one of them; returns the seconds spent (0.0 when it was up
    to date).  Raises :class:`NativeBuildError` on a failed build."""
    if sources is None:
        sources = [SOURCE, ENCODER_SOURCE]
    elif isinstance(sources, str):
        sources = [sources]
    lib = LIB if lib is None else lib
    if not _needs_build(sources, lib):
        return 0.0
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fno-exceptions",
           "-Wall", *sources, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"native build could not start {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise NativeBuildError(
            f"native build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    """The library, built and bound once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        # da:allow[blocking-under-lock] build-once lazy init: the lock exists to make the slow compile happen exactly once; callers blocking behind it is the design
        build()
        lib = ctypes.CDLL(LIB)
        lib.dfm_reader_open.restype = ctypes.c_void_p
        lib.dfm_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                                        ctypes.c_int64]
        lib.dfm_reader_close.restype = None
        lib.dfm_reader_close.argtypes = [ctypes.c_void_p]
        lib.dfm_reader_error.restype = ctypes.c_char_p
        lib.dfm_reader_error.argtypes = [ctypes.c_void_p]
        lib.dfm_reader_next_record.restype = ctypes.c_int64
        lib.dfm_reader_next_record.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.dfm_reader_next_ctr_batch.restype = ctypes.c_int64
        lib.dfm_reader_next_ctr_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.dfm_masked_crc32c.restype = ctypes.c_uint32
        lib.dfm_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.dfm_have_hw_crc.restype = ctypes.c_int
        lib.dfm_have_hw_crc.argtypes = []
        lib.dfm_blake2b64.restype = ctypes.c_uint64
        lib.dfm_blake2b64.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.dfm_criteo_hash_encode.restype = ctypes.c_int64
        lib.dfm_criteo_hash_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        # fills the CRC tables here, under the lock, before any reader
        # thread opens a handle
        lib.dfm_have_hw_crc()
        _lib = lib
        return lib


def have_hw_crc() -> bool:
    return bool(_load().dfm_have_hw_crc())


def masked_crc32c(data: bytes) -> int:
    return _load().dfm_masked_crc32c(data, len(data))


def blake2b64(data: bytes) -> int:
    """The 8-byte unkeyed BLAKE2b of ``data`` as a little-endian int, the
    Criteo hash: ``int.from_bytes(hashlib.blake2b(data,
    digest_size=8).digest(), "little")``."""
    return _load().dfm_blake2b64(data, len(data))


def criteo_hash_encode_file(input_path: str | os.PathLike, output_dir: str | os.PathLike,
                            *, feature_size: int, records_per_shard: int = 1_000_000,
                            prefix: str = "tr") -> int:
    """``data.criteo.convert_criteo_to_tfrecords`` with a
    ``CriteoHashEncoder``, in C++: the same shards byte for byte
    (``{prefix}-NNNNN.tfrecords`` in ``output_dir``), no interpreter per
    line.  Returns the records written.  Raises :class:`NativeReaderError`
    when a file cannot be opened or written, and ValueError when a line
    was malformed (after the well-formed lines were written: the Python
    encoder raises at the first)."""
    os.makedirs(output_dir, exist_ok=True)
    err = ctypes.create_string_buffer(256)
    n = _load().dfm_criteo_hash_encode(
        os.fsencode(os.fspath(input_path)), os.fsencode(os.fspath(output_dir)),
        prefix.encode(), feature_size, records_per_shard, err, len(err))
    if n < 0:
        raise NativeReaderError(err.value.decode(errors="replace"))
    if err.value:
        raise ValueError(err.value.decode(errors="replace"))
    return int(n)


def _pack_paths(paths: Sequence[str | os.PathLike]) -> bytes:
    return b"".join(os.fsencode(os.fspath(p)) + b"\x00" for p in paths) + b"\x00"


class _Handle:
    """One open ``dfm_reader`` over an ordered list of sources."""

    def __init__(self, paths, verify: bool, shard_n: int, shard_i: int):
        self.lib = _load()
        self.h = self.lib.dfm_reader_open(_pack_paths(paths), int(verify), shard_n, shard_i)
        if not self.h:
            raise NativeReaderError("dfm_reader_open failed")

    def error(self) -> str:
        return self.lib.dfm_reader_error(self.h).decode(errors="replace")

    def close(self) -> None:
        if self.h:
            self.lib.dfm_reader_close(self.h)
            self.h = None


def read_records(paths: str | os.PathLike | Sequence[str | os.PathLike], *,
                 verify: bool = True, shard_n: int = 1,
                 shard_i: int = 0) -> Iterator[bytes]:
    """The raw record payloads of this shard of ``paths``, in order."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    h = _Handle(paths, verify, shard_n, shard_i)
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    try:
        while True:
            n = h.lib.dfm_reader_next_record(h.h, ctypes.byref(ptr))
            if n == -1:
                return
            if n < 0:
                raise NativeReaderError(h.error())
            yield ctypes.string_at(ptr, n)
    finally:
        h.close()


class NativeCtrReader:
    """Decoded CTR batches from the C++ reader: ``{"feat_ids" i64 [B, F],
    "feat_vals" f32 [B, F], "label" f32 [B]}``, the batches
    ``data.pipeline.batched_ctr_batches`` gives for the same records.

    ``skip_counter`` is the input-position resume: a one-element list of
    whole batches to pass over, read at the record level (framing and CRC,
    no decode) and decremented as they go by.  The caller shares one
    counter across epochs to spread a skip over them.  A short tail counts
    as a batch only when ``drop_remainder`` is false."""

    def __init__(self, paths: Sequence[str | os.PathLike], *, batch_size: int,
                 field_size: int, shard_n: int = 1, shard_i: int = 0,
                 drop_remainder: bool = True, verify: bool = True,
                 skip_counter: list[int] | None = None):
        self._paths = list(paths)
        self._batch = batch_size
        self._fields = field_size
        self._shard = (shard_n, shard_i)
        self._drop = drop_remainder
        self._verify = verify
        self._skip = skip_counter

    def _skipped(self, h: _Handle) -> bool:
        """Pass over the batches ``skip_counter`` asks for; True when the
        stream ended inside them."""
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        while self._skip and self._skip[0] > 0:
            for pulled in range(self._batch):
                n = h.lib.dfm_reader_next_record(h.h, ctypes.byref(ptr))
                if n == -1:
                    if pulled and not self._drop:
                        self._skip[0] -= 1
                    return True
                if n < 0:
                    raise NativeReaderError(h.error())
            self._skip[0] -= 1
        return False

    def __iter__(self) -> Iterator[dict]:
        h = _Handle(self._paths, self._verify, *self._shard)
        b, f = self._batch, self._fields
        try:
            if self._skipped(h):
                return
            while True:
                ids = np.empty((b, f), np.int64)
                vals = np.empty((b, f), np.float32)
                labels = np.empty((b,), np.float32)
                n = h.lib.dfm_reader_next_ctr_batch(
                    h.h, b, f, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                if n < 0:
                    raise NativeReaderError(h.error())
                if n == b:
                    yield {"feat_ids": ids, "feat_vals": vals, "label": labels}
                    continue
                if n > 0 and not self._drop:
                    yield {"feat_ids": ids[:n], "feat_vals": vals[:n], "label": labels[:n]}
                return
        finally:
            h.close()
