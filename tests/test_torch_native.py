"""The port's C++ record reader (``deepfm_tpu_torch/native``), built here
with the system ``g++``, against the port's pure-Python reader and decoder
and against the JAX package's ``deepfm_tpu.native`` on the same files: raw
records, decoded batches, record sharding, the tail under
``drop_remainder=False``, the resume skip across epochs, the parallel
reader's order, and the errors (bad CRC, missing file, field-size
mismatch, a failed build).  Batches are compared bit for bit."""

import os
import threading
import time

import numpy as np
import pytest

from deepfm_tpu import native as jax_native
from deepfm_tpu_torch import native
from deepfm_tpu_torch.core.config import DataConfig
from deepfm_tpu_torch.data import parallel_ingest
from deepfm_tpu_torch.data import pipeline
from deepfm_tpu_torch.data.example_proto import serialize_ctr_example
from deepfm_tpu_torch.data.pipeline import (batched_ctr_batches, ctr_batches_from_sources,
                                            make_input_pipeline, record_stream)
from deepfm_tpu_torch.data.sharding import ShardDecision
from deepfm_tpu_torch.data.tfrecord import (TFRecordWriter, frame_record, masked_crc32c,
                                            read_records)

F = 7


def _records(n, seed=0, field=F):
    rng = np.random.default_rng(seed)
    return [serialize_ctr_example(float(rng.random()),
                                  rng.integers(-5, 1000, size=field).tolist(),
                                  rng.random(field).astype(np.float32).tolist())
            for _ in range(n)]


def _write(path, recs):
    with TFRecordWriter(path) as w:
        for r in recs:
            w.write(r)
    return str(path)


def _files(tmp_path, sizes, seed=0):
    recs = _records(sum(sizes), seed)
    out, off = [], 0
    for i, n in enumerate(sizes):
        out.append(_write(tmp_path / f"train-{i}.tfrecords", recs[off:off + n]))
        off += n
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_built_with_gxx_and_crc_matches_python_and_jax():
    native._load()
    assert os.path.exists(native.LIB)
    assert isinstance(native.have_hw_crc(), bool)
    for data in (b"", b"a", b"hello world", os.urandom(1 << 16)):
        assert native.masked_crc32c(data) == masked_crc32c(data) == \
            jax_native.masked_crc32c(data)


@pytest.mark.parametrize("shard", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_raw_records_equal_python_and_jax(tmp_path, shard):
    files = _files(tmp_path, [101, 0, 57])
    n, i = shard
    got = list(native.read_records(files, shard_n=n, shard_i=i))
    want = [r for j, r in enumerate(rec for f in files for rec in read_records(f))
            if j % n == i]
    assert got == want
    assert got == list(jax_native.read_records(files, shard_n=n, shard_i=i))


@pytest.mark.parametrize("drop", [True, False], ids=["drop", "keep_tail"])
@pytest.mark.parametrize("shard", [(1, 0), (3, 1)])
def test_batches_equal_python_decoder_and_jax_reader(tmp_path, drop, shard):
    files = _files(tmp_path, [70, 45])
    n, i = shard
    decision = ShardDecision(n, i)
    got = list(native.NativeCtrReader(files, batch_size=16, field_size=F, shard_n=n,
                                      shard_i=i, drop_remainder=drop))
    python = list(batched_ctr_batches(record_stream(files, decision=decision),
                                      batch_size=16, field_size=F, drop_remainder=drop))
    jax = list(jax_native.NativeCtrReader(files, batch_size=16, field_size=F,
                                          shard_n=n, shard_i=i, drop_remainder=drop))
    _equal(got, python)
    _equal(got, jax)
    assert (got[-1]["label"].shape[0] < 16) == (not drop and (115 // n) % 16 != 0)


ROUTES = {"native": dict(native=True), "python": dict(native=False),
          "parallel": dict(native=True, parallel_readers=3)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("drop", [True, False], ids=["drop", "keep_tail"])
def test_skip_counter_spans_epochs_on_every_route(tmp_path, monkeypatch, route, drop):
    monkeypatch.setattr(pipeline, "_host_cpu_count", lambda: 8)
    _files(tmp_path, [40, 33, 20])
    kw = ROUTES[route]
    cfg = DataConfig(training_data_dir=str(tmp_path), batch_size=8, num_epochs=3,
                     drop_remainder=drop, parallel_readers=kw.get("parallel_readers", 1))
    full = list(make_input_pipeline(cfg, field_size=F, seed=3, native=kw["native"]))
    per_epoch = 93 // 8 + (0 if drop else 1)
    assert len(full) == 3 * per_epoch
    for skip in (0, 5, per_epoch, per_epoch + 3, 3 * per_epoch, 3 * per_epoch + 4):
        rest = list(make_input_pipeline(cfg, field_size=F, seed=3, skip_batches=skip,
                                        native=kw["native"]))
        _equal(rest, full[skip:])
    python = list(make_input_pipeline(cfg, field_size=F, seed=3, native=False))
    _equal(full, python)


@pytest.mark.parametrize("threads", [2, 4])
@pytest.mark.parametrize("drop", [True, False], ids=["drop", "keep_tail"])
def test_parallel_reader_keeps_the_sequential_order(tmp_path, threads, drop):
    files = _files(tmp_path, [9000, 1, 0, 5000, 777], seed=4)
    got = list(parallel_ingest.parallel_ctr_batches(
        files, batch_size=512, field_size=F, drop_remainder=drop, num_threads=threads,
        chunk_records=1000))
    want = list(native.NativeCtrReader(files, batch_size=512, field_size=F,
                                       drop_remainder=drop))
    _equal(got, want)
    for n, i in ((2, 1), (3, 0)):
        got = list(parallel_ingest.parallel_ctr_batches(
            files, batch_size=512, field_size=F, shard_n=n, shard_i=i,
            drop_remainder=drop, num_threads=threads, chunk_records=777))
        _equal(got, list(native.NativeCtrReader(files, batch_size=512, field_size=F,
                                                shard_n=n, shard_i=i,
                                                drop_remainder=drop)))


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_dispatch_parallel_sequential_and_python(tmp_path, monkeypatch):
    files = _files(tmp_path, [30, 30, 30])
    monkeypatch.setattr(pipeline, "_host_cpu_count", lambda: 8)
    par = _spy(monkeypatch, parallel_ingest, "parallel_ctr_batches")
    seq = _spy(monkeypatch, native, "NativeCtrReader")
    py = _spy(monkeypatch, pipeline, "batched_ctr_batches")
    kw = dict(batch_size=8, field_size=F)
    want = list(ctr_batches_from_sources(files, native=False, **kw))
    assert len(py) == 1 and not par and not seq
    _equal(list(ctr_batches_from_sources(files, parallel_readers=4, **kw)), want)
    assert len(par) == 1 and par[0]["num_threads"] == 4
    # record sharding stays sequential; one file or one reader too
    list(ctr_batches_from_sources(files, parallel_readers=4,
                                  decision=ShardDecision(2, 1), **kw))
    list(ctr_batches_from_sources(files[:1], parallel_readers=4, **kw))
    list(ctr_batches_from_sources(files, parallel_readers=1, **kw))
    assert len(par) == 1 and len(seq) == 3
    monkeypatch.setenv("DEEPFM_NO_NATIVE", "1")
    _equal(list(ctr_batches_from_sources(files, parallel_readers=4, **kw)), want)
    assert len(py) == 2 and len(par) == 1 and len(seq) == 3
    monkeypatch.setattr(pipeline, "_host_cpu_count", lambda: 1)
    monkeypatch.delenv("DEEPFM_NO_NATIVE")
    list(ctr_batches_from_sources(files, parallel_readers=4, **kw))
    assert len(par) == 1 and len(seq) == 4  # capped at the host's cores


def test_bad_crc_missing_file_and_field_mismatch_raise(tmp_path):
    good = _records(20)
    blob = bytearray(b"".join(frame_record(r) for r in good))
    blob[len(blob) // 2] ^= 0xFF
    bad = tmp_path / "train-bad.tfrecords"
    bad.write_bytes(bytes(blob))
    with pytest.raises(native.NativeReaderError, match="(?i)crc"):
        list(native.NativeCtrReader([str(bad)], batch_size=4, field_size=F))
    with pytest.raises(native.NativeReaderError):
        list(native.read_records(str(tmp_path / "missing.tfrecords")))
    ok = _write(tmp_path / "train-ok.tfrecords", good)
    with pytest.raises(native.NativeReaderError, match="field_size"):
        list(native.NativeCtrReader([ok], batch_size=4, field_size=F + 1))
    # a reader thread's error reaches the consumer of the parallel route
    with pytest.raises(native.NativeReaderError):
        list(parallel_ingest.parallel_ctr_batches([ok, str(bad)], batch_size=4,
                                                  field_size=F, num_threads=2))


def test_early_abandon_of_the_parallel_reader_stops_its_threads(tmp_path):
    files = _files(tmp_path, [3000] * 4)
    before = threading.active_count()
    it = parallel_ingest.parallel_ctr_batches(files, batch_size=16, field_size=F,
                                              num_threads=4, chunk_records=64)
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    src = tmp_path / "broken.cc"
    src.write_text("int main( {\n")
    with pytest.raises(native.NativeBuildError, match="error"):
        native.build(str(src), str(tmp_path / "lib.so"))
    assert not os.path.exists(tmp_path / "lib.so")
    files = _files(tmp_path, [10])
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "LIB", str(tmp_path / "_build" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError):
        list(ctr_batches_from_sources(files, batch_size=4, field_size=F))
    # the Python decoder runs only when asked for
    assert len(list(ctr_batches_from_sources(files, batch_size=4, field_size=F,
                                             native=False))) == 2
    monkeypatch.setenv("DEEPFM_NO_NATIVE", "1")
    assert not native.enabled()
    assert len(list(ctr_batches_from_sources(files, batch_size=4, field_size=F))) == 2
