"""The port's input pipeline modes (deepfm_tpu_torch/data/pipeline.py)
held against the JAX package's on the same seeded records, as
``tests/test_pipeline.py`` drives JAX's: stream (Pipe) mode from a FIFO
with and without the record shuffle, a ``multi_path`` worker's own
channel and permuted ids, on the C++ route and the Python route (their
batches bit-equal to JAX's); ``shuffle_batches`` and the file-mode
shuffle over two epochs; ``InMemoryDataset``'s epochs and shuffle.  Each
FIFO's writer has a deadline (deepfm_tpu_torch/utils/channel_writer.py)."""

import numpy as np
import pytest

from deepfm_tpu.core.config import DataConfig as JaxDataConfig
from deepfm_tpu.data import pipeline as jax_pipeline
from deepfm_tpu.data.sharding import WorkerTopology as JaxTopology
from deepfm_tpu_torch.core.config import DataConfig
from deepfm_tpu_torch.data import pipeline
from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr
from deepfm_tpu_torch.data.sharding import WorkerTopology
from deepfm_tpu_torch.utils.channel_writer import ChannelWriter

FIELD, VOCAB = 5, 1000


def _write(path, n, seed=0):
    generate_synthetic_ctr(path, num_records=n, feature_size=VOCAB, field_size=FIELD,
                           seed=seed)
    return str(path)


def _records(n, seed=0) -> bytes:
    """``n`` seeded CTR records with ids spread over the vocabulary."""
    from deepfm_tpu_torch.data.example_proto import serialize_ctr_example
    from deepfm_tpu_torch.data.tfrecord import frame_record

    rng = np.random.default_rng(seed)
    return b"".join(frame_record(serialize_ctr_example(
        float(rng.random() < 0.3), rng.integers(0, VOCAB, FIELD).tolist(),
        rng.random(FIELD).astype(np.float32).tolist())) for _ in range(n))


def _assert_same(got: list[dict], want: list[dict]):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


STREAM_CASES = {
    "plain": ({}, (1, 0, 1, 0)),
    "shuffled": ({"shuffle_buffer": 24}, (1, 0, 1, 0)),
    "multi_path": ({"multi_path": True}, (1, 0, 2, 1)),
    "permuted": ({"permute_ids": True, "shuffle_buffer": 16}, (1, 0, 1, 0)),
}


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_mode_batches_equal_jax(tmp_path, monkeypatch, case, route):
    fields, topo = STREAM_CASES[case]
    payload = _records(77, seed=3)
    if route == "python":
        monkeypatch.setenv("DEEPFM_NO_NATIVE", "1")
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        channel = "training-1" if case == "multi_path" else "training"
        kw = dict(batch_size=8, stream_mode=True, drop_remainder=False, **fields)
        with ChannelWriter(d / channel, payload) as writer:
            if side == "jax":
                cfg = JaxDataConfig(**kw)
                out[side] = list(jax_pipeline.make_input_pipeline(
                    cfg, JaxTopology(*topo), field_size=FIELD, data_dir=str(d),
                    feature_size=VOCAB, seed=5, skip_batches=3))
            else:
                cfg = DataConfig(**kw)
                out[side] = list(pipeline.make_input_pipeline(
                    cfg, WorkerTopology(*topo), field_size=FIELD, data_dir=str(d), seed=5,
                    skip_batches=3, permute_vocab=VOCAB if cfg.permute_ids else 0,
                    native=route == "native"))
            writer.join()
    _assert_same(out["port"], out["jax"])
    # stream mode ignores the resume skip: a live channel never repeats
    assert sum(len(b["label"]) for b in out["port"]) == 77


def test_the_channel_name_of_a_multi_path_worker():
    base = DataConfig(stream_mode=True, multi_path=True)
    for local_rank, name in ((0, "training"), (1, "training-1"), (3, "training-3")):
        decision = pipeline.shard_plan(WorkerTopology(1, 0, 4, local_rank),
                                       stream_mode=True, pre_sharded=False, multi_path=True)
        assert pipeline.channel_path("/d", base.training_channel_name, decision) == f"/d/{name}"
        assert pipeline.channel_path("http://h:1/b/p/", "evaluation",
                                     decision) == f"http://h:1/b/p/{name.replace('training', 'evaluation')}"


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_shuffle_batches_equals_jax_and_keeps_every_record_once(seed):
    def batches(n_batches, bs=8):
        for t in range(n_batches):
            yield {"feat_ids": np.arange(t * bs, (t + 1) * bs).reshape(bs, 1),
                   "feat_vals": np.arange(t * bs, (t + 1) * bs, dtype=np.float32)
                   .reshape(bs, 1),
                   "label": np.zeros(bs, np.float32)}

    got = list(pipeline.shuffle_batches(batches(17), buffer_records=32, seed=seed))
    want = list(jax_pipeline.shuffle_batches(batches(17), buffer_records=32, seed=seed))
    _assert_same(got, want)
    ids = np.concatenate([b["feat_ids"].ravel() for b in got])
    np.testing.assert_array_equal(np.sort(ids), np.arange(136))
    assert not np.array_equal(ids, np.arange(136))
    assert all(len(b["label"]) == 8 for b in got)


def test_file_mode_shuffle_buffer_equals_jax_over_two_epochs(tmp_path):
    _write(tmp_path / "tr-0.tfrecords", 64, seed=1)
    _write(tmp_path / "tr-1.tfrecords", 40, seed=2)
    kw = dict(batch_size=8, shuffle_buffer=24, num_epochs=2)
    got = list(pipeline.make_input_pipeline(DataConfig(**kw), field_size=FIELD,
                                            data_dir=str(tmp_path), seed=3))
    want = list(jax_pipeline.make_input_pipeline(
        JaxDataConfig(**kw), JaxTopology(1, 0, 1, 0), field_size=FIELD,
        data_dir=str(tmp_path), seed=3))
    _assert_same(got, want)
    half = len(got) // 2
    e1 = np.concatenate([b["feat_vals"] for b in got[:half]])
    e2 = np.concatenate([b["feat_vals"] for b in got[half:]])
    assert not np.array_equal(e1, e2)  # each epoch reshuffles


@pytest.mark.parametrize("permute", [False, True])
def test_in_memory_dataset_equals_jax(tmp_path, permute):
    files = [_write(tmp_path / f"tr-{i}.tfrecords", 50 + i, seed=i) for i in range(2)]
    vocab = VOCAB if permute else 0
    got = pipeline.InMemoryDataset.from_files(files, FIELD, permute_vocab=vocab)
    want = jax_pipeline.InMemoryDataset.from_files(files, FIELD, permute_vocab=vocab)
    assert len(got) == len(want) == 101
    for k in ("feat_ids", "feat_vals", "label"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for kw in ({"num_epochs": 2}, {"num_epochs": 3, "shuffle": True, "seed": 4},
               {"drop_remainder": False, "shuffle": True, "seed": 1}):
        _assert_same(list(got.batches(16, **kw)), list(want.batches(16, **kw)))
    empty = pipeline.InMemoryDataset.from_files([], FIELD)
    assert len(empty) == 0 and empty.feat_ids.shape == (0, FIELD)
