"""Stream (Pipe) mode end to end in the port (data/pipeline.py,
train/loop.py) on the CPU, held against the JAX package as
``tests/test_stream_eval.py`` drives it: the pure-stream lifecycle (train
from the ``training`` FIFO, the final eval from the ``evaluation`` FIFO,
no file anywhere) takes JAX's step count and eval example count, starting
from JAX's initial weights carried across with the converter, and ends
within 1e-5 of JAX's weights; the eval of JAX's trained weights over the
same channel gives JAX's AUC within 1e-6; ``eval_max_batches`` bounds the
read, also of a channel that never closes; eval memory does not grow with
the channel; a missing channel raises.  Two gloo ranks (spawned, as
``tests/test_torch_dist.py`` runs them): as two hosts, each its own
channels, they train and their final eval reads each record once, at the
AUC of one process; as two processes of one host they train from their
own ``multi_path`` channels, and are refused before any FIFO is read where
they would share one (the training channel without ``multi_path``, the
evaluation channel).  Every FIFO writer has a deadline
(deepfm_tpu_torch/utils/channel_writer.py)."""

import json

import _torch_dist_worker as worker
import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.parallel import build_mesh, create_spmd_state, make_context
from deepfm_tpu.train.loop import run_eval as jax_run_eval
from deepfm_tpu.train.loop import run_train as jax_run_train
from deepfm_tpu.utils import MetricLogger as JaxLogger
from deepfm_tpu_torch.convert import train_state_from_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.data.example_proto import serialize_ctr_example
from deepfm_tpu_torch.data.tfrecord import frame_record
from deepfm_tpu_torch.train.loop import run_eval, run_train
from deepfm_tpu_torch.train.step import create_train_state
from deepfm_tpu_torch.utils.channel_writer import ChannelWriter
from deepfm_tpu_torch.utils.logging import MetricLogger
from test_torch_dist import _spawn

FEATURE, FIELD = 64, 5


def _records(n, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    return b"".join(frame_record(serialize_ctr_example(
        float(rng.random() < 0.3), rng.integers(0, FEATURE, FIELD).tolist(),
        rng.random(FIELD).astype(np.float32).tolist())) for _ in range(n))


def _doc(root, **data) -> dict:
    return {"model": {"feature_size": FEATURE, "field_size": FIELD, "embedding_size": 4,
                      "deep_layers": (8,), "dropout_keep": (1.0,),
                      "compute_dtype": "float32", "fused_kernel": "off"},
            "optimizer": {"learning_rate": 5e-4},
            "data": {"batch_size": 8, "stream_mode": True,
                     "training_data_dir": str(root), **data},
            "run": {"model_dir": str(root / "model"), "servable_model_dir": "",
                    "checkpoint_every_steps": 0, "log_steps": 100}}


class _Events(MetricLogger):
    def __init__(self):
        super().__init__(log_steps=100)
        self.events = []

    def event(self, kind, **fields):
        self.events.append({"kind": kind, **fields})


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_start(doc):
    """JAX's config on the 8 virtual devices, its context and its initial
    state (data parallel: one record a device at batch 8)."""
    jcfg = JaxConfig.from_dict({**doc, "mesh": {"data_parallel": 8, "model_parallel": 1}})
    ctx = make_context(jcfg, build_mesh(jcfg.mesh))
    return jcfg, ctx, create_spmd_state(ctx)


def test_the_pure_stream_lifecycle_equals_jax(tmp_path, capsys):
    train, evaluation = _records(64, seed=1), _records(24, seed=2)
    # JAX: train from its training FIFO, the final eval reads its evaluation FIFO
    jroot = tmp_path / "jax"
    jroot.mkdir()
    jcfg, jctx, jstart = _jax_start(_doc(jroot))
    with ChannelWriter(jroot / "training", train) as t, \
            ChannelWriter(jroot / "evaluation", evaluation) as e:
        jstate = jax_run_train(jcfg)
        t.join(), e.join()
    jevents = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    jeval = [e for e in jevents if e["kind"] == "eval"][-1]
    # the port from JAX's initial weights
    root = tmp_path / "port"
    root.mkdir()
    cfg = Config.from_dict(_doc(root))
    log = _Events()
    with ChannelWriter(root / "training", train) as t, \
            ChannelWriter(root / "evaluation", evaluation) as e:
        state = run_train(cfg, device="cpu", log=log,
                          state=train_state_from_jax(_numpy(jstart), cfg, device="cpu"))
        t.join(), e.join()
    evals = [e for e in log.events if e["kind"] == "eval"]
    done = [e for e in log.events if e["kind"] == "train_done"][0]
    assert state.step == int(jstate.step) == done["steps"] == 64 // 8
    assert len(evals) == 1 and evals[0]["examples"] == jeval["examples"] == 24
    want = train_state_from_jax(_numpy(jstate), cfg, device="cpu")
    for k, v in want.model.state_dict().items():
        np.testing.assert_allclose(state.model.state_dict()[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    # JAX's trained weights over one channel: JAX's eval and the port's
    for side in ("jax", "port"):
        (tmp_path / side / "evaluation").unlink()
        (tmp_path / side / "evaluation").write_bytes(_records(300, seed=7))
    jres = jax_run_eval(jcfg, jctx, jstate, JaxLogger())
    pres = run_eval(want.model, cfg)
    assert pres["examples"] == jres["examples"] == 300
    assert abs(pres["auc"] - jres["auc"]) <= 1e-6
    assert abs(pres["loss"] - jres["loss"]) <= 1e-5


def test_a_bounded_read_stops_after_eval_max_batches(tmp_path):
    cfg = Config.from_dict(_doc(tmp_path, eval_max_batches=2))
    model = create_train_state(cfg, "cpu").model
    (tmp_path / "evaluation").write_bytes(_records(40, seed=3))
    assert run_eval(model, cfg)["examples"] == 2 * cfg.data.batch_size
    # a channel that never closes: the read returns after 2 batches and
    # lets go of the FIFO, which the writer sees as a closed pipe
    live = tmp_path / "live"
    live.mkdir()
    cfg = Config.from_dict(_doc(live, eval_max_batches=2))
    with ChannelWriter(live / "evaluation", _records(16, seed=4), forever=True) as writer:
        assert run_eval(model, cfg)["examples"] == 16
        writer.join()
    assert writer.reader_closed and writer.written >= 16


def test_eval_memory_does_not_grow_with_the_channel(tmp_path):
    """The channel is read incrementally: the host's peak allocation during
    an eval is that of a few batches, for 2,000 records as for 100,000."""
    import tracemalloc

    block = _records(1000, seed=4)
    model = create_train_state(Config.from_dict(_doc(tmp_path)), "cpu").model

    def peak_for(repeats: int) -> int:
        d = tmp_path / f"ch_{repeats}"
        d.mkdir()
        cfg = Config.from_dict(_doc(tmp_path, batch_size=512, val_data_dir=str(d)))
        with open(d / "evaluation", "wb") as f:
            for _ in range(repeats):
                f.write(block)
        run_eval(model, cfg)  # warm-up outside the traced window
        tracemalloc.start()
        result = run_eval(model, cfg)
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        assert result["examples"] == repeats * 1000
        return peak

    small, large = peak_for(2), peak_for(100)
    assert large < small + 3_000_000, f"eval peak grew with the channel: {small} -> {large}"


def test_a_missing_channel_raises(tmp_path):
    cfg = Config.from_dict(_doc(tmp_path))
    with pytest.raises(FileNotFoundError, match="evaluation"):
        run_eval(create_train_state(cfg, "cpu").model, cfg)


# (local world size, multi_path, evaluation channel, what the ranks do)
RANK_CASES = {
    "two_hosts": (1, False, True, "train"),
    "one_host_multi_path": (2, True, False, "train"),
    "one_host_shared_training": (2, False, False, "refused"),
    "one_host_shared_evaluation": (2, True, True, "refused"),
}


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_two_ranks_train_from_their_own_channels(tmp_path, case):
    local_world, multi_path, has_eval, want = RANK_CASES[case]
    train, evaluation = _records(64, seed=1), _records(24, seed=2)
    # a host's data directory: its own under "two hosts", one shared by
    # both ranks of one host (channels training and, multi_path, training-1)
    dirs = [tmp_path / f"host{r}" if local_world == 1 else tmp_path / "host"
            for r in range(2)]
    channels = sorted({(d, "training-1" if multi_path and local_world == 2 and r else
                        "training") for r, d in enumerate(dirs)})
    argvs = []
    for r, d in enumerate(dirs):
        d.mkdir(exist_ok=True)
        argvs.append(["--task_type", "train", "--device", "cpu", "--training_data_dir",
                      str(d), "--model_dir", str(tmp_path / f"model{r}"),
                      "--feature_size", str(FEATURE), "--field_size", str(FIELD),
                      "--embedding_size", "4", "--deep_layers", "8", "--batch_size", "8",
                      "--num_epochs", "1", "--log_steps", "100",
                      "--set", "model.compute_dtype=float32",
                      "--set", "model.fused_kernel=off", "--set", "data.stream_mode=true",
                      "--set", f"data.multi_path={str(multi_path).lower()}"])
    writers = [ChannelWriter(d / name, train) for d, name in channels]
    writers += [ChannelWriter(d / "evaluation", evaluation)
                for d in sorted(set(dirs))] if has_eval else []
    try:
        r0, r1 = _spawn(worker.stream_train, tmp_path, argvs, local_world)
        if want == "refused":
            for r in (r0, r1):
                assert "LOCAL_WORLD_SIZE" in r.get("error", "")
                assert ("evaluation" in r["error"]) == has_eval
            assert all(w.written == 0 for w in writers)  # no FIFO was opened
            return
        for w in writers:
            w.join()
    finally:
        for w in writers:
            w.close()
    assert "error" not in r0 and "error" not in r1
    lines = [json.loads(x) for x in r0["log"].splitlines()]
    done = next(x for x in lines if x["kind"] == "train_done")
    # two hosts: each keeps its half of its channel; one host: each rank
    # its whole multi_path channel
    per_rank = 32 if local_world == 1 else 64
    assert r0["step"] == r1["step"] == done["steps"] == per_rank // 8
    assert (done["world_size"], done["examples"]) == (2, 2 * per_rank)
    for k, v in r0["final"].items():
        assert torch.equal(v, r1["final"][k]), k
    evals = [x for x in lines if x["kind"] == "eval"]
    assert len(evals) == int(has_eval)
    if has_eval:
        # each host reads its whole channel and keeps its data index's
        # records: every record counted once, the AUC of one process
        one = tmp_path / "one"
        one.mkdir()
        (one / "evaluation").write_bytes(evaluation)
        cfg = Config.from_dict(_doc(one))
        model = create_train_state(cfg, "cpu").model
        model.load_state_dict(r0["final"])
        res = run_eval(model, cfg)
        assert evals[0]["examples"] == res["examples"] == 24
        assert abs(evals[0]["auc"] - res["auc"]) <= 1e-6
