"""The port's elastic training (deepfm_tpu_torch/elastic) against JAX's
(deepfm_tpu/elastic) on the CPU, at the widths of tests/test_elastic.py
(feature 64, field 5, embedding 4, MLP (8,), batch 8).

* ``choose_mesh`` over JAX's parameter table; ``plan_reshard``'s summary
  equal to JAX's for a shrink, a grow and a width change (dense with
  ZeRO, and lazy); the registries' epochs and debounce beside JAX's on
  the same scripted readings.
* The elastic lifecycle on gloo rank processes (one a device,
  tests/_torch_elastic_worker.py: the rendezvous store, the coordinator
  and the device board in this process): [2, 2] -> [1, 2] -> [2, 2] after
  steps 3 and 6, dense and lazy, from JAX's initial weights (carried by
  convert.py into a step-0 commit), held to JAX's ElasticTrainer under the
  same script on the same log: the reshards summary, a strictly
  increasing lineage of 10 cursors, every manifest at the true
  vocabulary, the final parameters within JAX's own tolerance
  (rtol=1e-4, atol=1e-5).  Two ranks killed without notice (no drain
  commit, their devices still on the board, a short lease): the
  uncommitted step replays exactly once.  The lazy shrink and grow of
  xDeepFM and DCN-v2 against JAX's the same way.  A restart
  on fewer ranks resumes the commit with no live reshard.  The capacity
  wait times out.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from _torch_elastic_worker import Harness, spawn_ranks, start_ranks, wait_ranks
from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.core.config import MeshConfig as JaxMeshConfig
from deepfm_tpu.elastic import ElasticTrainer as JaxElasticTrainer
from deepfm_tpu.elastic import LiveDeviceRegistry as JaxLiveRegistry
from deepfm_tpu.elastic import VirtualDeviceRegistry as JaxVirtualRegistry
from deepfm_tpu.elastic import choose_mesh as jax_choose_mesh
from deepfm_tpu.elastic import plan_reshard as jax_plan_reshard
from deepfm_tpu.parallel import build_mesh, create_spmd_state, make_context
from deepfm_tpu.utils import MetricLogger as JaxMetricLogger
from deepfm_tpu_torch.checkpoint import Checkpointer
from deepfm_tpu_torch.convert import params_from_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.elastic import (Grid, LiveDeviceRegistry, RankDevice,
                                      VirtualDeviceRegistry, choose_mesh, plan_reshard)
from deepfm_tpu_torch.elastic.controller import ElasticTrainer
from deepfm_tpu_torch.elastic.mpmd import read_payload_tree
from deepfm_tpu_torch.elastic.plan import state_leaves
from deepfm_tpu_torch.online import append_segment, latest_manifest, list_versions
from deepfm_tpu_torch.online.publisher import read_manifest
from deepfm_tpu_torch.online.stream import StreamCursor
from deepfm_tpu_torch.online.trainer import commit_payload
from deepfm_tpu_torch.parallel.spmd import padded_vocab
from deepfm_tpu_torch.train.step import create_train_state

FEATURE, FIELD = 64, 5


def _fill_stream(root, *, segments, rows=8, start=0):
    for seq in range(start, start + segments):
        rng = np.random.default_rng(seq)
        append_segment(root, (rng.random(rows) < 0.3).astype(np.float32),
                       rng.integers(0, FEATURE, (rows, FIELD)).astype(np.int64),
                       rng.random((rows, FIELD)).astype(np.float32), seq=seq)


def _doc(root, *, lazy=False, **overrides) -> dict:
    """tests/test_elastic.py's config, as a dict both packages read."""
    base = {
        "model": {"feature_size": FEATURE, "field_size": FIELD, "embedding_size": 4,
                  "deep_layers": [8], "dropout_keep": [1.0], "compute_dtype": "float32"},
        "optimizer": {"learning_rate": 0.01, "lazy_embedding_updates": lazy},
        "data": {"training_data_dir": os.path.join(root, "stream"), "batch_size": 8},
        "run": {"model_dir": os.path.join(root, "ckpt"),
                "servable_model_dir": os.path.join(root, "publish"),
                "checkpoint_every_steps": 2, "online_publish_every_steps": 2,
                "log_steps": 10_000},
        "elastic": {"enabled": True, "prefer_model_parallel": 2},
    }
    for section, fields in overrides.items():
        base[section] = {**base.get(section, {}), **fields}
    return base


def _rank_doc(doc: dict, harness: Harness, **elastic) -> dict:
    return {**doc, "elastic": {**doc["elastic"], "coordinator_url": harness.coord_url,
                               "heartbeat_interval_secs": 0.2, "registry_debounce_polls": 1,
                               "poll_interval_secs": 0.05, **elastic}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# -- the grid policy and the plan ---------------------------------------------

@pytest.mark.parametrize("n,prefer,want", [(8, 4, (2, 4)), (4, 4, (1, 4)), (6, 4, (2, 3)),
                                           (3, 4, (1, 3)), (1, 4, (1, 1)), (8, 1, (8, 1))])
def test_choose_mesh_policy(n, prefer, want):
    assert choose_mesh(n, prefer_model_parallel=prefer) == want \
        == jax_choose_mesh(n, prefer_model_parallel=prefer)


def _jax_ctx(jcfg, dp, mp, devices):
    return make_context(jcfg, build_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp),
                                         devices=devices))


def _port_plan(cfg: Config, old, new):
    """The port's plan between ``(dp, mp, device ids)`` grids, over its own
    model's parameters at the old padded vocabulary."""
    state = create_train_state(cfg, "cpu")
    wm = 128 // cfg.model.embedding_size

    def grid(dp, mp, ids):
        return Grid((dp, mp), padded_vocab(FEATURE, mp, wm), tuple(ids))

    g_old, g_new = grid(*old), grid(*new)
    params = {n: ((g_old.padded_vocab,) + tuple(p.shape[1:]) if n in ("fm_w", "fm_v")
                  else tuple(p.shape), p.element_size())
              for n, p in state.model.named_parameters()}
    zero = old[0] > 1
    leaves = state_leaves(params, dp=old[0], lazy=cfg.optimizer.lazy_embedding_updates,
                          zero=zero)
    return plan_reshard(g_old, g_new, leaves)


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
@pytest.mark.parametrize("old,new,prefer", [
    ((2, 2, (0, 1, 2, 3)), (1, 2, (0, 1)), 2),      # a same-width shrink
    ((1, 2, (0, 1)), (2, 2, (0, 1, 2, 3)), 2),      # a grow
    ((1, 2, (0, 1)), (1, 4, (0, 1, 2, 3)), 4),      # a width change
], ids=["shrink", "grow", "width"])
def test_plan_summary_equals_jax(tmp_path, lazy, old, new, prefer):
    doc = _doc(str(tmp_path), lazy=lazy, elastic={"prefer_model_parallel": prefer})
    devs = jax.devices()
    jcfg = JaxConfig.from_dict(doc)
    want = jax_plan_reshard(_jax_ctx(jcfg, old[0], old[1], [devs[i] for i in old[2]]),
                            _jax_ctx(jcfg, new[0], new[1], [devs[i] for i in new[2]]))
    got = _port_plan(Config.from_dict(doc), old, new)
    assert got.summary() == want.summary()
    if new[0] < old[0] and new[1] == old[1]:
        assert got.moved_bytes == 0 and got.kept_bytes > 0 and got.joined_devices == 0
    else:
        assert 0 < got.moved_bytes < got.naive_bytes
    with pytest.raises(ValueError, match="targets mesh"):
        got.validate_target(Grid((9, 9), 64))


def test_reshard_state_windows_equal_jax(tmp_path):
    """JAX's live ``reshard_state`` from [2, 2] to [1, 4] and the port's
    ``reshard_state`` of the same gathered weights, window by window, give
    the same whole tables (pad rows zero)."""
    from deepfm_tpu.elastic import reshard_state as jax_reshard_state
    from deepfm_tpu_torch.elastic import reshard_state

    jcfg = JaxConfig.from_dict(_doc(str(tmp_path), elastic={"prefer_model_parallel": 4}))
    devs = jax.devices()
    state = create_spmd_state(_jax_ctx(jcfg, 2, 2, devs[:4]))
    moved = _np(jax_reshard_state(state, _jax_ctx(jcfg, 1, 4, devs[:4])).params)
    full = {"model": {k: torch.from_numpy(np.asarray(v)) for k, v in _np(state.params).items()
                      if k in ("fm_w", "fm_v")},
            "optimizer": {"count": 0, "slots": {}}, "lazy": None}
    rows = moved["fm_w"].shape[0] // 4
    for k in ("fm_w", "fm_v"):
        got = torch.cat([reshard_state(full, ("fm_w", "fm_v"), offset=i * rows,
                                       rows=rows)["model"][k] for i in range(4)])
        np.testing.assert_array_equal(got.numpy(), moved[k])


# -- the registries -----------------------------------------------------------

def test_virtual_registry_epoch_and_membership():
    devs = [RankDevice(i) for i in range(4)]
    reg, ref = VirtualDeviceRegistry(devs), JaxVirtualRegistry(jax.devices()[:4])
    for act, args in [("fail", (2, 3)), ("fail", (2,)), ("restore", (0,)),
                      ("restore", (2, 3))]:
        assert getattr(reg, act)(*args) == getattr(ref, act)(*args)
        assert [d.id for d in reg.devices()] == [d.id for d in ref.devices()]
    assert reg.snapshot()[0] == ref.snapshot()[0] == 2
    with pytest.raises(IndexError):
        reg.fail(99)


class _Stub:
    def __init__(self, devs):
        self.devs = devs

    def __call__(self):
        if self.devs is None:
            raise RuntimeError("slice collapsed")
        return self.devs

    def devices(self):  # JAX's registry reads jax.devices()
        return self()


@pytest.mark.parametrize("debounce", [1, 2])
def test_live_registry_epochs_and_debounce_as_jax(debounce):
    """The same scripted readings (changes, a failing query, flapping,
    transient blips) give the same epochs and device lists in both."""
    base = jax.devices()[:4]
    stub = _Stub(list(base))
    ref = JaxLiveRegistry(debounce_polls=debounce)
    ref._last = tuple(base)
    ref._last_ids = tuple(d.id for d in base)
    ref._jax = stub
    mine = _Stub([RankDevice(d.id) for d in base])
    reg = LiveDeviceRegistry(mine, debounce_polls=debounce)
    script = [base[:2], None, base, base[:2], base[:2], None, None, base, base, base[:3]]
    for reading in script * 2:
        stub.devs = None if reading is None else list(reading)
        mine.devs = None if reading is None else [RankDevice(d.id) for d in reading]
        assert reg.poll() == ref.poll()
        assert [d.id for d in reg.devices()] == [d.id for d in ref.devices()]
    with pytest.raises(ValueError, match="debounce_polls"):
        LiveDeviceRegistry(mine, debounce_polls=0)


def test_wait_for_capacity_times_out(tmp_path):
    doc = _doc(str(tmp_path), elastic={"min_devices": 2, "wait_for_capacity_secs": 0.2,
                                       "poll_interval_secs": 0.02})
    _fill_stream(doc["data"]["training_data_dir"], segments=1)
    reg = VirtualDeviceRegistry([RankDevice(0), RankDevice(1)])
    reg.fail(0, 1)
    with pytest.raises(RuntimeError, match="no capacity"):
        ElasticTrainer(Config.from_dict(doc), device="cpu", registry=reg).run(follow=False)
    stop = threading.Event()
    stop.set()
    with pytest.raises(RuntimeError, match="stopped while waiting"):
        ElasticTrainer(Config.from_dict(doc), device="cpu", registry=reg).run(
            follow=False, stop=stop)
    with pytest.raises(ValueError, match="coordinator_url"):
        ElasticTrainer(Config.from_dict(doc), device="cpu", store=object())
    with pytest.raises(ValueError, match="CTR families"):
        ElasticTrainer(Config.from_dict(doc).with_overrides(model={"model_name": "two_tower"}),
                       device="cpu", registry=reg)


def test_group_backend_and_what_counts_as_a_failed_collective(monkeypatch):
    """gloo on the CPU and where the ranks outnumber the cards, NCCL
    otherwise; a failed collective is torch.distributed's own error or
    gloo's (its message starts at a source location inside gloo), never a
    fault of the step that merely names a peer or a timeout."""
    import torch.distributed as dist

    from deepfm_tpu_torch.elastic.controller import _collective_failure, group_backend

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert group_backend(torch.device("cpu"), 1) == "gloo"
    assert group_backend(torch.device("cuda", 0), 4) == "gloo"
    assert group_backend(torch.device("cuda", 0), 2) == "nccl"
    assert _collective_failure(RuntimeError(
        "[/src/third_party/gloo/gloo/transport/tcp/pair.cc:553] Connection closed by peer"))
    assert _collective_failure(RuntimeError(
        "[../third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:78] Timed out waiting "
        "5000ms for recv operation to complete"))
    assert _collective_failure(dist.DistBackendError("NCCL error: remote process exited"))
    for text in ("peer table timeout", "connection to the gloo store", "CUDA error: nccl"):
        assert not _collective_failure(RuntimeError(text))


def test_a_rank_that_never_arrives_calls_the_epoch_off(tmp_path):
    """A rank whose epoch lists a peer that holds no lease here and never
    comes waits ``ARRIVAL_TTLS`` lease TTLs, calls the epoch off and raises;
    an idle tail's wait polls the registry and stops the reader once the
    epoch moved."""
    from deepfm_tpu_torch.elastic import controller

    doc = _doc(str(tmp_path))
    _fill_stream(doc["data"]["training_data_dir"], segments=1)
    h = Harness([0, 1])
    try:
        cfg = Config.from_dict(_rank_doc(doc, h, lease_ttl_secs=0.4,
                                         heartbeat_interval_secs=0.1))
        trainer = ElasticTrainer(cfg, device="cpu", store=h.store)
        epoch, devices = trainer._wait_for_capacity(None, None)
        assert [d.id for d in devices] == [0, 1]
        with pytest.raises(RuntimeError, match="1 of 2 ranks arrived"):
            trainer._arrive(epoch, 2)
        assert h.store.get(f"elastic/epoch-{epoch}/go") == b"0"
        tail = controller._Tail(None, lambda: trainer._current_epoch() != epoch)
        assert not tail.wait(0.01) and not tail.is_set()
        h.board.remove(1)
        deadline = time.monotonic() + 10
        while not tail.wait(0.05):
            assert time.monotonic() < deadline
        assert tail.is_set()
        trainer.registry.release()
    finally:
        h.close()


def _lone_rank_run(root: str, monkeypatch, interloper_after: int | None = None):
    """One rank (device 0) under a coordinator and a store, on a log of six
    batches.  With ``interloper_after``, a joiner's train lease (device 1)
    lands after that step while the rank's view, the board, still lists
    device 0 alone: the coordinator opens a transition to the same device
    set, and the step waits until the rank's registry sees it."""
    from deepfm_tpu_torch.elastic.coord import CoordClient
    from deepfm_tpu_torch.parallel import spmd

    doc = _doc(root)
    _fill_stream(doc["data"]["training_data_dir"], segments=6)
    h = Harness([0])
    joiner = CoordClient(h.coord_url, "d1-joiner", role="train", owns=(1,))
    try:
        trainer = ElasticTrainer(Config.from_dict(_rank_doc(doc, h)), device="cpu",
                                 store=h.store)
        train_step, tokens = spmd.train_step, []

        def step(state, batch, ctx):
            metrics = train_step(state, batch, ctx)
            if state.step == interloper_after:
                epoch = trainer._current_epoch()
                tokens.append(trainer.registry.fence_token)
                joiner.acquire(view=[0, 1])
                deadline = time.monotonic() + 30
                while trainer._current_epoch() == epoch:
                    assert time.monotonic() < deadline, "the transition never opened"
                    time.sleep(0.02)
            return metrics

        with monkeypatch.context() as m:
            m.setattr(spmd, "train_step", step)
            state = trainer.run(follow=False)
        tokens.append(trainer.registry.fence_token)
        trainer.registry.release()
    finally:
        joiner.release()
        h.close()
    return trainer, state, tokens


def test_a_lease_that_keeps_the_device_set_re_forms_without_a_reshard(tmp_path, monkeypatch):
    """A joiner's lease lands before the running rank's view includes its
    device, so the coordinator flips the epoch to the same device set.  The
    rank drains, forms the new epoch's group at the grid it left and goes on
    with its live state: no reshard is recorded (JAX's trainer never makes
    one to the same grid), the cohort holds a newer fencing token, every
    batch is applied once, and the weights end bit-equal to a run without
    the lease."""
    trainer, state, tokens = _lone_rank_run(str(tmp_path / "lease"), monkeypatch,
                                            interloper_after=3)
    kinds = [e["kind"] for e in trainer.lifecycle]
    assert trainer.reshards == [] and trainer.metrics_snapshot()["reshards_total"] == 0
    assert "reform" in kinds and "replan" not in kinds and "reshard" not in kinds, kinds
    assert tokens[1] > tokens[0]
    lineage = trainer.cursor_lineage
    assert len(lineage) == 6 and all(a < b for a, b in zip(lineage, lineage[1:]))
    _, plain, _ = _lone_rank_run(str(tmp_path / "plain"), monkeypatch)
    assert int(state.step) == int(plain.step) == 6
    want = plain.model.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


# -- the lifecycle on rank processes -------------------------------------------

class _FlipOnStep(JaxMetricLogger):
    def __init__(self, script):
        super().__init__(log_steps=10_000)
        self._script = sorted(script.items())

    def step(self, step, *a, **kw):
        super().step(step, *a, **kw)
        if self._script and step >= self._script[0][0]:
            self._script.pop(0)[1]()


def _jax_run(doc, script=None, **kw):
    jcfg = JaxConfig.from_dict(doc)
    reg = JaxVirtualRegistry(jax.devices()[:4])
    trainer = JaxElasticTrainer(jcfg, registry=reg)
    if script:
        trainer._log = _FlipOnStep({k: (lambda f=f: f(reg)) for k, f in script.items()})
    return trainer, trainer.run(follow=False, **kw)


def _seed_port_commit(doc: dict) -> None:
    """JAX's initial weights at [2, 2] as the port's step-0 commit: both
    runs start from the same weights."""
    jcfg = JaxConfig.from_dict(doc)
    init = _np(create_spmd_state(_jax_ctx(jcfg, 2, 2, jax.devices()[:4])))
    cfg = Config.from_dict(doc)
    state = create_train_state(cfg, "cpu")
    sd = params_from_jax(init.params, init.model_state, cfg.model)
    state.model.load_state_dict(sd)
    commit_payload(Checkpointer(doc["run"]["model_dir"]), state, StreamCursor())


def _jobs(doc, harness, root, ids, scripts=None, joiners=(), **elastic):
    rdoc = _rank_doc(doc, harness, **elastic)
    os.makedirs(root, exist_ok=True)
    release = os.path.join(root, "release")
    return [{"cfg": rdoc, "device_id": i, "store": harness.store_addr,
             "script": (scripts or {}).get(i, {}), "release": release,
             "wait_for": release if i in joiners else None,
             "out": os.path.join(root, f"rank-{i}.pt")} for i in ids]


def _final_params(doc) -> dict:
    _, tree = read_payload_tree(doc["run"]["model_dir"])
    return {k: v.clone() for k, v in tree["model"].items()}


def _assert_params_close(port: dict, jax_state, cfg: Config) -> None:
    want = params_from_jax(_np(jax_state.params), _np(jax_state.model_state), cfg.model)
    assert port.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(port[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _summary(r: dict) -> dict:
    return {k: v for k, v in r.items() if k != "wall_secs"}


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_shrink_grow_mid_run_matches_uninterrupted_oracle(tmp_path, lazy):
    """[2, 2] -> [1, 2] after step 3 (devices 2 and 3 leave the board) and
    back to [2, 2] after step 6 (two new rank processes join), with drain
    commits: JAX's reshards summary, every event applied once along the
    lineage, JAX's final parameters, manifests at the true vocabulary."""
    _shrink_grow(tmp_path, lazy)


# the other CTR families at the widths above: xDeepFM's CIN and DCN-v2's
# cross layers move as replicated parameters, their tables (DCN-v2: fm_v
# alone) and lazy moments as row shards
FAMILY_MODEL = {"xdeepfm": {"model_name": "xdeepfm", "cin_layers": [8, 8]},
                "dcnv2": {"model_name": "dcnv2", "cross_layers": 2}}


@pytest.mark.parametrize("name", sorted(FAMILY_MODEL))
def test_shrink_grow_of_each_family_matches_jax(tmp_path, name):
    """The lazy shrink and grow of xDeepFM and DCN-v2 against JAX's
    ElasticTrainer of the family under the same script: the reshards
    summary (the tables each family has), the lineage, the final
    parameters and the manifests (the family's model_name)."""
    _shrink_grow(tmp_path, True, model=FAMILY_MODEL[name])


def _shrink_grow(tmp_path, lazy, **overrides):
    root = str(tmp_path / "port")
    doc = _doc(root, lazy=lazy, **overrides)
    _fill_stream(doc["data"]["training_data_dir"], segments=10)
    _seed_port_commit(doc)
    h = Harness([0, 1, 2, 3])
    try:
        jobs = _jobs(doc, h, root, [0, 1, 2, 3, 4, 5], joiners=(4, 5),
                     scripts={0: {3: [("drop", [2, 3])], 6: [("grow", [4, 5])]}})
        ranks = start_ranks(jobs)  # JAX's run goes on meanwhile
        jdoc = _doc(str(tmp_path / "jax"), lazy=lazy, **overrides)
        jdoc["data"]["training_data_dir"] = doc["data"]["training_data_dir"]
        jtrainer, jstate = _jax_run(jdoc, {3: lambda reg: reg.fail(2, 3),
                                           6: lambda reg: reg.restore(2, 3)})
        results = wait_ranks(ranks, jobs)
    finally:
        h.close()
    for r in results:
        assert r is not None and r["error"] is None, r and r["error"]
    r0 = results[0]
    assert [r["left"] for r in results] == [False, False, True, True, False, False]
    assert [_summary(r) for r in r0["reshards"]] == [_summary(r) for r in jtrainer.reshards]
    assert [r["to_mesh"] for r in r0["reshards"]] == [[1, 2], [2, 2]]
    assert r0["reshards"][0]["moved_bytes"] == 0 and r0["reshards"][1]["moved_bytes"] > 0
    assert all(r["steps_replayed"] == 0 for r in r0["reshards"])
    lineage = r0["lineage"]
    assert len(lineage) == 10 and all(a < b for a, b in zip(lineage, lineage[1:]))
    assert lineage == [tuple(c) for c in jtrainer.cursor_lineage]
    assert r0["step"] == int(jstate.step) == 10
    for want in ("detect", "drain_commit", "replan", "reshard", "publish", "done"):
        assert want in r0["lifecycle"], r0["lifecycle"]
    assert r0["metrics"]["reshards_total"] == 2
    cfg = Config.from_dict(doc)
    _assert_params_close(_final_params(doc), jstate, cfg)
    pub = doc["run"]["servable_model_dir"]
    assert len(list_versions(pub)) >= 3
    for v in list_versions(pub):
        m = read_manifest(pub, v)
        assert (m.feature_size, m.field_size, m.model_name) == (FEATURE, FIELD,
                                                               cfg.model.model_name)
    assert latest_manifest(pub).step == 10


def test_uncommitted_tail_replays_exactly_once_without_drain(tmp_path):
    """Ranks 2 and 3 are killed after step 3 without notice (the board
    still lists them; no drain commit): the survivors' next collective
    fails, their leases expire and the coordinator opens an epoch without
    their devices; the survivors resume from the step-2 commit at [1, 2]
    and replay step 3 once, equal to JAX's run of the same hard loss."""
    root = str(tmp_path / "port")
    doc = _doc(root, elastic={"drain_commit": False})
    _fill_stream(doc["data"]["training_data_dir"], segments=8)
    _seed_port_commit(doc)
    h = Harness([0, 1, 2, 3], lease_ttl=6.0)
    try:
        jobs = _jobs(doc, h, root, [0, 1, 2, 3], lease_ttl_secs=6.0,
                     scripts={2: {3: [("kill", None)]}, 3: {3: [("kill", None)]}})
        ranks = start_ranks(jobs)  # JAX's run goes on meanwhile
        jdoc = _doc(str(tmp_path / "jax"), elastic={"drain_commit": False})
        jdoc["data"]["training_data_dir"] = doc["data"]["training_data_dir"]
        jtrainer, jstate = _jax_run(jdoc, {3: lambda reg: reg.fail(2, 3)}, max_batches=8)
        results = wait_ranks(ranks, jobs)
    finally:
        h.close()
    assert results[2] is None and results[3] is None
    for r in results[:2]:
        assert r["error"] is None, r["error"]
        assert r["step"] == 8 and len(r["reshards"]) == 1
        assert r["reshards"][0]["steps_replayed"] == 1
        assert "group_failed" in r["lifecycle"] and "drain_commit_failed" in r["lifecycle"]
        lineage = r["lineage"]
        assert len(lineage) == 8 and all(a < b for a, b in zip(lineage, lineage[1:]))
    assert [_summary(r) for r in results[0]["reshards"]] == \
        [_summary(r) for r in jtrainer.reshards]
    _assert_params_close(_final_params(doc), jstate, Config.from_dict(doc))


def test_restart_after_shrink_resumes_on_new_topology(tmp_path):
    """A job stopped outright restarts on fewer ranks: the restore is the
    reshard (no live one), and only the new tail is applied."""
    root = str(tmp_path)
    doc = _doc(root)
    _fill_stream(doc["data"]["training_data_dir"], segments=4)
    h = Harness([0, 1, 2, 3])  # the coordinator outlives the job (its tokens rise)
    try:
        first = spawn_ranks(_jobs(doc, h, root, [0, 1, 2, 3]))
        assert [r["step"] for r in first] == [4] * 4 and first[0]["error"] is None
        _fill_stream(doc["data"]["training_data_dir"], segments=2, start=4)
        h.board.write([0, 1])
        second = spawn_ranks(_jobs(doc, h, str(tmp_path / "again"), [0, 1]))
    finally:
        h.close()
    for r in second:
        assert r["error"] is None, r["error"]
        assert r["step"] == 6 and r["reshards"] == [] and len(r["lineage"]) == 2
        assert "resume" in r["lifecycle"]


def test_the_cli_runs_a_one_process_elastic_job(tmp_path, capsys, monkeypatch):
    """``--task_type online-train`` with ``elastic.enabled`` and no launcher
    environment: a world of one process at [1, 1] (no coordinator, its
    own device as the view), publishing at the true vocabulary; the same
    command again resumes and applies nothing."""
    import json

    from deepfm_tpu_torch.launch.cli import run

    root = str(tmp_path)
    _fill_stream(os.path.join(root, "stream"), segments=5)
    argv = ["--task_type", "online-train", "--device", "cpu", "--training_data_dir",
            os.path.join(root, "stream"), "--model_dir", os.path.join(root, "ckpt"),
            "--servable_model_dir", os.path.join(root, "publish"), "--feature_size",
            str(FEATURE), "--field_size", str(FIELD), "--embedding_size", "4",
            "--deep_layers", "8", "--batch_size", "8", "--set", "elastic.enabled=true",
            "--set", "run.online_idle_timeout_secs=0.5",
            "--set", "run.online_publish_every_steps=2"]
    for env in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"):
        monkeypatch.delenv(env, raising=False)
    assert run(argv).step == 5
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    done = [r for r in lines if r["kind"] == "elastic_done"]
    assert done == [{"kind": "elastic_done", "step": 5, "applied": 5, "reshards": 0,
                     "mesh": [1, 1], "forward_launches": 0, "backward_launches": 0}]
    assert latest_manifest(os.path.join(root, "publish")).feature_size == FEATURE
    assert run(argv).step == 5
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["step"] for r in lines if r["kind"] == "elastic_resume"] == [5]
    assert [r["applied"] for r in lines if r["kind"] == "elastic_done"] == [0]
