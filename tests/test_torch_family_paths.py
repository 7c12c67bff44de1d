"""xDeepFM and DCN-v2 through the CTR paths that ran DeepFM alone, each
held to the JAX package's same function on the CPU, from JAX's init
parameters carried by ``deepfm_tpu_torch/convert.py``; and the tiered
store's cold tier on an object store.

Small widths: V = 200, F = 6, K = 4, MLP 16/8 in float32, dropout off,
``cin_layers`` (8, 8), ``cross_layers`` 2, batches of 16 made from a
seed with numpy.

* the tiered paged step (``TieredTrainer``) against JAX's: per-step
  losses (rtol 1e-5), JAX's eviction count, the exported tables and
  moments and the rest of the model (atol 1e-5); against the port's
  resident lazy step bit for bit; the tiered scorer of each package's
  publish (atol 1e-6), behind the port's server too;
* the cold tier on a URL of the dev object store: a run equals the run
  on a local directory bit for bit, the port's page objects are JAX's
  names and bytes for the same writes, and JAX's tier reads them back;
* the shard-group member at ``[1, 2]`` and ``[2, 2]`` with both
  exchanges: bit for bit the single-process graphed predict at psum,
  JAX's ``load_sharded_servable`` within 1e-6; a fleet member whose
  tenants are all of one family;
* the funnel with a variant ranker: JAX's export converted, the port's
  scorer against JAX's (ids equal, probabilities 1e-6);
* the online trainer: a JAX commit resumed in the port, its manifests'
  versions, steps, cursors and watermarks JAX's exactly, its params and
  Adam moments within 1e-5;
* the elastic trainer (in ``tests/test_torch_elastic.py``);
* the paths that refuse two-tower, in JAX's words.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.online import ModelPublisher as JaxPublisher
from deepfm_tpu.tiered import TieredScorer as JaxTieredScorer
from deepfm_tpu.tiered import TieredTrainer as JaxTieredTrainer
from deepfm_tpu.tiered.store import ColdTier as JaxColdTier
from deepfm_tpu.tiered.store import RecordLayout as JaxRecordLayout
from deepfm_tpu.train.step import create_train_state as jax_create_train_state
from deepfm_tpu.utils import dev_object_store as jax_dev
from deepfm_tpu.utils.retry import RetryPolicy as JaxRetry
from deepfm_tpu_torch.convert import params_from_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.online.publisher import ModelPublisher
from deepfm_tpu_torch.tiered import TieredScorer, TieredTrainer
from deepfm_tpu_torch.tiered.store import ColdTier, RecordLayout
from deepfm_tpu_torch.train.step import create_train_state, train_step
from deepfm_tpu_torch.utils import dev_object_store as port_dev
from deepfm_tpu_torch.utils.retry import RetryPolicy

V, F, K, B = 200, 6, 4, 16
FAMILIES = ("xdeepfm", "dcnv2")
MODEL = dict(feature_size=V, field_size=F, embedding_size=K, deep_layers=(16, 8),
             dropout_keep=(1.0, 1.0), cin_layers=(8, 8), cross_layers=2,
             compute_dtype="float32")
SIZES = dict(capacity=B * F, stage_rows=B * F, host_rows=2 * V)
TABLES = {"xdeepfm": ("fm_w", "fm_v"), "dcnv2": ("fm_v",)}
FAST = dict(max_attempts=3, base_delay_secs=0.01, max_delay_secs=0.05)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batches(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"feat_ids": rng.integers(0, V, (B, F)).astype(np.int64),
             "feat_vals": rng.random((B, F), dtype=np.float32),
             "label": (rng.random(B) < 0.3).astype(np.float32)} for _ in range(n)]


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- the tiered store ------------------------------------------------------------

def _tiered_doc(name: str) -> dict:
    return {"model": dict(MODEL, model_name=name, fused_kernel="off",
                          tiered_embeddings=True, tiered_page_rows=32),
            "optimizer": {"lazy_embedding_updates": True, "learning_rate": 5e-3},
            "data": {"batch_size": B}}


def _tiered_pair(name: str):
    """JAX's initial lazy state and the port's on the same weights."""
    jcfg = JaxConfig.from_dict(_tiered_doc(name))
    cfg = Config.from_dict(jcfg.to_dict())
    jstate = jax_create_train_state(jcfg)
    params, mstate = _np(jstate.params), _np(jstate.model_state)
    state = create_train_state(cfg, "cpu")
    state.model.load_state_dict(params_from_jax(params, mstate, cfg.model))
    return jcfg, jstate, cfg, state, params, mstate


@pytest.mark.parametrize("name", FAMILIES)
def test_tiered_step_matches_jax(tmp_path, name):
    """The paged step of each family against JAX's TieredTrainer from the
    same weights, a cache of one batch (evictions every step): losses,
    evictions, the paged tables and moments, the resident rest."""
    jcfg, jstate, cfg, state, params, mstate = _tiered_pair(name)
    with JaxTieredTrainer.from_resident_state(jcfg, jstate, str(tmp_path / "jcold"),
                                              **SIZES) as jtr, \
            TieredTrainer.from_resident_state(cfg, state, str(tmp_path / "cold"),
                                              **SIZES) as tr:
        assert tr.cold.layout.keys == TABLES[name] == tuple(jtr.cold.layout.keys)
        for b in _batches(6, seed=4):
            want = float(jtr.train_batch(b)["loss"])
            got = float(tr.train_batch(b)["loss"])
            np.testing.assert_allclose(got, want, rtol=1e-5)
        assert tr.pager.stats()["evictions"] == jtr.pager.stats()["evictions"] > 0
        for g, w, part in zip(tr.export_tables(), jtr.export_tables(), ("rows", "m", "v")):
            assert g.keys() == w.keys() == set(TABLES[name])
            for k in g:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5,
                                           err_msg=f"{part} {k}")
        rest = params_from_jax({**params, **_np(jtr.state.rest)}, mstate, cfg.model)
        for n, p in tr.state.model.named_parameters():
            if n not in TABLES[name]:
                np.testing.assert_allclose(p.detach().numpy(), rest[n].numpy(), rtol=0,
                                           atol=1e-5, err_msg=n)


@pytest.mark.parametrize("name", FAMILIES)
def test_paged_step_equals_the_resident_lazy_step(tmp_path, name):
    """The family's paged step is its resident lazy step bit for bit:
    losses, the tables and moments, the CIN or cross weights."""
    cfg = Config.from_dict(_tiered_doc(name))
    resident = create_train_state(cfg, "cpu")
    with TieredTrainer.from_resident_state(cfg, create_train_state(cfg, "cpu"),
                                           str(tmp_path / "cold"), **SIZES) as tr:
        for b in _batches(5, seed=2):
            assert float(tr.train_batch(b)["loss"]) == \
                float(train_step(resident, _tensors(b))["loss"])
        rows, m, v = tr.export_tables()
        for k in TABLES[name]:
            assert np.array_equal(rows[k], getattr(resident.model, k).detach().numpy())
            assert np.array_equal(m[k], resident.lazy.m[k].numpy())
            assert np.array_equal(v[k], resident.lazy.v[k].numpy())
        want = dict(resident.model.named_parameters())
        for n, p in tr.state.model.named_parameters():
            if n not in TABLES[name]:
                assert torch.equal(p, want[n]), n


@pytest.mark.parametrize("name", FAMILIES)
def test_tiered_scorer_matches_jax(tmp_path, name):
    """Each package publishes its trainer after 4 steps (publish_tiered);
    the port's TieredScorer of its publish answers as JAX's TieredScorer of
    JAX's, over HTTP too, through a cache smaller than the vocabulary."""
    from deepfm_tpu_torch.serve.server import ScoringHTTPServer, make_handler

    jcfg, jstate, cfg, state, _, _ = _tiered_pair(name)
    with JaxTieredTrainer.from_resident_state(jcfg, jstate, str(tmp_path / "jcold"),
                                              **SIZES) as jtr, \
            TieredTrainer.from_resident_state(cfg, state, str(tmp_path / "cold"),
                                              **SIZES) as tr:
        for b in _batches(4, seed=5):
            jtr.train_batch(b)
            tr.train_batch(b)
        JaxPublisher(str(tmp_path / "jpub")).publish_tiered(jcfg, jtr)
        ModelPublisher(str(tmp_path / "pub")).publish_tiered(cfg, tr)
    jscorer = JaxTieredScorer.from_publish(str(tmp_path / "jpub"), str(tmp_path / "jst"),
                                           capacity=B * F, host_rows=2 * V)
    scorer = TieredScorer.from_publish(str(tmp_path / "pub"), str(tmp_path / "st"),
                                       capacity=B * F, host_rows=2 * V, device="cpu")
    assert scorer.cold.layout.keys == TABLES[name]
    probe = _batches(3, seed=9)
    for b in probe:
        np.testing.assert_allclose(scorer.score(b["feat_ids"], b["feat_vals"]),
                                   jscorer.score(b["feat_ids"], b["feat_vals"]),
                                   rtol=0, atol=1e-6)
    assert scorer.paging_snapshot()["evictions"] > 0
    server = ScoringHTTPServer(("127.0.0.1", 0), make_handler(scorer, name))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        b = probe[0]
        body = json.dumps({"instances": [{"feat_ids": i.tolist(), "feat_vals": v.tolist()}
                                         for i, v in zip(b["feat_ids"], b["feat_vals"])]})
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/models/{name}:predict",
            data=body.encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.load(r)["predictions"], np.float32)
        np.testing.assert_allclose(got, jscorer.score(b["feat_ids"], b["feat_vals"]),
                                   rtol=0, atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()


# -- the cold tier on an object store (ROADMAP A11) --------------------------------

@pytest.fixture()
def store(tmp_path):
    """One bucket served by the port's dev object store."""
    server, base = port_dev.serve(str(tmp_path / "store"))
    try:
        yield base
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("name", ("deepfm", *FAMILIES))
def test_a_url_cold_tier_runs_as_a_local_directory(tmp_path, store, name):
    """The same paged run on a directory and on a URL prefix: the same
    losses, tables and moments bit for bit, a checkpoint and a cache-cold
    restore on the URL root, and overlay objects under the prefix."""
    cfg = Config.from_dict(_tiered_doc(name))
    url = f"{store}/bucket/run/cold"
    batches = _batches(8, seed=3)
    with TieredTrainer.from_resident_state(cfg, create_train_state(cfg, "cpu"),
                                           str(tmp_path / "cold"), **SIZES) as local:
        want = [float(local.train_batch(b)["loss"]) for b in batches]
        want_tables = local.export_tables()
    with TieredTrainer.from_resident_state(cfg, create_train_state(cfg, "cpu"), url,
                                           retry=RetryPolicy(**FAST), **SIZES) as tr:
        got = [float(tr.train_batch(b)["loss"]) for b in batches[:4]]
        tr.save(str(tmp_path / "ckpt"))
    with TieredTrainer.restore(cfg, str(tmp_path / "ckpt"), device="cpu", **SIZES) as tr:
        assert tr.cold.root == url and tr.cold.stats()["cold_reads"] == 0
        got += [float(tr.train_batch(b)["loss"]) for b in batches[4:]]
        assert tr.cold.stats()["cold_reads"] > 0
        got_tables = tr.export_tables()
    assert got == want
    for g, w in zip(got_tables, want_tables):
        for k in TABLES.get(name, ("fm_w", "fm_v")):
            assert np.array_equal(g[k], w[k]), k
    from deepfm_tpu_torch.data.object_store import HttpObjectStore

    pages = HttpObjectStore().list_prefix(f"{url}/pages/")
    assert pages and all(p.endswith(".bin") for p in pages)


def _layout_widths():
    return {"fm_w": 1, "fm_v": 4}


def _write_pages(cold, rows):
    rng = np.random.default_rng(1)
    mk = lambda w: {"fm_w": rng.random(rows).astype(np.float32) + w,  # noqa: E731
                    "fm_v": rng.random((rows, 4)).astype(np.float32) + w}
    cold.import_dense(mk(0), mk(1), mk(2))
    for page in (1, 3, 1):
        recs = cold.read_page(page)
        recs[page] += 5.0
        cold.write_page(page, recs)


def test_the_ports_page_objects_are_jaxs(tmp_path, store):
    """The same import and overlay writes through the port's ColdTier and
    JAX's on one bucket, under two prefixes: the same object names and
    bytes; JAX's tier pinned to the port's snapshot reads every page back
    as the port does; the overlay gc deletes the same objects."""
    from deepfm_tpu_torch.data.object_store import HttpObjectStore

    port = ColdTier(f"{store}/bucket/port", rows=100, layout=RecordLayout(_layout_widths()),
                    page_rows=16, pages_per_segment=2, retry=RetryPolicy(**FAST))
    jcold = JaxColdTier(f"{store}/bucket/jax", rows=100,
                        layout=JaxRecordLayout(_layout_widths()), page_rows=16,
                        pages_per_segment=2, retry=JaxRetry(**FAST))
    _write_pages(port, 100)
    _write_pages(jcold, 100)
    s3 = HttpObjectStore()

    def objects(prefix):
        base = f"{store}/bucket/{prefix}/"
        return {u[len(base):]: s3.get(u) for u in s3.list_prefix(base)}

    got, want = objects("port"), objects("jax")
    assert sorted(got) == sorted(want) and any(k.startswith("pages/") for k in got)
    for k in want:
        assert got[k] == want[k], k
    reader = JaxColdTier(f"{store}/bucket/port", rows=100,
                         layout=JaxRecordLayout(_layout_widths()), page_rows=16,
                         pages_per_segment=2,
                         page_versions={int(p): v for p, v in
                                        port.snapshot()["page_versions"].items()})
    for page in range(port.num_pages):
        np.testing.assert_array_equal(reader.read_page(page), port.read_page(page))
    assert port.gc_overlays() == jcold.gc_overlays() == 1
    assert sorted(objects("port")) == sorted(objects("jax"))


def test_the_port_reads_pages_jax_wrote_on_a_store(tmp_path):
    """JAX's dev store holds JAX's segments and overlays; the port's tier on
    that URL reads them as JAX does."""
    server, base = jax_dev.serve(str(tmp_path / "store"))
    try:
        jcold = JaxColdTier(f"{base}/bucket/t", rows=100,
                            layout=JaxRecordLayout(_layout_widths()), page_rows=16)
        _write_pages(jcold, 100)
        port = ColdTier(f"{base}/bucket/t", rows=100, layout=RecordLayout(_layout_widths()),
                        page_rows=16, page_versions={int(p): v for p, v in
                                                     jcold.snapshot()["page_versions"].items()})
        for page in range(port.num_pages):
            np.testing.assert_array_equal(port.read_page(page), jcold.read_page(page))
        assert port.stats()["cold_reads"] == port.num_pages
    finally:
        server.shutdown()
        server.server_close()


# -- the shard-group member ----------------------------------------------------------

SPLITS = [(1, 2, "psum"), (1, 2, "alltoall"), (2, 2, "psum"), (2, 2, "alltoall")]
BUCKETS = (4, 8)


def _jax_servable(name: str, d, delta: float = 0.0):
    """A JAX servable of the family's init (moved by ``delta``) at ``d``,
    and the port's state dict of it."""
    import orbax.checkpoint as ocp

    from deepfm_tpu.serve import export_servable as jax_export_servable
    from deepfm_tpu.train.step import TrainState
    from deepfm_tpu_torch.core.config import load_config

    jcfg = JaxConfig.from_dict({"model": dict(MODEL, model_name=name)})
    state = jax_create_train_state(jcfg)
    if delta:
        state = TrainState(step=state.step + 1, params=jax.tree_util.tree_map(
            lambda x: x + delta if x.dtype == np.float32 else x, state.params),
            model_state=state.model_state, opt_state=state.opt_state, rng=state.rng)
    jax_export_servable(jcfg, state, d)
    ckptr = ocp.StandardCheckpointer()
    payload = ckptr.restore(str(d / "params"))
    ckptr.close()
    return jcfg, state, params_from_jax(payload["params"], payload["model_state"],
                                        load_config(d))


@pytest.fixture(scope="module", params=FAMILIES)
def member_env(request, tmp_path_factory):
    from deepfm_tpu_torch.core.config import load_config
    from deepfm_tpu_torch.serve.export import export_servable

    name = request.param
    root = tmp_path_factory.mktemp(f"member_{name}")
    jcfg, state, sd = _jax_servable(name, root / "jax")
    cfg = load_config(root / "jax")
    return {"name": name, "jdir": str(root / "jax"), "cfg": cfg, "sd": sd, "root": root,
            "jcfg": jcfg, "state": state,
            "servable": export_servable(cfg, sd, root / "servable")}


def _features(n, seed=0, high=V):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, high, (n, F)).astype(np.int64),
            rng.random((n, F)).astype(np.float32))


@pytest.mark.parametrize("dp,mp,exchange", SPLITS, ids=[f"{d}x{m}-{e}" for d, m, e in SPLITS])
def test_member_equals_the_single_process_predict(member_env, dp, mp, exchange):
    """Every bucket, ids past the vocabulary, and a batch crowding one
    shard past the all-to-all's capacity (the psum fallback): bit for bit
    the family's single-process graphed predict; the slot holds the
    family's tables as row shards and no table of another family."""
    from deepfm_tpu_torch.serve.graphs import GraphedPredictor
    from deepfm_tpu_torch.serve.pool.sharded import load_sharded_servable

    env = member_env
    single = GraphedPredictor(env["cfg"], env["sd"], device="cpu", buckets=BUCKETS)
    _, pred, _, ctx = load_sharded_servable(env["servable"], dp, mp, device="cpu",
                                            exchange=exchange, buckets=BUCKETS)
    assert ctx.exchange == exchange and ctx.cfg.feature_size % mp == 0
    want_leaves = {f"{k}.{j}" for k in TABLES[env["name"]] for j in range(mp)}
    leaves = set(pred._models[0].leaves())
    assert want_leaves <= leaves and not {f"fm_w.{j}" for j in range(mp)} - want_leaves & leaves
    for b in BUCKETS:
        ids, vals = _features(b, seed=b, high=V + 9)
        assert np.array_equal(pred.predict_with(0, ids, vals), single.predict_with(0, ids, vals))
    skewed = (np.arange(8 * F) % ctx.rows_local).reshape(8, F).astype(np.int64)
    ones = np.ones((8, F), np.float32)
    assert np.array_equal(pred.predict_with(0, skewed, ones), single.predict_with(0, skewed, ones))


@pytest.mark.parametrize("dp,mp,exchange", SPLITS, ids=[f"{d}x{m}-{e}" for d, m, e in SPLITS])
def test_member_matches_jax(member_env, dp, mp, exchange):
    """The port's member against JAX's ``load_sharded_servable`` of the
    same family on the CPU mesh: probabilities within 1e-6."""
    from deepfm_tpu.serve.pool.sharded import build_serve_mesh
    from deepfm_tpu.serve.pool.sharded import load_sharded_servable as jax_load_sharded
    from deepfm_tpu_torch.serve.pool.sharded import load_sharded_servable

    env = member_env
    jpredict, _, _, jctx = jax_load_sharded(env["jdir"], build_serve_mesh(dp, mp),
                                            exchange=exchange)
    _, pred, _, ctx = load_sharded_servable(env["servable"], dp, mp, device="cpu",
                                            exchange=exchange, buckets=BUCKETS)
    assert jctx.cfg.model.feature_size == ctx.cfg.feature_size
    ids, vals = _features(8, seed=3)
    want = np.asarray(jpredict(ids.astype(np.int32), vals))
    np.testing.assert_allclose(pred.predict_with(0, ids, vals), want, rtol=0, atol=1e-6)


def _post(url, payload, headers=None, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def test_a_fleet_member_of_one_family_serves_as_jaxs(member_env):
    """Tenants A and B, both of the family (a fleet's tenants are of one
    spec), each on its own published version in one ``[1, 2]`` member:
    every tenant's answers within 1e-6 of JAX's member with the same
    tenants and versions."""
    from deepfm_tpu.online.publisher import ModelPublisher as JaxModelPublisher
    from deepfm_tpu.serve.pool.sharded import build_serve_mesh
    from deepfm_tpu.serve.pool.worker import start_member as jax_start_member
    from deepfm_tpu_torch.serve.pool.worker import start_member

    env, root = member_env, member_env["root"]
    roots, jroots = {}, {}
    for t, delta in (("A", 0.05), ("B", -0.05)):
        jcfg, state, sd = _jax_servable(env["name"], root / f"jax_{t}", delta)
        roots[t] = str(root / f"publish_{t}")
        ModelPublisher(roots[t]).publish(env["cfg"], sd, step=1)
        jroots[t] = str(root / f"jax_publish_{t}")
        JaxModelPublisher(jroots[t]).publish(jcfg, state)
    tenants = lambda r: [{"name": t, "source": r[t], "split_percent": 50}  # noqa: E731
                         for t in ("A", "B")]
    h, u, m = start_member(env["servable"], tenants=tenants(roots), group="g0",
                           buckets=BUCKETS, max_wait_ms=1.0, device="cpu",
                           model_parallel=2, staging_dir=str(root / "stage"))
    jh, ju, jm = jax_start_member(env["jdir"], build_serve_mesh(1, 2), group="g0",
                                  buckets=BUCKETS, max_wait_ms=1.0, tenants=tenants(jroots))
    try:
        rng = np.random.default_rng(11)
        inst = [{"feat_ids": rng.integers(0, V, F).tolist(),
                 "feat_vals": rng.random(F).round(4).tolist()} for _ in range(6)]
        answers = {}
        for url in (u, ju):
            for t in ("A", "B"):
                _post(f"{url}/admin:stage", {"version": 1, "tenant": t})
                _post(f"{url}/admin:commit", {"generation": 1, "version": 1, "tenant": t})
                doc = _post(f"{url}/v1/models/deepfm:predict", {"instances": inst},
                            headers={"X-Tenant": t})
                assert (doc["tenant"], doc["model_version"]) == (t, 1)
                answers[url, t] = np.asarray(doc["predictions"], np.float32)
        for t in ("A", "B"):
            np.testing.assert_allclose(answers[u, t], answers[ju, t], rtol=0, atol=1e-6)
        assert np.abs(answers[u, "A"] - answers[u, "B"]).max() > 1e-3
    finally:
        for server, member in ((h, m), (jh, jm)):
            server.shutdown()
            member.close()


# -- the funnel's ranker and publisher -------------------------------------------------

ITEM_VOCAB, USER_VOCAB, FU, FI, N_ITEMS, CAPACITY = 40, 50, 2, 2, 34, 48
TOP_K, RETURN_N = 6, 4


def _query_dict():
    return {"model_name": "two_tower", "user_vocab_size": USER_VOCAB,
            "item_vocab_size": ITEM_VOCAB, "user_field_size": FU, "item_field_size": FI,
            "tower_layers": (16,), "tower_dim": 8, "embedding_size": 4,
            "compute_dtype": "float32"}


@pytest.mark.parametrize("name", FAMILIES)
def test_funnel_with_a_variant_ranker_matches_jax(tmp_path, name):
    """A funnel whose ranker is xDeepFM or DCN-v2: JAX's int8 export
    converted by ``convert.funnel_from_jax``, the port's FunnelScorer
    against JAX's (the returned ids equal, rank probabilities within 1e-6,
    retrieval scores within the funnel tests' 1e-5); both publishers'
    versions of the same funnel carry the family and the same hashes, and
    the port's published tree loads back as the family."""
    from deepfm_tpu.funnel import FunnelPublisher as JaxFunnelPublisher
    from deepfm_tpu.funnel import build_index as jax_build_index
    from deepfm_tpu.funnel import export_funnel_servable as jax_export
    from deepfm_tpu.funnel import load_funnel_artifact as jax_load_artifact
    from deepfm_tpu.funnel.publish import as_state
    from deepfm_tpu.funnel.serve import FunnelScorer as JaxFunnelScorer
    from deepfm_tpu.models.two_tower import init_two_tower
    from deepfm_tpu.serve.pool.sharded import build_serve_mesh
    from deepfm_tpu_torch.convert import funnel_from_jax, two_tower_params_from_jax
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.funnel import FunnelIndex, FunnelPublisher, load_funnel_artifact
    from deepfm_tpu_torch.funnel.serve import FunnelScorer
    from deepfm_tpu_torch.online.publisher import latest_manifest, version_location

    rng = np.random.default_rng(7)
    jrank_cfg = JaxConfig.from_dict({"model": dict(MODEL, model_name=name)})
    jquery_cfg = JaxConfig.from_dict({"model": _query_dict()})
    rank_state = jax_create_train_state(jrank_cfg)
    qparams = _np(init_two_tower(jax.random.PRNGKey(3), jquery_cfg.model)[0])
    corpus = rng.permutation(ITEM_VOCAB)[:N_ITEMS].astype(np.int64)
    item_fi = rng.integers(0, ITEM_VOCAB, (N_ITEMS, FI))
    jindex = jax_build_index(jquery_cfg, qparams, corpus, item_fi,
                             np.ones((N_ITEMS, FI), np.float32), chunk=16)
    jdir = str(tmp_path / "jax")
    jax_export(jdir, jrank_cfg, rank_state, jquery_cfg, as_state(qparams), jindex,
               top_k=TOP_K, return_n=RETURN_N, capacity=CAPACITY, retrieval="int8",
               oversample=2, min_recall=0.5)
    art = jax_load_artifact(jdir)
    art = art._replace(**{k: _np(getattr(art, k))
                          for k in ("rank_params", "rank_state", "query_params")})
    pdir = funnel_from_jax(art, str(tmp_path / "port"))
    jscorer = JaxFunnelScorer(jdir, build_serve_mesh(1, 1), buckets=(4, 8), max_wait_ms=0.0)
    scorer = FunnelScorer(pdir, device="cpu", buckets=(4, 8), max_wait_ms=0.0)
    try:
        assert scorer.ctx.rank_cfg.model_name == name
        for b, n in ((1, None), (3, 2), (8, RETURN_N), (11, 1)):
            uids = rng.integers(0, USER_VOCAB, (b, FU))
            rids = rng.integers(0, V, (b, F))
            rvals = rng.random((b, F)).astype(np.float32).round(3)
            inst = [{"user_ids": uids[i].tolist(), "user_vals": [1.0] * FU,
                     "feat_ids": rids[i].tolist(), "feat_vals": rvals[i].tolist()}
                    for i in range(b)]
            want = jscorer.recommend_instances(inst, n=n)
            got = scorer.recommend_instances(inst, n=n)
            assert got["items"] == want["items"]
            np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-6)
            np.testing.assert_allclose(got["retrieval_scores"], want["retrieval_scores"],
                                       rtol=0, atol=1e-5)
    finally:
        jscorer.close()
        scorer.close()
    rank_cfg = ModelConfig(**dict(MODEL, model_name=name))
    query_cfg = ModelConfig(**_query_dict())
    index = FunnelIndex(item_ids=np.asarray(jindex.item_ids),
                        item_emb=np.asarray(jindex.item_emb))
    kw = dict(top_k=TOP_K, capacity=CAPACITY, retrieval="exact")
    jman = JaxFunnelPublisher(str(tmp_path / "jpub")).publish_funnel(
        jrank_cfg, rank_state, jquery_cfg, as_state(qparams), jindex, **kw)
    rank_sd = load_funnel_artifact(pdir).rank_state
    man = FunnelPublisher(str(tmp_path / "pub")).publish_funnel(
        rank_cfg, rank_sd, query_cfg, two_tower_params_from_jax(qparams, query_cfg), index,
        **kw)
    assert man.model_name == jman.model_name == name
    assert man.param_hash == jman.param_hash
    assert man.index["sha256"] == jman.index["sha256"]
    back = load_funnel_artifact(version_location(str(tmp_path / "pub"),
                                                 latest_manifest(str(tmp_path / "pub")).version))
    assert back.rank_cfg.model_name == name and set(back.rank_state) == set(rank_sd)


# -- the online trainer -------------------------------------------------------------------

def _fill_events(root, segments, rows=8):
    from deepfm_tpu_torch.online import append_segment

    for seq in range(segments):
        rng = np.random.default_rng(seq)
        append_segment(root, (rng.random(rows) < 0.3).astype(np.float32),
                       rng.integers(0, V, (rows, F)).astype(np.int64),
                       rng.random((rows, F)).astype(np.float32), seq=seq)


def _online_doc(tmp_path, name, run_name, stream):
    return {"model": dict(MODEL, model_name=name, fused_kernel="off"),
            "optimizer": {"learning_rate": 5e-4},
            "data": {"training_data_dir": stream, "batch_size": 8},
            "run": {"model_dir": str(tmp_path / run_name / "ckpt"),
                    "servable_model_dir": str(tmp_path / run_name / "publish"),
                    "checkpoint_every_steps": 2, "online_publish_every_steps": 2,
                    "keep_checkpoints": 10, "log_steps": 10_000}}


@pytest.mark.parametrize("name", FAMILIES)
def test_online_trainer_resumes_a_jax_commit_and_matches_jax(tmp_path, name):
    """JAX's online trainer commits after 4 batches of the family; the
    payload goes through ``online_payload_from_jax`` into a port commit,
    and the port's trainer resumes it to the end of the log, publishing
    into the same root.  Every manifest's version, step, cursor and
    watermark equal JAX's uninterrupted run's, its model_name is the
    family, and the params and Adam moments match JAX's within 1e-5."""
    from deepfm_tpu.checkpoint import make_checkpointer as jax_make_checkpointer
    from deepfm_tpu.online import OnlineTrainer as JaxOnlineTrainer
    from deepfm_tpu.online import StreamCursor as JaxCursor
    from deepfm_tpu.online.trainer import OnlinePayload as JaxPayload
    from deepfm_tpu.online.trainer import restore_latest_payload as jax_restore_latest
    from deepfm_tpu_torch.checkpoint import make_checkpointer
    from deepfm_tpu_torch.convert import online_payload_from_jax, train_state_from_jax
    from deepfm_tpu_torch.online import (OnlineTrainer, StreamCursor, list_versions,
                                         read_manifest, segment_name)
    from deepfm_tpu_torch.online.trainer import commit_payload

    stream = str(tmp_path / "stream")
    _fill_events(stream, 8)
    whole = JaxOnlineTrainer(JaxConfig.from_dict(
        _online_doc(tmp_path, name, "whole", stream))).run(follow=False)
    jcfg = JaxConfig.from_dict(_online_doc(tmp_path, name, "split", stream))
    JaxOnlineTrainer(jcfg).run(follow=False, max_batches=4)
    ck = jax_make_checkpointer(jcfg.run.model_dir)
    payload = jax_restore_latest(ck, JaxPayload.wrap(jax_create_train_state(jcfg),
                                                     JaxCursor()))
    ck.close()
    doc = _online_doc(tmp_path, name, "split", stream)
    doc["run"]["model_dir"] = str(tmp_path / "port")
    cfg = Config.from_dict(doc)
    ported = online_payload_from_jax(_np(payload), cfg, device="cpu")
    assert ported.cursor() == StreamCursor(segment_name(3), 8) and ported.step == 4
    commit_payload(make_checkpointer(cfg.run.model_dir), ported.train, ported.cursor())
    got = OnlineTrainer(cfg, device="cpu").run(follow=False)
    assert got.step == int(whole.step) == 8
    want = train_state_from_jax(_np(whole), cfg, device="cpu")
    for (gn, g), (wn, w) in zip(sorted(got.model.state_dict().items()),
                                sorted(want.model.state_dict().items())):
        assert gn == wn
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=gn)
    for n, slots in want.optimizer.slots.items():
        for s, t in slots.items():
            np.testing.assert_allclose(got.optimizer.slots[n][s].numpy(), t.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{n}.{s}")
    assert got.optimizer.count == want.optimizer.count == 8
    split, ref = cfg.run.servable_model_dir, str(tmp_path / "whole" / "publish")
    assert list_versions(split) == list_versions(ref) == [1, 2, 3, 4]
    for v in (1, 2, 3, 4):
        a, b = read_manifest(split, v), read_manifest(ref, v)
        assert (a.version, a.step, a.cursor, a.watermark, a.model_name) == \
            (b.version, b.step, b.cursor, b.watermark, name)


# -- the elastic publish task's cut --------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_the_publish_task_cuts_every_table_the_family_has(name):
    """``elastic/mpmd.py servable_from_payload`` cuts a grid commit's padded
    tables to the true vocabulary: DCN-v2's fm_v alone, xDeepFM's both."""
    from deepfm_tpu_torch.elastic.mpmd import servable_from_payload
    from deepfm_tpu_torch.online.trainer import cursor_to_arrays
    from deepfm_tpu_torch.online import StreamCursor

    cfg = Config.from_dict({"model": dict(MODEL, model_name=name)})
    model = {k: torch.ones((V + 56,) if k == "fm_w" else (V + 56, K)) for k in TABLES[name]}
    model["fm_b"] = torch.zeros(1)
    seg, n, rec = cursor_to_arrays(StreamCursor("seg-3", 5))
    tree = {"model": model, "online": {"cursor_segment": torch.from_numpy(np.asarray(seg)),
                                       "cursor_len": torch.from_numpy(np.asarray(n)),
                                       "cursor_record": torch.from_numpy(np.asarray(rec))}}
    sd, cursor = servable_from_payload(cfg, tree)
    assert set(sd) == {"fm_b", *TABLES[name]}
    assert all(sd[k].shape[0] == V for k in TABLES[name])
    assert cursor == {"segment": "seg-3", "record": 5}


# -- two-tower, refused where JAX refuses it, in JAX's words --------------------------------

def _two_tower_doc(tmp_path) -> dict:
    return {"model": {"model_name": "two_tower", "user_vocab_size": USER_VOCAB,
                      "item_vocab_size": ITEM_VOCAB},
            "data": {"training_data_dir": str(tmp_path / "stream")},
            "run": {"model_dir": str(tmp_path / "ckpt"),
                    "servable_model_dir": str(tmp_path / "publish")}}


def _servable_dir(tmp_path, doc) -> str:
    d = tmp_path / "servable"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(JaxConfig.from_dict(doc).to_dict()))
    return str(d)


def _funnel_dir(tmp_path, doc) -> str:
    d = tmp_path / "funnel"
    (d / "rank").mkdir(parents=True)
    (d / "funnel.json").write_text("{}")
    (d / "rank" / "config.json").write_text(json.dumps(JaxConfig.from_dict(doc).to_dict()))
    return str(d)


def _refusals(tmp_path):
    """Each path's (JAX call, port call) on a two-tower model."""
    from deepfm_tpu.elastic import ElasticTrainer as JaxElasticTrainer
    from deepfm_tpu.funnel import load_funnel_artifact as jax_load_artifact
    from deepfm_tpu.online import OnlineTrainer as JaxOnlineTrainer
    from deepfm_tpu.serve.pool.sharded import build_serve_mesh
    from deepfm_tpu.serve.pool.sharded import load_sharded_servable as jax_load_sharded
    from deepfm_tpu_torch.elastic.controller import ElasticTrainer
    from deepfm_tpu_torch.funnel import load_funnel_artifact
    from deepfm_tpu_torch.online import OnlineTrainer
    from deepfm_tpu_torch.serve.pool.sharded import load_sharded_servable

    doc = _two_tower_doc(tmp_path)
    return {
        "online trainer": (lambda: JaxOnlineTrainer(JaxConfig.from_dict(doc)),
                           lambda: OnlineTrainer(Config.from_dict(doc), device="cpu")),
        "elastic trainer": (lambda: JaxElasticTrainer(JaxConfig.from_dict(doc)),
                            lambda: ElasticTrainer(Config.from_dict(doc), device="cpu")),
        "shard-group member": (
            lambda: jax_load_sharded(_servable_dir(tmp_path, doc), build_serve_mesh(1, 2)),
            lambda: load_sharded_servable(str(tmp_path / "servable"), 1, 2, device="cpu")),
        "funnel ranker": (lambda: jax_load_artifact(_funnel_dir(tmp_path, doc)),
                          lambda: load_funnel_artifact(str(tmp_path / "funnel"))),
    }


@pytest.mark.parametrize("path", ["online trainer", "elastic trainer", "shard-group member",
                                  "funnel ranker"])
def test_two_tower_is_refused_in_jaxs_words(tmp_path, path):
    jax_call, port_call = _refusals(tmp_path)[path]
    with pytest.raises(ValueError) as jerr:
        jax_call()
    with pytest.raises(ValueError) as err:
        port_call()
    assert str(err.value) == str(jerr.value)


# -- the command line ------------------------------------------------------------------------

def _cli(tmp_path, name, task, data, *extra):
    from deepfm_tpu_torch.launch.cli import main

    return main(["--task_type", task, "--device", "cpu", "--model_name", name,
                 "--training_data_dir", str(data), "--model_dir", str(tmp_path / f"{task}_ckpt"),
                 "--servable_model_dir", str(tmp_path / f"{task}_pub"),
                 "--feature_size", str(V), "--field_size", str(F), "--embedding_size", str(K),
                 "--deep_layers", "16,8", "--batch_size", str(B), "--log_steps", "1000",
                 "--set", "model.cin_layers=[8,8]", "--set", "model.cross_layers=2", *extra])


@pytest.mark.parametrize("name", FAMILIES)
def test_the_cli_runs_the_family_on_the_tiered_and_online_tasks(tmp_path, capsys, name):
    """``--model_name`` reaches the tiered train task (its publish scored by
    a TieredScorer of the family) and the online-train task (manifests of
    the family)."""
    from deepfm_tpu_torch.data import generate_synthetic_ctr
    from deepfm_tpu_torch.online import latest_manifest

    (tmp_path / "files").mkdir()
    generate_synthetic_ctr(tmp_path / "files" / "tr-0.tfrecords", num_records=4 * B,
                           feature_size=V, field_size=F, seed=1)
    assert _cli(tmp_path, name, "train", tmp_path / "files",
                "--set", "model.tiered_embeddings=true", "--set", "model.fused_kernel=off",
                "--set", "optimizer.lazy_embedding_updates=true",
                "--set", "model.tiered_page_rows=32") == 0
    kinds = [json.loads(x)["kind"] for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert "publish_tiered" in kinds and "tiered_done" in kinds
    from deepfm_tpu_torch.tiered.trainer import default_init_fn

    # the task's table is virtual: a page it never wrote comes from its
    # initializer, as the trainer read it
    init = default_init_fn(Config.from_dict({"model": dict(MODEL, model_name=name)}),
                           RecordLayout({k: 1 if k == "fm_w" else K for k in TABLES[name]}),
                           32)
    scorer = TieredScorer.from_publish(str(tmp_path / "train_pub"), str(tmp_path / "st"),
                                       init_fn=init, device="cpu")
    assert scorer.cfg.model.model_name == name and scorer.cold.layout.keys == TABLES[name]
    b = _batches(1)[0]
    probs = scorer.score(b["feat_ids"], b["feat_vals"])
    assert probs.shape == (B,) and np.all((probs > 0) & (probs < 1))
    _fill_events(str(tmp_path / "stream"), 3)
    assert _cli(tmp_path, name, "online-train", tmp_path / "stream",
                "--set", "run.online_idle_timeout_secs=0.2",
                "--set", "run.online_publish_every_steps=1") == 0
    manifest = latest_manifest(str(tmp_path / "online-train_pub"))
    assert manifest.model_name == name and manifest.step == 2  # 24 events, batches of 16
