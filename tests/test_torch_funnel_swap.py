"""The funnel's versioned hot swap and row-sharded index
(``deepfm_tpu_torch/funnel``) against ``deepfm_tpu/funnel`` on the CPU.

Both sides start from the same weights (the JAX init, converted) and the
same corpus as ``tests/test_torch_funnel.py``, with its two engineered
exact ties.  Tolerances: ids equal; served scores within 1e-5 (float32
arithmetic with sums in another order, rounded to 6 decimals on both
sides); sharded retrieval scores within 1e-6 of the row's largest score
magnitude (JAX's own sharded scores differ from brute force by at most
5.96e-8 on this corpus).
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import Config
from deepfm_tpu.funnel import build_index as jax_build_index
from deepfm_tpu.funnel import build_retrieve_with as jax_build_retrieve
from deepfm_tpu.funnel import export_funnel_servable as jax_export
from deepfm_tpu.funnel import load_funnel_artifact as jax_load_artifact
from deepfm_tpu.funnel import make_funnel_context as jax_context
from deepfm_tpu.funnel import stage_funnel_payload as jax_stage
from deepfm_tpu.funnel.index import FunnelIndex as JaxFunnelIndex
from deepfm_tpu.funnel.publish import FunnelPublisher as JaxFunnelPublisher
from deepfm_tpu.funnel.publish import as_state
from deepfm_tpu.funnel.serve import FunnelScorer as JaxFunnelScorer
from deepfm_tpu.funnel.serve import FunnelSwapper as JaxFunnelSwapper
from deepfm_tpu.models.two_tower import init_two_tower
from deepfm_tpu.online.publisher import resolve_version as jax_resolve_version
from deepfm_tpu.parallel.retrieval import encode_queries as jax_encode_queries
from deepfm_tpu.serve.pool.sharded import build_serve_mesh
from deepfm_tpu.train import create_train_state
from deepfm_tpu_torch.convert import (funnel_from_jax, params_from_jax,
                                      two_tower_params_from_jax)
from deepfm_tpu_torch.core.config import ModelConfig
from deepfm_tpu_torch.funnel import (FunnelIndex, FunnelPublisher, brute_force_topk,
                                     build_retrieve_with, make_funnel_context,
                                     stage_funnel_payload)
from deepfm_tpu_torch.funnel import index as funnel_index
from deepfm_tpu_torch.funnel.serve import (FunnelScorer, FunnelSwapper, handle_recommend,
                                           serve_funnel)
from deepfm_tpu_torch.models import DeepFM, TwoTower
from deepfm_tpu_torch.online.publisher import read_manifest, resolve_version, version_location
from deepfm_tpu_torch.serve.server import serve_forever

V_RANK, F_RANK = 64, 5
ITEM_VOCAB, USER_VOCAB = 40, 50
FU, FI = 2, 2
N_ITEMS, CAPACITY = 34, 48
TOP_K, RETURN_N = 6, 4
BUCKETS = (4, 8)
TOL = 1e-5
SHARD_TOL = 1e-6
# the int8 funnel of the swap tests: oversample 2, a gate this corpus passes
INT8 = dict(retrieval="int8", oversample=2, min_recall=0.5)


def _rank_dict():
    return {"feature_size": V_RANK, "field_size": F_RANK, "embedding_size": 4,
            "deep_layers": (8,), "dropout_keep": (1.0,), "compute_dtype": "float32"}


def _query_dict():
    return {"model_name": "two_tower", "user_vocab_size": USER_VOCAB,
            "item_vocab_size": ITEM_VOCAB, "user_field_size": FU, "item_field_size": FI,
            "tower_layers": (16,), "tower_dim": 8, "embedding_size": 4,
            "compute_dtype": "float32"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree):
    return jax.tree_util.tree_map(
        lambda x: x + np.float32(0.01) if x.dtype == np.float32 else x, tree)


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(7)
    jrank_cfg = Config.from_dict({"model": _rank_dict()})
    jquery_cfg = Config.from_dict({"model": _query_dict()})
    rank_state = create_train_state(jrank_cfg)
    qparams = _np_tree(init_two_tower(jax.random.PRNGKey(3), jquery_cfg.model)[0])
    corpus_ids = rng.permutation(ITEM_VOCAB)[:N_ITEMS].astype(np.int64)
    item_fi = rng.integers(0, ITEM_VOCAB, (N_ITEMS, FI))
    item_fv = np.ones((N_ITEMS, FI), np.float32)
    item_fi[30] = item_fi[1]
    item_fi[31] = item_fi[2]
    jindex = jax_build_index(jquery_cfg, qparams, corpus_ids, item_fi, item_fv, chunk=16)
    rank_cfg = ModelConfig(**_rank_dict())
    query_cfg = ModelConfig(**_query_dict())
    return {"jrank_cfg": jrank_cfg, "jquery_cfg": jquery_cfg, "rank_state": rank_state,
            "params": _np_tree(rank_state.params), "qparams": qparams, "jindex": jindex,
            "corpus": (corpus_ids, item_fi, item_fv), "rank_cfg": rank_cfg,
            "query_cfg": query_cfg,
            "index": FunnelIndex(item_ids=np.asarray(jindex.item_ids),
                                 item_emb=np.asarray(jindex.item_emb))}


def _port_version(env, params, qparams, index):
    """The port's (rank state_dict, query state_dict, index) of a JAX version."""
    return (params_from_jax(params, {}, env["rank_cfg"]),
            two_tower_params_from_jax(qparams, env["query_cfg"]),
            FunnelIndex(item_ids=np.asarray(index.item_ids, np.int32),
                        item_emb=np.asarray(index.item_emb, np.float32)))


def _publish_pair(env, jroot, proot, params, qparams, index, **kw):
    """One version, published by JAX's FunnelPublisher and by the port's
    from the same (converted) weights and index."""
    kw = {"top_k": TOP_K, "return_n": RETURN_N, "capacity": CAPACITY, **kw}
    jm = JaxFunnelPublisher(jroot).publish_funnel(
        env["jrank_cfg"], as_state(params, {}, step=3), env["jquery_cfg"], as_state(qparams),
        JaxFunnelIndex(item_ids=np.asarray(index.item_ids),
                       item_emb=np.asarray(index.item_emb)), **kw)
    rank, query, pindex = _port_version(env, params, qparams, index)
    pm = FunnelPublisher(proot).publish_funnel(env["rank_cfg"], rank, env["query_cfg"], query,
                                               pindex, step=3, **kw)
    return jm, pm


@pytest.fixture(scope="module")
def servables(env, tmp_path_factory):
    """The exact and int8 JAX funnel servables, and each through
    convert.funnel_from_jax in the port's format."""
    root = tmp_path_factory.mktemp("swap")
    out = {}
    for mode, kw in (("exact", {}), ("int8", INT8)):
        jdir = str(root / f"jax_{mode}")
        jax_export(jdir, env["jrank_cfg"], env["rank_state"], env["jquery_cfg"],
                   as_state(env["qparams"]), env["jindex"], top_k=TOP_K,
                   return_n=RETURN_N, capacity=CAPACITY, **kw)
        art = jax_load_artifact(jdir)
        art = art._replace(**{k: _np_tree(getattr(art, k))
                              for k in ("rank_params", "rank_state", "query_params")})
        out[mode] = (jdir, funnel_from_jax(art, str(root / f"port_{mode}")))
    return out


@pytest.fixture(scope="module")
def scorers(servables):
    """An exact JAX scorer on [1, 1] and the port's on the CPU."""
    jdir, pdir = servables["exact"]
    jscorer = JaxFunnelScorer(jdir, build_serve_mesh(1, 1), buckets=BUCKETS, max_wait_ms=0.0)
    scorer = FunnelScorer(pdir, device="cpu", buckets=BUCKETS, max_wait_ms=0.0)
    yield jscorer, scorer
    jscorer.close()
    scorer.close()


def _instances(rng, b):
    uids = rng.integers(0, USER_VOCAB, (b, FU))
    rids = rng.integers(0, V_RANK, (b, F_RANK))
    rvals = rng.random((b, F_RANK)).astype(np.float32).round(3)
    return [{"user_ids": uids[i].tolist(), "user_vals": [1.0] * FU,
             "feat_ids": rids[i].tolist(), "feat_vals": rvals[i].tolist()}
            for i in range(b)]


def _same_answer(got, want) -> bool:
    return got["items"] == want["items"] and all(
        np.allclose(got[k], want[k], atol=TOL, rtol=0) for k in ("scores", "retrieval_scores"))


# ---------------------------------------------------------------------------
# publishing


@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_publishers_write_equal_manifests(env, tmp_path, mode):
    """The port's FunnelPublisher and JAX's, on the same weights and index:
    equal param_hash, index sha256, query_param_hash, items, dim and
    retrieval section; the version's tree loads as a funnel servable."""
    kw = INT8 if mode == "int8" else {}
    jm, pm = _publish_pair(env, str(tmp_path / "j"), str(tmp_path / "p"), env["params"],
                           env["qparams"], env["jindex"], **kw)
    assert (pm.version, pm.step) == (jm.version, int(jm.step)) == (1, 3)
    assert pm.param_hash == jm.param_hash
    for key in ("items", "dim", "sha256", "query_param_hash", "retrieval"):
        assert pm.index[key] == jm.index[key], key
    assert (pm.field_size, pm.feature_size, pm.model_name) == \
        (jm.field_size, jm.feature_size, jm.model_name)
    # the port's resolve_version and JAX's read the same manifest
    m, local = resolve_version(str(tmp_path / "p"), 1, str(tmp_path / "stage"))
    jm2, jlocal = jax_resolve_version(str(tmp_path / "p"), 1, str(tmp_path / "stage"))
    assert m == read_manifest(str(tmp_path / "p"), 1) and local == jlocal
    assert jm2.index == m.index and os.path.isfile(os.path.join(local, "funnel.json"))


def test_export_takes_capacity_and_item_field(env, tmp_path):
    from deepfm_tpu_torch.funnel import export_funnel_servable, load_funnel_artifact

    rank, query, index = _port_version(env, env["params"], env["qparams"], env["jindex"])
    d = export_funnel_servable(str(tmp_path / "s"), env["rank_cfg"], rank, env["query_cfg"],
                               query, index, top_k=TOP_K, capacity=CAPACITY, item_field=2)
    meta = load_funnel_artifact(d).meta
    assert (meta["capacity"], meta["item_field"], meta["items"]) == (CAPACITY, 2, N_ITEMS)


# ---------------------------------------------------------------------------
# stage_version: each refusal where JAX's refuses


def _tamper_manifest(root, fn):
    path = os.path.join(root, "MANIFEST-00000001.json")
    with open(path) as f:
        doc = json.load(f)
    fn(doc)
    with open(path, "w") as f:
        json.dump(doc, f)


def _flip_npz_byte(root):
    npz = os.path.join(version_location(root, 1), "index.npz")
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(npz, "wb") as f:
        f.write(bytes(blob))


def _bad_index(env, ids):
    ids = np.asarray(ids, np.int32)
    emb = np.tile(np.asarray(env["jindex"].item_emb)[:1], (len(ids), 1))
    return FunnelIndex(item_ids=ids, item_emb=emb.astype(np.float32))


REFUSALS = {
    "no_index": (lambda doc: doc.update(index=None), None, "no index section"),
    "rank_hash": (lambda doc: doc.update(param_hash="0" * 64), None,
                  "rank param hash mismatch"),
    "index_sha": (lambda doc: doc["index"].update(sha256="0" * 64), None,
                  "index hash mismatch"),
    "index_bytes": (None, _flip_npz_byte, "hash|index|CRC"),
    "query_hash": (lambda doc: doc["index"].update(query_param_hash="0" * 64), None,
                   "query tower hash mismatch"),
    "mode_skew": (lambda doc: doc["index"]["retrieval"].update(mode="int8"), None,
                  "retrieval-mode skew"),
    "over_capacity": ("index", lambda env: np.arange(CAPACITY + 1) % V_RANK,
                      "over the funnel capacity"),
    "negative_id": ("index", lambda env: np.r_[np.arange(10), -2], "must be >= 0"),
    "past_feature_size": ("index", lambda env: np.r_[np.arange(10), V_RANK],
                          "exceeds the ranker's feature_size"),
    # with feature_size < 2**24 the feature_size guard fires first, as in JAX
    "past_2_24": ("index", lambda env: np.r_[np.arange(10), 1 << 24],
                  "exceeds the ranker's feature_size"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_stage_version_refuses_where_jax_refuses(env, scorers, tmp_path, case):
    """A tampered or unservable version raises in the port's stage_version
    where JAX's raises, with the same meaning; the live slot and versions
    stay, and a local root's artifact is never purged (neither side purges
    outside its staging directory)."""
    jscorer, scorer = scorers
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    tamper, how, pattern = REFUSALS[case]
    index = _bad_index(env, how(env)) if tamper == "index" else env["jindex"]
    _publish_pair(env, jroot, proot, env["params"], env["qparams"], index)
    if callable(tamper):
        _tamper_manifest(jroot, tamper)
        _tamper_manifest(proot, tamper)
    elif how is not None and tamper is None:
        how(jroot)
        how(proot)
    live = scorer.holder.get()
    for sc, root in ((jscorer, jroot), (scorer, proot)):
        with pytest.raises(Exception, match=pattern):
            sc.stage_version(root, 1, str(tmp_path / "stage"))
        assert os.path.isdir(version_location(root, 1))
    assert scorer.holder.get() == live and scorer.versions() == (0, 0)


def test_stage_version_slot_of_a_three_slot_scorer(env, servables, tmp_path):
    """A three-slot scorer (a pool member's) has no single idle slot: the
    caller names it.  A slot out of range or the live one is refused and
    the live slot keeps serving; a named idle slot takes the version."""
    _, pdir = servables["exact"]
    proot = str(tmp_path / "p")
    _publish_pair(env, str(tmp_path / "j"), proot, env["params"], env["qparams"],
                  env["jindex"])
    scorer = FunnelScorer(pdir, device="cpu", buckets=BUCKETS, max_wait_ms=0.0, slots=3)
    try:
        assert scorer.holder.get() == 0
        stage = str(tmp_path / "stage")
        for slot, pattern in ((None, "caller names the slot"), (-1, "out of range"),
                              (3, "out of range"), (0, "is live")):
            with pytest.raises(ValueError, match=pattern):
                scorer.stage_version(proot, 1, stage, slot=slot)
            assert scorer.holder.get() == 0
        slot, manifest = scorer.stage_version(proot, 1, stage, slot=2)
        assert (slot, manifest.version) == (2, 1)
    finally:
        scorer.close()


def test_purge_removes_only_staged_copies(tmp_path):
    staging = tmp_path / "staging"
    for cls in (JaxFunnelScorer, FunnelScorer):
        staged, outside = staging / "00000001", tmp_path / "root" / "00000001"
        staged.mkdir(parents=True)
        outside.mkdir(parents=True)
        cls._purge_staged(str(staged), str(staging))
        cls._purge_staged(str(outside), str(staging))
        assert not staged.exists() and outside.exists()
        shutil.rmtree(tmp_path / "root")


def test_canary_rolls_back_a_nan_ranker_and_a_mispadded_index(env, servables, tmp_path):
    """Version 1 (NaN ranker) and version 2 (3 items, its manifest claiming
    34) fail the canary on both sides; the port's swapper rolls both back
    and the boot version keeps serving the same answers."""
    jdir, pdir = servables["exact"]
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    nan = dict(env["params"], fm_b=np.full_like(env["params"]["fm_b"], np.nan))
    _publish_pair(env, jroot, proot, nan, env["qparams"], env["jindex"])
    small = JaxFunnelIndex(item_ids=np.asarray(env["jindex"].item_ids)[:3],
                           item_emb=np.asarray(env["jindex"].item_emb)[:3])
    _publish_pair(env, jroot, proot, env["params"], env["qparams"], small)
    for root in (jroot, proot):
        path = os.path.join(root, "MANIFEST-00000002.json")
        doc = json.load(open(path))
        doc["index"]["items"] = N_ITEMS
        json.dump(doc, open(path, "w"))
    jscorer = JaxFunnelScorer(jdir, build_serve_mesh(1, 1), buckets=BUCKETS, max_wait_ms=0.0)
    scorer = FunnelScorer(pdir, device="cpu", buckets=BUCKETS, max_wait_ms=0.0)
    try:
        for version, pattern in ((1, "non-finite probabilities"), (2, "mis-padded")):
            for sc, root in ((jscorer, jroot), (scorer, proot)):
                with pytest.raises(ValueError, match=pattern):
                    sc.stage_version(root, version, str(tmp_path / "stage"))
        inst = _instances(np.random.default_rng(4), 3)
        before = scorer.recommend_instances(inst)
        swapper = FunnelSwapper(scorer, proot, staging_dir=str(tmp_path / "stage"))
        assert not swapper.poll_once()          # the latest (2) is rolled back
        st = swapper.status()
        assert (st["rollbacks_total"], st["swaps_total"], st["model_version"]) == (1, 0, 0)
        assert "mis-padded" in st["last_error"] and st["live_slot"] == 0
        assert scorer.recommend_instances(inst) == before
        from deepfm_tpu_torch.obs import flight
        events = [e for e in flight.render_events() if e.get("kind") == "swap_rollback"]
        assert events and events[-1]["subsystem"] == "funnel"
    finally:
        jscorer.close()
        scorer.close()


# ---------------------------------------------------------------------------
# a swap to version 2, served over HTTP against JAX's scorer


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), dict(e.headers)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        body = r.read().decode()
        return json.loads(body) if body.startswith("{") else body


def _version2(env):
    params2, qparams2 = _perturbed(env["params"]), _perturbed(env["qparams"])
    corpus_ids, item_fi, item_fv = env["corpus"]
    index2 = jax_build_index(env["jquery_cfg"], qparams2, corpus_ids, item_fi, item_fv,
                             chunk=16)
    return params2, qparams2, index2


def test_recommend_after_a_swap_matches_jax_on_version_2(env, servables, tmp_path):
    """Both servers boot on the int8 servable; version 2 (ranker and query
    tower perturbed, the index rebuilt) is published into each root and
    swapped in.  The port's /v1/recommend then answers what JAX's scorer
    answers on version 2, and /v1/metrics, /readyz and /metrics report it."""
    jdir, pdir = servables["int8"]
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    _publish_pair(env, jroot, proot, env["params"], env["qparams"], env["jindex"], **INT8)
    jm, pm = _publish_pair(env, jroot, proot, *_version2(env), **INT8)
    assert jm.version == pm.version == 2 and jm.param_hash == pm.param_hash
    jscorer = JaxFunnelScorer(jdir, build_serve_mesh(1, 1), buckets=BUCKETS, max_wait_ms=0.0)
    jswap = JaxFunnelSwapper(jscorer, jroot, staging_dir=str(tmp_path / "jstage"))
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(pdir,), kwargs=dict(
        port=0, buckets=BUCKETS, max_wait_ms=0.0, device="cpu", ready=ready,
        reload_url=proot, reload_interval_secs=30.0), daemon=True)
    thread.start()
    assert ready.wait(120)
    base = f"http://127.0.0.1:{ready.port}"
    try:
        assert jswap.poll_once() and jscorer.versions() == (2, 2)
        assert ready.swapper.poll_once() is False       # adopted before the socket
        assert ready.scorer.versions() == (2, 2)
        rng = np.random.default_rng(21)
        for b, n in ((1, None), (3, 2), (8, RETURN_N), (11, 1)):
            inst = _instances(rng, b)
            want = jscorer.recommend_instances(inst, n=n)
            code, got, _ = _post(f"{base}/v1/recommend",
                                 json.dumps({"instances": inst, "n": n}).encode())
            assert code == 200, got
            assert (got["model_version"], got["index_version"]) == (2, 2)
            assert got["items"] == want["items"]
            for key in ("scores", "retrieval_scores"):
                np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=0)
        metrics = _get(f"{base}/v1/metrics")
        reload = metrics["reload"]
        assert (reload["model_version"], reload["index_version"], reload["swaps_total"],
                reload["rollbacks_total"]) == (2, 2, 1, 0)
        assert reload["last_stage_ms"] > 0 and reload["last_canary_ms"] > 0
        assert reload["live_slot"] == 1 and reload["graphs"] == 0
        funnel = metrics["funnel"]
        assert (funnel["model_version"], funnel["index_version"], funnel["index_items"],
                funnel["index_capacity"]) == (2, 2, N_ITEMS, CAPACITY)
        assert funnel["oversample_effective"] == funnel["oversample"] == 2
        assert funnel["degraded_dispatch_total"] == 0 and funnel["kernel_engaged"] is False
        assert funnel["wire_bytes_est"] == 12 * max(BUCKETS) * TOP_K
        ready_doc = _get(f"{base}/readyz")
        assert ready_doc["ready"] and ready_doc["reload_breaker"] == "closed"
        assert (ready_doc["model_version"], ready_doc["index_version"]) == (2, 2)
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
        jscorer.close()
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# the version-skew drill


def test_version_skew_drill_zero_mixed_responses(env, servables, tmp_path):
    """4 client threads hammer /v1/recommend (handle_recommend) while
    version 2 is published and the swapper hot-swaps it: 0 failed
    responses, 0 with a mixed (model, index) pair, 0 whose items and
    scores match neither version's answer; the scorer ends on version 2."""
    _, pdir = servables["exact"]
    root = str(tmp_path / "pub")
    scorer = FunnelScorer(pdir, device="cpu", buckets=BUCKETS, max_wait_ms=0.0)
    rank, query, index = _port_version(env, env["params"], env["qparams"], env["jindex"])
    FunnelPublisher(root).publish_funnel(env["rank_cfg"], rank, env["query_cfg"], query,
                                         index, top_k=TOP_K, return_n=RETURN_N,
                                         capacity=CAPACITY)
    swapper = FunnelSwapper(scorer, root, interval_secs=0.05,
                            staging_dir=str(tmp_path / "stage"))
    bodies = [{"instances": _instances(np.random.default_rng(s), 2)} for s in range(4)]
    try:
        assert swapper.poll_once() and scorer.versions() == (1, 1)
        ref = {1: [handle_recommend(scorer, b)[1] for b in bodies]}
        swapper.start()
        stop = threading.Event()
        results, errors = [], []

        def client(i):
            while not stop.is_set():
                code, doc = handle_recommend(scorer, bodies[i % len(bodies)])
                if code != 200:
                    errors.append((code, doc))
                else:
                    results.append((i % len(bodies), doc))

        threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.2)
            rank2, query2, index2 = _port_version(env, *_version2(env))
            FunnelPublisher(root).publish_funnel(env["rank_cfg"], rank2, env["query_cfg"],
                                                 query2, index2, top_k=TOP_K,
                                                 return_n=RETURN_N, capacity=CAPACITY)
            t0 = time.monotonic()
            while scorer.versions()[0] < 2 and time.monotonic() - t0 < 60:
                time.sleep(0.05)
            time.sleep(0.2)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
            swapper.stop()
        assert scorer.versions() == (2, 2) and swapper.status()["swaps_total"] == 2
        ref[2] = [handle_recommend(scorer, b)[1] for b in bodies]
    finally:
        scorer.close()
    assert errors == [], errors[:3]
    assert {(d["model_version"], d["index_version"]) for _, d in results} <= {(1, 1), (2, 2)}
    assert {d["model_version"] for _, d in results} == {1, 2}
    neither = [(i, d) for i, d in results
               if not any(_same_answer(d, ref[v][i]) for v in (1, 2))]
    assert neither == [], neither[:2]
    assert not any(_same_answer(ref[1][i], ref[2][i]) for i in range(len(bodies)))


# ---------------------------------------------------------------------------
# the row-sharded index


def _port_models(env):
    rank = DeepFM(env["rank_cfg"], device="cpu")
    rank.load_state_dict(params_from_jax(env["params"], {}, env["rank_cfg"]))
    query = TwoTower(env["query_cfg"], device="cpu")
    query.load_state_dict(two_tower_params_from_jax(env["qparams"], env["query_cfg"]))
    return rank, query


@pytest.mark.parametrize("mode", ["exact", "int8"])
@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_retrieve_matches_brute_force_and_jax(env, mp, mode):
    """M shards on the CPU: exact ids equal brute_force_topk's over the
    padded index bit for bit (the engineered ties included), scores within
    1e-6 of the row's largest magnitude; both modes equal JAX's [1, M]
    mesh on ids (and exact scores to the same tolerance); no pad row is
    returned; only [B, K] packs and the [B, D] queries cross shards."""
    rank, query = _port_models(env)
    ctx = make_funnel_context(env["rank_cfg"], env["query_cfg"], capacity=CAPACITY,
                              top_k=TOP_K, return_n=RETURN_N, retrieval=mode, oversample=2,
                              model_parallel=mp)
    assert (ctx.capacity, ctx.rows_local) == (CAPACITY, CAPACITY // mp)
    payload = stage_funnel_payload(ctx, rank, query, env["index"])
    assert len(payload["shards"]) == mp
    rng = np.random.default_rng(11)
    uids = rng.integers(0, USER_VOCAB, (16, FU))
    uvals = np.ones((16, FU), np.float32)
    crossed = []
    funnel_index.exchange_observer = crossed.append
    try:
        with torch.no_grad():
            s, ids = build_retrieve_with(ctx)(payload, torch.from_numpy(uids),
                                              torch.from_numpy(uvals))
    finally:
        funnel_index.exchange_observer = None
    s, ids = s.numpy(), ids.numpy()
    assert crossed and all(shape in {(16, TOP_K), (16, 8)} for shape in crossed), crossed
    assert (ids >= 0).all()
    jctx = jax_context(env["jrank_cfg"], env["jquery_cfg"], build_serve_mesh(1, mp),
                       capacity=CAPACITY, top_k=TOP_K, return_n=RETURN_N, retrieval=mode,
                       oversample=2, pallas="off")
    jpayload = jax_stage(jctx, env["rank_state"].params, env["rank_state"].model_state,
                         env["qparams"], env["jindex"])
    js, jids = (np.asarray(a) for a in jax_build_retrieve(jctx)(jpayload, uids, uvals))
    np.testing.assert_array_equal(ids, jids)
    scale = SHARD_TOL * np.abs(np.where(np.isfinite(s), s, 0)).max(axis=1, keepdims=True)
    if mode == "exact":
        u = np.asarray(jax_encode_queries(env["qparams"], uids, uvals,
                                          cfg=env["jquery_cfg"].model))
        emb = np.zeros((CAPACITY, 8), np.float32)
        emb[:N_ITEMS] = env["index"].item_emb
        iid = np.full((CAPACITY,), -1, np.int32)
        iid[:N_ITEMS] = env["index"].item_ids
        bs, bids = brute_force_topk(emb, iid, u, TOP_K)
        np.testing.assert_array_equal(ids, bids)
        assert (np.abs(s - bs) <= scale).all()
        assert (np.abs(s - js) <= scale).all()
        # the tied pair (corpus rows 1 and 30): the smaller row first
        a, b = int(env["index"].item_ids[1]), int(env["index"].item_ids[30])
        both = [r.tolist() for r in ids if a in r and b in r]
        assert all(r.index(a) < r.index(b) for r in both)


def test_sharded_scorer_answers_as_one_shard(servables):
    """FunnelScorer at model_parallel 2 and 4 (shards on the CPU) answers
    what one shard answers; the geometry follows JAX's rules."""
    _, pdir = servables["int8"]
    one = FunnelScorer(pdir, device="cpu", buckets=BUCKETS, max_wait_ms=0.0)
    inst = _instances(np.random.default_rng(9), 7)
    try:
        want = one.recommend_instances(inst)
        for mp in (2, 4):
            sharded = FunnelScorer(pdir, device="cpu", buckets=BUCKETS, max_wait_ms=0.0,
                                   model_parallel=mp)
            try:
                assert _same_answer(sharded.recommend_instances(inst), want)
                snap = sharded.funnel_snapshot()
                assert snap["model_parallel"] == mp
                assert snap["wire_bytes_est"] == 12 * max(BUCKETS) * TOP_K * mp
            finally:
                sharded.close()
    finally:
        one.close()
    with pytest.raises(ValueError, match="per-shard index rows"):
        FunnelScorer(pdir, device="cpu", buckets=BUCKETS, model_parallel=16)


# ---------------------------------------------------------------------------
# the server surface: tracing, the registry, the serve task, refusals


def test_recommend_is_traced_and_stage_latency_is_in_the_registry(servables):
    _, pdir = servables["exact"]
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(pdir,), kwargs=dict(
        port=0, buckets=BUCKETS, max_wait_ms=0.0, device="cpu", ready=ready,
        trace_sample_rate=0.0), daemon=True)
    thread.start()
    assert ready.wait(120)
    base = f"http://127.0.0.1:{ready.port}"
    trace_id = "feedbeefcafe1234"
    try:
        body = json.dumps({"instances": _instances(np.random.default_rng(1), 3)}).encode()
        code, _, headers = _post(f"{base}/v1/recommend", body, {"X-Trace-Id": trace_id})
        assert code == 200 and headers.get("X-Trace-Id") == trace_id
        traces = {t["trace_id"]: t for t in _get(f"{base}/v1/trace/recent")["traces"]}
        names = [s["name"] for s in traces[trace_id]["spans"]]
        assert traces[trace_id]["name"] == "recommend"
        assert "recommend.queue" in names and "recommend.dispatch" in names
        prom = _get(f"{base}/metrics")
        for stage in ("retrieval", "rank"):
            assert f'deepfm_funnel_stage_seconds_count{{stage="{stage}"}} 1' in prom
        snap = _get(f"{base}/v1/metrics")["funnel"]
        assert snap["retrieval_ms"]["count"] == snap["rank_ms"]["count"] == 1
        assert "p50" in snap["retrieval_ms"] and "p99" in snap["rank_ms"]
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)


def test_serve_task_passes_reload_and_model_parallel(servables, monkeypatch):
    from deepfm_tpu_torch.core.config import Config as PortConfig
    from deepfm_tpu_torch.serve import server
    from deepfm_tpu_torch.train.loop import run_serve

    _, pdir = servables["exact"]
    seen = {}
    monkeypatch.setattr(server, "serve_forever", lambda d, **kw: seen.update(kw, dir=d))
    cfg = PortConfig().with_overrides(
        run={"task_type": "serve", "servable_model_dir": pdir, "serve_reload_url": "/pub",
             "serve_reload_interval_secs": 0.5},
        mesh={"model_parallel": 2})
    run_serve(cfg, device="cpu")
    assert seen["reload_url"] == "/pub" and seen["reload_interval_secs"] == 0.5
    assert seen["funnel"] == {"model_parallel": 2}


def test_funnel_refusals(servables):
    """The funnel's data_parallel (the pool's row slices, ported) serves
    each slice's rows as one slice would; the corpus and URL refusals
    stand, and a multi-tenant funnel member is ROADMAP A18."""
    from deepfm_tpu_torch.serve.pool.worker import GroupMember

    _, pdir = servables["exact"]
    ready = threading.Event()
    t = threading.Thread(target=serve_funnel, args=(pdir,),
                         kwargs=dict(port=0, device="cpu", data_parallel=2, buckets=BUCKETS,
                                     ready=ready), daemon=True)
    t.start()
    assert ready.wait(60)
    one = FunnelScorer(pdir, device="cpu", buckets=BUCKETS)
    try:
        rng = np.random.default_rng(5)
        inst = [{"user_ids": rng.integers(0, USER_VOCAB, FU).tolist(), "user_vals": [1.0] * FU,
                 "feat_ids": rng.integers(0, V_RANK, F_RANK).tolist(),
                 "feat_vals": [1.0] * F_RANK} for _ in range(3)]
        req = urllib.request.Request(
            f"http://127.0.0.1:{ready.port}/v1/recommend",
            data=json.dumps({"instances": inst, "n": RETURN_N}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            doc = json.load(r)
        want = handle_recommend(one, {"instances": inst, "n": RETURN_N})[1]
        assert doc["items"] == want["items"]
        np.testing.assert_allclose(doc["scores"], want["scores"], rtol=0, atol=TOL)
        assert ready.scorer.graphs.data_parallel == 2
    finally:
        ready.server.shutdown()
        t.join(timeout=30)
        one.close()
    with pytest.raises(ValueError, match="not divisible"):
        FunnelScorer(pdir, device="cpu", buckets=(3, 8), data_parallel=2)
    with pytest.raises(NotImplementedError, match="A18"):
        GroupMember(pdir, device="cpu", buckets=BUCKETS, tenants=[{"name": "exp"}])
    with pytest.raises(ValueError, match="item-corpus"):
        serve_forever(pdir, port=0, device="cpu", item_corpus="/corpus")
    with pytest.raises(NotImplementedError, match="A6|A15"):
        FunnelSwapper(object(), "http://store/pub")
