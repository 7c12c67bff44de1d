"""The port's recommendation funnel (``deepfm_tpu_torch/funnel``) against
``deepfm_tpu/funnel`` on the CPU, the JAX side on a [1, 1] mesh.

Both sides start from the same weights (the JAX init, converted) and the
same corpus, with two engineered exact ties (corpus rows 1/30 and 2/31
share item-tower features, so only the (-score, row) rule orders them).
Tolerances: ids equal; scores within 1e-5 (float32 arithmetic with sums in
another order; the int8 shortlist is scored as dequantize-then-dot here,
as ``(u·codes)·scale`` by the JAX scan, and both are rescored exactly).
Served scores are rounded to 6 decimals on both sides.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import Config
from deepfm_tpu.funnel import build_index as jax_build_index
from deepfm_tpu.funnel import build_rank_topn_with as jax_build_rank
from deepfm_tpu.funnel import build_retrieve_with as jax_build_retrieve
from deepfm_tpu.funnel import export_funnel_servable as jax_export
from deepfm_tpu.funnel import load_funnel_artifact as jax_load_artifact
from deepfm_tpu.funnel import make_funnel_context as jax_context
from deepfm_tpu.funnel import stage_funnel_payload as jax_stage
from deepfm_tpu.funnel.index import FunnelIndex as JaxFunnelIndex
from deepfm_tpu.funnel.publish import as_state
from deepfm_tpu.funnel.publish import resolve_retrieval_section as jax_retrieval_section
from deepfm_tpu.funnel.recall import near_tie_corpus
from deepfm_tpu.funnel.serve import FunnelScorer as JaxFunnelScorer
from deepfm_tpu.models.two_tower import init_two_tower
from deepfm_tpu.parallel.retrieval import encode_queries as jax_encode_queries
from deepfm_tpu.serve.pool.sharded import build_serve_mesh
from deepfm_tpu.train import create_train_state
from deepfm_tpu_torch.convert import (funnel_from_jax, params_from_jax,
                                      two_tower_params_from_jax)
from deepfm_tpu_torch.core.config import ModelConfig
from deepfm_tpu_torch.funnel import (FunnelIndex, brute_force_topk, build_index,
                                     build_rank_topn_with, build_retrieve_with,
                                     export_funnel_servable, index_hash,
                                     make_funnel_context, stage_funnel_payload)
from deepfm_tpu_torch.funnel.serve import FunnelScorer
from deepfm_tpu_torch.models import DeepFM, TwoTower
from deepfm_tpu_torch.ops import retrieval
from deepfm_tpu_torch.serve.server import serve_forever

V_RANK, F_RANK = 64, 5
ITEM_VOCAB, USER_VOCAB = 40, 50
FU, FI = 2, 2
N_ITEMS, CAPACITY = 34, 48
TOP_K, RETURN_N = 6, 4
BUCKETS = (4, 8)
TOL = 1e-5


def _rank_dict(feature_size=V_RANK):
    return {"feature_size": feature_size, "field_size": F_RANK, "embedding_size": 4,
            "deep_layers": (8,), "dropout_keep": (1.0,), "compute_dtype": "float32"}


def _query_dict():
    return {"model_name": "two_tower", "user_vocab_size": USER_VOCAB,
            "item_vocab_size": ITEM_VOCAB, "user_field_size": FU, "item_field_size": FI,
            "tower_layers": (16,), "tower_dim": 8, "embedding_size": 4,
            "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(7)
    jrank_cfg = Config.from_dict({"model": _rank_dict()})
    jquery_cfg = Config.from_dict({"model": _query_dict()})
    rank_state = create_train_state(jrank_cfg)
    qparams, _ = init_two_tower(jax.random.PRNGKey(3), jquery_cfg.model)
    qparams = jax.tree_util.tree_map(np.asarray, qparams)
    corpus_ids = rng.permutation(ITEM_VOCAB)[:N_ITEMS].astype(np.int64)
    item_fi = rng.integers(0, ITEM_VOCAB, (N_ITEMS, FI))
    item_fv = np.ones((N_ITEMS, FI), np.float32)
    item_fi[30] = item_fi[1]
    item_fi[31] = item_fi[2]
    jindex = jax_build_index(jquery_cfg, qparams, corpus_ids, item_fi, item_fv, chunk=16)

    rank_cfg = ModelConfig(**_rank_dict())
    query_cfg = ModelConfig(**_query_dict())
    params = jax.tree_util.tree_map(np.asarray, rank_state.params)
    rank = DeepFM(rank_cfg, device="cpu")
    rank.load_state_dict(params_from_jax(params, {}, rank_cfg))
    query = TwoTower(query_cfg, device="cpu")
    query.load_state_dict(two_tower_params_from_jax(qparams, query_cfg))
    return {"jrank_cfg": jrank_cfg, "jquery_cfg": jquery_cfg, "rank_state": rank_state,
            "qparams": qparams, "jindex": jindex, "corpus": (corpus_ids, item_fi, item_fv),
            "rank_cfg": rank_cfg, "query_cfg": query_cfg, "rank": rank, "query": query,
            "index": FunnelIndex(item_ids=np.asarray(jindex.item_ids),
                                 item_emb=np.asarray(jindex.item_emb))}


def _queries(rng, b):
    uids = rng.integers(0, USER_VOCAB, (b, FU))
    uids[0, 0] = USER_VOCAB + 3      # clips to the last row on both sides
    return uids, np.ones((b, FU), np.float32)


def _rank_rows(rng, b):
    return (rng.integers(0, V_RANK, (b, F_RANK)),
            rng.random((b, F_RANK)).astype(np.float32).round(3))


def _contexts(env, mode, oversample=2):
    jctx = jax_context(env["jrank_cfg"], env["jquery_cfg"], build_serve_mesh(1, 1),
                       capacity=CAPACITY, top_k=TOP_K, return_n=RETURN_N,
                       retrieval=mode, oversample=oversample, pallas="off")
    ctx = make_funnel_context(env["rank_cfg"], env["query_cfg"], capacity=CAPACITY,
                              top_k=TOP_K, return_n=RETURN_N, retrieval=mode,
                              oversample=oversample)
    assert ctx.retrieval_mode == jctx.retrieval_mode == mode
    assert ctx.item_field == jctx.item_field and ctx.oversample == jctx.oversample
    jpayload = jax_stage(jctx, env["rank_state"].params, env["rank_state"].model_state,
                         env["qparams"], env["jindex"])
    payload = stage_funnel_payload(ctx, env["rank"], env["query"], env["index"])
    return jctx, jpayload, ctx, payload


def test_build_index_matches_jax(env):
    corpus_ids, item_fi, item_fv = env["corpus"]
    got = build_index(env["query"], corpus_ids, item_fi, item_fv, chunk=16)
    want = env["jindex"]
    np.testing.assert_array_equal(got.item_ids, np.asarray(want.item_ids))
    assert got.item_ids.dtype == np.int32 and got.item_emb.dtype == np.float32
    np.testing.assert_allclose(got.item_emb, np.asarray(want.item_emb), atol=TOL, rtol=0)
    # the engineered ties are bit-equal rows on both sides
    assert np.array_equal(got.item_emb[1], got.item_emb[30])
    same = JaxFunnelIndex(item_ids=got.item_ids, item_emb=got.item_emb)
    from deepfm_tpu.funnel.index import index_hash as jax_index_hash
    assert index_hash(got) == jax_index_hash(same)


@pytest.mark.parametrize("mode,oversample", [("exact", 1), ("int8", 2), ("int8", 8)])
def test_retrieve_matches_jax_and_brute_force(env, mode, oversample):
    """Ids equal (ties included), scores within 1e-5, pads unreturnable.
    int8 with oversample 8 takes the whole index into the shortlist."""
    jctx, jpayload, ctx, payload = _contexts(env, mode, oversample)
    rng = np.random.default_rng(11)
    uids, uvals = _queries(rng, 8)
    js, jids = jax_build_retrieve(jctx)(jpayload, uids, uvals)
    before = retrieval.launches
    with torch.inference_mode():
        s, ids = build_retrieve_with(ctx)(payload, torch.from_numpy(uids),
                                          torch.from_numpy(uvals))
    assert retrieval.launches == before          # CPU tensors: plain version
    assert s.shape == ids.shape == (8, TOP_K) and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=TOL, rtol=0)
    assert (ids.numpy() >= 0).all()
    if mode == "exact" or oversample * TOP_K >= CAPACITY:
        u = np.asarray(jax_encode_queries(env["qparams"], uids, uvals,
                                          cfg=env["jquery_cfg"].model))
        emb = np.zeros((CAPACITY, 8), np.float32)
        emb[:N_ITEMS] = env["index"].item_emb
        iid = np.full((CAPACITY,), -1, np.int32)
        iid[:N_ITEMS] = env["index"].item_ids
        bs, bids = brute_force_topk(emb, iid, u, TOP_K)
        np.testing.assert_array_equal(ids.numpy(), bids)
        np.testing.assert_allclose(s.numpy(), bs, atol=TOL, rtol=0)


def test_retrieve_orders_the_engineered_ties(env):
    """A query equal to the tied items' embedding: both in the top 2, the
    smaller corpus row first, on both modes."""
    for mode in ("exact", "int8"):
        _, _, ctx, payload = _contexts(env, mode)
        u = torch.from_numpy(env["index"].item_emb[[1]])
        emb, iid = payload["index"]["item_emb"], payload["index"]["item_ids"]
        if mode == "exact":
            scores = torch.where(iid[None] >= 0, u @ emb.T, float("-inf"))
            _, li = torch.sort(scores, dim=1, descending=True, stable=True)
            assert li[0, :2].tolist() == [1, 30]
        else:
            _, rows = retrieval.retrieval_topk(u, payload["index"]["item_codes"],
                                               payload["index"]["item_scales"], iid, 4)
            assert rows[0, :2].tolist() == [1, 30]


def test_rank_matches_jax(env):
    """The [B, 3, N] pack on the same candidates: ids equal, probabilities
    and retrieval scores within 1e-5, pad candidates last."""
    jctx, jpayload, ctx, payload = _contexts(env, "exact")
    rng = np.random.default_rng(5)
    fids, fvals = _rank_rows(rng, 8)
    cand = np.stack([rng.permutation(env["index"].item_ids)[:TOP_K] for _ in range(8)])
    cand[3, 2] = -1                   # a pad candidate
    cscores = rng.normal(size=(8, TOP_K)).astype(np.float32)
    want = np.asarray(jax_build_rank(jctx)(jpayload, fids, fvals, cand.astype(np.int32),
                                           cscores))
    with torch.inference_mode():
        got = build_rank_topn_with(ctx)(payload, torch.from_numpy(fids),
                                        torch.from_numpy(fvals),
                                        torch.from_numpy(cand.astype(np.int32)),
                                        torch.from_numpy(cscores)).numpy()
    assert got.shape == (8, 3, RETURN_N) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=TOL, rtol=0)
    assert -1.0 not in got[3, 0]


@pytest.mark.parametrize("case", ["over_capacity", "negative_id", "past_feature_size",
                                  "dim"])
def test_staging_guards_raise_where_jax_raises(env, case):
    jctx, _, ctx, _ = _contexts(env, "int8")
    ids, emb = env["index"].item_ids.copy(), env["index"].item_emb.copy()
    if case == "over_capacity":
        ids = np.arange(CAPACITY + 1, dtype=np.int32) % V_RANK
        emb = np.ones((CAPACITY + 1, 8), np.float32)
    elif case == "negative_id":
        ids[3] = -2
    elif case == "past_feature_size":
        ids[3] = V_RANK
    else:
        emb = np.ones((N_ITEMS, 7), np.float32)
    with pytest.raises(ValueError) as jerr:
        jax_stage(jctx, env["rank_state"].params, env["rank_state"].model_state,
                  env["qparams"], JaxFunnelIndex(item_ids=ids, item_emb=emb))
    with pytest.raises(ValueError) as err:
        stage_funnel_payload(ctx, env["rank"], env["query"],
                             FunnelIndex(item_ids=ids, item_emb=emb))
    assert str(err.value).split(" ")[:3] == str(jerr.value).split(" ")[:3]


@pytest.fixture(scope="module")
def servables(env, tmp_path_factory):
    """A JAX int8 funnel servable, and the same funnel through
    convert.funnel_from_jax in the port's format."""
    root = tmp_path_factory.mktemp("funnel")
    jdir = str(root / "jax")
    jax_export(jdir, env["jrank_cfg"], env["rank_state"], env["jquery_cfg"],
               as_state(env["qparams"]), env["jindex"], top_k=TOP_K,
               return_n=RETURN_N, capacity=CAPACITY, retrieval="int8",
               oversample=2, min_recall=0.5)
    art = jax_load_artifact(jdir)
    art = art._replace(**{k: jax.tree_util.tree_map(np.asarray, getattr(art, k))
                          for k in ("rank_params", "rank_state", "query_params")})
    pdir = funnel_from_jax(art, str(root / "port"))
    return jdir, pdir


def _instances(rng, b):
    uids, uvals = _queries(rng, b)
    rids, rvals = _rank_rows(rng, b)
    return [{"user_ids": uids[i].tolist(), "user_vals": uvals[i].tolist(),
             "feat_ids": rids[i].tolist(), "feat_vals": rvals[i].tolist()}
            for i in range(b)]


def test_recommend_matches_jax_scorer(servables):
    jdir, pdir = servables
    jscorer = JaxFunnelScorer(jdir, build_serve_mesh(1, 1), buckets=BUCKETS,
                              max_wait_ms=0.0)
    scorer = FunnelScorer(pdir, device="cpu", buckets=BUCKETS, max_wait_ms=0.0)
    try:
        assert scorer.ctx.retrieval_mode == jscorer.ctx.retrieval_mode == "int8"
        rng = np.random.default_rng(21)
        for b, n in ((1, None), (3, 2), (8, RETURN_N), (11, 1)):
            inst = _instances(rng, b)
            want = jscorer.recommend_instances(inst, n=n)
            got = scorer.recommend_instances(inst, n=n)
            assert got["items"] == want["items"]
            for key in ("scores", "retrieval_scores"):
                np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=0)
        snap = scorer.funnel_snapshot()
        assert snap["retrieval_mode"] == "int8" and snap["index_items"] == N_ITEMS
        # counted over dispatched (bucket-padded) rows, as in JAX
        assert snap["candidates_total"] == \
            jscorer.funnel_snapshot()["candidates_total"] == (4 + 4 + 8 + 12) * TOP_K
        assert snap["retrieval_ms"]["count"] > 0 and "p50" in snap["rank_ms"]
    finally:
        jscorer.close()
        scorer.close()


def _post(url, body):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_recommend_over_http(servables):
    _, pdir = servables
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(pdir,), kwargs=dict(
        port=0, buckets=BUCKETS, max_wait_ms=0.0, device="cpu", ready=ready,
        funnel={"top_k": TOP_K}), daemon=True)
    thread.start()
    assert ready.wait(120)
    base = f"http://127.0.0.1:{ready.port}"
    try:
        inst = _instances(np.random.default_rng(3), 5)
        code, doc = _post(f"{base}/v1/recommend", json.dumps({"instances": inst, "n": 3}).encode())
        assert code == 200, doc
        assert [len(r) for r in doc["items"]] == [3] * 5
        assert len(doc["scores"]) == len(doc["retrieval_scores"]) == 5
        assert doc["model_version"] == doc["index_version"] == 0
        ragged = dict(inst[0], user_ids=[1])
        for body in (json.dumps({"instances": [ragged]}),
                     json.dumps({"instances": inst, "n": RETURN_N + 1}),
                     json.dumps({"instances": inst, "n": 0}),
                     "[1, 2]", "not json", json.dumps({"n": 2})):
            code, doc = _post(f"{base}/v1/recommend", body.encode())
            assert code == 400, (body, doc)
        code, _ = _post(f"{base}/v1/models/deepfm:predict", b"{}")
        assert code == 404
        with urllib.request.urlopen(f"{base}/v1/metrics", timeout=60) as r:
            metrics = json.load(r)
        assert metrics["funnel"]["candidates_total"] == 8 * TOP_K   # one bucket of 8
        with urllib.request.urlopen(f"{base}/readyz", timeout=60) as r:
            assert json.load(r)["ready"]
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_non_funnel_servable_refuses_funnel_flags(servables):
    _, pdir = servables
    with pytest.raises(ValueError, match="funnel options"):
        serve_forever(pdir + "/rank", port=0, device="cpu", funnel={"top_k": 3})


def test_int8_publish_gate_refuses_like_jax(env, tmp_path):
    """A near-tie corpus at oversample 1 misses a 0.999 recall gate on both
    sides; a passing corpus records the same section on both."""
    emb = near_tie_corpus(64, 8, groups=4, eps=1e-3, seed=0)
    ids = np.arange(64, dtype=np.int32)
    rank_cfg = ModelConfig(**_rank_dict(feature_size=128))
    rank = DeepFM(rank_cfg, device="cpu")
    kw = dict(top_k=8, retrieval="int8", oversample=1, min_recall=0.999)
    with pytest.raises(ValueError, match="min_recall gate"):
        jax_retrieval_section(JaxFunnelIndex(item_ids=ids, item_emb=emb), capacity=64,
                              top_k=8, retrieval="int8", oversample=1, min_recall=0.999)
    with pytest.raises(ValueError, match="min_recall gate"):
        export_funnel_servable(str(tmp_path / "refused"), rank_cfg, rank.state_dict(),
                               env["query_cfg"], env["query"].state_dict(),
                               FunnelIndex(item_ids=ids, item_emb=emb), **kw)
    assert not (tmp_path / "refused").exists()
    from deepfm_tpu_torch.funnel.publish import resolve_retrieval_section
    got = resolve_retrieval_section(env["index"], capacity=CAPACITY, top_k=TOP_K,
                                    retrieval="int8", oversample=2, min_recall=0.5)
    want = jax_retrieval_section(env["jindex"], capacity=CAPACITY, top_k=TOP_K,
                                 retrieval="int8", oversample=2, min_recall=0.5)
    assert got == want
