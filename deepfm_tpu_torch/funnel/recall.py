"""Recall harness for the quantized retrieval tier: a copy of
``deepfm_tpu/funnel/recall.py`` (numpy only).

* :func:`simulate_quantized_topk` - a host-side numpy twin of the device
  int8 path (quantize -> approximate-score shortlist of K·oversample with
  the smaller-row tie-break -> exact f32 rescore -> lexicographic top-K).
* :func:`recall_at_k` - per-query fraction of the reference top-K ids
  recovered; :func:`measure_recall` runs the whole harness against
  :func:`~deepfm_tpu_torch.funnel.index.brute_force_topk` and reports mean
  and worst-query recall.

The corpus generators of the JAX copy serve its tests and benchmarks and
are not carried over.

``funnel/publish.py resolve_retrieval_section`` runs this harness on every
int8 export and refuses the corpus when the measured recall falls under
``min_recall``.

One change against the JAX copy: the per-query selection takes the
``k`` smallest ``(-score, row)`` keys with :func:`topk_lex`, which
partitions first and sorts only the rows that can be among them, instead
of a ``np.lexsort`` over the whole corpus.  The result is the same.
"""

from __future__ import annotations

import numpy as np

from .quant import dequantize_rows, quantize_rows


def topk_lex(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` largest ``scores`` (1-D), ties toward the
    smaller index, in that order: ``np.lexsort((rows, -scores))[:k]``.

    Every row scoring at least the k-th largest score is kept (all ties
    at the boundary included) and only those are lexsorted."""
    n = scores.shape[0]
    k = min(int(k), n)
    if k <= 0:
        return np.zeros(0, np.int64)
    neg = -scores
    if k < n:
        kth = np.partition(neg, k - 1)[k - 1]
        cand = np.flatnonzero(neg <= kth)
    else:
        cand = np.arange(n)
    return cand[np.lexsort((cand, neg[cand]))][:k]


def probe_queries(emb: np.ndarray, n_queries: int, *,
                  seed: int = 0) -> np.ndarray:
    """The harness's query mix: half random unit vectors, half corpus rows
    themselves (each sits in near-tie territory with its neighbours)."""
    rng = np.random.default_rng(seed)
    n, d = emb.shape
    n_rand = max(1, n_queries // 2)
    q = rng.normal(size=(n_rand, d)).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    n_self = min(n, n_queries - n_rand)
    if n_self > 0:
        rows = rng.choice(n, size=n_self, replace=False)
        q = np.concatenate([q, emb[rows]], axis=0)
    return q


def simulate_quantized_topk(
    emb: np.ndarray,
    item_ids: np.ndarray,
    queries: np.ndarray,
    k: int,
    *,
    oversample: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side twin of the device int8 path: approximate shortlist of
    ``k * oversample`` by dequantized scores (ties toward the smaller
    row), exact f32 rescore of the shortlist, lexicographic (-score, row)
    top-``k``.  Returns ``(scores [B, k] f32, ids [B, k] i32)``."""
    emb = np.asarray(emb, np.float32)
    item_ids = np.asarray(item_ids, np.int32)
    queries = np.asarray(queries, np.float32)
    codes, scales = quantize_rows(emb)
    deq = dequantize_rows(codes, scales)
    kos = min(k * int(oversample), emb.shape[0])
    out_s = np.full((queries.shape[0], k), -np.inf, np.float32)
    out_i = np.full((queries.shape[0], k), -1, np.int32)
    for b in range(queries.shape[0]):
        approx = queries[b] @ deq.T
        approx[item_ids < 0] = -np.inf
        short = topk_lex(approx, kos)
        exact = queries[b] @ emb[short].T
        exact[item_ids[short] < 0] = -np.inf
        order = np.lexsort((short, -exact))[:k]
        take = short[order]
        out_s[b, :take.size] = exact[order]
        out_i[b, :take.size] = item_ids[take]
    return out_s, out_i


def recall_at_k(got_ids: np.ndarray, ref_ids: np.ndarray) -> np.ndarray:
    """Per-query fraction of the reference's real top-K ids (pads in the
    reference don't count against either side)."""
    got_ids = np.asarray(got_ids)
    ref_ids = np.asarray(ref_ids)
    out = np.empty(ref_ids.shape[0], np.float64)
    for b in range(ref_ids.shape[0]):
        ref = ref_ids[b][ref_ids[b] >= 0]
        if ref.size == 0:
            out[b] = 1.0
            continue
        out[b] = np.isin(ref, got_ids[b]).mean()
    return out


def measure_recall(
    emb: np.ndarray,
    item_ids: np.ndarray,
    k: int,
    *,
    oversample: int,
    n_queries: int = 256,
    seed: int = 0,
) -> dict:
    """Probe queries, quantized path vs ``brute_force_topk``, recall@k:
    the mean (``recall``, what the gate compares with ``min_recall``) and
    the worst query."""
    from .index import brute_force_topk

    queries = probe_queries(np.asarray(emb, np.float32), int(n_queries),
                            seed=seed)
    _, ref_ids = brute_force_topk(emb, item_ids, queries, k)
    _, got_ids = simulate_quantized_topk(emb, item_ids, queries, k,
                                         oversample=oversample)
    per_q = recall_at_k(got_ids, ref_ids)
    return {
        "recall": float(per_q.mean()),
        "worst_query_recall": float(per_q.min()),
        "k": int(k),
        "oversample": int(oversample),
        "n_queries": int(queries.shape[0]),
    }
