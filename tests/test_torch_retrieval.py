"""Kernel B2's plain version (``deepfm_tpu_torch/ops/retrieval.py``) and the
port's copies of the int8 codec and recall harness, against the JAX
package on the CPU.

``retrieval_topk_plain`` is held to JAX ``retrieval_topk_kernel(...,
interpret=True)`` and to ``score_topk_tiles``.  Tolerance: rows equal;
scores within rtol 1e-4 / atol 1e-5, because the port (like the Pallas
kernel) dequantizes and then takes the dot, while the JAX scan computes
``(u·codes)·scale``: the two round differently.  Slots that hold -inf
(a corpus smaller than kos) carry no row and are compared on the score
only.  The numpy copies must give equal outputs.
"""

import numpy as np
import pytest
import torch

from deepfm_tpu.funnel import quant as jquant
from deepfm_tpu.funnel import recall as jrecall
from deepfm_tpu.ops.pallas_retrieval import retrieval_topk_kernel, score_topk_tiles
from deepfm_tpu_torch.funnel import quant, recall
from deepfm_tpu_torch.ops import retrieval

RTOL, ATOL = 1e-4, 1e-5


def _data(r=512, d=8, b=3, seed=2, pads=5):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(r, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    if r > 12:
        emb[r - 12] = emb[5]        # exact tie across tiles
    ids = np.arange(r, dtype=np.int32)
    if pads:
        ids[-pads:] = -1            # pad rows
    codes, scales = jquant.quantize_rows(emb)
    u = rng.normal(size=(b, d)).astype(np.float32)
    return emb, codes, scales, ids, u


def _port(u, codes, scales, ids, kos):
    s, r = retrieval.retrieval_topk(torch.from_numpy(u), torch.from_numpy(codes),
                                    torch.from_numpy(scales), torch.from_numpy(ids), kos)
    assert s.dtype == torch.float32 and r.dtype == torch.int32
    assert s.shape == r.shape == (u.shape[0], kos)
    return s.numpy(), r.numpy()


def _assert_match(got, want):
    (gs, gr), (ws, wr) = got, want
    finite = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), finite)
    np.testing.assert_array_equal(gr[finite], wr[finite])
    np.testing.assert_allclose(gs[finite], ws[finite], rtol=RTOL, atol=ATOL)
    assert np.all(gs[~finite] == -np.inf)


@pytest.mark.parametrize("kos", [16, 13])
def test_plain_matches_jax_kernel_and_scan(kos):
    """r 512, d 8: an exact tie across tiles (row 5 == row 500) and pad
    rows; kos 13 is not a power of two."""
    _, codes, scales, ids, u = _data()
    got = _port(u, codes, scales, ids, kos)
    k = retrieval_topk_kernel(u, codes, scales, ids, kos=kos, tile=128, interpret=True)
    t = score_topk_tiles(u, codes, scales, ids, kos=kos, tile=128)
    for want in (k, t):
        _assert_match(got, tuple(np.asarray(x) for x in want))


def test_tie_goes_to_the_smaller_row():
    """A query equal to row 5's dequantized direction puts rows 5 and 500
    (bit-equal) on top: 5 first."""
    emb, codes, scales, ids, _ = _data(pads=0)
    u = (codes[5].astype(np.float32) * scales[5])[None, :]
    s, r = _port(u, codes, scales, ids, 4)
    assert r[0, 0] == 5 and r[0, 1] == 500 and s[0, 0] == s[0, 1]


def test_corpus_smaller_than_kos():
    """R 20 < kos 32 with 3 pads: 17 finite slots, the rest -inf."""
    _, codes, scales, ids, u = _data(r=20, pads=3)
    got = _port(u, codes, scales, ids, 32)
    want = retrieval_topk_kernel(u, codes, scales, ids, kos=32, tile=128, interpret=True)
    _assert_match(got, tuple(np.asarray(x) for x in want))
    assert np.isfinite(got[0]).sum(axis=1).tolist() == [17] * u.shape[0]


def test_negative_zero_is_one_score():
    """A zero query scores every row 0: the order is the row order, and
    -0.0 comes back as +0.0."""
    _, codes, scales, ids, _ = _data(r=40, pads=0)
    u = np.zeros((1, codes.shape[1]), np.float32)
    u[0, 0] = -0.0
    s, r = _port(u, codes, scales, ids, 8)
    np.testing.assert_array_equal(r[0], np.arange(8))
    assert not np.signbit(s).any()


def test_cpu_tensor_runs_plain():
    _, codes, scales, ids, u = _data()
    args = [torch.from_numpy(x) for x in (u, codes, scales, ids)]
    before = retrieval.launches
    got = retrieval.retrieval_topk(*args, 16)
    want = retrieval.retrieval_topk_plain(*args, 16)
    assert retrieval.launches == before
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_quant_copy_matches_jax():
    emb = jrecall.seeded_corpus(300, 8, seed=4)
    emb[7] = 0.0                    # a pad-like zero row
    codes, scales = quant.quantize_rows(emb)
    jc, js = jquant.quantize_rows(emb)
    np.testing.assert_array_equal(codes, jc)
    np.testing.assert_array_equal(scales, js)
    np.testing.assert_array_equal(quant.dequantize_rows(codes, scales),
                                  jquant.dequantize_rows(jc, js))
    assert quant.quantization_stats(emb, codes, scales) == \
        jquant.quantization_stats(emb, jc, js)
    for mode in ("exact", "int8", "auto"):
        for cap in (10, 1 << 20):
            assert quant.resolve_retrieval_mode(mode, cap) == \
                jquant.resolve_retrieval_mode(mode, cap)
    with pytest.raises(ValueError, match="funnel_retrieval"):
        quant.resolve_retrieval_mode("fp8", 10)
    assert quant.RETRIEVAL_MODES == jquant.RETRIEVAL_MODES


@pytest.mark.parametrize("corpus", ["seeded", "near_tie"])
def test_recall_copy_matches_jax(corpus):
    if corpus == "seeded":
        emb = jrecall.seeded_corpus(200, 8, seed=1)
    else:
        emb = jrecall.near_tie_corpus(200, 8, groups=4, eps=1e-3, seed=1)
    emb[50] = emb[3]                # an exact tie
    ids = np.arange(200, dtype=np.int32)
    ids[-4:] = -1
    q = recall.probe_queries(emb, 16, seed=2)
    np.testing.assert_array_equal(q, jrecall.probe_queries(emb, 16, seed=2))
    for k, os_ in ((8, 2), (5, 1), (4, 100)):
        got = recall.simulate_quantized_topk(emb, ids, q, k, oversample=os_)
        want = jrecall.simulate_quantized_topk(emb, ids, q, k, oversample=os_)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)
    assert recall.measure_recall(emb, ids, 8, oversample=2, n_queries=32) == \
        jrecall.measure_recall(emb, ids, 8, oversample=2, n_queries=32)


@pytest.mark.parametrize("seed", range(4))
def test_topk_lex_equals_full_lexsort(seed):
    """The partition-first selection gives np.lexsort's first k, with
    many ties, -inf entries and k past the length."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(-3, 4, size=300).astype(np.float32)
    scores[rng.random(300) < 0.1] = -np.inf
    rows = np.arange(300)
    for k in (1, 7, 50, 299, 300, 400):
        np.testing.assert_array_equal(
            recall.topk_lex(scores, k), np.lexsort((rows, -scores))[:k])
