"""The traffic generator: deterministic by seed; the cells' per-field mix
(each categorical field in its own slice, truncated Zipf inside it); and
the stress mix, the distribution of ``deepfm_tpu_torch.data.libsvm
generate_synthetic_ctr``."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from ctrbench import feed


def _mix(name: str) -> dict:
    return json.load(open(os.path.join(ROOT, "ctrbench", "traffic", f"{name}.json")))


FIELDS = _mix("criteo_fields_b1024")
SHARED = _mix("shared_zipf_b1024")
MODEL = {"feature_size": 117_581, "field_size": 39}
CAT_IDS = MODEL["feature_size"] - 14


def _records(seed: int, traffic=FIELDS, batches: int = 4):
    tr = dict(traffic, ring_batches=batches)
    return feed.make_records(tr, MODEL, seed, torch.device("cpu"))


@pytest.mark.parametrize("traffic", [FIELDS, SHARED], ids=["per_field", "shared"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, -5])
def test_same_seed_same_ring(seed, traffic):
    a, b = _records(seed, traffic), _records(seed, traffic)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_seeds_differ():
    assert not torch.equal(_records(1)["feat_ids"], _records(2)["feat_ids"])


def test_sub_seeds_are_distinct_and_in_range():
    seen = {feed.sub_seed(s, p) for s in (0, 1, 2**40, -3) for p in (0, 1, 2)}
    assert len(seen) == 12
    assert all(0 <= x < 2**63 for x in seen)


def test_every_cell_mix_is_per_field():
    for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]:
        assert _mix(w["traffic"])["layout"] == "per_field", w["name"]


def test_field_sizes_water_fill():
    cards = FIELDS["field_cardinalities"]
    sizes = feed.field_sizes(cards, CAT_IDS)
    assert sum(sizes) == CAT_IDS and len(sizes) == 26
    cap = max(sizes)
    for c, s in zip(cards, sizes):
        assert s == c if c < cap - 1 else s in (cap - 1, cap)
    assert sizes[8] == 3 and sizes[2] == cap  # C9 keeps its 3 values; C3 is capped
    assert feed.field_sizes([5, 7], 100) == [5, 7]
    assert feed.field_sizes([1, 50, 50], 30) == [1, 15, 14]
    with pytest.raises(ValueError):
        feed.field_sizes([1] * 5, 4)


def test_per_field_slices_and_skew():
    rec = _records(3, batches=16)
    ids, vals, label = rec["feat_ids"], rec["feat_vals"], rec["label"]
    n = ids.shape[0]
    assert ids.dtype == torch.int64 and ids.shape == (n, 39)
    assert torch.equal(ids[:, :13], torch.arange(1, 14).expand(n, 13))
    assert torch.equal(vals[:, 13:], torch.ones(n, 26))
    assert abs(float(label.mean()) - 0.25) < 0.02
    sizes = feed.field_sizes(FIELDS["field_cardinalities"], CAT_IDS)
    start = 14
    for j, size in enumerate(sizes):
        col = ids[:, 13 + j]
        assert int(col.min()) >= start and int(col.max()) < start + size, j
        pmf = np.arange(1, size + 1, dtype=np.float64) ** -FIELDS["zipf_a"]
        pmf /= pmf.sum()
        for r in range(min(3, size)):
            p = float((col == start + r).double().mean())
            assert abs(p - pmf[r]) < 4 * np.sqrt(pmf[r] / n) + 1e-3, (j, r, p, pmf[r])
        start += size
    assert start == MODEL["feature_size"]


def test_shared_mix_is_generate_synthetic_ctr():
    rec = _records(3, SHARED, batches=8)
    ids, vals, label = rec["feat_ids"], rec["feat_vals"], rec["label"]
    n = ids.shape[0]
    assert ids.dtype == torch.int64 and vals.dtype == torch.float32
    assert ids.shape == (n, 39) and vals.shape == (n, 39) and label.shape == (n,)
    assert torch.equal(ids[:, :13], torch.arange(1, 14).expand(n, 13))
    assert float(vals[:, :13].min()) >= 0.0 and float(vals[:, :13].max()) < 1.0
    assert abs(float(vals[:, :13].mean()) - 0.5) < 0.01
    assert torch.equal(vals[:, 13:], torch.ones(n, 26))
    cat = ids[:, 13:]
    assert int(cat.min()) >= 14 and int(cat.max()) < MODEL["feature_size"]
    assert abs(float(label.mean()) - 0.25) < 0.01
    assert set(label.unique().tolist()) <= {0.0, 1.0}


def test_zipf_matches_numpy_rule():
    """The vectorised draws follow numpy's Zipf(1.3): the same frequency
    of each small value, to sampling noise."""
    g = torch.Generator().manual_seed(5)
    ours = feed.zipf(1.3, 400_000, g).numpy()
    ref = np.random.default_rng(5).zipf(1.3, 400_000).astype(np.float64)
    assert ours.min() >= 1.0 and np.all(ours == np.floor(ours))
    for v in (1, 2, 3, 5, 10):
        p_ours, p_ref = np.mean(ours == v), np.mean(ref == v)
        assert abs(p_ours - p_ref) < 4 * np.sqrt(p_ref / 400_000) + 1e-4, v
    assert abs(np.mean(ours > 1000) - np.mean(ref > 1000)) < 0.003


def test_host_ring_batches_in_record_order():
    rec = _records(4)
    ring = feed.host_ring(rec, FIELDS["batch_size"], pin=False)
    assert len(ring) == 4
    assert torch.equal(ring[2]["feat_ids"], rec["feat_ids"][2048:3072])
    src = feed.Ring(ring)
    got = [next(src) for _ in range(6)]
    assert got[5] is ring[1] and src.i == 6
