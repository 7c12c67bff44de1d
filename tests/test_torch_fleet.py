"""The port's fleet control plane (``deepfm_tpu_torch/fleet``) held to JAX's
(``deepfm_tpu/fleet``) on the same inputs: split arms, re-split movement,
shadow samples and rendezvous rankings equal JAX's exactly (both packages
hash the key's md5); the registry's and the config's checks refuse the
same inputs naming the same fields; the shadow scorer offers, sheds,
counts errors, gates and refuses to shadow itself as JAX's does.  No
tolerance is needed: every comparison is exact."""

import json
import time

import numpy as np
import pytest

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.core.config import tenant_spec_divergence as jax_divergence
from deepfm_tpu.core.config import validate_tenant_entries as jax_validate
from deepfm_tpu.fleet.registry import TenantRegistry as JaxRegistry
from deepfm_tpu.fleet.registry import parse_tenants as jax_parse
from deepfm_tpu.fleet.shadow import ShadowScorer as JaxShadow
from deepfm_tpu.fleet.split import TrafficSplit as JaxSplit
from deepfm_tpu.fleet.split import rendezvous_ranking as jax_ranking
from deepfm_tpu.fleet.split import sampled as jax_sampled
from deepfm_tpu_torch.core.config import (EXECUTABLE_SPEC_FIELDS, Config,
                                          tenant_spec_divergence, validate_tenant_entries)
from deepfm_tpu_torch.fleet import (DEFAULT_TENANT, ShadowScorer, TenantRegistry, TenantSpec,
                                    TrafficSplit, parse_tenants, rendezvous_arm,
                                    rendezvous_ranking, sampled, split_point)

KEYS_10K = [f"user-{i}" for i in range(10_000)]
SPLITS = [{"a": 90.0, "b": 10.0}, {"a": 50.0, "b": 50.0},
          {"prod": 33.3, "exp": 33.3, "canary": 33.4}]


@pytest.mark.parametrize("arms", SPLITS, ids=["90-10", "50-50", "three-arms"])
def test_split_arms_equal_jax_over_10k_keys(arms):
    port, jax = TrafficSplit(dict(arms)), JaxSplit(dict(arms))
    assert [port.arm(k) for k in KEYS_10K] == [jax.arm(k) for k in KEYS_10K]
    assert port.arms() == jax.arms()


RESPLITS = [({"a": 90.0, "b": 10.0}, {"a": 50.0, "b": 50.0}),
            ({"a": 50.0, "b": 50.0}, {"a": 80.0, "b": 20.0}),
            ({"a": 50.0, "b": 50.0}, {"b": 30.0, "c": 70.0})]


@pytest.mark.parametrize("before,after", RESPLITS, ids=["90-10-to-50", "50-to-80-20",
                                                         "drop-and-add-arm"])
def test_a_resplit_moves_the_same_keys_as_jax(before, after):
    port, jax = TrafficSplit(dict(before)), JaxSplit(dict(before))
    first = {k: port.arm(k) for k in KEYS_10K}
    assert port.set_percentages(dict(after)) == jax.set_percentages(dict(after))
    moved = {k for k in KEYS_10K if port.arm(k) != first[k]}
    assert moved == {k for k in KEYS_10K if jax.arm(k) != first[k]}
    if set(before) == set(after):  # a two-arm shift moves exactly its window
        grown = next(a for a in after if after[a] > before[a])
        assert all(port.arm(k) == grown for k in moved)
        assert abs(len(moved) / len(KEYS_10K)
                   - abs(after[grown] - before[grown]) / 100) < 0.02


def test_shadow_samples_and_rendezvous_rankings_equal_jax():
    for pct in (0.0, 12.5, 25.0, 100.0):
        assert [sampled(k, pct) for k in KEYS_10K] == [jax_sampled(k, pct) for k in KEYS_10K]
    for arms in (["use1", "euw1"], ["use1", "euw1", "apne1"], ["a", "b", "c", "d", "e"]):
        for k in KEYS_10K[:2000]:
            ranking = rendezvous_ranking(k, arms)
            assert ranking == jax_ranking(k, arms)
            assert rendezvous_arm(k, list(reversed(arms))) == ranking[0]
    assert all(0 <= split_point(k) < 1_000_000 for k in KEYS_10K[:100])
    with pytest.raises(ValueError, match="at least one arm"):
        rendezvous_ranking("k", [])


def test_removing_a_region_moves_only_its_keys():
    arms = ["use1", "euw1", "apne1"]
    home = {k: rendezvous_arm(k, arms) for k in KEYS_10K}
    left = [a for a in arms if a != "euw1"]
    for k in KEYS_10K:
        if home[k] != "euw1":
            assert rendezvous_arm(k, left) == home[k]
        else:
            assert rendezvous_arm(k, left) == rendezvous_ranking(k, arms)[1]


def test_split_validation_matches_jax():
    for arms in ({"a": 60.0, "b": 20.0}, {"a": 110.0, "b": -10.0}, {}):
        with pytest.raises(ValueError) as port:
            TrafficSplit(arms)
        with pytest.raises(ValueError) as jax:
            JaxSplit(arms)
        assert str(port.value) == str(jax.value)


# ---------------------------------------------------------------- registry

BAD_ENTRIES = [
    [{"name": "a", "source": "/1"}, {"name": "a", "source": "/2"}],
    [{"name": "a", "split_percent": 70}, {"name": "b", "split_percent": 20}],
    [{"name": "a"}, {"name": "s", "shadow_of": "missing"}],
    [{"name": "a", "split_percent": 100}, {"name": "s", "shadow_of": "a", "split_percent": 5}],
    [{"name": "a", "sauce": "/typo"}],
    [{"source": "/nameless"}],
    ["not-an-object"],
    [{"name": "a", "split_percent": -5}],
]


@pytest.mark.parametrize("entries", BAD_ENTRIES, ids=[
    "duplicate", "sum", "dangling-shadow", "shadow-split", "unknown-key", "nameless",
    "not-object", "negative"])
def test_tenant_entries_are_refused_as_jax_refuses_them(entries):
    with pytest.raises(ValueError) as port:
        validate_tenant_entries(entries)
    with pytest.raises(ValueError) as jax:
        jax_validate(entries)
    assert str(port.value) == str(jax.value)
    d = {"fleet": {"tenants": entries}}
    with pytest.raises(ValueError) as port_cfg:
        Config.from_dict(d)
    assert str(port_cfg.value) == str(jax.value)


def test_the_config_and_registry_name_the_same_divergent_fields():
    from deepfm_tpu.core.config import EXECUTABLE_SPEC_FIELDS as JAX_FIELDS

    assert EXECUTABLE_SPEC_FIELDS == JAX_FIELDS
    model = {"embedding_size": 64, "deep_layers": [512], "l2_reg": 0.01}
    d = {"fleet": {"tenants": [{"name": "a", "model": model}]}}
    with pytest.raises(ValueError) as port:
        Config.from_dict(d)
    with pytest.raises(ValueError) as jax:
        JaxConfig.from_dict(d)
    for msg in (str(port.value), str(jax.value)):
        assert "['deep_layers', 'embedding_size']" in msg and "l2_reg" not in msg
    base = {"embedding_size": 32, "deep_layers": (8,), "l2_reg": 1e-4}
    for ov in ({"deep_layers": [8]}, {"embedding_size": 64, "fused_kernel": "on"},
               {"l2_reg": 0.5}):
        assert tenant_spec_divergence(base, ov) == jax_divergence(base, ov)
    with pytest.raises(ValueError) as port:
        TenantRegistry([{"name": "t", "model": {"embedding_size": 64}}], base_model=base)
    with pytest.raises(ValueError) as jax:
        JaxRegistry([{"name": "t", "model": {"embedding_size": 64}}], base_model=base)
    assert str(port.value) == str(jax.value)


def test_registry_views_and_mutations_match_jax():
    entries = [{"name": "prod", "source": "/p", "split_percent": 90},
               {"name": "exp", "source": "/e", "split_percent": 10},
               {"name": "shadow", "source": "/s", "shadow_of": "prod"}]
    port, jax = TenantRegistry(entries), JaxRegistry(entries)
    assert port.names() == jax.names() == ["prod", "exp", "shadow"]
    assert [t.to_dict() for t in port.serving()] == [t.to_dict() for t in jax.serving()]
    assert port.shadow_pairs() == jax.shadow_pairs() == [("shadow", "prod")]
    assert port.split().arms() == jax.split().arms()
    for reg in (port, jax):
        with pytest.raises(ValueError, match="already registered"):
            reg.add({"name": "prod", "source": "/p2"})
        with pytest.raises(ValueError, match="shadowed by"):
            reg.remove("prod")
        with pytest.raises(KeyError, match="unknown tenant"):
            reg.get("nobody")
        reg.remove("shadow")
        reg.remove("prod")
        assert reg.names() == ["exp"]
    assert TenantRegistry([{"name": "x"}]).split() is None
    assert parse_tenants(json.dumps(entries)) == parse_tenants(entries) == parse_tenants(
        list(parse_tenants(entries)))
    assert [t.to_dict() for t in parse_tenants(entries)] == [
        t.to_dict() for t in jax_parse(entries)]
    assert isinstance(parse_tenants(entries)[0], TenantSpec) and DEFAULT_TENANT == "default"


def test_registry_changes_land_in_the_flight_recorder():
    from deepfm_tpu_torch.obs import flight

    reg = TenantRegistry([{"name": "a"}])
    reg.add({"name": "b", "source": "/b"})
    reg.remove("b")
    kinds = [e["kind"] for e in flight.render_events()[-2:]]
    assert kinds == ["tenant_added", "tenant_removed"]


def test_the_fleet_flag_reaches_the_config_as_jax_s():
    from deepfm_tpu.launch.cli import resolve_config as jax_resolve
    from deepfm_tpu_torch.launch.cli import resolve_config

    tenants = json.dumps([{"name": "prod", "source": "/p", "split_percent": 100}])
    cfg, _ = resolve_config(["--task_type", "serve", "--serve_tenants", tenants])
    jcfg, _ = jax_resolve(["--task_type", "serve", "--serve_tenants", tenants, "--no_env"])
    assert cfg.fleet.tenants == jcfg.fleet.tenants


# ------------------------------------------------------------------ shadow

def _wait(pred, secs=5.0):
    deadline = time.monotonic() + secs
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _pair(**kw):
    return ShadowScorer("challenger", "incumbent", **kw), JaxShadow("challenger", "incumbent",
                                                                    **kw)


def test_the_shadow_scores_and_sheds_as_jax_s():
    """Offers over a full, unstarted queue shed without blocking; a
    started worker scores the gap; the same offers give both packages the
    same stats."""
    rng = np.random.default_rng(0)
    gaps = rng.uniform(0.0, 0.2, 32)
    stats = []
    for sh in _pair(queue_depth=4, sample_percent=50.0):
        calls = iter(gaps)
        sh.bind(lambda body, _c=calls: (200, {"predictions": [0.5 + next(_c)]}))
        t0 = time.perf_counter()
        took = [sh.offer(f"k{i}", {"instances": [i]}, [0.5]) for i in range(64)]
        assert time.perf_counter() - t0 < 0.5
        st = sh.stats()
        assert took.count(True) == 4 and st["shed_total"] == st["offered_total"] - 4 > 0
        sh.start()
        assert _wait(lambda: sh.stats()["scored_total"] == 4)
        for i in range(64, 90):
            sh.offer(f"k{i}", {}, [0.5])
            assert _wait(lambda: sh._q.empty())
        sh.stop()
        sh.start()  # the worker starts again after a stop
        for i in range(4):
            sh.offer(f"again-{i}", {}, [0.5])
        assert _wait(lambda: sh._q.empty())
        sh.stop()
        stats.append(sh.stats())
    assert stats[0] == stats[1]
    assert stats[0]["scored_total"] > 4 and stats[0]["divergence"]["count"] > 4


def test_the_shadow_counts_errors_gates_and_refuses_itself():
    for sh in _pair(queue_depth=8):
        sh.bind(lambda body: (503, {"error": "down"})).start()
        try:
            sh.offer("k", {}, [0.5])
            assert _wait(lambda: sh.stats()["errors_total"] == 1)
            sh.bind(lambda body: (200, {"predictions": [0.1, 0.2]}))
            sh.offer("k2", {}, [0.5])  # a length mismatch is an error too
            assert _wait(lambda: sh.stats()["errors_total"] == 2)
            open_gate = [False]
            sh.set_gate(lambda: open_gate[0])
            assert not sh.offer("k3", {}, [0.5]) and sh.stats()["gated_total"] == 1
            sh.set_sample_percent(0.0)
            open_gate[0] = True
            assert not sh.offer("k4", {}, [0.5])
            assert sh.stats()["scored_total"] == 0 and sh.stats()["offered_total"] == 2
        finally:
            sh.stop()
    for cls in (ShadowScorer, JaxShadow):
        with pytest.raises(ValueError, match="shadow itself"):
            cls("t", "t")
        with pytest.raises(ValueError, match="bind"):
            cls("c", "i").start()


def test_the_shadow_gate_is_the_load_shed_gate():
    from deepfm_tpu_torch.serve.control.admission import LoadShedGate

    gate = LoadShedGate()
    sh = ShadowScorer("c", "i", queue_depth=4).set_gate(gate.allow_shadow)
    assert sh.offer("k", {}, [0.5])
    for _ in range(200):
        gate.note(True)
    assert not gate.allow_shadow()
    assert not sh.offer("k", {}, [0.5]) and sh.stats()["gated_total"] == 1
    text = sh.registry.render_prometheus()
    assert 'deepfm_shadow_events_total{tenant="c",event="gated"} 1' in text
