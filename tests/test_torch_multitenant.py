"""The port's multi-tenant fleet on the serving pool (``fleet/`` and
``serve/pool/``) on the CPU, after JAX's ``tests/test_multitenant.py``,
at ``FEATURE, FIELD = 64, 5``: N tenants in one member (three weight
slots each), ``X-Tenant`` selection, per-tenant generations and swaps (A's
swap leaves B bit for bit), the (tenant, generation) skew gate and the 409
attribution guard, the router's split, re-split and shadow, per-tenant
swappers and repair, the spec gates, and the pool CLI with ``--tenants``.

Each tenant's versions are JAX servables converted with
``convert.params_from_jax``; its answers are held to JAX's
``load_servable`` of the same version within ``TOL`` = 1e-5 (two
implementations of one float32 function, sums in another order).  What
the port computes twice by one path is compared exactly."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import orbax.checkpoint as ocp
import pytest

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.fleet.split import TrafficSplit as JaxSplit
from deepfm_tpu.serve import export_servable as jax_export_servable
from deepfm_tpu.serve import load_servable as jax_load_servable
from deepfm_tpu.train import create_train_state
from deepfm_tpu_torch.convert import params_from_jax
from deepfm_tpu_torch.core.config import load_config
from deepfm_tpu_torch.fleet import ShadowScorer, TrafficSplit
from deepfm_tpu_torch.online.publisher import ModelPublisher
from deepfm_tpu_torch.serve.export import export_servable
from deepfm_tpu_torch.serve.pool.router import start_router
from deepfm_tpu_torch.serve.pool.sharded import MEMBER_SLOTS
from deepfm_tpu_torch.serve.pool.swap import GroupSwapper
from deepfm_tpu_torch.serve.pool.worker import GroupMember, start_member

ROOT = Path(__file__).resolve().parent.parent
FEATURE, FIELD = 64, 5
BUCKETS = (4, 8)
TOL = 1e-5
# each (tenant, version)'s weights: the base state moved by a constant
DELTAS = {("A", 1): 0.05, ("B", 1): -0.05, ("A", 2): 0.11, ("C", 1): 0.02}


def _jax_cfg(**model):
    return JaxConfig.from_dict({"model": {
        "feature_size": FEATURE, "field_size": FIELD, "embedding_size": 4,
        "deep_layers": (8,), "dropout_keep": (1.0,), "compute_dtype": "float32", **model}})


def _perturbed(state, delta: float):
    import jax

    from deepfm_tpu.train.step import TrainState

    params = jax.tree_util.tree_map(lambda x: x + delta if x.dtype == np.float32 else x,
                                    state.params)
    return TrainState(step=state.step + 1, params=params, model_state=state.model_state,
                      opt_state=state.opt_state, rng=state.rng)


def _jax_version(jcfg, state, d: Path):
    """A JAX servable of ``state`` at ``d`` and the port's state dict of it."""
    jax_export_servable(jcfg, state, d)
    ckptr = ocp.StandardCheckpointer()
    payload = ckptr.restore(str(d / "params"))
    ckptr.close()
    return params_from_jax(payload["params"], payload["model_state"], load_config(d))


@pytest.fixture(scope="module")
def fleet_env(tmp_path_factory):
    """The base servable (JAX's and the port's), and each tenant's versions
    as JAX servables and port state dicts; tenants A and B have v1 in
    their own publish roots."""
    root = tmp_path_factory.mktemp("fleet")
    jcfg = _jax_cfg()
    state = create_train_state(jcfg)
    base_sd = _jax_version(jcfg, state, root / "jax_base")
    cfg = load_config(root / "jax_base")
    servable = export_servable(cfg, base_sd, root / "servable")
    jdirs, sds = {}, {}
    for (t, v), delta in DELTAS.items():
        jdirs[t, v] = root / f"jax_{t}{v}"
        sds[t, v] = _jax_version(jcfg, _perturbed(state, delta), jdirs[t, v])
    roots = {t: str(root / f"publish_{t}") for t in ("A", "B")}
    for t, r in roots.items():
        assert ModelPublisher(r).publish(cfg, sds[t, 1], step=1).version == 1
    return {"cfg": cfg, "servable": servable, "roots": roots, "jdirs": jdirs, "sds": sds,
            "root": root, "jcfg": jcfg, "state": state}


def _instances(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"feat_ids": rng.integers(0, FEATURE, FIELD).tolist(),
             "feat_vals": rng.random(FIELD).round(4).tolist()} for _ in range(n)]


def _jax_scores(jdir, instances):
    """JAX's answers for one version (``load_servable``, as JAX's
    ``tests/test_multitenant.py _expected_scores``)."""
    predict, _ = jax_load_servable(str(jdir))
    ids = np.asarray([i["feat_ids"] for i in instances], np.int64)
    vals = np.asarray([i["feat_vals"] for i in instances], np.float32)
    return np.asarray(predict(ids, vals))


def _post(url, payload, headers=None, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def _http_error(url, payload, headers=None):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, payload, headers)
    return e.value.code, json.load(e.value)


def _start(env, tenants, **kw):
    kw = {"group": "g0", "buckets": BUCKETS, "max_wait_ms": 1.0, "device": "cpu",
          "model_parallel": 2, "staging_dir": str(env["root"] / f"stage_{time.time_ns()}"),
          **kw}
    return start_member(env["servable"], tenants=tenants, **kw)


def _ab(env):
    return [{"name": t, "source": env["roots"][t], "split_percent": 50} for t in ("A", "B")]


@pytest.fixture(scope="module")
def member_env(fleet_env):
    h, u, m = _start(fleet_env, _ab(fleet_env))
    for t in ("A", "B"):  # both tenants on their published v1
        _post(f"{u}/admin:stage", {"version": 1, "tenant": t})
        _post(f"{u}/admin:commit", {"generation": 1, "version": 1, "tenant": t})
    yield {**fleet_env, "url": u, "member": m}
    h.shutdown()
    m.close()


def _predict(env, inst, tenant, **headers):
    return _post(f"{env['url']}/v1/models/deepfm:predict", {"instances": inst},
                 headers={"X-Tenant": tenant, **headers})


# ------------------------------------------------------------------ member

def test_tenants_share_one_member_s_slots_and_graph_set(member_env):
    m = member_env["member"]
    assert m.tenant_names() == ["A", "B"] and set(m.tenant_compile_secs) == {"A", "B"}
    assert m.predictor.slots == 2 * MEMBER_SLOTS
    assert [m._tenant(t).base for t in ("A", "B")] == [0, MEMBER_SLOTS]
    # each tenant's live slot is its own; the engines are one a tenant
    assert m._tenant("A").holder.get() in range(0, MEMBER_SLOTS)
    assert m._tenant("B").holder.get() in range(MEMBER_SLOTS, 2 * MEMBER_SLOTS)
    assert m._tenant("A").engine is not m._tenant("B").engine


@pytest.mark.parametrize("tenant", ["A", "B"])
def test_each_tenant_s_answers_are_held_to_jax(member_env, tenant):
    env = member_env
    inst = _instances(5)
    doc = _predict(env, inst, tenant)
    assert (doc["tenant"], doc["shard_group"], doc["group_generation"],
            doc["model_version"]) == (tenant, "g0", 1, 1)
    np.testing.assert_allclose(np.asarray(doc["predictions"], np.float32),
                               _jax_scores(env["jdirs"][tenant, 1], inst), rtol=0, atol=TOL)
    other = _predict(env, inst, "B" if tenant == "A" else "A")
    assert np.abs(np.asarray(doc["predictions"]) - np.asarray(other["predictions"])).max() > 1e-3


def test_a_swap_of_one_tenant_leaves_the_other_bit_for_bit(member_env):
    """A's stage, commit and rollback move only A's generation, version,
    slots and answers; B's answers are the same bytes throughout, and
    nothing is captured (the slot count and graph count are constant)."""
    env, m = member_env, member_env["member"]
    inst = _instances(6, seed=1)
    b_before = _predict(env, inst, "B")
    counts = (m.graph_count, m.predictor.slots)
    ModelPublisher(env["roots"]["A"]).publish(env["cfg"], env["sds"]["A", 2], step=2)
    _post(f"{env['url']}/admin:stage", {"version": 2, "tenant": "A"})
    assert _predict(env, inst, "B")["predictions"] == b_before["predictions"]
    doc = _post(f"{env['url']}/admin:commit", {"generation": 2, "version": 2, "tenant": "A"})
    assert (doc["tenant"], doc["model_version"]) == ("A", 2)
    ready = _get(f"{env['url']}/readyz")
    assert ready["tenants"] == {"A": {"generation": 2, "model_version": 2},
                                "B": {"generation": 1, "model_version": 1}}
    a2 = _predict(env, inst, "A")
    np.testing.assert_allclose(np.asarray(a2["predictions"], np.float32),
                               _jax_scores(env["jdirs"]["A", 2], inst), rtol=0, atol=TOL)
    b_after = _predict(env, inst, "B")
    assert b_after["predictions"] == b_before["predictions"]
    assert b_after["group_generation"] == b_before["group_generation"] == 1
    doc = _post(f"{env['url']}/admin:rollback", {"tenant": "A"})
    assert (doc["tenant"], doc["model_version"], doc["group_generation"]) == ("A", 1, 1)
    assert _predict(env, inst, "B")["predictions"] == b_before["predictions"]
    assert (m.graph_count, m.predictor.slots) == counts


def test_the_skew_gate_is_keyed_by_tenant_and_generation(member_env):
    env = member_env
    inst = _instances(2)
    gen = {t: g["generation"] for t, g in _get(f"{env['url']}/readyz")["tenants"].items()}
    code, err = _http_error(f"{env['url']}/v1/models/deepfm:predict", {"instances": inst},
                            {"X-Tenant": "A", "X-Pinned-Generation": str(gen["A"] - 1)})
    assert code == 409 and (err["tenant"], err["group_generation"]) == ("A", gen["A"])
    doc = _predict(env, inst, "B", **{"X-Pinned-Generation": str(gen["B"])})
    assert doc["tenant"] == "B"
    snap = _get(f"{env['url']}/v1/metrics")
    assert snap["tenants"]["A"]["skew_aborts_total"] >= 1
    assert snap["tenants"]["B"]["skew_aborts_total"] == 0


def test_the_attribution_guard_409s_when_the_generation_moves_mid_request(fleet_env,
                                                                          tmp_path):
    env = fleet_env
    root = str(tmp_path / "pub_A")
    pub = ModelPublisher(root)
    pub.publish(env["cfg"], env["sds"]["A", 1], step=1)
    pub.publish(env["cfg"], env["sds"]["A", 2], step=2)
    h, url, m = _start(env, [{"name": "A", "source": root, "split_percent": 100}])
    try:
        _post(f"{url}/admin:stage", {"version": 1, "tenant": "A"})
        _post(f"{url}/admin:commit", {"generation": 1, "version": 1, "tenant": "A"})
        _post(f"{url}/admin:stage", {"version": 2, "tenant": "A"})
        ts = m._tenant("A")
        inner, fired = ts.engine, []

        class MidSwapEngine:
            def __getattr__(self, attr):
                return getattr(inner, attr)

            def score_instances(self, instances, **kw):
                out = inner.score_instances(instances, **kw)
                if not fired:
                    fired.append(True)
                    m.commit(2, 2, tenant="A")
                return out

        ts.engine = MidSwapEngine()
        inst = _instances(3, seed=3)
        code, err = _http_error(f"{url}/v1/models/deepfm:predict", {"instances": inst},
                                {"X-Tenant": "A"})
        assert code == 409 and fired and "moved mid-request" in err["error"]
        assert (err["tenant"], err["group_generation"]) == ("A", 2)
        assert _get(f"{url}/v1/metrics")["tenants"]["A"]["skew_aborts_total"] >= 1
        ts.engine = inner
        doc = _post(f"{url}/v1/models/deepfm:predict", {"instances": inst},
                    headers={"X-Tenant": "A"})
        assert (doc["group_generation"], doc["model_version"]) == (2, 2)
        np.testing.assert_allclose(np.asarray(doc["predictions"], np.float32),
                                   _jax_scores(env["jdirs"]["A", 2], inst), rtol=0, atol=TOL)
    finally:
        h.shutdown()
        m.close()


def test_an_unknown_tenant_is_a_400(member_env):
    url = member_env["url"]
    code, err = _http_error(f"{url}/v1/models/deepfm:predict", {"instances": _instances(1)},
                            {"X-Tenant": "nope"})
    assert code == 400 and sorted(err["tenants"]) == ["A", "B"]
    for verb, body in (("stage", {"version": 1}), ("commit", {"generation": 9, "version": 1}),
                       ("rollback", {}), ("abort", {})):
        code, err = _http_error(f"{url}/admin:{verb}", {**body, "tenant": "nope"})
        assert code == 400 and "unknown tenant 'nope'" in err["error"]


@pytest.fixture(scope="module")
def jax_member(fleet_env):
    """JAX's member with tenants A and B over the same servable (its own
    publish roots: JAX's versions), for the metrics schema."""
    from deepfm_tpu.online.publisher import ModelPublisher as JaxPublisher
    from deepfm_tpu.serve.pool.sharded import build_serve_mesh
    from deepfm_tpu.serve.pool.worker import start_member as jax_start_member

    env = fleet_env
    jax_base = env["root"] / "jax_member_servable"
    jax_export_servable(env["jcfg"], env["state"], jax_base)
    roots = {}
    for t, delta in (("A", 0.05), ("B", -0.05)):
        roots[t] = str(env["root"] / f"jax_publish_{t}")
        JaxPublisher(roots[t]).publish(env["jcfg"], _perturbed(env["state"], delta))
    h, u, m = jax_start_member(
        str(jax_base), build_serve_mesh(1, 2), group="g0", buckets=BUCKETS, max_wait_ms=1.0,
        tenants=[{"name": t, "source": roots[t], "split_percent": 50} for t in ("A", "B")])
    for t in ("A", "B"):
        _post(f"{u}/admin:stage", {"version": 1, "tenant": t})
        _post(f"{u}/admin:commit", {"generation": 1, "version": 1, "tenant": t})
    yield u
    h.shutdown()
    m.close()


def test_the_tenants_metrics_and_readiness_keys_equal_jax_s(member_env, jax_member):
    port, jax = _get(f"{member_env['url']}/v1/metrics"), _get(f"{jax_member}/v1/metrics")
    assert set(port["tenants"]) == set(jax["tenants"]) == {"A", "B"}
    for t in ("A", "B"):
        assert set(port["tenants"][t]) == set(jax["tenants"][t])
        assert set(port["tenants"][t]["engine"]) == set(jax["tenants"][t]["engine"])
    pr, jr = _get(f"{member_env['url']}/readyz"), _get(f"{jax_member}/readyz")
    assert {t: set(d) for t, d in pr["tenants"].items()} == {
        t: set(d) for t, d in jr["tenants"].items()}
    inst = _instances(2)
    for url in (member_env["url"], jax_member):
        doc = _predict({"url": url}, inst, "B")
        assert (doc["tenant"], doc["shard_group"]) == ("B", "g0")
    # the binary path carries the tenant's headers
    ids, vals = np.zeros((2, FIELD), "<i8"), np.ones((2, FIELD), "<f4")
    body = np.array([2, FIELD], "<u4").tobytes() + ids.tobytes() + vals.tobytes()
    req = urllib.request.Request(f"{member_env['url']}/v1/models/deepfm:predict_binary",
                                 data=body, headers={"X-Tenant": "B"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert (r.headers["X-Tenant"], r.headers["X-Shard-Group"]) == ("B", "g0")
        r.read()


# ------------------------------------------------------------------ router

@pytest.fixture()
def fleet_router(member_env):
    shadow = ShadowScorer("B", "A", sample_percent=100.0, queue_depth=64)
    httpd, url, router = start_router({"g0": [member_env["url"]]},
                                      split=TrafficSplit({"A": 50.0, "B": 50.0}),
                                      shadow=shadow, probe_interval_secs=0.2)
    yield {**member_env, "rurl": url, "router": router, "shadow": shadow}
    httpd.shutdown()
    router.close()


def test_the_router_splits_as_jax_s_split_and_pins_per_tenant(fleet_router):
    env = fleet_router
    inst = _instances(2)
    jax_split = JaxSplit({"A": 50.0, "B": 50.0})
    seen = set()
    for i in range(40):
        doc = _post(f"{env['rurl']}/v1/models/deepfm:predict",
                    {"key": f"user-{i}", "instances": inst})
        assert doc["tenant"] == doc["router"]["tenant"] == jax_split.arm(f"user-{i}")
        seen.add(doc["tenant"])
    assert seen == {"A", "B"}
    doc = _post(f"{env['rurl']}/v1/models/deepfm:predict",
                {"key": "user-0", "instances": inst}, headers={"X-Tenant": "B"})
    assert doc["tenant"] == "B"
    snap = _get(f"{env['rurl']}/v1/metrics")
    assert snap["tenants"]["A"]["requests_total"] > 0 and snap["tenants"]["A"][
        "split_percent"] == 50.0
    assert snap["groups"]["g0"]["tenant_generations"] == {"A": 1, "B": 1}
    # a stale (group, tenant) pin re-pins on the 409 and retries in place
    env["router"]._generation[("g0", "A")] = 0
    doc = _post(f"{env['rurl']}/v1/models/deepfm:predict", {"instances": inst},
                headers={"X-Tenant": "A"})
    assert doc["router"]["attempts"] == 2 and env["router"].skew_aborts_total >= 1


def test_a_resplit_moves_only_the_shifted_window_and_refuses_unknown_arms(fleet_router):
    env = fleet_router
    split = env["router"]._split
    keys = [f"user-{i}" for i in range(400)]
    before = {k: split.arm(k) for k in keys}
    doc = _post(f"{env['rurl']}/admin:split", {"percentages": {"A": 80.0, "B": 20.0}})
    assert doc["arms"] == {"A": 80.0, "B": 20.0}
    jax_split = JaxSplit({"A": 50.0, "B": 50.0})
    jax_split.set_percentages({"A": 80.0, "B": 20.0})
    moved = [k for k in keys if split.arm(k) != before[k]]
    assert moved and all(split.arm(k) == "A" == jax_split.arm(k) for k in moved)
    assert [k for k in keys if jax_split.arm(k) != before[k]] == moved
    code, err = _http_error(f"{env['rurl']}/admin:split",
                            {"percentages": {"A": 90.0, "B_typo": 10.0}})
    assert code == 400 and "B_typo" in err["error"] and split.arms() == {"A": 80.0, "B": 20.0}
    _post(f"{env['rurl']}/admin:split", {"percentages": {"A": 50.0, "B": 50.0}})
    assert {k: split.arm(k) for k in keys} == before


def test_the_shadow_scores_the_live_stream_and_leaves_the_answers(fleet_router):
    env = fleet_router
    inst = _instances(3, seed=2)
    want = _predict(env, inst, "A")["predictions"]
    docs = [_post(f"{env['rurl']}/v1/models/deepfm:predict",
                  {"key": f"sh-{i}", "instances": inst}, headers={"X-Tenant": "A"})
            for i in range(10)]
    assert all(d["tenant"] == "A" and d["predictions"] == want for d in docs)
    deadline = time.monotonic() + 10
    while env["shadow"].stats()["scored_total"] < 10 and time.monotonic() < deadline:
        time.sleep(0.05)
    st = env["shadow"].stats()
    assert st["scored_total"] >= 10 and st["errors_total"] == 0
    gap = np.abs(np.asarray(want) - np.asarray(_predict(env, inst, "B")["predictions"]))
    assert st["divergence"]["p50"] == pytest.approx(float(gap.mean()), abs=1e-6)
    assert _get(f"{env['rurl']}/v1/metrics")["tenants"]["B"]["shadow"]["scored_total"] >= 10


# ------------------------------------------------------------ swap, gates

def test_per_tenant_swappers_converge_independently(fleet_env):
    env = fleet_env
    roots = {t: str(env["root"] / f"swap_publish_{t}") for t in ("A", "B")}
    for t, r in roots.items():
        ModelPublisher(r).publish(env["cfg"], env["sds"][t, 1], step=1)
    h, u, m = _start(env, [{"name": t, "source": roots[t], "split_percent": 50}
                           for t in ("A", "B")])
    try:
        swappers = {t: GroupSwapper([u], roots[t], group="g0", tenant=t) for t in ("A", "B")}
        assert all(s.poll_once() is True for s in swappers.values())
        ModelPublisher(roots["A"]).publish(env["cfg"], env["sds"]["A", 2], step=2)
        assert swappers["A"].poll_once() is True and swappers["B"].poll_once() is False
        assert _get(f"{u}/readyz")["tenants"] == {"A": {"generation": 2, "model_version": 2},
                                                  "B": {"generation": 1, "model_version": 1}}
        assert swappers["A"].status()["tenant"] == "A"
        timings = _get(f"{u}/v1/metrics")["reload"]["tenant_timings"]
        assert timings["A"]["last_swap_ms"] is not None
    finally:
        h.shutdown()
        m.close()
    # a "respawned" member: every tenant at generation 0 on the base
    # servable, re-converged tenant by tenant by the repair pass
    h, u, m = _start(env, [{"name": t, "source": roots[t], "split_percent": 50}
                           for t in ("A", "B")])
    try:
        for t, s in swappers.items():
            fresh = GroupSwapper([u], roots[t], group="g0", tenant=t)
            fresh.generation, fresh.version = s.generation, s.version
            assert fresh.repair_once() == 1
        assert _get(f"{u}/readyz")["tenants"] == {"A": {"generation": 2, "model_version": 2},
                                                  "B": {"generation": 1, "model_version": 1}}
    finally:
        h.shutdown()
        m.close()


def test_a_spec_divergent_tenant_is_refused(fleet_env, tmp_path):
    """At load (the split must cover 100) and at stage time: a version
    whose model section diverges on an executable-spec field is refused
    with JAX's message naming the field, and the tenant stays live."""
    env = fleet_env
    with pytest.raises(ValueError, match="sum to 100"):
        _start(env, [{"name": "A", "source": "", "split_percent": 10}])
    wide = _jax_cfg(embedding_size=8)
    sd = _jax_version(wide, create_train_state(wide), tmp_path / "wide")
    root = str(tmp_path / "pub_wide")
    ModelPublisher(root).publish(load_config(tmp_path / "wide"), sd, step=1)
    h, u, m = _start(env, [{"name": "A", "source": root, "split_percent": 100}])
    try:
        code, err = _http_error(f"{u}/admin:stage", {"version": 1, "tenant": "A"})
        assert code == 400 and "diverges from the group's executable spec on " \
                               "['embedding_size']" in err["error"]
        assert m.stage_failures_total == 1 and m._tenant("A").holder.version == 0
    finally:
        h.shutdown()
        m.close()


def test_a_funnel_member_refuses_tenants_with_jax_s_message(fleet_env, tmp_path):
    from deepfm_tpu.serve.pool.sharded import build_serve_mesh
    from deepfm_tpu.serve.pool.worker import GroupMember as JaxMember

    d = tmp_path / "funnel_servable"
    d.mkdir()
    (d / "funnel.json").write_text("{}")
    with pytest.raises(ValueError) as port:
        GroupMember(str(d), device="cpu", tenants=_ab(fleet_env))
    with pytest.raises(ValueError) as jax:
        JaxMember(str(d), build_serve_mesh(1, 2), tenants=_ab(fleet_env))
    assert str(port.value) == str(jax.value)


def test_concurrent_tenants_show_no_cross_talk(member_env):
    """Three clients a tenant at once: every answer is its tenant's
    version's answer (the dispatch lock keeps the shared bucket buffers
    to one replay at a time; on the CPU the slots run eagerly)."""
    env = member_env
    inst = _instances(4, seed=3)
    want = {t: _predict(env, inst, t)["predictions"] for t in ("A", "B")}
    for t in ("A", "B"):
        np.testing.assert_allclose(np.asarray(want[t], np.float32),
                                   _jax_scores(env["jdirs"][t, 1], inst), rtol=0, atol=TOL)
    errors = []

    def client(t):
        try:
            for _ in range(15):
                doc = _predict(env, inst, t)
                assert doc["tenant"] == t and doc["predictions"] == want[t]
        except Exception as e:
            errors.append(f"{t}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(t,)) for t in ("A", "B") for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often, to surface a lost update
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors


# -------------------------------------------------------------- the CLI

def _free_port_block(n: int) -> int:
    rng = np.random.default_rng(os.getpid() + 7)
    for _ in range(200):
        base = int(rng.integers(20000, 50000))
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                s.bind(("127.0.0.1", p))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port block")


def test_the_pool_cli_runs_a_fleet(fleet_env, tmp_path):
    """``python -m deepfm_tpu_torch.serve.pool --tenants @file``: each
    tenant's swapper adopts its v1, keyed requests land on the split's
    arm with that tenant's JAX answers, the challenger shadows A, and
    SIGTERM stops the tree with one kernel-runs line."""
    env = fleet_env
    roots = {t: str(tmp_path / f"publish_{t}") for t in ("A", "B", "C")}
    for t, r in roots.items():
        ModelPublisher(r).publish(env["cfg"], env["sds"][t, 1], step=1)
    tenants = [{"name": "A", "source": roots["A"], "split_percent": 50},
               {"name": "B", "source": roots["B"], "split_percent": 50},
               {"name": "C", "source": roots["C"], "shadow_of": "A"}]
    spec = tmp_path / "tenants.json"
    spec.write_text(json.dumps(tenants))
    base = _free_port_block(2)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepfm_tpu_torch.serve.pool", "--servable", env["servable"],
         "--router", "--groups", "1", "--port", str(base), "--member-port-base", str(base + 1),
         "--buckets", "4,8", "--health-interval", "0.2", "--reload-interval", "0.2",
         "--tenants", f"@{spec}", "--shadow-sample", "100", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(ROOT), stdout=subprocess.PIPE,
        text=True)
    rurl, murl = f"http://127.0.0.1:{base}", f"http://127.0.0.1:{base + 1}"
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                ready = _get(f"{murl}/readyz", timeout=2)
                if all(d["model_version"] == 1 for d in ready["tenants"].values()):
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert set(ready["tenants"]) == {"A", "B", "C"}
        assert all(d["model_version"] == 1 for d in ready["tenants"].values())
        inst = _instances(3, seed=5)
        want = {t: _jax_scores(env["jdirs"][t, 1], inst) for t in ("A", "B")}
        split = TrafficSplit({"A": 50.0, "B": 50.0})
        for i in range(16):
            doc = _post(f"{rurl}/v1/models/deepfm:predict", {"key": f"k{i}", "instances": inst})
            assert doc["tenant"] == split.arm(f"k{i}")
            np.testing.assert_allclose(np.asarray(doc["predictions"], np.float32),
                                       want[doc["tenant"]], rtol=0, atol=TOL)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            shadow = _get(f"{rurl}/v1/metrics")["tenants"]["C"]["shadow"]
            if shadow["scored_total"] and shadow["scored_total"] == shadow["offered_total"]:
                break
            time.sleep(0.2)
        assert shadow["scored_total"] > 0 and shadow["errors_total"] == 0
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    lines = [json.loads(x) for x in out.splitlines() if x.startswith('{"kind": "kernel_runs"')]
    assert [x["role"] for x in lines] == ["member:g0"]
