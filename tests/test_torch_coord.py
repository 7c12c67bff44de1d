"""The port's coordination (deepfm_tpu_torch/elastic/coord.py) against
JAX's (deepfm_tpu/elastic/coord.py).

* The same request sequences (acquire, heartbeat, ack, release, status,
  on fake clocks: joins, drains, expiry, TTL clamps, barrier timeouts and
  restarts, publishers, bad requests) sent to JAX's ``Coordinator`` and to
  the port's give the same responses: epochs, phases, transitions,
  tokens, lease ids and expiry.
* The port's ``CoordClient`` against JAX's coordinator server answers as
  JAX's client does, faults and expiry included.
* ``Fence`` on a local root and on an object-store URL (the port's dev
  store); JAX's ``read_fence`` reads the port's mark and the reverse;
  ``commit_payload`` and ``ModelPublisher.publish`` refuse a stale token.
* ``CoordinatedRegistry``: two registries reshard together, the frozen
  topology under an outage and its thaw, the self-fence on expiry and the
  re-admission, against both packages' servers.
"""

import pytest

from deepfm_tpu.elastic import coord as jax_coord
from deepfm_tpu_torch.elastic import coord as port_coord
from deepfm_tpu_torch.elastic.registry import RankDevice, VirtualDeviceRegistry

IMPLS = {"jax": jax_coord, "port": port_coord}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.mark.parametrize("views", [
    {"p0": (0, 1, 2, 3), "p1": (1, 2, 3, 9)}, {"p1": (1, 2, 3, 9), "p0": (0, 1, 2, 3)},
    {"p0": (3, 1, 2), "p1": (1, 2, 3)}, {}, {"p0": ()}])
def test_merge_views_as_jax(views):
    assert port_coord.merge_views(views) == jax_coord.merge_views(views)


# each scenario: steps of (op, pid, kwargs); "T" in an ack is the
# coordinator's current transition, a number in "advance" moves the clock
SCENARIOS = {
    "join_reshard_steady": [
        ("acquire", "p0", {"view": [0, 1, 2, 3]}), ("ack", "p0", "reshard"),
        ("heartbeat", "p0", {"view": [0, 1, 2, 3], "on_epoch": 1}), ("status",)],
    "two_trainers_drain": [
        ("acquire", "pA", {"view": list(range(8))}), ("ack", "pA", "reshard"),
        ("acquire", "pB", {"view": list(range(8))}), ("ack", "pA", "drain"),
        ("ack", "pA", "reshard"), ("ack", "pB", "reshard"),
        ("heartbeat", "pA", {"view": [0, 1, 2, 3]}), ("ack", "pA", "drain"),
        ("ack", "pB", "drain"), ("ack", "pA", "reshard"), ("ack", "pB", "reshard"),
        ("status",)],
    "expiry_stales_token": [
        ("acquire", "pA", {"view": [0, 1]}), ("ack", "pA", "reshard"),
        ("acquire", "pB", {"view": [0, 1]}), ("ack", "pA", "drain"),
        ("ack", "pA", "reshard"), ("ack", "pB", "reshard"), ("advance", 6),
        ("heartbeat", "pA", {}), ("advance", 6), ("heartbeat", "pB", {}),
        ("heartbeat", "pA", {}), ("status",)],
    "ttl_clamp_and_bad_ttl": [
        ("acquire", "p0", {"view": [0], "ttl_secs": 3.0}),
        ("acquire", "p1", {"view": [0], "ttl_secs": 99.0}),
        ("acquire", "p2", {"view": [0], "ttl_secs": "soon"}),
        ("acquire", "p3", {"view": [0], "ttl_secs": float("nan")}),
        ("acquire", "p4", {"role": "judge"}), ("advance", 4), ("status",)],
    "barrier_timeout_evicts": [
        ("acquire", "pA", {"view": [0, 1, 2, 3]}), ("ack", "pA", "reshard"),
        ("acquire", "pB", {"view": [0, 1, 2, 3]}), ("ack", "pA", "drain"),
        ("ack", "pA", "reshard"), ("ack", "pB", "reshard"),
        ("heartbeat", "pA", {"view": [0, 1]}), ("ack", "pA", "drain"),
        ("advance", 7), ("heartbeat", "pA", {}), ("status",)],
    "restart_invalidates_acks_and_publisher": [
        ("acquire", "pub", {"role": "publish"}), ("acquire", "pA", {"view": [0, 1, 2, 3]}),
        ("ack", "pA", "reshard"), ("heartbeat", "pA", {"view": [0, 1, 2]}),
        ("ack", "pA", "drain"), ("heartbeat", "pA", {"view": [0, 1]}),
        ("ack", "pA", "reshard"), ("heartbeat", "pub", {}), ("release", "pA"),
        ("heartbeat", "pA", {}), ("acquire", "pub", {"role": "publish"}), ("status",)],
}


def _transcript(impl, steps) -> list:
    clock = FakeClock()
    co = impl.Coordinator(lease_ttl_secs=10, barrier_timeout_secs=5, clock=clock)
    leases, out = {}, []
    for op, *args in steps:
        try:
            if op == "advance":
                clock.advance(args[0])
                continue
            if op == "status":
                out.append(co.status())
                continue
            pid = args[0]
            if op == "acquire":
                r = co.acquire(pid, **args[1])
                leases[pid] = r["lease"]["lease_id"]
            elif op == "heartbeat":
                r = co.heartbeat(pid, leases.get(pid, ""), **args[1])
            elif op == "ack":
                r = co.ack(pid, leases.get(pid, ""), args[1], co.transition)
            else:
                r = co.release(pid, leases.get(pid, ""))
            out.append(r)
        except Exception as e:  # the same refusals, by kind and message
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_the_coordinators_answer_alike(name):
    want = _transcript(jax_coord, SCENARIOS[name])
    assert _transcript(port_coord, SCENARIOS[name]) == want
    assert any(isinstance(r, dict) for r in want)


@pytest.mark.parametrize("leave", ["expire", "release"])
def test_an_owned_device_leaves_the_consensus_with_its_lease(leave):
    """A train lease that owns its device: when it goes (expiry without
    notice, or release) the device leaves the next epoch although every
    other view still lists it; a new lease owning it brings it back; once
    the last trainer is gone a new job starts from the views alone.  JAX's
    coordinator knows no owners: there the dead device stays."""
    clock = FakeClock()
    co = port_coord.Coordinator(lease_ttl_secs=10, barrier_timeout_secs=0, clock=clock)
    jco = jax_coord.Coordinator(lease_ttl_secs=10, barrier_timeout_secs=0, clock=clock)
    lease, jlease = {}, {}
    for i in range(3):
        lease[i] = co.acquire(f"d{i}", view=[0, 1, 2], owns=[i])["lease"]["lease_id"]
        jlease[i] = jco.acquire(f"d{i}", view=[0, 1, 2])["lease"]["lease_id"]
    for c, ids in ((co, lease), (jco, jlease)):
        for i in range(3):
            c.ack(f"d{i}", ids[i], "reshard", c.transition)
    assert co.status()["consensus"]["devices"] == [0, 1, 2]
    if leave == "expire":
        clock.advance(6)
        for c, ids in ((co, lease), (jco, jlease)):
            for i in (0, 1):
                c.heartbeat(f"d{i}", ids[i], view=[0, 1, 2], on_epoch=c.epoch)
        clock.advance(6)
    else:
        co.release("d2", lease[2])
    c = co.status()["consensus"]
    assert (c["phase"], c["pending_devices"]) == ("drain", [0, 1])
    if leave == "expire":
        assert jco.status()["consensus"]["pending_devices"] == [0, 1, 2]
    for i in (0, 1):
        co.ack(f"d{i}", lease[i], "drain", co.transition)
    assert co.status()["consensus"]["devices"] == [0, 1]
    lease[2] = co.acquire("d2", view=[0, 1, 2], owns=[2])["lease"]["lease_id"]
    assert co.status()["consensus"]["pending_devices"] == [0, 1, 2]
    for i in range(3):
        co.release(f"d{i}", lease[i])
    co.acquire("d0", view=[0, 1, 2], owns=[0])
    assert co.status()["consensus"]["pending_devices"] == [0, 1, 2]
    with pytest.raises(ValueError, match="owns"):
        co.acquire("d9", view=[0], owns="x")


def _served(impl, clock=None):
    kw = {"clock": clock} if clock is not None else {}
    return impl.serve_coordinator(impl.Coordinator(lease_ttl_secs=10, **kw))


@pytest.mark.parametrize("client", ["jax", "port"])
def test_a_client_against_jax_server(client):
    """JAX's server: the port's client sees what JAX's client sees."""
    impl = IMPLS[client]
    clock = FakeClock()
    server, url, _ = _served(jax_coord, clock)
    try:
        cl = impl.CoordClient(url, "p0", lease_ttl_secs=5.0)
        r = cl.acquire(view=[0, 1])
        assert cl.token == r["lease"]["token"] and cl.granted_ttl == 5.0
        cl.ack("reshard", r["consensus"]["transition"])
        assert cl.heartbeat(view=[0, 1], on_epoch=1)["consensus"]["phase"] == "steady"
        server.fault_plan.set_rules([{"verb": "*", "key": "*", "status": 503}])
        with pytest.raises(impl.CoordUnreachableError):
            cl.heartbeat(view=[0, 1])
        server.fault_plan.clear()
        cl.breaker._opened_at = -1e9
        assert cl.heartbeat(view=[0, 1])["consensus"]["epoch"] == 1
        assert cl.clamp_interval(1.0, event="x") == 1.0
        assert cl.clamp_interval(4.0, event="x") == 1.25
        clock.advance(6)
        with pytest.raises(impl.LeaseExpired):
            cl.heartbeat(view=[0, 1])
        assert cl.breaker.state == "closed"
        cl.release()
    finally:
        server.shutdown()
        server.server_close()


# -- fences -------------------------------------------------------------------

def _fence_roots(tmp_path):
    from deepfm_tpu_torch.utils.dev_object_store import serve

    server, base = serve(str(tmp_path / "store"))
    return server, [str(tmp_path / "local"), f"{base}/bucket/root"]


def test_fences_on_local_and_url_roots(tmp_path):
    server, roots = _fence_roots(tmp_path)
    try:
        for root in roots:
            assert port_coord.read_fence(root) == jax_coord.read_fence(root) == 0
            port_coord.Fence(root, 3, holder="a").advance()
            assert jax_coord.read_fence(root) == 3
            jax_coord.write_fence(root, 5, holder="jax")
            assert port_coord.read_fence(root) == 5
            with pytest.raises(port_coord.StaleFencingTokenError, match="stale"):
                port_coord.Fence(root, 4).check()
            port_coord.Fence(root, 5).advance()  # equal: no refusal, no write
            port_coord.Fence(root, 7).advance()
            assert port_coord.read_fence(root) == 7
    finally:
        server.shutdown()
        server.server_close()


def test_commit_and_publish_refuse_a_stale_token(tmp_path):
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.online import ModelPublisher, latest_manifest
    from deepfm_tpu_torch.online.stream import StreamCursor
    from deepfm_tpu_torch.online.trainer import OnlinePayload, commit_payload
    from deepfm_tpu_torch.train.step import create_train_state

    cfg = Config.from_dict({"model": {"feature_size": 16, "field_size": 3,
                                      "embedding_size": 2, "deep_layers": (4,)}})
    state = create_train_state(cfg, "cpu")
    ck = Checkpointer(tmp_path / "ckpt")
    commit_payload(ck, state, StreamCursor("s", 1), fence=port_coord.Fence(str(tmp_path / "ckpt"), 4))
    assert port_coord.read_fence(str(tmp_path / "ckpt")) == 4
    payload = ck.restore(OnlinePayload.wrap(create_train_state(cfg, "cpu"), StreamCursor()))
    assert int(payload.fence_token) == 4
    state.step = 1
    with pytest.raises(port_coord.StaleFencingTokenError):
        commit_payload(ck, state, StreamCursor("s", 2),
                       fence=port_coord.Fence(str(tmp_path / "ckpt"), 3))
    assert ck.all_steps() == [0]
    pub = ModelPublisher(str(tmp_path / "pub"))
    sd = state.model.state_dict()
    pub.publish(cfg, sd, step=1, fence=port_coord.Fence(str(tmp_path / "pub"), 9))
    assert latest_manifest(str(tmp_path / "pub")).extra["fence_token"] == 9
    with pytest.raises(port_coord.StaleFencingTokenError):
        pub.publish(cfg, sd, step=2, fence=port_coord.Fence(str(tmp_path / "pub"), 8))
    assert latest_manifest(str(tmp_path / "pub")).step == 1


# -- the coordinated registry ----------------------------------------------------

def _registry(url, pid, ids=(0, 1, 2, 3)):
    local = VirtualDeviceRegistry([RankDevice(i) for i in ids])
    return local, port_coord.CoordinatedRegistry(
        local, port_coord.CoordClient(url, pid), heartbeat_interval_secs=0.0)


@pytest.mark.parametrize("server_impl", ["jax", "port"])
def test_coordinated_registries_reshard_together(server_impl):
    server, url, co = _served(IMPLS[server_impl])
    try:
        loc_a, reg_a = _registry(url, "pA", range(8))
        _, reg_b = _registry(url, "pB", range(8))
        e_a, _ = reg_a.snapshot()
        reg_a.ack_topology(e_a)
        e_j, d_j = reg_b.snapshot()
        assert e_j == e_a + 1 and d_j == ()
        assert reg_a.poll() == e_j
        reg_a.ack_drain()
        (e1a, d1a), (e1b, d1b) = reg_a.snapshot(), reg_b.snapshot()
        assert e1a == e1b == e_j and [d.id for d in d1a] == [d.id for d in d1b] == list(range(8))
        reg_a.ack_topology(e1a)
        reg_b.ack_topology(e1b)
        tok = reg_a.fence_token
        assert reg_b.fence_token == tok
        loc_a.fail(4, 5, 6, 7)
        pend = reg_a.poll()
        assert reg_a.snapshot() == (pend, ()) and reg_b.poll() == pend
        reg_a.ack_drain()
        assert reg_a.snapshot() == (pend, ())
        reg_b.ack_drain()
        e2, d2 = reg_a.snapshot()
        assert e2 == pend and [d.id for d in d2] == [0, 1, 2, 3]
        assert reg_a.fence_token == reg_b.fence_token > tok
        reg_a.ack_topology(e2)
        reg_b.ack_topology(e2)
        assert co.phase == "steady" and co.epoch == pend
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("server_impl", ["jax", "port"])
def test_registry_frozen_then_thawed_and_fenced_then_readmitted(server_impl):
    clock = FakeClock()
    server, url, co = _served(IMPLS[server_impl], clock)
    try:
        _, reg = _registry(url, "p0")
        e, d = reg.snapshot()
        reg.ack_topology(e)
        server.fault_plan.set_rules([{"verb": "*", "key": "*", "status": 503}])
        assert reg.poll() == e and reg.frozen and reg.frozen_polls > 0
        e2, d2 = reg.snapshot()
        assert e2 == e and [x.id for x in d2] == [x.id for x in d]
        server.fault_plan.clear()
        reg._client.breaker._opened_at = -1e9
        assert reg.poll() == e and not reg.frozen
        tok = reg.fence_token
        clock.advance(11)
        assert reg.poll() == -1 and reg.fenced
        server.fault_plan.set_rules(
            [{"verb": "ACQUIRE", "key": "*", "times": 2, "status": 503}])
        assert reg.snapshot() == (-1, ()) and reg.fenced
        reg._client.breaker._opened_at = -1e9  # the outages opened it: let a probe by
        assert reg.poll() >= e and not reg.fenced and reg.fence_token > tok
        reg.poll()
        assert co.status()["members"][reg._client.pid]["admitted_epoch"] is None
    finally:
        server.shutdown()
        server.server_close()
