"""Elastic coordination across processes: TTL leases, registry-view
consensus, a two-phase reshard barrier and monotone fencing tokens.  The
port's copy of ``deepfm_tpu/elastic/coord.py`` (the JAX file imports no
JAX), with two additions: ``main`` can host the rank group's rendezvous
``TCPStore`` beside the HTTP port (``--store-port``), a store that must
outlive every rank (elastic/controller.py); and a train lease may name the
devices it **owns** (a rank process's own device), which leave the
consensus when that lease goes (expired, evicted or released), even while
every other view still lists them, until a new lease owns them again.  A
rank that dies without notice is so taken out of its peers' next epoch.

Protocol (one coordinator process, N participants):

* **lease**: each participant (``role="train"`` or ``"publish"``) holds a
  TTL lease it refreshes by heartbeating its local registry view (the
  device ids it can address).  A process that stops heartbeating expires
  and drops out of consensus, and so do the devices its lease owns.
* **consensus**: the live trainers' views merge into one device set
  (:func:`merge_views`, the intersection), named by a monotone **epoch**.
* **two-phase barrier**: when the merged set changes the coordinator opens
  a transition.  Phase ``drain``: every trainer admitted to the old epoch
  finishes its step and commits.  Only once all acked, phase ``reshard``:
  the new epoch and device set become visible and every trainer rebuilds
  its group.  Then ``steady`` once all acked again.
* **fencing token**: one token per trainer cohort (the co-writers of one
  checkpoint root hold the same token), re-issued strictly newer at every
  epoch flip; each publisher incarnation gets its own newer token.
  :class:`Fence` records the high-water mark beside the data (a local
  directory or an object-store URL), and a write bearing an older token
  is refused (:class:`StaleFencingTokenError`).

Degradation (:class:`CoordinatedRegistry`): coordinator unreachable ->
**frozen** topology under a circuit breaker; lease expired ->
**self-fenced**, commit-free draining until re-admitted.

Run standalone:  python -m deepfm_tpu_torch.elastic.coord --port 8600
                 [--store-port 8601]
In tests:        serve_coordinator(Coordinator(...)) -> (server, url, coord)
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Sequence

from ..obs import flight as obs_flight
from ..obs.metrics import MetricsRegistry
from ..utils.retry import CircuitBreaker, RetryPolicy

FENCE_NAME = "_FENCE.json"


# ---------------------------------------------------------------------------
# fencing: a durable monotone high-water mark next to the data


class StaleFencingTokenError(RuntimeError):
    """A write carried a fencing token older than the root's recorded
    high-water mark — the writer missed an epoch and must not touch this
    root again until re-admitted."""


def _fence_path(root: str) -> str:
    from ..data.object_store import is_url, join_url

    return join_url(root, FENCE_NAME) if is_url(root) else os.path.join(
        root, FENCE_NAME)


def read_fence(root: str) -> int:
    """The root's recorded token high-water mark (0 = never fenced)."""
    from ..data.object_store import get_store, is_url

    path = _fence_path(root)
    try:
        if is_url(root):
            raw = get_store().get(path)
        else:
            with open(path, "rb") as f:
                raw = f.read()
    except FileNotFoundError:
        return 0
    except Exception as e:
        from ..data.object_store import ObjectStoreError

        if isinstance(e, ObjectStoreError) and e.status == 404:
            return 0
        raise
    return int(json.loads(raw.decode()).get("token", 0))


def write_fence(root: str, token: int, *, holder: str = "") -> None:
    from ..data.object_store import get_store, is_url

    doc = json.dumps({"token": int(token), "holder": holder,
                      "written_unix": time.time()}).encode()
    path = _fence_path(root)
    if is_url(root):
        get_store().put(path, doc)
        return
    os.makedirs(root, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"  # the ranks of a cohort may write at once
    with open(tmp, "wb") as f:
        f.write(doc)
    os.replace(tmp, path)


class Fence:
    """One writer's claim on one root: ``check()`` refuses when a newer
    holder already advanced the mark, ``advance()`` records this token as
    the new high-water mark (never lowers it).

    The check-then-write window is NOT atomic; the coordinator closes it
    upstream (a higher token is only issued after the old epoch drained or
    its lease expired), so the fence is the storage-level backstop that
    turns the residual zombie window into a refused write instead of a
    corrupted lineage."""

    def __init__(self, root: str, token: int, *, holder: str = ""):
        self.root = root
        self.token = int(token)
        self.holder = holder

    def check(self) -> int:
        """Refuse if a newer holder advanced the mark; returns the stored
        token so callers don't re-read it."""
        stored = read_fence(self.root)
        if stored > self.token:
            raise StaleFencingTokenError(
                f"fencing token {self.token} is stale for {self.root!r}: "
                f"recorded high-water mark is {stored} — a newer holder "
                f"was admitted; refusing the write"
            )
        return stored

    def advance(self) -> None:
        if self.check() < self.token:
            write_fence(self.root, self.token, holder=self.holder)


# ---------------------------------------------------------------------------
# consensus: the registry-view merge


def merge_views(views: dict[str, Sequence]) -> tuple:
    """Merge per-process registry views into the consensus device set:
    the INTERSECTION of every live trainer's view — a device any process
    lost is out for everyone (a synchronous program cannot address a
    device one participant cannot), and a lost device only returns once
    every process sees it again.  Order follows the view of the smallest
    participant id (all processes of one job report the same global
    order, so this is a deterministic tie-break, not a preference);
    merge is therefore order-independent across participants."""
    if not views:
        return ()
    common = None
    for ids in views.values():
        s = set(ids)
        common = s if common is None else (common & s)
    anchor = views[min(views)]
    return tuple(i for i in anchor if i in common)


# ---------------------------------------------------------------------------
# the coordinator (pure logic; HTTP layer below)


class _Member:
    __slots__ = ("pid", "role", "lease_id", "token", "expires", "ttl",
                 "view", "owns", "acked_drain", "acked_reshard", "admitted_epoch")

    def __init__(self, pid, role, lease_id, token, expires, ttl, view, owns=()):
        self.pid = pid
        self.role = role
        self.lease_id = lease_id
        self.token = token
        self.expires = expires
        self.ttl = ttl
        self.view = tuple(view)
        self.owns = tuple(owns)
        self.acked_drain = -1
        self.acked_reshard = -1
        self.admitted_epoch = None  # set on reshard ack: built a topology


class LeaseExpired(Exception):
    """Server-side: the heartbeating lease is gone — the caller must
    self-fence and re-acquire."""


class Coordinator:
    """Lease + consensus + barrier state machine.  All public methods are
    thread-safe; ``clock`` is injectable so expiry tests run on a fake
    clock with zero real sleeps."""

    def __init__(
        self,
        *,
        lease_ttl_secs: float = 10.0,
        barrier_timeout_secs: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        metrics: MetricsRegistry | None = None,
    ):
        if lease_ttl_secs <= 0:
            raise ValueError(
                f"lease_ttl_secs must be > 0, got {lease_ttl_secs}")
        self._ttl = float(lease_ttl_secs)
        # drain barriers evict live-but-stuck members after this long (a
        # DEAD member is reclaimed by the lease TTL; the timeout is the
        # backstop for one wedged process stalling the whole pod).  0
        # disables eviction.
        self._barrier_timeout = float(barrier_timeout_secs)
        self._clock = clock
        self._lock = threading.Lock()
        self._members: dict[str, _Member] = {}
        # devices whose owning train lease went and no lease owns since
        self._gone: set = set()
        self._fence_counter = 0
        self._cohort_token = 0  # the shared train-cohort token (per epoch)
        self._lease_seq = 0
        self.epoch = 0
        self.devices: tuple = ()
        self.phase = "steady"          # steady | drain | reshard
        self.transition = 0
        self._pending_devices: tuple | None = None
        self._pending_epoch: int | None = None
        self._transition_started: float | None = None
        m = metrics or MetricsRegistry()
        self.metrics = m
        self._m_epoch = m.gauge(
            "deepfm_coord_epoch", "consensus membership epoch")
        self._m_members = m.gauge(
            "deepfm_coord_members", "live leases", labels=("role",))
        self._m_transitions = m.counter(
            "deepfm_coord_transitions_total", "barrier transitions opened")
        self._m_expired = m.counter(
            "deepfm_coord_leases_expired_total", "leases dropped on TTL")
        self._m_evicted = m.counter(
            "deepfm_coord_barrier_evictions_total",
            "members evicted for stalling a barrier past its timeout")

    # -- state machine (call with _lock held) -------------------------------
    def _trainers(self) -> list[_Member]:
        return [m for m in self._members.values() if m.role == "train"]

    def _drop(self, m: _Member) -> None:
        """Take ``m`` out (expired, evicted or released): the devices it
        owned stay out of the consensus until a lease owns them again, or
        until the last trainer is gone (a job that starts again starts from
        the views alone)."""
        del self._members[m.pid]
        if m.role == "train":
            self._gone.update(m.owns)
            if not self._trainers():
                self._gone.clear()

    def _sweep(self) -> None:
        now = self._clock()
        expired = [m for m in self._members.values() if m.expires <= now]
        for m in expired:
            self._drop(m)
            self._m_expired.inc()
            obs_flight.record("coord_lease_expired", subsystem="coord",
                              pid=m.pid, role=m.role)
        if self._barrier_timeout > 0 \
                and self._transition_started is not None \
                and now - self._transition_started >= self._barrier_timeout:
            # BOTH barriers get the backstop (the timer restarts at the
            # flip): a wedged member that drain-acked but never reshard-
            # acks would otherwise pin the reshard phase forever
            if self.phase == "drain":
                stalled = [m for m in self._trainers()
                           if m.admitted_epoch is not None
                           and m.acked_drain != self.transition]
            elif self.phase == "reshard":
                stalled = [m for m in self._trainers()
                           if m.acked_reshard != self.transition]
            else:
                stalled = []
            for m in stalled:
                self._drop(m)
                self._m_evicted.inc()
                obs_flight.record("coord_barrier_evicted",
                                  subsystem="coord", pid=m.pid,
                                  phase=self.phase,
                                  transition=self.transition)
            expired.extend(stalled)
        if any(m.role == "train" for m in expired):
            # a trainer LEFT: membership changed even if the merged device
            # set did not, and the flip must re-issue the cohort token so
            # the departed process's copy goes stale
            self._recompute(force=True)
        self._refresh_gauges()

    def _recompute(self, *, force: bool = False) -> None:
        """Re-derive consensus from the live trainer views.  ``force``
        opens a transition even when the merged device set is unchanged —
        trainer membership changes (join / expiry / release / eviction)
        must flip the epoch so the new shared cohort token stales every
        token held outside the new cohort.  Only a transition still in
        its DRAIN phase needs no restart for that: its flip is ahead and
        re-issues anyway.  In the reshard phase the flip already
        happened, so a membership change there must restart the
        transition or the departed process would keep a token equal to
        the live cohort's forever."""
        merged = tuple(i for i in merge_views({m.pid: m.view for m in self._trainers()})
                       if i not in self._gone)
        target = (self.devices if self.phase == "steady"
                  else self._pending_devices)
        if merged == target and not (force and self.phase != "drain"):
            self._advance_barrier()
            return
        # the merged set moved: open (or restart) a transition.  Restart
        # invalidates stale acks — ack payloads carry the transition id.
        self.transition += 1
        self.phase = "drain"
        self._pending_devices = merged
        self._pending_epoch = self.epoch + 1
        self._transition_started = self._clock()
        self._m_transitions.inc()
        obs_flight.record("coord_transition", subsystem="coord",
                          transition=self.transition,
                          pending_epoch=self._pending_epoch,
                          devices=len(merged))
        self._advance_barrier()

    def _advance_barrier(self) -> None:
        if self.phase == "drain":
            need = [m for m in self._trainers()
                    if m.admitted_epoch is not None]
            if all(m.acked_drain == self.transition for m in need):
                # every old-epoch trainer drained+committed: flip the
                # epoch, expose the new set, and issue ONE new cohort
                # token shared by every live trainer — co-writers of the
                # same checkpoint root must hold EQUAL tokens (distinct
                # values would make each cohort member's advance fence
                # out its peers), while anything that missed this flip
                # holds a strictly older token the fences refuse.
                # Publishers keep their per-incarnation acquire tokens.
                self.epoch = self._pending_epoch
                self.devices = tuple(self._pending_devices or ())
                self.phase = "reshard"
                # the reshard barrier gets its own full timeout window —
                # a restore is legitimately slower than a drain
                self._transition_started = self._clock()
                self._fence_counter += 1
                self._cohort_token = self._fence_counter
                for m in self._members.values():
                    if m.role == "train":
                        m.token = self._cohort_token
                obs_flight.record("coord_epoch", subsystem="coord",
                                  epoch=self.epoch,
                                  devices=len(self.devices))
        if self.phase == "reshard":
            if all(m.acked_reshard == self.transition
                   for m in self._trainers()):
                self.phase = "steady"
                self._pending_devices = None
                self._pending_epoch = None
                self._transition_started = None
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        self._m_epoch.set(self.epoch)
        for role in ("train", "publish"):
            self._m_members.labels(role).set(
                sum(1 for m in self._members.values() if m.role == role))

    def _consensus(self) -> dict:
        return {
            "epoch": self.epoch,
            "devices": list(self.devices),
            "phase": self.phase,
            "transition": self.transition,
            "pending_epoch": self._pending_epoch,
            "pending_devices": (None if self._pending_devices is None
                                else list(self._pending_devices)),
        }

    def _lease_doc(self, m: _Member) -> dict:
        return {"lease_id": m.lease_id, "token": m.token,
                "ttl_secs": m.ttl}

    def _grant_ttl(self, requested) -> float:
        """The participant requests a TTL at acquire; the coordinator's
        own ``lease_ttl_secs`` is both the default and the CEILING (a
        shorter lease is honored, a longer one is clamped — expiry must
        stay coordinator-bounded)."""
        import math

        if requested is None:
            return self._ttl
        try:
            req = float(requested)
        except (TypeError, ValueError):
            # non-numeric JSON must answer 400, not tear the connection
            raise ValueError(
                f"ttl_secs must be a number, got {requested!r}") from None
        # NaN passes every <=/min comparison and would mint a lease that
        # can never TTL-expire (expires=NaN fails `expires <= now`
        # forever), pinning its stale view in consensus — refuse anything
        # non-finite alongside non-positive
        if not (req > 0 and math.isfinite(req)):
            raise ValueError(f"ttl_secs must be finite and > 0, "
                             f"got {requested}")
        return min(req, self._ttl)

    def _validate(self, pid: str, lease_id: str) -> _Member:
        m = self._members.get(pid)
        if m is None or m.lease_id != lease_id:
            raise LeaseExpired(pid)
        return m

    # -- participant API ----------------------------------------------------
    def acquire(self, pid: str, role: str = "train",
                view: Sequence = (), ttl_secs: float | None = None,
                owns: Sequence = ()) -> dict:
        if role not in ("train", "publish"):
            raise ValueError(f"unknown role {role!r} (train|publish)")
        try:
            owns = tuple(int(i) for i in owns)
        except (TypeError, ValueError):
            raise ValueError(f"owns must be a list of device ids, got {owns!r}") from None
        with self._lock:
            self._sweep()
            self._lease_seq += 1
            ttl = self._grant_ttl(ttl_secs)
            if role == "publish":
                # one publisher per publish root: each INCARNATION gets a
                # strictly newer token, so a replaced publisher's first
                # advance fences its predecessor out
                self._fence_counter += 1
                token = self._fence_counter
            else:
                # trainers share the cohort token; the forced transition
                # below re-issues a strictly newer one at its flip, which
                # is what stales this pid's previous incarnation
                token = self._cohort_token
            m = _Member(
                pid=pid, role=role,
                lease_id=f"L{self._lease_seq}-{pid}",
                token=token,
                expires=self._clock() + ttl,
                ttl=ttl,
                view=view if role == "train" else (),
                owns=owns if role == "train" else (),
            )
            self._members[pid] = m  # rejoin replaces: old lease_id dies
            self._gone.difference_update(m.owns)
            obs_flight.record("coord_lease_acquired", subsystem="coord",
                              pid=pid, role=role, token=m.token)
            if role == "train":
                self._recompute(force=True)
            else:
                self._refresh_gauges()
            return {"lease": self._lease_doc(m),
                    "consensus": self._consensus()}

    def heartbeat(self, pid: str, lease_id: str,
                  view: Sequence | None = None,
                  on_epoch: int | None = None) -> dict:
        with self._lock:
            self._sweep()
            m = self._validate(pid, lease_id)
            m.expires = self._clock() + m.ttl
            if m.role == "train" and on_epoch is not None:
                # the epoch this member is TRAINING ON: a member that
                # joined an already-steady consensus registers here, so
                # the next drain barrier waits for it too
                m.admitted_epoch = int(on_epoch)
            if m.role == "train" and view is not None \
                    and tuple(view) != m.view:
                m.view = tuple(view)
                self._recompute()
            return {"lease": self._lease_doc(m),
                    "consensus": self._consensus()}

    def ack(self, pid: str, lease_id: str, phase: str,
            transition: int) -> dict:
        with self._lock:
            self._sweep()
            m = self._validate(pid, lease_id)
            m.expires = self._clock() + m.ttl
            if transition == self.transition:
                if phase == "drain":
                    m.acked_drain = transition
                elif phase == "reshard":
                    m.acked_reshard = transition
                    m.admitted_epoch = self.epoch
                else:
                    raise ValueError(f"unknown barrier phase {phase!r}")
                self._advance_barrier()
            return {"lease": self._lease_doc(m),
                    "consensus": self._consensus()}

    def release(self, pid: str, lease_id: str) -> dict:
        with self._lock:
            m = self._members.get(pid)
            if m is not None and m.lease_id == lease_id:
                self._drop(m)
                obs_flight.record("coord_lease_released",
                                  subsystem="coord", pid=pid, role=m.role)
                if m.role == "train":
                    self._recompute(force=True)
                self._refresh_gauges()
            return {"consensus": self._consensus()}

    def status(self) -> dict:
        with self._lock:
            self._sweep()
            return {
                "consensus": self._consensus(),
                "fence_counter": self._fence_counter,
                "cohort_token": self._cohort_token,
                "members": {
                    pid: {
                        "role": m.role, "token": m.token,
                        "ttl_secs": m.ttl,
                        "view": list(m.view),
                        "expires_in_secs": round(
                            m.expires - self._clock(), 3),
                        "acked_drain": m.acked_drain,
                        "acked_reshard": m.acked_reshard,
                        "admitted_epoch": m.admitted_epoch,
                    }
                    for pid, m in sorted(self._members.items())
                },
            }


# ---------------------------------------------------------------------------
# HTTP layer


def _make_handler(coord: Coordinator, plan):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, doc: dict) -> None:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _fault(self, verb: str, key: str) -> bool:
            """Consult the shared FaultPlan (verbs: ACQUIRE / HEARTBEAT /
            ACK / RELEASE / STATUS, key = participant pid); True when the
            fault already answered (error status or dropped connection)."""
            if plan is None:
                return False
            rule = plan.match(verb, key)
            if rule is None:
                return False
            if rule.delay_secs > 0:
                time.sleep(rule.delay_secs)
            if rule.drop:
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass
                return True
            if rule.status:
                self._send(rule.status, {"error": "injected fault"})
                return True
            return False

        def do_GET(self) -> None:
            if self.path == "/__faults__" and plan is not None:
                return self._send(200, plan.to_dict())
            if self.path == "/metrics":
                return self._send_text(
                    200, coord.metrics.render_prometheus().encode(),
                    "text/plain; version=0.0.4")
            if self.path in ("/v1/status", "/v1/metrics"):
                if self._fault("STATUS", ""):
                    return
                doc = coord.status()
                if self.path == "/v1/metrics":
                    doc = {"coord": doc}
                return self._send(200, doc)
            self._send(404, {"error": "no such endpoint"})

        def do_POST(self) -> None:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            if self.path == "/__faults__" and plan is not None:
                try:
                    doc = json.loads(raw or b"{}")
                    plan.set_rules(doc.get("rules", []),
                                   seed=doc.get("seed"))
                except (ValueError, TypeError) as e:
                    return self._send(400, {"error": f"bad fault plan: {e}"})
                return self._send(200, {"ok": True})
            try:
                req = json.loads(raw or b"{}")
            except ValueError as e:
                return self._send(400, {"error": f"bad json: {e}"})
            pid = str(req.get("pid", ""))
            try:
                if self.path == "/v1/lease/acquire":
                    if self._fault("ACQUIRE", pid):
                        return
                    return self._send(200, coord.acquire(
                        pid, role=req.get("role", "train"),
                        view=req.get("view", ()),
                        ttl_secs=req.get("ttl_secs"),
                        owns=req.get("owns", ())))
                if self.path == "/v1/lease/heartbeat":
                    if self._fault("HEARTBEAT", pid):
                        return
                    return self._send(200, coord.heartbeat(
                        pid, str(req.get("lease_id", "")),
                        view=req.get("view"),
                        on_epoch=req.get("on_epoch")))
                if self.path == "/v1/barrier/ack":
                    if self._fault("ACK", pid):
                        return
                    return self._send(200, coord.ack(
                        pid, str(req.get("lease_id", "")),
                        str(req.get("phase", "")),
                        int(req.get("transition", -1))))
                if self.path == "/v1/lease/release":
                    if self._fault("RELEASE", pid):
                        return
                    return self._send(200, coord.release(
                        pid, str(req.get("lease_id", ""))))
            except LeaseExpired:
                return self._send(410, {"error": "lease_expired"})
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            self._send(404, {"error": "no such endpoint"})

        def do_DELETE(self) -> None:
            if self.path == "/__faults__" and plan is not None:
                plan.clear()
                return self._send(200, {"ok": True})
            self._send(404, {"error": "no such endpoint"})

    return Handler


def serve_coordinator(
    coord: Coordinator | None = None,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    fault_plan=None,
    **coord_kw,
) -> tuple[ThreadingHTTPServer, str, Coordinator]:
    """Start a daemon-thread coordinator; returns (server, url, coord).
    Callers own shutdown (``server.shutdown(); server.server_close()``).
    ``fault_plan`` (a dev_object_store.FaultPlan) scripts coordinator
    outages exactly like store outages — also over ``/__faults__``."""
    from ..utils.dev_object_store import FaultPlan

    coord = coord if coord is not None else Coordinator(**coord_kw)
    plan = fault_plan if fault_plan is not None else FaultPlan()
    server = ThreadingHTTPServer((host, port), _make_handler(coord, plan))
    server.daemon_threads = True
    server.fault_plan = plan  # type: ignore[attr-defined]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://{host}:{server.server_address[1]}", coord


# ---------------------------------------------------------------------------
# client


class CoordUnreachableError(RuntimeError):
    """The coordinator could not be reached (connection/5xx after retries,
    or the circuit breaker is open) — degrade to frozen topology."""


class CoordClient:
    """Thin JSON client for one participant: bounded retries per call
    (``RetryPolicy``), a circuit breaker across calls so a dead
    coordinator costs one probe per cooldown, and the 410 lease-expired
    signal surfaced as :class:`LeaseExpired`."""

    def __init__(
        self,
        url: str,
        pid: str,
        *,
        role: str = "train",
        lease_ttl_secs: float | None = None,
        owns: Sequence = (),
        timeout_secs: float = 5.0,
        retry: RetryPolicy | None = None,
        breaker: CircuitBreaker | None = None,
    ):
        self.url = url.rstrip("/")
        self.pid = pid
        self.role = role
        # requested at acquire; the coordinator grants it clamped to its
        # own --lease-ttl ceiling, and granted_ttl records the answer
        self.lease_ttl_secs = lease_ttl_secs
        self.granted_ttl: float | None = None
        self.owns = tuple(int(i) for i in owns)
        self._timeout = timeout_secs
        self._retry = retry or RetryPolicy(
            max_attempts=2, base_delay_secs=0.05, max_delay_secs=0.5)
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=0.5, window=4, min_calls=2,
            cooldown_secs=2.0, name=f"coord:{pid}")
        self.lease_id: str | None = None
        self.token: int | None = None

    def _post(self, path: str, doc: dict) -> dict:
        def attempt() -> dict:
            req = urllib.request.Request(
                self.url + path, data=json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=self._timeout) as r:
                    return json.load(r)
            except urllib.error.HTTPError as e:
                if e.code == 410:
                    raise LeaseExpired(self.pid) from None
                raise CoordUnreachableError(
                    f"{path} -> HTTP {e.code}") from e
            except OSError as e:
                raise CoordUnreachableError(f"{path}: {e}") from e

        if not self.breaker.allow():
            raise CoordUnreachableError(
                f"coordinator breaker open "
                f"({self.breaker.cooldown_remaining():.1f}s cooldown left)")
        try:
            out = self._retry.call(
                attempt,
                classify=lambda e: isinstance(e, CoordUnreachableError))
        except LeaseExpired:
            self.breaker.record_success()  # the SERVICE answered
            raise
        except BaseException:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return out

    def clamp_interval(self, interval: float, *, event: str) -> float:
        """Shrink a heartbeat cadence to fit the GRANTED lease TTL.  The
        config validated the cadence against the *requested* TTL, but the
        coordinator may clamp the grant below it — left alone, every
        lease would expire before its next heartbeat (a silent perpetual
        expire/self-fence/re-acquire livelock).  Flight-records ``event``
        once per shrink."""
        granted = self.granted_ttl
        if granted is None or interval < granted / 2:
            return interval
        clamped = granted / 4
        obs_flight.record(event, subsystem="elastic", pid=self.pid,
                          granted_ttl=granted, interval=interval,
                          clamped_to=clamped)
        return clamped

    def _adopt(self, resp: dict) -> dict:
        lease = resp.get("lease") or {}
        self.lease_id = lease.get("lease_id", self.lease_id)
        if lease.get("token") is not None:
            self.token = int(lease["token"])
        if lease.get("ttl_secs") is not None:
            self.granted_ttl = float(lease["ttl_secs"])
        return resp

    def acquire(self, view: Sequence = ()) -> dict:
        doc = {"pid": self.pid, "role": self.role, "view": list(view)}
        if self.lease_ttl_secs is not None:
            doc["ttl_secs"] = float(self.lease_ttl_secs)
        if self.owns:
            doc["owns"] = list(self.owns)
        return self._adopt(self._post("/v1/lease/acquire", doc))

    def heartbeat(self, view: Sequence | None = None,
                  on_epoch: int | None = None) -> dict:
        doc = {"pid": self.pid, "lease_id": self.lease_id}
        if view is not None:
            doc["view"] = list(view)
        if on_epoch is not None:
            doc["on_epoch"] = int(on_epoch)
        return self._adopt(self._post("/v1/lease/heartbeat", doc))

    def ack(self, phase: str, transition: int) -> dict:
        return self._adopt(self._post("/v1/barrier/ack", {
            "pid": self.pid, "lease_id": self.lease_id,
            "phase": phase, "transition": transition}))

    def release(self) -> None:
        if self.lease_id is None:
            return
        try:
            self._post("/v1/lease/release",
                       {"pid": self.pid, "lease_id": self.lease_id})
        # da:allow[swallowed-exception] release is best-effort teardown; the TTL reclaims the lease anyway
        except Exception:
            pass
        self.lease_id = None


class CoordinatedRegistry:
    """The multi-host registry: wraps a LOCAL registry (virtual or live)
    and speaks the controller's epoch/devices protocol from the
    coordinator's CONSENSUS instead of the local view.

    * ``poll()`` — polls the local registry, heartbeats the local view
      (throttled to ``heartbeat_interval_secs``; immediate when the view
      changed or a transition is in flight), and returns the epoch the
      trainer should be on: the settled consensus epoch, or the pending
      epoch while a transition drains (which is what trips the
      controller's detect→drain path).
    * ``snapshot()`` — ``(epoch, devices)``.  During the drain phase the
      device tuple is EMPTY: the controller's capacity wait keeps polling
      and no process can build the new mesh before the barrier opens.
    * ``ack_drain()`` / ``ack_topology(epoch)`` — the controller's
      barrier hooks (absent on plain registries, so the single-process
      path is unchanged).  A barrier restarted while this process was
      already drained re-acks automatically on the next heartbeat.
    * degradation — ``frozen`` (coordinator unreachable: keep the cached
      consensus, train on) and ``fenced`` (lease expired: report a
      sentinel epoch so the controller drains commit-free and waits for
      re-admission).
    """

    def __init__(
        self,
        local,
        client: CoordClient,
        *,
        heartbeat_interval_secs: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._local = local
        self._client = client
        self._interval = float(heartbeat_interval_secs)
        self._clock = clock
        self._lock = threading.Lock()
        base = getattr(local, "_base", None) or local.devices()
        self._by_id = {d.id: d for d in base}
        self._unmappable: tuple = ()  # consensus ids we cannot address
        self._epoch = 0
        self._devices: tuple = ()
        self._phase = "steady"
        self._transition = 0
        self._pending_epoch: int | None = None
        self._last_hb = -float("inf")
        self._last_view: tuple | None = None
        self._drained = False                 # controller has drained
        self._drained_for: int | None = None  # transition the ack LANDED on
        self._on_epoch: int | None = None     # epoch we built a topology on
        self.frozen = False
        self.fenced = False
        self.fence_token: int | None = None
        self.frozen_polls = 0

    # -- wire helpers -------------------------------------------------------
    def _view(self) -> tuple[int, ...]:
        poll = getattr(self._local, "poll", None)
        if poll is not None:
            poll()
        devs = self._local.devices()
        # refresh the id->object map from the LIVE view every poll: a
        # runtime reinit (e.g. on grow) can mint device ids that did not
        # exist at construction, and a died device's stale object must
        # not be handed to a mesh build
        self._by_id = {d.id: d for d in devs}
        return tuple(d.id for d in devs)

    def _to_devices(self, ids: Sequence) -> tuple:
        missing = tuple(i for i in ids if i not in self._by_id)
        if missing:
            # the consensus names a device this process cannot address
            # (it lost one while frozen, or the runtime re-inventoried).
            # Building a SMALLER mesh than the consensus — and than the
            # peers — would silently diverge the pod; report NOTHING so
            # the controller sits in its capacity wait until the view is
            # heard and a new consensus forms.
            if missing != self._unmappable:
                self._unmappable = missing
                obs_flight.record(
                    "elastic_consensus_unmappable", subsystem="elastic",
                    pid=self._client.pid, missing=list(missing),
                    epoch=self._epoch)
            return ()
        self._unmappable = ()
        return tuple(self._by_id[i] for i in ids)

    def _adopt_consensus(self, resp: dict) -> None:
        self._interval = self._client.clamp_interval(
            self._interval, event="elastic_heartbeat_clamped")
        while True:
            c = resp["consensus"]
            self._epoch = int(c["epoch"])
            self._devices = tuple(c["devices"])
            self._phase = c["phase"]
            self._transition = int(c["transition"])
            self._pending_epoch = c.get("pending_epoch")
            self.fence_token = self._client.token
            if self.frozen:
                self.frozen = False
                obs_flight.record("elastic_thawed", subsystem="elastic",
                                  pid=self._client.pid, epoch=self._epoch)
            # we have drained but the coordinator has not recorded it for
            # the CURRENT transition — either the barrier restarted while
            # we sat in the capacity wait, or our ack RPC failed and this
            # is the first call to get through since.  Re-ack; only a
            # SUCCESSFUL ack records _drained_for, so a transient ack
            # failure is retried by every later heartbeat instead of
            # stalling the whole pod's barrier.
            if (self._phase == "drain" and self._drained
                    and self._drained_for != self._transition):
                t = self._transition
                try:
                    resp = self._client.ack("drain", t)
                except (CoordUnreachableError, LeaseExpired):
                    return  # the normal poll paths will retry / self-fence
                self._drained_for = t
                continue
            return

    def _heartbeat(self, *, force: bool = False) -> None:
        now = self._clock()
        view = self._view()
        due = (force
               or view != self._last_view
               or self._phase != "steady"
               or now - self._last_hb >= self._interval)
        if not due:
            return
        try:
            if self.fenced or self._client.lease_id is None:
                # re-admission abandons the old topology: it must NOT
                # re-register as admitted to an epoch it will never drain
                # from (the drain barrier would wait on this process
                # forever) — ack_topology re-registers after the rebuild
                self._on_epoch = None
                resp = self._client.acquire(view)
                if self.fenced:
                    self.fenced = False
                    obs_flight.record(
                        "elastic_readmitted", subsystem="elastic",
                        pid=self._client.pid,
                        token=self._client.token)
                self._drained = False
                self._drained_for = None
            else:
                # on_epoch registers the epoch this process TRAINS ON —
                # without it, a member that joined an already-steady
                # consensus would be invisible to the next drain barrier
                resp = self._client.heartbeat(view,
                                              on_epoch=self._on_epoch)
            self._last_hb = now
            self._last_view = view
            self._adopt_consensus(resp)
        except LeaseExpired:
            self._last_hb = now
            if not self.fenced:
                self.fenced = True
                obs_flight.record("elastic_self_fenced",
                                  subsystem="elastic",
                                  pid=self._client.pid)
        except CoordUnreachableError:
            self._last_hb = now
            self.frozen_polls += 1
            if not self.frozen:
                self.frozen = True
                obs_flight.record(
                    "elastic_frozen", subsystem="elastic",
                    pid=self._client.pid, epoch=self._epoch,
                    breaker=self._client.breaker.state)

    # -- registry protocol --------------------------------------------------
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._effective_epoch()

    def _effective_epoch(self) -> int:
        if self.fenced:
            return -1  # sentinel: never equals a built topology's epoch
        if self._phase == "drain" and self._pending_epoch is not None:
            return int(self._pending_epoch)
        return self._epoch

    def poll(self) -> int:
        with self._lock:
            self._heartbeat()
            return self._effective_epoch()

    def devices(self) -> tuple:
        with self._lock:
            return self._to_devices(self._devices)

    def snapshot(self) -> tuple[int, tuple]:
        with self._lock:
            self._heartbeat()
            if self.fenced or self._phase == "drain":
                return self._effective_epoch(), ()
            return self._epoch, self._to_devices(self._devices)

    # -- controller barrier hooks -------------------------------------------
    def ack_drain(self) -> None:
        with self._lock:
            # _drained marks the LOCAL fact (the controller finished its
            # in-flight step); _drained_for is only set once the ack RPC
            # SUCCEEDS — if it fails here, every later successful
            # heartbeat re-acks (_adopt_consensus), so one transient
            # network failure cannot leave the coordinator waiting on an
            # ack that will never be resent
            self._drained = True
            t = self._transition
            try:
                resp = self._client.ack("drain", t)
            except (CoordUnreachableError, LeaseExpired):
                # frozen/fenced paths pick this up on the next poll; the
                # barrier cannot open without us, so no one reshards early
                self._heartbeat(force=True)
                return
            self._drained_for = t
            self._adopt_consensus(resp)

    def ack_topology(self, epoch: int) -> None:
        """The controller built (or rebuilt) a topology for ``epoch`` —
        complete the reshard barrier if one is pending for it."""
        with self._lock:
            self._drained = False
            self._drained_for = None
            self._on_epoch = int(epoch)
            if self._phase != "reshard" or epoch != self._epoch:
                return
            try:
                self._adopt_consensus(
                    self._client.ack("reshard", self._transition))
            except (CoordUnreachableError, LeaseExpired):
                self._heartbeat(force=True)

    def release(self) -> None:
        self._client.release()


# ---------------------------------------------------------------------------
# standalone entrypoint


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument(
        "--lease-ttl", type=float, default=10.0,
        help="default AND ceiling for participant lease TTLs (an acquire "
             "may request a shorter one)")
    ap.add_argument(
        "--barrier-timeout", type=float, default=60.0,
        help="evict a live member that stalls a drain barrier this long "
             "(0 disables; dead members are reclaimed by the TTL)")
    ap.add_argument(
        "--store-port", type=int, default=0,
        help="also host the ranks' rendezvous TCPStore on this port (the "
             "ranks' MASTER_ADDR/MASTER_PORT); 0: none")
    args = ap.parse_args()
    store = None
    if args.store_port:
        from torch.distributed import TCPStore

        store = TCPStore(args.host, args.store_port, is_master=True,
                         wait_for_workers=False)
    server, url, _coord = serve_coordinator(
        Coordinator(lease_ttl_secs=args.lease_ttl,
                    barrier_timeout_secs=args.barrier_timeout),
        host=args.host, port=args.port,
    )
    print(f"elastic coordinator on {url}"
          + (f", rendezvous store on {args.host}:{args.store_port}" if store else ""),
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
