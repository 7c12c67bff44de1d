"""The pool front: consistent hashing -> shard-group, health-driven
ejection, generation pinning, bounded cross-group retry, hedging: the
port's copy of ``deepfm_tpu/serve/pool/router.py`` for one tenant.

Host-only control plane: nothing here touches CUDA, so the router runs
in the supervisor (serve/pool/__main__.py), which never initialises it.

* **Consistent hashing** (:class:`HashRing`): request key -> ordered
  candidate groups via a virtual-node ring.  Removing one of ``n`` groups
  moves only the keys that mapped to it.
* **Least-loaded tie-break** among the first ``spread`` healthy ring
  candidates, by router-tracked in-flight rows.
* **Bounded retry**: a failed forward (connection error, or a 5xx other
  than 503, the engine's backpressure) counts toward the member's
  ejection and tries the next candidate group, at most ``retry_limit``
  extra groups.
* **Ejection / re-admission**: ``eject_after`` consecutive failed
  ``/healthz`` probes (or forwards) eject a member; it comes back only
  when its ``/readyz`` passes (graphs captured, weights loaded).
* **Generation pinning**: every forward carries ``X-Pinned-Generation``;
  a member mid-swap answers 409 (a skew abort) and the router re-reads
  the generation and retries, so no client sees a response scored across
  a group commit.
* **SLO control plane** (serve/control/, each optional): the shared
  retry/hedge :class:`~..control.hedge.TokenBudget` (an empty bucket
  fails fast with 503 + ``Retry-After``), hedged tails
  (:class:`~..control.hedge.HedgeController`: when the first group's p95
  breaches the SLO a hedge to the next group fires after an adaptive
  delay, first answer wins), and the
  :class:`~..control.admission.LoadShedGate` fed by member backpressure.
* **Impression log** (flywheel/impressions.py): with an
  ``ImpressionLogger`` attached, every answered ``:predict`` is offered
  to it after the response is formed (sampled, bounded, never blocking).

Multi-tenant routing (the traffic split, ``/admin:split``, shadow
scoring) is ROADMAP A18: a split or a shadow raises, ``/admin:split``
answers 400, and an ``X-Tenant`` other than the default is forwarded for
the member to refuse.
"""

from __future__ import annotations

import hashlib
import json
import queue as _queue
import threading
import time
import urllib.error
import urllib.request

from http.server import BaseHTTPRequestHandler

from ...obs import flight as obs_flight
from ...obs.metrics import MetricsRegistry
from ...obs.trace import DEFAULT_SAMPLE_RATE, Tracer, current_trace
from ..server import ScoringHTTPServer, _send_json, _send_text
from . import TENANTS_NOT_PORTED


class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``candidates(key)`` walks clockwise from the key's point and returns
    every distinct node in ring order — element 0 is the consistent
    primary; the rest are the deterministic failover order."""

    def __init__(self, nodes=(), *, replicas: int = 64):
        self._replicas = int(replicas)
        self._points: list[tuple[int, str]] = []
        self._nodes: set[str] = set()
        for n in nodes:
            self.add(n)

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self._replicas):
            self._points.append((self._hash(f"{node}#{i}"), node))
        self._points.sort()

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._points = [(h, n) for h, n in self._points if n != node]

    def __len__(self) -> int:
        return len(self._nodes)

    def candidates(self, key: str, n: int | None = None) -> list[str]:
        if not self._points:
            return []
        want = len(self._nodes) if n is None else min(n, len(self._nodes))
        h = self._hash(key)
        # bisect to the key's point, then walk clockwise collecting
        # distinct nodes
        import bisect

        idx = bisect.bisect_left(self._points, (h, ""))
        out: list[str] = []
        for off in range(len(self._points)):
            node = self._points[(idx + off) % len(self._points)][1]
            if node not in out:
                out.append(node)
                if len(out) == want:
                    break
        return out


class _Member:
    __slots__ = ("url", "healthy", "fails", "inflight", "doc")

    def __init__(self, url: str):
        self.url = url
        self.healthy = True       # optimistic: probed immediately
        self.fails = 0
        self.inflight = 0
        self.doc: dict = {}       # last readiness doc (generation, wire est)


class Router:
    """Route predict requests across shard-groups (module docstring).

    ``groups`` maps group name -> list of member base URLs.  Thread-safe;
    ``start()`` launches the health prober, ``close()`` stops it."""

    def __init__(
        self,
        groups: dict[str, list[str]],
        *,
        model_name: str = "deepfm",
        retry_limit: int = 2,
        spread: int = 2,
        eject_after: int = 2,
        probe_interval_secs: float = 1.0,
        request_timeout_secs: float = 60.0,
        registry: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        split=None,
        shadow=None,
        retry_budget=None,
        hedge=None,
        shed_gate=None,
        flywheel=None,
    ):
        if not groups:
            raise ValueError("router needs at least one shard-group")
        self.model_name = model_name
        self._ring = HashRing(sorted(groups))
        self._members = {
            g: [_Member(u) for u in urls] for g, urls in groups.items()
        }
        # scale-down keeps the drained group's member records here so
        # ``group_inflight`` stays answerable while requests finish
        self._retired: dict[str, list[_Member]] = {}
        self._retry_limit = int(retry_limit)
        self._spread = max(1, int(spread))
        self._eject_after = max(1, int(eject_after))
        self._probe_interval = float(probe_interval_secs)
        self._timeout = float(request_timeout_secs)
        self._lock = threading.Lock()
        # generation pins keyed (group, tenant); tenant None is the
        # legacy tenant-less pin (single-tenant members).  Per-tenant
        # keys are learned from readiness probes' ``tenants`` map and
        # from member responses/409s
        self._generation: dict[tuple[str, str | None], int] = {}
        # all counters/latency live in the shared obs registry
        # (obs/metrics.py): /v1/metrics re-renders from it unchanged and
        # GET /metrics scrapes it directly
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        # the router is where a request enters the pool: it is the trace
        # HEAD (mints X-Trace-Id at the shipped sample rate, or adopts
        # the client's — always recorded); members inherit the decision
        # via the propagated headers
        self.tracer = tracer if tracer is not None else Tracer(
            "router", sample_rate=DEFAULT_SAMPLE_RATE)
        r = self.registry
        self._c_requests = r.counter(
            "deepfm_router_requests_total", "requests routed")
        self._c_retries = r.counter(
            "deepfm_router_retries_total", "cross-member retry attempts")
        self._c_skew = r.counter(
            "deepfm_router_skew_aborts_total",
            "409 generation-skew aborts observed")
        self._c_ejections = r.counter(
            "deepfm_router_ejections_total", "members ejected")
        self._c_readmissions = r.counter(
            "deepfm_router_readmissions_total", "members re-admitted")
        self._c_no_capacity = r.counter(
            "deepfm_router_no_capacity_total",
            "requests refused with no healthy shard-group")
        # family refs kept: add_group mints new label children at runtime
        self._f_group_requests = r.counter(
            "deepfm_router_group_requests_total",
            "requests answered per shard-group", labels=("group",))
        self._f_latency = r.histogram(
            "deepfm_router_group_latency_seconds",
            "router-measured member latency", labels=("group",))
        self._group_requests = {
            g: self._f_group_requests.labels(g) for g in groups
        }
        self._windows = {g: self._f_latency.labels(g) for g in groups}
        # SLO control plane (serve/control/), each optional: the shared
        # retry/hedge token budget, the tail-hedging controller, and the
        # shadow shed gate
        self._retry_budget = retry_budget
        self._hedge = hedge
        self._shed_gate = shed_gate
        # data flywheel (flywheel/impressions.py): an optional
        # ImpressionLogger; answered requests are OFFERED after the
        # response is formed — hash-stable sampling, bounded queue,
        # drop-with-metric — so the serve path never waits on the log
        self._flywheel = flywheel
        self._c_budget_exhausted = r.counter(
            "deepfm_router_retry_budget_exhausted_total",
            "retries/hedges suppressed: shared token budget empty")
        if split is not None or shadow is not None:
            raise NotImplementedError(f"a traffic split or shadow: {TENANTS_NOT_PORTED}")
        self._stop = threading.Event()
        self._prober: threading.Thread | None = None

    # registry-backed totals, read-compatible with the pre-registry attrs
    @property
    def requests_total(self) -> int:
        return int(self._c_requests.value)

    @property
    def retries_total(self) -> int:
        return int(self._c_retries.value)

    @property
    def skew_aborts_total(self) -> int:
        return int(self._c_skew.value)

    @property
    def ejections_total(self) -> int:
        return int(self._c_ejections.value)

    @property
    def readmissions_total(self) -> int:
        return int(self._c_readmissions.value)

    @property
    def no_capacity_total(self) -> int:
        return int(self._c_no_capacity.value)

    # -- health -------------------------------------------------------------
    def _get_json(self, url: str, timeout: float = 5.0) -> dict:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.load(r)

    def _probe_member(self, group: str, m: _Member) -> None:
        try:
            if m.healthy:
                self._get_json(m.url + "/healthz")
                # readiness carries generation + wire estimate (the
                # group_status merge, serve/server.py)
                doc = self._get_json(m.url + "/readyz")
            else:
                # ejected members must pass READINESS (engine compiled,
                # weights loaded) to re-enter rotation, not mere liveness
                doc = self._get_json(m.url + "/readyz")
            ok = bool(doc.get("ready", True))
        except Exception as e:
            # the failure IS the probe result; keep it observable on the
            # member record (surfaces in /v1/metrics while ejected)
            ok, doc = False, {"probe_error": f"{type(e).__name__}: {e}"}
        with self._lock:
            if ok:
                if not m.healthy:
                    self._c_readmissions.inc()
                    obs_flight.record("member_readmitted", group=group,
                                      url=m.url)
                m.healthy, m.fails, m.doc = True, 0, doc
                if "group_generation" in doc:
                    self._generation[(group, None)] = int(
                        doc["group_generation"]
                    )
            else:
                m.fails += 1
                if m.healthy and m.fails >= self._eject_after:
                    m.healthy = False
                    self._c_ejections.inc()
                    obs_flight.record("member_ejected", group=group,
                                      url=m.url, via="probe",
                                      fails=m.fails)

    def probe_once(self) -> None:
        # snapshot under the lock: the autoscaler adds/removes groups
        # from another thread while this loop is mid-iteration
        with self._lock:
            live = [(g, list(ms)) for g, ms in self._members.items()]
        for g, members in live:
            for m in members:
                self._probe_member(g, m)

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(self._probe_interval)

    def start(self) -> "Router":
        self.probe_once()  # populate generations before traffic
        if self._prober is None:
            self._prober = threading.Thread(
                target=self._probe_loop, daemon=True, name="router-prober"
            )
            self._prober.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=10)
            self._prober = None

    # -- fleet control plane ------------------------------------------------
    def update_split(self, percentages: dict[str, float]) -> dict:
        """JAX's live re-split of tenant arms: there are no arms here."""
        raise ValueError(f"router has no traffic split configured: {TENANTS_NOT_PORTED}")

    # -- elastic topology ---------------------------------------------------
    def add_group(self, name: str, urls: list[str]) -> None:
        """Admit a new shard-group into rotation (the autoscaler's
        scale-up commit, AFTER the members' ``/readyz`` passed).
        Consistent hashing means only ≈K/n of K keys move to it; every
        other key keeps its group."""
        with self._lock:
            if name in self._members:
                raise ValueError(f"group {name!r} already routed")
            self._retired.pop(name, None)
            self._members[name] = [_Member(u) for u in urls]
            self._group_requests[name] = self._f_group_requests.labels(name)
            self._windows[name] = self._f_latency.labels(name)
            # a fresh ring (not in-place mutation): ``candidates`` reads
            # the point list lock-free, so the swap must be atomic
            self._ring = HashRing(sorted(self._members))
        obs_flight.record("group_added", subsystem="slo", group=name,
                          urls=list(urls))
        for m in self._members[name]:
            self._probe_member(name, m)

    def remove_group(self, name: str) -> None:
        """Stop admitting to a group (the autoscaler's scale-down start).
        In-flight requests on it finish normally — the member records
        move to the retired set so ``group_inflight`` keeps answering
        while the supervisor waits out the drain, then terminates the
        processes.  Never removes the last group."""
        with self._lock:
            if name not in self._members:
                raise ValueError(f"group {name!r} is not routed")
            if len(self._members) <= 1:
                raise ValueError("refusing to remove the last shard-group")
            self._retired[name] = self._members.pop(name)
            self._ring = HashRing(sorted(self._members))
            stale = [k for k in self._generation if k[0] == name]
            for k in stale:
                del self._generation[k]
        obs_flight.record("group_removed", subsystem="slo", group=name)

    def group_inflight(self, name: str) -> int:
        """Router-tracked in-flight rows on a group — live or retired
        (the drain monitor's signal)."""
        with self._lock:
            members = self._members.get(name) or self._retired.get(name, [])
            return sum(m.inflight for m in members)

    def group_names(self) -> list[str]:
        with self._lock:
            return sorted(self._members)

    # -- routing ------------------------------------------------------------
    @staticmethod
    def request_key(body: dict) -> str:
        """The routing key: an explicit top-level ``"key"`` when the
        client supplies one (sticky sessions / cache affinity), else a
        content hash of the instances — deterministic, so identical
        requests land on the same group."""
        if "key" in body:
            return str(body["key"])
        return hashlib.md5(
            json.dumps(body.get("instances", []), sort_keys=True).encode()
        ).hexdigest()

    def _healthy_members(self, group: str) -> list[_Member]:
        return [m for m in self._members.get(group, ()) if m.healthy]

    def _plan(self, key: str) -> list[str]:
        """Candidate groups in try-order: ring order, with the first
        ``spread`` healthy candidates re-ranked by in-flight load (the
        least-loaded tie-break), then the remaining ring order as
        failover."""
        ring = self._ring.candidates(key)
        healthy = [g for g in ring if self._healthy_members(g)]
        if not healthy:
            return []
        with self._lock:
            head = sorted(
                healthy[: self._spread],
                key=lambda g: sum(
                    m.inflight for m in self._healthy_members(g)
                ),
            )
        return head + [g for g in healthy if g not in head]

    def handle_predict(self, body: dict,
                       path: str | None = None,
                       tenant: str | None = None,
                       _offer_shadow: bool = True,
                       deadline_ms: float | None = None,
                       priority: str | None = None) -> tuple[int, dict]:
        """Route one predict (or funnel recommend — ``path`` overrides
        the default ``:predict`` member route; same pinning, ejection and
        retry discipline); returns ``(http_status, response_doc)``.  The
        member's response document passes through untouched (it already
        carries predictions — or the funnel's items + index_version —
        model_version, shard_group, tenant and group_generation) plus a
        ``router`` attribution section.

        ``tenant`` is the explicit X-Tenant selection; with none and a
        split attached, the request's hash-stable split arm decides.
        ``_offer_shadow=False`` marks the shadow worker's own re-scores
        (a challenger score must never re-offer itself).

        ``deadline_ms``/``priority`` are the client's SLO declaration
        (``X-Deadline-Ms``/``X-Priority``), forwarded to the member whose
        admission controller prices them; with a
        :class:`~..control.hedge.HedgeController` attached, a request
        whose first-choice group's live p95 breaches the SLO budget races
        a delayed hedge against the next healthy candidate."""
        target = path or f"/v1/models/{self.model_name}:predict"
        key = self.request_key(body)
        rows = len(body.get("instances", []))
        plan = self._plan(key)
        self._c_requests.inc()
        if self._retry_budget is not None:
            # every routed request accrues fractional retry/hedge credit
            self._retry_budget.note_request()
        if (self._hedge is not None and self._hedge.budget is not None
                and self._hedge.budget is not self._retry_budget):
            # a hedge budget configured as its own bucket accrues too
            self._hedge.budget.note_request()
        # the request's trace context (set by the router handler): every
        # forward attempt becomes a span, and the SAME trace id rides the
        # propagation headers across retries — including the 409 re-pin
        # path, so one client request is one trace end-to-end
        tctx = current_trace()
        if not plan:
            self._c_no_capacity.inc()
            return 503, {"error": "no healthy shard-group"}
        kw = dict(
            target=target, payload=json.dumps(body).encode(), rows=rows,
            tenant=tenant, tctx=tctx, key=key, body=body,
            _offer_shadow=_offer_shadow, deadline_ms=deadline_ms,
            priority=priority,
        )
        groups = plan[: self._retry_limit + 1]
        delay = None
        if self._hedge is not None and len(groups) > 1:
            delay = self._hedge.plan(
                self._windows[groups[0]].snapshot().get("p95")
            )
        if delay is None:
            return self._route(groups, **kw)
        return self._route_hedged(groups, delay, **kw)

    def _route(self, groups: list[str], **kw) -> tuple[int, dict]:
        """Sequential failover over the candidate groups.  Every group
        past the first is a cross-group retry and spends one shared
        budget token first; an empty bucket FAILS FAST — retrying into a
        pool-wide brownout multiplies the offered load exactly when
        capacity is scarcest."""
        state = {"attempts": 0, "last_err": {"error": "exhausted"}}
        for i, group in enumerate(groups):
            if i > 0 and self._retry_budget is not None \
                    and not self._retry_budget.try_spend():
                self._c_budget_exhausted.inc()
                return 503, {
                    "error": "retry budget exhausted (pool-wide "
                             "brownout guard): failing fast",
                    "retry_after_s": 1.0,
                }
            out = self._try_group(group, state=state, **kw)
            if out is not None:
                return out
        return 503, state["last_err"]

    def _route_hedged(self, groups: list[str], delay: float,
                      **kw) -> tuple[int, dict]:
        """Race the primary plan against a delayed hedge on the next
        candidate.  The hedge fires only if the primary outlives
        ``delay`` AND the shared token budget grants it (≤ the budget
        ratio of recent request rate — bounded extra load by
        construction).  First answer wins; the loser's work is counted
        cancelled (nobody consumes it)."""
        resq: _queue.Queue = _queue.Queue()

        def run(subgroups: list[str], tag: str) -> None:
            try:
                resq.put((tag, self._route(subgroups, **kw)))
            except Exception as e:   # defensive: a leg must always report
                resq.put((tag, (500,
                                {"error": f"{type(e).__name__}: {e}"})))

        threading.Thread(target=run, args=(groups, "primary"),
                         daemon=True, name="route-primary").start()
        try:
            _, out = resq.get(timeout=max(0.001, delay))
            return out           # answered inside the hedge delay
        except _queue.Empty:
            pass
        if not self._hedge.try_fire():
            _, out = resq.get()  # budget empty: wait out the primary
            return out
        threading.Thread(target=run, args=([groups[1]], "hedge"),
                         daemon=True, name="route-hedge").start()
        first_tag, first = resq.get()
        if first[0] == 200:
            self._hedge.record_outcome(hedge_won=(first_tag == "hedge"))
            first[1].setdefault("router", {})["hedge"] = first_tag
            return first
        # the first arrival failed — the race is decided by the other leg
        second_tag, second = resq.get()
        winner_tag, winner = ((second_tag, second) if second[0] == 200
                              else (first_tag, first))
        self._hedge.record_outcome(
            hedge_won=(winner_tag == "hedge" and winner[0] == 200))
        if winner[0] == 200:
            winner[1].setdefault("router", {})["hedge"] = winner_tag
        return winner

    def _try_group(self, group: str, *, target: str, payload: bytes,
                   rows: int, tenant: str | None, tctx, state: dict,
                   key: str, body: dict, _offer_shadow: bool,
                   deadline_ms: float | None = None,
                   priority: str | None = None) -> tuple[int, dict] | None:
        """One candidate group's forward: least-loaded member pick plus
        one in-group re-pin retry.  Returns a terminal ``(status, doc)``
        or None — this group cannot answer, try the next candidate."""
        members = sorted(
            self._healthy_members(group), key=lambda m: m.inflight
        )
        if not members:
            return None
        m = members[0]
        # one in-group re-pin retry: a 409 means OUR generation was
        # stale (the group swapped under us), not that the group is bad
        for _pin_attempt in range(2):
            state["attempts"] += 1
            if state["attempts"] > 1:
                self._c_retries.inc()
            gen = self._generation.get((group, tenant))
            headers = {"Content-Type": "application/json"}
            if tenant is not None:
                headers["X-Tenant"] = tenant
            if gen is not None:
                headers["X-Pinned-Generation"] = str(gen)
            if deadline_ms is not None:
                # the member's admission controller prices the request
                # against this (made absolute on ITS clock at parse time)
                headers["X-Deadline-Ms"] = str(deadline_ms)
            if priority is not None:
                headers["X-Priority"] = priority
            if tctx is not None:
                headers.update(tctx.headers())
            req = urllib.request.Request(
                f"{m.url}{target}", data=payload, headers=headers,
            )
            t0 = time.perf_counter()
            with self._lock:
                m.inflight += rows
            try:
                with urllib.request.urlopen(
                    req, timeout=self._timeout
                ) as r:
                    doc = json.load(r)
                dt = time.perf_counter() - t0
                self._windows[group].observe(dt)
                self._group_requests[group].inc()
                with self._lock:
                    if "group_generation" in doc:
                        self._generation[(group, tenant)] = int(
                            doc["group_generation"]
                        )
                if self._shed_gate is not None:
                    self._shed_gate.note(False)
                if tctx is not None:
                    span_attrs = {"group": group,
                                  "attempt": state["attempts"],
                                  "status": 200}
                    if tenant is not None:
                        span_attrs["tenant"] = tenant
                    tctx.add_span(
                        "router.forward", t0, time.perf_counter(),
                        **span_attrs,
                    )
                doc["router"] = {"group": group,
                                 "attempts": state["attempts"]}
                if tenant is not None:
                    doc["router"]["tenant"] = tenant
                if _offer_shadow and "predictions" in doc \
                        and self._flywheel is not None:
                    # the scored impression into the flywheel log, after
                    # the answer is formed (sampled, bounded, dropped
                    # rather than waited on)
                    self._flywheel.offer(
                        key=key,
                        trace_id=(tctx.trace_id if tctx is not None else ""),
                        tenant=doc.get("tenant", tenant) or "",
                        model_version=int(doc.get("model_version", -1)),
                        instances=body.get("instances", ()),
                        scores=doc["predictions"],
                        deadline_class=(priority if priority is not None
                                        else "deadline" if deadline_ms is not None
                                        else "default"),
                    )
                return 200, doc
            except urllib.error.HTTPError as e:
                try:
                    err = json.load(e)
                except (ValueError, OSError):
                    err = {"error": f"http {e.code}"}
                if tctx is not None:
                    tctx.add_span(
                        "router.forward", t0, time.perf_counter(),
                        group=group, attempt=state["attempts"],
                        status=e.code,
                    )
                if e.code == 409:
                    # generation skew: learn the member's live
                    # generation FOR THIS TENANT and retry once,
                    # same group (the 409 carries the tenant whose
                    # pin went stale — tenant A's swap never
                    # invalidates B's pins)
                    self._c_skew.inc()
                    with self._lock:
                        if "group_generation" in err:
                            self._generation[(group, tenant)] = int(
                                err["group_generation"]
                            )
                    state["last_err"] = err
                    continue
                if e.code in (400, 413):
                    # the client's fault: no retry can fix the body
                    return e.code, err
                if e.code == 504:
                    # the member ANSWERED: the deadline passed while the
                    # request sat queued (expiry-at-dequeue).  Not a
                    # health verdict, and not retryable — the deadline
                    # is equally gone on every other group
                    return e.code, err
                state["last_err"] = err
                if e.code >= 500 and e.code != 503:
                    # a server-side failure counts toward ejection
                    # exactly like a connection failure — a member
                    # whose engine 500s every predict must leave
                    # rotation at traffic speed.  503 is exempt: it
                    # is the engine's BACKPRESSURE signal (bounded
                    # queue shedding), and ejecting an overloaded-
                    # but-healthy member would amplify the overload
                    self._eject_on_traffic(group, m, f"http {e.code}")
                elif e.code == 503 and self._shed_gate is not None:
                    # backpressure feeds the shadow shed gate instead
                    self._shed_gate.note(True)
                return None  # 5xx/503: next group
            except Exception as e:
                # connection-level failure: count toward ejection so
                # a dead member leaves rotation at traffic speed, not
                # probe speed
                if tctx is not None:
                    tctx.add_span(
                        "router.forward", t0, time.perf_counter(),
                        group=group, attempt=state["attempts"],
                        status=type(e).__name__,
                    )
                self._eject_on_traffic(group, m, type(e).__name__)
                state["last_err"] = {"error": f"{type(e).__name__}: {e}"}
                return None
            finally:
                with self._lock:
                    m.inflight -= rows
        return None  # both pin attempts skewed: next group

    def _eject_on_traffic(self, group: str, m: _Member, why: str) -> None:
        with self._lock:
            m.fails += 1
            ejected = m.healthy and m.fails >= self._eject_after
            if ejected:
                m.healthy = False
        if ejected:
            self._c_ejections.inc()
            obs_flight.record("member_ejected", group=group, url=m.url,
                              via="traffic", reason=why)

    # -- observability ------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        with self._lock:
            groups = {}
            for g, members in self._members.items():
                healthy = [m for m in members if m.healthy]
                doc = next((m.doc for m in members if m.doc), {})
                groups[g] = {
                    "members": len(members),
                    "member_urls": [m.url for m in members],
                    "healthy_members": len(healthy),
                    "inflight_rows": sum(m.inflight for m in members),
                    "generation": self._generation.get((g, None)),
                    "tenant_generations": {
                        t: gen
                        for (grp, t), gen in self._generation.items()
                        if grp == g and t is not None
                    },
                    "requests_total": int(self._group_requests[g].value),
                    "latency_ms": self._windows[g].snapshot(),
                    "exchange_wire_bytes_est": doc.get(
                        "exchange_wire_bytes_est"
                    ),
                    "exchange": doc.get("exchange"),
                    "mesh": doc.get("mesh"),
                }
            out = {
                "router": {
                    "model": self.model_name,
                    "groups": len(self._members),
                    "requests_total": self.requests_total,
                    "retries_total": self.retries_total,
                    "skew_aborts_total": self.skew_aborts_total,
                    "ejections_total": self.ejections_total,
                    "readmissions_total": self.readmissions_total,
                    "no_capacity_total": self.no_capacity_total,
                    "retry_limit": self._retry_limit,
                },
                "groups": groups,
            }
        # the SLO control plane's own gauges (each section present only
        # when that mechanism is attached)
        if self._retry_budget is not None:
            out["router"]["retry_budget"] = self._retry_budget.snapshot()
            out["router"]["retry_budget_exhausted_total"] = int(
                self._c_budget_exhausted.value)
        if self._hedge is not None:
            out["router"]["hedge"] = self._hedge.snapshot()
        if self._shed_gate is not None:
            out["router"]["shed_gate"] = self._shed_gate.snapshot()
        if self._flywheel is not None:
            # impression-logger counters, plus the join service's last
            # committed checkpoint when its output root is configured
            out["flywheel"] = self._flywheel.stats()
        return out


def make_router_handler(router: Router):
    predict_path = f"/v1/models/{router.model_name}:predict"
    recommend_path = "/v1/recommend"   # funnel members (funnel/serve.py)
    status_path = f"/v1/models/{router.model_name}"

    class RouterHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True
        _send = _send_json
        _send_plain = _send_text

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send(200, {"status": "alive", "role": "router"})
            elif self.path == "/metrics":
                self._send_plain(200, router.registry.render_prometheus())
            elif self.path == "/v1/trace/recent":
                self._send(200, {"traces": router.tracer.recent()})
            elif self.path == "/v1/flight":
                self._send(200, {"events": obs_flight.render_events()})
            elif self.path == "/readyz":
                snap = router.metrics_snapshot()
                ready = any(
                    g["healthy_members"] > 0
                    for g in snap["groups"].values()
                )
                self._send(200 if ready else 503,
                           {"ready": ready, "role": "router"})
            elif self.path == status_path:
                self._send(200, {
                    "model_version_status": [
                        {"version": "router", "state": "AVAILABLE"}
                    ],
                })
            elif self.path == "/v1/metrics":
                self._send(200, router.metrics_snapshot())
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802
            if self.path == "/admin:split":
                # live re-split of tenant traffic (hash-stable minimal
                # key movement, fleet/split.py); flight-recorded
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length))
                    arms = router.update_split(body["percentages"])
                except (ValueError, KeyError, TypeError) as e:
                    return self._send(400,
                                      {"error": f"{type(e).__name__}: {e}"})
                return self._send(200, {"arms": arms})
            if self.path not in (predict_path, recommend_path):
                return self._send(404,
                                  {"error": f"unknown path {self.path!r}"})
            # the trace head: mint an X-Trace-Id (or adopt the client's)
            # here, where the request enters the pool; handle_predict
            # propagates it to the member on every attempt
            name = ("recommend" if self.path == recommend_path
                    else "predict")
            ctx = router.tracer.begin(name, self.headers)
            token = router.tracer.activate(ctx)
            self._obs_status = None
            try:
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length))
                    body["instances"]
                except Exception as e:
                    return self._send(400,
                                      {"error": f"{type(e).__name__}: {e}"})
                deadline_ms = None
                hdr = self.headers.get("X-Deadline-Ms")
                if hdr is not None:
                    try:
                        deadline_ms = max(0.0, float(hdr))
                    except ValueError:
                        deadline_ms = None
                code, doc = router.handle_predict(
                    body,
                    path=recommend_path if self.path == recommend_path
                    else None,
                    # explicit tenant selection wins over the split arm
                    tenant=self.headers.get("X-Tenant"),
                    deadline_ms=deadline_ms,
                    priority=self.headers.get("X-Priority"),
                )
                # admission rejections carry a back-off hint; surface it
                # as the HTTP Retry-After header the member couldn't set
                # across the hop
                extra = None
                if code == 503 and isinstance(
                        doc.get("retry_after_s"), (int, float)):
                    extra = {"Retry-After":
                             max(1, int(doc["retry_after_s"] + 0.999))}
                self._send(code, doc, extra_headers=extra)
            finally:
                router.tracer.finish(ctx, token, status=self._obs_status)

        def log_message(self, fmt, *args):
            pass

    return RouterHandler


def start_router(
    groups: dict[str, list[str]],
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    **router_kw,
) -> tuple[ScoringHTTPServer, str, Router]:
    """Router front on a daemon thread; returns (server, base_url,
    router).  Callers own shutdown (``server.shutdown();
    router.close()``)."""
    router = Router(groups, **router_kw).start()
    httpd = ScoringHTTPServer((host, port), make_router_handler(router))
    threading.Thread(
        target=httpd.serve_forever, daemon=True, name="pool-router"
    ).start()
    return httpd, f"http://{host}:{httpd.server_address[1]}", router
