"""Front tier: home-region routing with staleness-gated failover (the
port's copy of ``deepfm_tpu/region/front.py``).

Each user (routing key) has a home region assigned by rendezvous hashing
over the region names (``fleet/split.py rendezvous_ranking``: hash-stable
across restarts and fronts, and losing one of n regions moves only that
region's keys).  The front is the layer above the pool routers: one pool a
region, the front routes between pools.

Whole-region health aggregates each region's router ``/healthz`` and
``/readyz``: ``eject_after`` consecutive probe failures eject the region,
and failures seen in traffic count toward the same bar, so a dead region
is ejected at request speed.

**Model-version skew is an SLO.**  The prober compares every region
store's newest committed version with the home root's.  A region whose
skew exceeds ``max_version_skew`` drains (takes no new traffic) until the
replicator brings it back to ``readmit_version_skew``: the hysteresis band
that keeps a slow store from flapping.  An ejected region re-admits only
when its router is ready again and its skew is back inside the SLO.

Cross-region failover spends a ``TokenBudget`` (serve/control/hedge.py):
the first attempt is free, every further region costs a token accrued at
``failover_budget_pct`` of the recent request rate; an empty budget fails
fast with 503 and ``Retry-After``.  Responses carry the serving and home
region (``X-Region``, ``X-Region-Home``), and the front is the trace head:
a failed-over request keeps its ``X-Trace-Id`` across both attempts.

Pure control plane: no torch, no model bytes; requests pass through as
opaque payloads (``audit_region_front``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

from ..fleet.split import rendezvous_ranking
from ..obs import flight as obs_flight
from ..obs.metrics import MetricsRegistry
from ..obs.trace import DEFAULT_SAMPLE_RATE, Tracer, current_trace
from ..online.publisher import list_versions
from ..serve.control.hedge import TokenBudget
from ..serve.server import ScoringHTTPServer, _send_json, _send_text, traced_request

REGION_HEADER = "X-Region"            # the region that actually served
HOME_HEADER = "X-Region-Home"         # the key's rendezvous home


class _Region:
    __slots__ = ("name", "router_url", "store_root", "admitted",
                 "draining", "fails", "store_version", "served_version",
                 "requests", "failovers_in")

    def __init__(self, name: str, router_url: str, store_root: str):
        self.name = name
        self.router_url = router_url.rstrip("/")
        self.store_root = store_root
        self.admitted = True      # optimistic until the first probe
        self.draining = False     # staleness SLO drain (health is fine)
        self.fails = 0
        self.store_version = 0
        self.served_version = 0
        self.requests = 0
        self.failovers_in = 0


class RegionFront:
    """Route requests to per-region pool routers, home-first.

    ``regions`` maps region name → ``{"router_url", "store_root"}``.
    ``home_root`` is the home publish root whose newest committed
    version defines staleness zero; tests and the audit feed versions
    directly via ``note_home_version``/``note_store_version`` instead of
    running the prober."""

    def __init__(
        self,
        regions: dict[str, dict],
        *,
        home_root: str = "",
        max_version_skew: int = 2,
        readmit_version_skew: int = 0,
        probe_interval_secs: float = 1.0,
        eject_after: int = 2,
        failover_budget_pct: float = 10.0,
        timeout_secs: float = 30.0,
        model_name: str = "deepfm",
        registry: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
    ):
        if not regions:
            raise ValueError("a region front needs at least one region")
        if readmit_version_skew > max_version_skew:
            raise ValueError(
                f"readmit_version_skew={readmit_version_skew} must not "
                f"exceed max_version_skew={max_version_skew} — the "
                f"re-admit bar cannot be laxer than the drain bar"
            )
        self._regions: dict[str, _Region] = {}
        for name, spec in regions.items():
            self._regions[name] = _Region(
                name, spec["router_url"], spec.get("store_root", ""))
        self.home_root = home_root
        self.model_name = model_name
        self.max_version_skew = int(max_version_skew)
        self.readmit_version_skew = int(readmit_version_skew)
        self.probe_interval_secs = float(probe_interval_secs)
        self.eject_after = max(1, int(eject_after))
        self._timeout = float(timeout_secs)
        self._home_version = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.retry_budget = TokenBudget(failover_budget_pct / 100.0)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        # the front is where a request enters the SERVICE: it is the
        # trace head; the per-region router adopts the propagated id, so
        # one trace spans home attempt → failover attempt
        self.tracer = tracer if tracer is not None else Tracer(
            "region-front", sample_rate=DEFAULT_SAMPLE_RATE)
        r = self.registry
        self._c_requests = r.counter(
            "region_front_requests_total", "requests by serving region",
            labels=("region",))
        self._c_failovers = r.counter(
            "region_front_failovers_total",
            "requests served outside their home region",
            labels=("home", "served"))
        self._c_rejected = r.counter(
            "region_front_rejected_total",
            "fail-fast 503s (no serving region / budget exhausted)")
        self._g_home = r.gauge(
            "region_home_version", "newest committed home version")
        self._g_admitted = r.gauge(
            "region_admitted", "1 = taking traffic", labels=("region",))
        self._g_draining = r.gauge(
            "region_draining", "1 = drain-and-catch-up (stale)",
            labels=("region",))
        self._g_store = r.gauge(
            "region_store_version", "region store's newest version",
            labels=("region",))
        self._g_served = r.gauge(
            "region_served_version",
            "newest model_version observed in the region's responses",
            labels=("region",))
        self._g_skew = r.gauge(
            "region_version_skew", "home latest minus region store latest",
            labels=("region",))

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "RegionFront":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._probe_loop, name="region-front-probe",
                daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception as e:  # pragma: no cover - loop guard
                obs_flight.record("region_probe_error",
                                  error=f"{type(e).__name__}: {e}")
            self._stop.wait(self.probe_interval_secs)

    # -- health + staleness probe -------------------------------------------

    def probe_once(self) -> None:
        if self.home_root:
            try:
                versions = list_versions(self.home_root)
                self.note_home_version(versions[-1] if versions else 0)
            # da:allow[swallowed-exception] an unreadable home root freezes staleness zero at the last observed version; the replicator's error path surfaces the outage
            except Exception:
                pass
        for reg in self._regions.values():
            ok = self._probe_region(reg)
            if reg.store_root:
                try:
                    have = list_versions(reg.store_root)
                    self.note_store_version(
                        reg.name, have[-1] if have else 0)
                # da:allow[swallowed-exception] an unreachable region store reads as infinitely stale (it cannot prove freshness, so it must not pass the re-admit gate); the skew gauge carries the outage
                except Exception:
                    self.note_store_version(reg.name, 0)
            with self._lock:
                if ok:
                    reg.fails = 0
                    if not reg.admitted and self._inside_readmit(reg):
                        reg.admitted = True
                        obs_flight.record(
                            "region_readmit", region=reg.name,
                            skew=self._skew(reg))
                elif reg.admitted:
                    reg.fails += 1
                    if reg.fails >= self.eject_after:
                        self._eject(reg, "probe")
            self._export_region(reg)

    def _probe_region(self, reg: _Region) -> bool:
        """Whole-region health: the router's /healthz + /readyz already
        aggregate its members; ejected regions are probed on /readyz
        only (readiness is the re-admission signal)."""
        paths = ("/healthz", "/readyz") if reg.admitted else ("/readyz",)
        try:
            for p in paths:
                with urllib.request.urlopen(
                        f"{reg.router_url}{p}", timeout=5.0) as r:
                    if r.status != 200:
                        return False
            return True
        # da:allow[swallowed-exception] health probe: refused/reset/timeout IS the unhealthy signal; the fails counter and the region_eject flight event carry it
        except Exception:
            return False

    def _skew(self, reg: _Region) -> int:
        return max(0, self._home_version - reg.store_version)

    def _inside_readmit(self, reg: _Region) -> bool:
        return self._skew(reg) <= self.readmit_version_skew

    def _eject(self, reg: _Region, why: str) -> None:
        # caller holds self._lock
        reg.admitted = False
        reg.fails = 0
        obs_flight.record("region_eject", region=reg.name, why=why)

    def note_home_version(self, version: int) -> None:
        with self._lock:
            self._home_version = max(self._home_version, int(version))
        self._g_home.set(self._home_version)
        self._apply_staleness()

    def note_store_version(self, region: str, version: int) -> None:
        reg = self._regions[region]
        with self._lock:
            reg.store_version = int(version)
        self._apply_staleness()

    def _apply_staleness(self) -> None:
        """The staleness SLO edge: drain a region whose skew breached
        ``max_version_skew``; release the drain once the replicator has
        it back inside ``readmit_version_skew`` (hysteresis)."""
        with self._lock:
            for reg in self._regions.values():
                skew = self._skew(reg)
                if not reg.draining and skew > self.max_version_skew:
                    reg.draining = True
                    obs_flight.record(
                        "region_drain", region=reg.name, skew=skew,
                        max_version_skew=self.max_version_skew)
                elif reg.draining and skew <= self.readmit_version_skew:
                    reg.draining = False
                    obs_flight.record(
                        "region_catchup", region=reg.name, skew=skew)

    def _export_region(self, reg: _Region) -> None:
        with self._lock:
            vals = (reg.admitted, reg.draining, reg.store_version,
                    reg.served_version, self._skew(reg))
        self._g_admitted.labels(reg.name).set(float(vals[0]))
        self._g_draining.labels(reg.name).set(float(vals[1]))
        self._g_store.labels(reg.name).set(vals[2])
        self._g_served.labels(reg.name).set(vals[3])
        self._g_skew.labels(reg.name).set(vals[4])

    # -- routing ------------------------------------------------------------

    @staticmethod
    def request_key(body: dict, headers=None) -> str:
        key = body.get("key")
        if isinstance(key, str) and key:
            return key
        if headers is not None:
            for h in ("X-User-Id", "X-Trace-Id"):
                v = headers.get(h)
                if v:
                    return v
        return json.dumps(body.get("instances", ""), sort_keys=True)[:256]

    def plan(self, key: str) -> list[str]:
        """Home-first candidate order for ``key``: the full rendezvous
        ranking filtered to regions currently taking traffic (admitted
        and not draining)."""
        ranking = rendezvous_ranking(key, sorted(self._regions))
        with self._lock:
            return [n for n in ranking
                    if self._regions[n].admitted
                    and not self._regions[n].draining]

    def home(self, key: str) -> str:
        return rendezvous_ranking(key, sorted(self._regions))[0]

    def handle(self, body: dict, *, path: str, tctx=None,
               fwd_headers: dict | None = None) -> tuple[int, dict, dict]:
        """Route one request; returns ``(status, doc, extra_headers)``.

        Attempt 1 is the best serving region (the key's home unless it
        is ejected/draining); every FURTHER region costs one failover
        token.  Exhausted budget or no serving region → fail-fast 503
        with ``Retry-After`` (a brownout must not cascade)."""
        self.retry_budget.note_request()
        key = self.request_key(body, fwd_headers)
        home = self.home(key)
        candidates = self.plan(key)
        payload = json.dumps(body).encode()
        attempts = 0
        for name in candidates:
            if attempts >= 1 and not self.retry_budget.try_spend():
                self._c_rejected.inc()
                obs_flight.record("region_budget_exhausted", key_home=home)
                return (503, {
                    "error": "cross-region failover budget exhausted",
                    "retry_after_s": 1.0, "home_region": home,
                }, {"Retry-After": "1", HOME_HEADER: home})
            attempts += 1
            result = self._try_region(
                name, path=path, payload=payload, tctx=tctx,
                fwd_headers=fwd_headers, attempt=attempts)
            if result is None:
                continue
            code, doc = result
            reg = self._regions[name]
            with self._lock:
                reg.requests += 1
                if name != home:
                    reg.failovers_in += 1
                v = doc.get("model_version")
                if isinstance(v, int):
                    reg.served_version = max(reg.served_version, v)
            self._c_requests.labels(name).inc()
            if name != home:
                self._c_failovers.labels(home, name).inc()
                obs_flight.record("region_failover", home=home,
                                  served=name, attempts=attempts)
            doc["region"] = {"served": name, "home": home,
                             "attempts": attempts}
            extra = {REGION_HEADER: name, HOME_HEADER: home}
            if code == 503 and isinstance(
                    doc.get("retry_after_s"), (int, float)):
                extra["Retry-After"] = str(
                    max(1, int(doc["retry_after_s"] + 0.999)))
            return code, doc, extra
        self._c_rejected.inc()
        return (503, {
            "error": "no admitted region inside the staleness SLO",
            "retry_after_s": 1.0, "home_region": home,
        }, {"Retry-After": "1", HOME_HEADER: home})

    def _try_region(self, name: str, *, path: str, payload: bytes,
                    tctx, fwd_headers, attempt: int):
        """One region's forward.  Returns terminal ``(status, doc)`` or
        None — this region cannot answer, try the next candidate."""
        reg = self._regions[name]
        headers = {"Content-Type": "application/json"}
        if fwd_headers is not None:
            for h in ("X-Tenant", "X-Deadline-Ms", "X-Priority"):
                v = fwd_headers.get(h)
                if v is not None:
                    headers[h] = v
        if tctx is not None:
            # the SAME trace id on every attempt: one trace spans the
            # home-region attempt and the failover attempt
            headers.update(tctx.headers())
        req = urllib.request.Request(
            f"{reg.router_url}{path}", data=payload, headers=headers)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                doc = json.load(r)
                code = r.status
        except urllib.error.HTTPError as e:
            try:
                doc = json.load(e)
            # da:allow[swallowed-exception] best-effort parse of the error body; the HTTPError status drives the decision either way
            except Exception:
                doc = {"error": str(e)}
            code = e.code
            if code in (408, 429) or code >= 500:
                self._note_traffic_failure(reg, f"http {code}")
                return None
            # a 4xx is the CLIENT's problem in every region — surface it
        except Exception as e:
            self._note_traffic_failure(reg, f"{type(e).__name__}")
            return None
        if tctx is not None:
            tctx.add_span("front.forward", t0, time.perf_counter(),
                          region=name, attempt=attempt, status=code)
        return code, doc

    def _note_traffic_failure(self, reg: _Region, why: str) -> None:
        """Traffic-observed region failure: counts toward the same
        ejection threshold as probe failures, so a dead region stops
        receiving first attempts at request speed."""
        with self._lock:
            if not reg.admitted:
                return
            reg.fails += 1
            if reg.fails >= self.eject_after:
                self._eject(reg, "traffic")

    # -- introspection ------------------------------------------------------

    def region_names(self) -> list[str]:
        return sorted(self._regions)

    def status(self) -> dict:
        with self._lock:
            regions = {
                r.name: {
                    "admitted": r.admitted,
                    "draining": r.draining,
                    "store_version": r.store_version,
                    "served_version": r.served_version,
                    "version_skew": self._skew(r),
                    "requests": r.requests,
                    "failovers_in": r.failovers_in,
                }
                for r in self._regions.values()
            }
            home_version = self._home_version
        return {
            "role": "region-front",
            "home_version": home_version,
            "max_version_skew": self.max_version_skew,
            "readmit_version_skew": self.readmit_version_skew,
            "budget": self.retry_budget.snapshot(),
            "regions": regions,
        }


def make_front_handler(front: RegionFront):
    class FrontHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True
        _send = _send_json
        _send_plain = _send_text

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send(200, {"status": "alive", "role": "region-front"})
            elif self.path == "/readyz":
                snap = front.status()
                ready = any(r["admitted"] and not r["draining"]
                            for r in snap["regions"].values())
                self._send(200 if ready else 503,
                           {"ready": ready, "role": "region-front"})
            elif self.path == "/metrics":
                self._send_plain(200, front.registry.render_prometheus())
            elif self.path == "/v1/metrics":
                self._send(200, front.status())
            elif self.path == "/v1/trace/recent":
                self._send(200, {"traces": front.tracer.recent()})
            elif self.path == "/v1/flight":
                self._send(200, {"events": obs_flight.render_events()})
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802
            if not self.path.startswith("/v1/"):
                return self._send(404,
                                  {"error": f"unknown path {self.path!r}"})
            with traced_request(self, front.tracer, "front"):
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length))
                except Exception as e:
                    return self._send(400,
                                      {"error": f"{type(e).__name__}: {e}"})
                code, doc, extra = front.handle(
                    body, path=self.path, tctx=current_trace(),
                    fwd_headers=self.headers)
                self._send(code, doc, extra_headers=extra)

        def log_message(self, fmt, *args):
            pass

    return FrontHandler


def start_front(
    regions: dict[str, dict],
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    **front_kw,
) -> tuple[ScoringHTTPServer, str, RegionFront]:
    """Region front on a daemon thread; returns ``(server, base_url,
    front)``.  Callers own shutdown (``server.shutdown();
    front.close()``)."""
    front = RegionFront(regions, **front_kw).start()
    httpd = ScoringHTTPServer((host, port), make_front_handler(front))
    threading.Thread(
        target=httpd.serve_forever, daemon=True, name="region-front"
    ).start()
    return httpd, f"http://{host}:{httpd.server_address[1]}", front
