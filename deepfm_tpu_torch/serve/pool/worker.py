"""One shard-group member: the sharded scorer behind HTTP plus the member
half of the group-atomic swap: counterpart of
``deepfm_tpu/serve/pool/worker.py`` for one tenant.

A member holds its ``[dp, mp]`` row-sharded predict (sharded.py) behind
the micro-batcher, every bucket a CUDA graph in each of three weight
slots, or a funnel servable's :class:`~...funnel.serve.FunnelScorer` with
three slots, and answers the swap protocol that swap.py drives:

    POST /admin:stage    {"version": V[, "source": ROOT]}
        fetch, check the param hash and the tensor specs, upload into a
        free slot and canary through that slot's live graphs; hold it
        staged.
    POST /admin:commit   {"generation": G, "version": V}
        repoint traffic to the staged slot and adopt generation G (it must
        advance); the previous slot is kept for a rollback.
    POST /admin:rollback
        back to the kept slot and its generation.
    POST /admin:abort
        drop the staged slot (it was never live).

**Three slots.**  A member can hold a live payload, a staged one and the
retained previous one at once (``commit`` keeps ``prev``, a later
``stage`` does not drop it), so a stage always finds a free slot and never
overwrites the payload a rollback needs.  Weights are never copied at
commit: the canary ran through the very graphs that go live.

**Generation-skew protection**: the router pins each request to a group
generation (``X-Pinned-Generation``); a member on another answers 409 and
scores nothing, and a 200 whose generation moved while it was scored is
turned into a 409 too, so no response is labelled with a generation that
did not score it.

The HTTP surface is serve/server.py's handler with ``group_status``:
responses carry ``shard_group``, ``tenant`` and ``group_generation``,
``/readyz`` the generation and version, ``/v1/metrics`` a ``router``
section (with the card memory the member's allocator holds).  With an SLO
(``core.config.SloConfig``), one ``AdmissionController`` over a
``BucketCostModel`` of the buckets prices deadlines and sheds in the
member's engine (a funnel member's is built first, so the scorer captures
its degraded retrieve).  A member serves one tenant, JAX's
``DEFAULT_TENANT``; multi-tenant members are ROADMAP A18.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable

import numpy as np

from ...obs import flight as obs_flight
from ...obs.metrics import MetricsRegistry
from ...obs.trace import DEFAULT_SAMPLE_RATE, Tracer
from ..batcher import DEFAULT_BUCKETS, MicroBatcher
from ..server import ScoringHTTPServer, device_memory, make_handler
from . import DEFAULT_TENANT, TENANTS_NOT_PORTED
from .sharded import MEMBER_SLOTS, group_wire_bytes_est, load_sharded_servable



class SwapProtocolError(RuntimeError):
    """A stage/commit/rollback out of protocol order (no staged payload,
    a generation that does not advance, nothing to roll back): HTTP 409,
    so the coordinator tells misuse from a failed verb."""


def _canary_batch(feature_size: int, fields: int, rows: int):
    """A zero row plus spread in-vocabulary ids (the HotSwapper's probe)."""
    ids = np.zeros((rows, fields), np.int64)
    if rows > 1:
        ids[1:] = np.linspace(0, max(0, feature_size - 1), (rows - 1) * fields,
                              dtype=np.int64).reshape(rows - 1, fields)
    return ids, np.ones((rows, fields), np.float32)


def _check_tenant(tenant: str | None) -> None:
    if tenant not in (None, DEFAULT_TENANT):
        raise ValueError(f"unknown tenant {tenant!r}: {TENANTS_NOT_PORTED}")


def make_admission(slo, buckets, name: str, registry: MetricsRegistry):
    """One ``AdmissionController(BucketCostModel(buckets))`` from an
    ``SloConfig`` (JAX ``worker.py``), or None without one."""
    if slo is None:
        return None
    from ..control.admission import AdmissionController
    from ..control.cost import BucketCostModel

    return AdmissionController(
        BucketCostModel(buckets), deadline_ms=slo.deadline_ms,
        shed_shadow_util=slo.shed_shadow_util, degrade_util=slo.degrade_util,
        shed_predict_util=slo.shed_predict_util, degrade_floor_pct=slo.degrade_floor_pct,
        name=name, registry=registry)


class GroupMember:
    """One member of shard-group ``group`` on ``device`` (default: the
    card).  All swap-protocol state (the staged slot, the retained
    previous slot, the generation) is guarded by one lock; scoring never
    takes it (the holder's drain orders swaps against dispatches)."""

    def __init__(self, servable_dir: str, *, data_parallel: int = 1, model_parallel: int = 1,
                 device=None, group: str = "g0", member: str = "m0",
                 buckets=DEFAULT_BUCKETS, max_wait_ms: float = 2.0,
                 max_queue_rows: int | None = None, exchange: str | None = None,
                 source: str | None = None, staging_dir: str | None = None,
                 funnel_top_k: int = 0, funnel_return_n: int = 0,
                 funnel_retrieval: str = "", funnel_oversample: int = 0,
                 registry: MetricsRegistry | None = None, slo=None, tenants=None):
        from ...funnel.publish import is_funnel_servable

        if tenants:
            raise NotImplementedError(f"--tenants: {TENANTS_NOT_PORTED}")
        buckets = tuple(sorted(int(b) for b in buckets))
        self.group, self.member = group, member
        self.registry = registry if registry is not None else MetricsRegistry()
        # router-propagated trace ids are always recorded; direct traffic
        # is sampled here
        self.tracer = Tracer(f"worker:{group}/{member}", sample_rate=DEFAULT_SAMPLE_RATE)
        self.funnel = is_funnel_servable(os.path.abspath(servable_dir))
        self._source = source
        # per-member staging: in-process members must not satisfy each
        # other's fetch
        self._staging = staging_dir or os.path.join(
            tempfile.gettempdir(), f"deepfm_pool_{os.getpid()}_{group}_{member}")
        os.makedirs(self._staging, exist_ok=True)
        engine_name = f"{'recommend' if self.funnel else 'predict'}[{group}/{member}]"
        self.admission = make_admission(slo, buckets, engine_name, self.registry)
        if self.funnel:
            from ...funnel.serve import FunnelScorer

            self._scorer = FunnelScorer(
                servable_dir, device=device, top_k=funnel_top_k, return_n=funnel_return_n,
                retrieval=funnel_retrieval, oversample=funnel_oversample,
                model_parallel=model_parallel, data_parallel=data_parallel, buckets=buckets,
                max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows, name=engine_name,
                registry=self.registry, admission=self.admission, slots=MEMBER_SLOTS)
            self.ctx = self._scorer.ctx
            self.holder = self._scorer.holder
            self.engine = self._scorer.engine
            self.predictor = None
            self.mesh = [int(data_parallel), self.ctx.model_parallel]
            self.device = self._scorer.device
        else:
            self._scorer = None
            predict, self.predictor, self.holder, self.ctx = load_sharded_servable(
                servable_dir, data_parallel, model_parallel, device=device,
                exchange=exchange, buckets=buckets)
            self.engine = MicroBatcher(predict, self.ctx.cfg.field_size, buckets=buckets,
                                       max_wait_ms=max_wait_ms,
                                       max_queue_rows=max_queue_rows, name=engine_name,
                                       registry=self.registry, admission=self.admission)
            self.mesh = [self.ctx.data_parallel, self.ctx.model_parallel]
            self.device = self.ctx.device
            self._canary = _canary_batch(self.ctx.true_feature_size, self.ctx.cfg.field_size,
                                         buckets[0])
        self._lock = threading.Lock()
        self.generation = 0
        self.staged = None          # (slot, manifest)
        self.prev = None            # (slot, version, generation, manifest)
        self.skew_aborts_total = 0
        self.swaps_total = 0
        self.rollbacks_total = 0
        self.stage_failures_total = 0
        self.last_stage_ms: float | None = None
        self.last_canary_ms: float | None = None
        self.last_swap_ms: float | None = None
        # every (slot, bucket) graph captured and warmed up before the
        # socket opens (the funnel scorer captured its own)
        self.compile_secs = (self._scorer.compile_secs if self.funnel else {
            "capture": self.engine.run_on_worker(self.predictor.precompile),
            "warm": self.engine.precompile()})

    # -- serving surface ----------------------------------------------------
    @property
    def version(self) -> int:
        return self.holder.version

    @property
    def graph_count(self) -> int:
        return (self._scorer.graphs.graph_count if self.funnel
                else self.predictor.graph_count)

    def group_status(self) -> dict:
        """The ``group_status`` document (serve/server.py make_handler):
        predict responses, ``/readyz`` and ``/v1/metrics``' ``router``
        section.  Lock-free: a probe must not queue behind a commit's
        drain."""
        if self.funnel:
            from ...funnel.index import funnel_wire_bytes_est

            exchange, wire = "funnel", funnel_wire_bytes_est(self.ctx, max(self.engine.buckets))
        else:
            exchange = self.ctx.exchange
            wire = group_wire_bytes_est(self.ctx, max(self.engine.buckets))
        return {
            "shard_group": self.group,
            "member": self.member,
            "tenant": DEFAULT_TENANT,
            "group_generation": self.generation,
            "exchange": exchange,
            "mesh": list(self.mesh),
            "exchange_wire_bytes_est": wire,
            "skew_aborts_total": self.skew_aborts_total,
            **device_memory(),
        }

    def readiness(self) -> dict:
        doc = {"ready": True, "engine_compiled": True, "weights_loaded": True,
               "model_version": self.holder.version,
               "tenants": {DEFAULT_TENANT: {"generation": self.generation,
                                            "model_version": self.holder.version}}}
        if self.funnel:
            doc["retrieval_mode"] = self.ctx.retrieval_mode
        return doc

    def reload_status(self) -> dict:
        staged = self.staged
        return {
            "model_version": self.holder.version,
            "tenant": DEFAULT_TENANT,
            "swaps_total": self.swaps_total,
            "rollbacks_total": self.rollbacks_total,
            "stage_failures_total": self.stage_failures_total,
            "staged_version": None if staged is None else staged[1].version,
            "live_slot": self.holder.get(),
            "graphs": self.graph_count,
            "last_stage_ms": self.last_stage_ms,
            "last_canary_ms": self.last_canary_ms,
            "last_swap_ms": self.last_swap_ms,
        }

    # -- swap protocol (member half; swap.py is the coordinator) ------------
    def _free_slot(self) -> int:
        busy = {self.holder.get()}
        if self.prev is not None:
            busy.add(self.prev[0])
        if self.staged is not None:
            busy.add(self.staged[0])
        slots = self._scorer.graphs.slots if self.funnel else self.predictor.slots
        return next(s for s in range(slots) if s not in busy)

    def stage(self, version: int, source: str | None = None, tenant: str | None = None) -> dict:
        """Fetch, verify and canary ``version`` into a free slot and hold
        it staged.  Raises on any failure; the slot was never live."""
        _check_tenant(tenant)
        root = source or self._source
        if not root:
            raise ValueError("no publish root: the member has no source and the stage "
                             "request named none")
        with self._lock:
            # a re-stage replaces the staged slot, never the live or the kept one
            self.staged = None
            slot = self._free_slot()
        try:
            t0 = time.perf_counter()
            if self.funnel:
                slot, manifest = self._scorer.stage_version(root, int(version),
                                                            self._staging, slot=slot)
                self.last_stage_ms = self._scorer.last_stage_ms
                self.last_canary_ms = self._scorer.last_canary_ms
            else:
                manifest = self._stage_ctr(root, int(version), slot, t0)
        except Exception as e:
            with self._lock:
                self.stage_failures_total += 1
            obs_flight.record("swap_stage_failed", subsystem="pool", group=self.group,
                              member=self.member, version=int(version),
                              error=f"{type(e).__name__}: {e}")
            raise
        with self._lock:
            self.staged = (slot, manifest)
            gen = self.generation
        obs_flight.record("swap_stage", subsystem="pool", group=self.group,
                          member=self.member, version=manifest.version, slot=slot)
        return {"staged_version": manifest.version, "tenant": DEFAULT_TENANT,
                "group_generation": gen}

    def _stage_ctr(self, root: str, version: int, slot: int, t0: float):
        from ...convert import params_to_jax
        from ...core.config import load_config
        from ...online.publisher import param_tree_hash, resolve_version
        from ..export import read_params
        from .sharded import stage_sharded_payload

        manifest, local = resolve_version(root, version, self._staging)
        try:
            served = load_config(local)
            state = read_params(local)
            got = param_tree_hash(*params_to_jax(state, served))
            if manifest.param_hash and got != manifest.param_hash:
                raise ValueError(
                    f"version {version} param hash mismatch (manifest "
                    f"{manifest.param_hash[:12]}…, staged {got[:12]}…) — torn or "
                    f"corrupted artifact")
        except Exception:
            # corruption-shaped: purge the staged copy so a retry fetches it again
            if os.path.abspath(local).startswith(os.path.abspath(self._staging) + os.sep):
                shutil.rmtree(local, ignore_errors=True)
            raise
        ctx = self.ctx
        if (served.feature_size, served.field_size) != (ctx.true_feature_size,
                                                        ctx.cfg.field_size):
            raise ValueError(
                f"version {version} has feature_size {served.feature_size} and field_size "
                f"{served.field_size}; the member's graphs serve {ctx.true_feature_size} "
                f"and {ctx.cfg.field_size}: not hot-swappable, redeploy")
        staged = stage_sharded_payload(ctx, state)
        live = self.predictor.slot_specs()
        if live != {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in staged.items()}:
            raise ValueError(f"version {version} parameter tree differs from the member's "
                             f"graphs': swapping would need a re-capture; redeploy")
        self.engine.run_on_worker(lambda: self.predictor.load_slot(slot, staged))
        t1 = time.perf_counter()
        probs = self.engine.run_on_worker(
            lambda: self.predictor.predict_with(slot, *self._canary))
        self.last_stage_ms = round(1e3 * (t1 - t0), 3)
        self.last_canary_ms = round(1e3 * (time.perf_counter() - t1), 3)
        if not np.isfinite(probs).all():
            raise ValueError(f"canary probe produced non-finite scores "
                             f"({int((~np.isfinite(probs)).sum())}/{probs.size} bad)")
        if ((probs < 0.0) | (probs > 1.0)).any():
            raise ValueError("canary probe produced out-of-range scores")
        return manifest

    def commit(self, generation: int, version: int, tenant: str | None = None,
               drain_timeout_secs: float = 30.0) -> dict:
        """Make the staged slot live and adopt ``generation``, which must
        advance (a respawned member's repair jumps forward); the previous
        slot is kept for one rollback."""
        _check_tenant(tenant)
        with self._lock:
            generation = int(generation)
            if self.staged is None:
                raise SwapProtocolError(
                    f"commit without a staged payload (generation {self.generation})")
            slot, manifest = self.staged
            if manifest.version != int(version):
                raise SwapProtocolError(
                    f"commit names version {version} but {manifest.version} is staged")
            if generation <= self.generation:
                raise SwapProtocolError(
                    f"commit generation {generation} does not advance {self.generation}")
            prev = (self.holder.get(), self.holder.version, self.generation,
                    self.holder.manifest)
            # the generation first: a request pinned to the old one that
            # arrives during the drain is refused, not scored on new weights
            self.generation = generation
            t0 = time.perf_counter()
            drained = self.holder.swap(slot, version=manifest.version, manifest=manifest,
                                       drain_timeout_secs=drain_timeout_secs)
            self.last_swap_ms = round(1e3 * (time.perf_counter() - t0), 3)
            self.prev, self.staged = prev, None
            self.swaps_total += 1
            obs_flight.record("swap_commit", subsystem="pool", group=self.group,
                              member=self.member, generation=generation,
                              version=manifest.version, drained=bool(drained))
            return {"group_generation": generation, "tenant": DEFAULT_TENANT,
                    "model_version": self.holder.version, "drained": bool(drained)}

    def rollback(self, tenant: str | None = None) -> dict:
        """Back to the kept slot, its version and generation."""
        _check_tenant(tenant)
        with self._lock:
            if self.prev is None:
                raise SwapProtocolError("nothing to roll back")
            slot, version, gen, manifest = self.prev
            self.generation = gen
            self.holder.swap(slot, version=version, manifest=manifest)
            self.prev = None
            self.rollbacks_total += 1
            obs_flight.record("swap_rollback", subsystem="pool", group=self.group,
                              member=self.member, generation=gen, version=version)
            return {"group_generation": gen, "tenant": DEFAULT_TENANT,
                    "model_version": self.holder.version}

    def abort(self, tenant: str | None = None) -> dict:
        _check_tenant(tenant)
        with self._lock:
            had = self.staged is not None
            self.staged = None
            gen = self.generation
        if had:
            obs_flight.record("swap_abort", subsystem="pool", group=self.group,
                              member=self.member, generation=gen)
        return {"aborted": had, "tenant": DEFAULT_TENANT, "group_generation": gen}

    def close(self) -> None:
        self.engine.close()


def make_member_handler(member: GroupMember, model_name: str):
    """serve/server.py's handler with the member's ``group_status``, plus
    the admin verbs, the ``X-Tenant`` check and the generation-skew gate on
    ``:predict``, ``:predict_binary`` and (funnel members) ``/v1/recommend``."""
    from ...funnel.serve import RECOMMEND_PATH, handle_recommend

    base = make_handler(member._scorer if member.funnel else member.engine, model_name,
                        reload_status=member.reload_status, readiness=member.readiness,
                        registry=member.registry, tracer=member.tracer,
                        group_status=member.group_status)
    predict_paths = {f"/v1/models/{model_name}:predict",
                     f"/v1/models/{model_name}:predict_binary"}
    if member.funnel:
        predict_paths = {RECOMMEND_PATH}
    admin: dict[str, Callable[[dict], dict]] = {
        "/admin:stage": lambda b: member.stage(b["version"], b.get("source"),
                                               tenant=b.get("tenant")),
        "/admin:commit": lambda b: member.commit(b["generation"], b["version"],
                                                 tenant=b.get("tenant")),
        "/admin:rollback": lambda b: member.rollback(tenant=b.get("tenant")),
        "/admin:abort": lambda b: member.abort(tenant=b.get("tenant")),
    }

    class MemberHandler(base):
        _attrib_generation = None

        def do_POST(self):  # noqa: N802 (http.server API)
            try:
                return self._member_post()
            finally:
                # keep-alive reuses the handler: the guard is per request
                self._attrib_generation = None

        def _member_post(self):
            if self.path in admin:
                return self._do_admin(admin[self.path])
            if self.path not in predict_paths:
                if member.funnel:
                    self._drain_body()
                    return self._send(404, {"error": f"unknown path {self.path!r} (funnel "
                                                     f"members serve POST {RECOMMEND_PATH})"})
                return super().do_POST()
            tenant = self.headers.get("X-Tenant")
            if tenant not in (None, DEFAULT_TENANT):
                self._drain_body()
                return self._send(400, {"error": f"unknown tenant {tenant!r}",
                                        "tenants": [DEFAULT_TENANT]})
            pinned = self.headers.get("X-Pinned-Generation")
            if pinned is not None:
                try:
                    want = int(pinned)
                except ValueError:
                    self._drain_body()
                    return self._send(400, {"error": f"bad X-Pinned-Generation {pinned!r}"})
                live = member.generation
                if want != live:
                    # the skew abort: refuse, never score (lock-free: a
                    # refusal must stay fast while a commit drains)
                    member.skew_aborts_total += 1
                    obs_flight.record("skew_abort", subsystem="pool", group=member.group,
                                      member=member.member, pinned_generation=want,
                                      group_generation=live)
                    self._drain_body()
                    return self._send(409, {"error": "generation skew",
                                            "pinned_generation": want,
                                            "shard_group": member.group,
                                            "tenant": DEFAULT_TENANT,
                                            "group_generation": live})
            # arm the attribution guard (_send): the generation the gate let in
            self._attrib_generation = member.generation
            if member.funnel:
                ctx = member.tracer.begin("recommend", self.headers)
                token = member.tracer.activate(ctx)
                self._obs_status = None
                try:
                    return self._do_recommend()
                finally:
                    member.tracer.finish(ctx, token, status=self._obs_status)
            return super().do_POST()

        def _send(self, code, doc, extra_headers=None):
            # a JSON 200 whose generation moved while it was scored would
            # carry the new label on possibly old scores: 409 instead (the
            # router re-pins and retries)
            gen = getattr(self, "_attrib_generation", None)
            if gen is not None and code == 200 and member.generation != gen:
                live = member.generation
                member.skew_aborts_total += 1
                obs_flight.record("skew_abort", subsystem="pool", phase="response",
                                  group=member.group, member=member.member,
                                  pinned_generation=gen, group_generation=live)
                return super()._send(409, {"error": "generation moved mid-request",
                                           "shard_group": member.group,
                                           "tenant": DEFAULT_TENANT,
                                           "group_generation": live})
            return super()._send(code, doc, extra_headers=extra_headers)

        def _do_recommend(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                if not isinstance(req, dict):
                    raise TypeError(f"the body is {type(req).__name__}, not an object")
            except Exception as e:
                return self._send(400, {"error": f"{type(e).__name__}: {e}"})
            code, doc = handle_recommend(member._scorer, req)
            if code == 200:
                doc.update(shard_group=member.group, tenant=DEFAULT_TENANT,
                           group_generation=self._attrib_generation)
            self._send(code, doc)

        def _drain_body(self):
            # an early reject still reads the body, or the keep-alive
            # framing would parse the next request out of it
            length = int(self.headers.get("Content-Length", "0") or 0)
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 16))
                if not chunk:
                    break
                length -= len(chunk)

        def _do_admin(self, fn):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
            except Exception as e:
                return self._send(400, {"error": f"{type(e).__name__}: {e}"})
            try:
                doc = fn(body)
            except SwapProtocolError as e:
                return self._send(409, {"error": str(e)})
            except (ValueError, KeyError, TypeError, NotImplementedError) as e:
                return self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})
            self._send(200, doc)

    return MemberHandler


def start_member(servable_dir: str, *, model_name: str = "deepfm", host: str = "127.0.0.1",
                 port: int = 0, **member_kw) -> tuple[ScoringHTTPServer, str, GroupMember]:
    """An in-process member on a daemon thread (the tests' topology; the
    pool runs :func:`serve_member` in a process a member).  Returns
    ``(server, base_url, member)``; the caller shuts both down
    (``server.shutdown(); member.close()``)."""
    gm = GroupMember(servable_dir, **member_kw)
    httpd = ScoringHTTPServer((host, port), make_member_handler(gm, model_name))
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name=f"pool-member-{gm.group}-{gm.member}").start()
    return httpd, f"http://{host}:{httpd.server_address[1]}", gm


def serve_member(servable_dir: str, *, model_name: str = "deepfm", host: str = "127.0.0.1",
                 port: int = 0, ready: threading.Event | None = None, **member_kw) -> None:
    """The member process's body (serve/pool/__main__.py): build, capture,
    then serve until the process stops."""
    import sys

    gm = GroupMember(servable_dir, **member_kw)
    try:
        with ScoringHTTPServer((host, port), make_member_handler(gm, model_name)) as httpd:
            if ready is not None:
                ready.port = httpd.server_address[1]  # type: ignore[attr-defined]
                ready.server = httpd  # type: ignore[attr-defined]
                ready.member = gm  # type: ignore[attr-defined]
                ready.set()
            print(f"pool member {gm.group}/{gm.member}: serving {model_name} on "
                  f"http://{host}:{httpd.server_address[1]} (mesh {gm.mesh}, exchange "
                  f"{gm.group_status()['exchange']}, {gm.graph_count} graphs, capture "
                  f"{gm.compile_secs})", file=sys.stderr)
            httpd.serve_forever()
    finally:
        gm.close()
