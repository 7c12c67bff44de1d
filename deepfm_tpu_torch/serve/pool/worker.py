"""One shard-group member: the sharded scorer behind HTTP plus the member
half of the group-atomic swap: counterpart of
``deepfm_tpu/serve/pool/worker.py``.

A member holds its ``[dp, mp]`` row-sharded predict (sharded.py) behind
a micro-batcher, every bucket a CUDA graph in each weight slot, or a
funnel servable's :class:`~...funnel.serve.FunnelScorer` with three slots,
and answers the swap protocol that swap.py drives:

    POST /admin:stage    {"version": V[, "source": ROOT][, "tenant": T]}
        fetch, check the param hash, the executable spec and the tensor
        specs, upload into a free slot of the tenant and canary through
        that slot's live graphs; hold it staged.
    POST /admin:commit   {"generation": G, "version": V[, "tenant": T]}
        repoint the tenant's traffic to the staged slot and adopt
        generation G (it must advance); the previous slot is kept for a
        rollback.
    POST /admin:rollback {["tenant": T]}
        back to the kept slot and its generation.
    POST /admin:abort    {["tenant": T]}
        drop the staged slot (it was never live).

**Three slots a tenant.**  A tenant can hold a live payload, a staged one
and the retained previous one at once (``commit`` keeps ``prev``, a later
``stage`` does not drop it), so a stage always finds a free slot and never
overwrites the payload a rollback needs.  Weights are never copied at
commit: the canary ran through the very graphs that go live.

**Multi-tenant members** (fleet/): a member serves N same-spec model
variants, *tenants*.  Tenant ``i`` owns slots ``[3i, 3i + 3)`` of the
predictor, captured with every other slot at boot, its own holder, its own
micro-batcher (one tenant's burst cannot pad another's dispatches), its
own generation and its own swap-protocol state.  Requests pick a tenant
with ``X-Tenant`` (default: the first tenant), admin verbs with a
``"tenant"`` field, and the generation-skew gate is keyed by (tenant,
generation): tenant A's swap cannot roll back, skew-abort or relabel
tenant B.  Every slot's graphs share each bucket's static buffers, so
every replay, slot upload, canary and capture of every tenant runs under
one dispatch lock (JAX's member serializes its dispatches the same way).

**Generation-skew protection**: the router pins each request to a
(tenant, generation) (``X-Pinned-Generation``); a member on another
answers 409 and scores nothing, and a 200 whose generation moved while it
was scored is turned into a 409 too, so no response is labelled with a
generation that did not score it.

The HTTP surface is serve/server.py's handler with ``group_status``:
responses carry ``shard_group``, ``tenant`` and ``group_generation``,
``/readyz`` a ``tenants`` map (generation and version of each),
``/v1/metrics`` a ``router`` section (with the card memory the member's
allocator holds) and a ``tenants`` section.  With an SLO
(``core.config.SloConfig``), one ``AdmissionController`` over a
``BucketCostModel`` of the buckets prices deadlines and sheds in every
tenant's engine (a funnel member's is built first, so the scorer captures
its degraded retrieve).  A funnel member serves its one published funnel.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable

import numpy as np

from ...fleet.registry import DEFAULT_TENANT, TenantSpec, parse_tenants
from ...obs import flight as obs_flight
from ...obs.metrics import MetricsRegistry
from ...obs.trace import DEFAULT_SAMPLE_RATE, Tracer
from ..batcher import DEFAULT_BUCKETS, MicroBatcher
from ..server import ScoringHTTPServer, device_memory, make_handler, traced_request
from .sharded import MEMBER_SLOTS, group_wire_bytes_est, load_sharded_servable


class SwapProtocolError(RuntimeError):
    """A stage/commit/rollback out of protocol order (no staged payload,
    a generation that does not advance, nothing to roll back): HTTP 409,
    so the coordinator tells misuse from a failed verb."""


class _TenantState:
    """One tenant's share of a member: its first slot, holder, engine,
    generation and swap-protocol state.  A plain container: every change
    happens in GroupMember's methods under the member lock."""

    __slots__ = ("name", "source", "base", "holder", "engine", "generation", "staged",
                 "prev", "skew_aborts_total", "swaps_total", "rollbacks_total",
                 "stage_failures_total", "last_stage_ms", "last_canary_ms", "last_swap_ms")

    def __init__(self, name: str, source: str | None, base: int):
        self.name = name
        self.source = source or ""
        self.base = base             # the tenant's slots: [base, base + MEMBER_SLOTS)
        self.holder = None           # SwappableParams over the live slot
        self.engine = None           # MicroBatcher
        self.generation = 0
        self.staged = None           # (slot, manifest)
        self.prev = None             # (slot, version, generation, manifest)
        self.skew_aborts_total = 0
        self.swaps_total = 0
        self.rollbacks_total = 0
        self.stage_failures_total = 0
        self.last_stage_ms: float | None = None
        self.last_canary_ms: float | None = None
        self.last_swap_ms: float | None = None


class _TenantDispatch:
    """The engine ``make_handler`` scores through: each handler thread
    selects its tenant (``X-Tenant``, set by the member handler) and its
    score calls land on that tenant's engine.  ``metrics_snapshot`` keeps
    the single-engine schema (the default tenant's engine);
    ``tenants_snapshot`` is the ``tenants`` section's hook."""

    # the handler passes X-Deadline-Ms / X-Priority through
    supports_deadline = True

    def __init__(self, member: "GroupMember"):
        self._member = member

    def score(self, ids, vals, **kw):
        return self._member._tenant().engine.score(ids, vals, **kw)

    def score_instances(self, instances, **kw):
        return self._member._tenant().engine.score_instances(instances, **kw)

    def metrics_snapshot(self) -> dict:
        return self._member.engine.metrics_snapshot()

    def tenants_snapshot(self) -> dict:
        return self._member.tenants_snapshot()


def _canary_batch(feature_size: int, fields: int, rows: int):
    """A zero row plus spread in-vocabulary ids (the HotSwapper's probe)."""
    ids = np.zeros((rows, fields), np.int64)
    if rows > 1:
        ids[1:] = np.linspace(0, max(0, feature_size - 1), (rows - 1) * fields,
                              dtype=np.int64).reshape(rows - 1, fields)
    return ids, np.ones((rows, fields), np.float32)


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
    card), serving ``tenants`` (TenantSpecs, dicts or JSON; default one
    tenant, ``DEFAULT_TENANT``, on ``source``).  All swap-protocol state is
    guarded by one lock; scoring never takes it (each holder's drain orders
    swaps against dispatches)."""

    def __init__(self, servable_dir: str, *, data_parallel: int = 1, model_parallel: int = 1,
                 device=None, group: str = "g0", member: str = "m0",
                 buckets=DEFAULT_BUCKETS, max_wait_ms: float = 2.0,
                 max_queue_rows: int | None = None, exchange: str | None = None,
                 source: str | None = None, staging_dir: str | None = None,
                 funnel_top_k: int = 0, funnel_return_n: int = 0,
                 funnel_retrieval: str = "", funnel_oversample: int = 0,
                 registry: MetricsRegistry | None = None, slo=None, tenants=None):
        from ...funnel.publish import is_funnel_servable

        buckets = tuple(sorted(int(b) for b in buckets))
        self.group, self.member = group, member
        self.registry = registry if registry is not None else MetricsRegistry()
        # router-propagated trace ids are always recorded; direct traffic
        # is sampled here
        self.tracer = Tracer(f"worker:{group}/{member}", sample_rate=DEFAULT_SAMPLE_RATE)
        self.funnel = is_funnel_servable(os.path.abspath(servable_dir))
        specs = parse_tenants(tenants) if tenants else ()
        if specs and self.funnel:
            raise ValueError("multi-tenant serving supports CTR servables; a funnel "
                             "member serves its one published funnel")
        if not specs:
            # a pool launched without a fleet config is a one-tenant fleet
            specs = (TenantSpec(name=DEFAULT_TENANT, source=source or ""),)
        self._source = source
        # per-member staging: in-process members must not satisfy each
        # other's fetch
        self._staging = staging_dir or os.path.join(
            tempfile.gettempdir(), f"deepfm_pool_{os.getpid()}_{group}_{member}")
        os.makedirs(self._staging, exist_ok=True)
        self._lock = threading.Lock()
        # one lock over every replay, slot upload, canary and capture of
        # every tenant: their graphs share each bucket's static buffers
        # (serve/graphs.py), and each tenant's engine dispatches from its
        # own thread
        self._dispatch_lock = threading.Lock()
        self._selected = threading.local()
        self._tenants: dict[str, _TenantState] = {}
        self._default = specs[0].name
        self.skew_aborts_total = 0
        self.swaps_total = 0
        self.rollbacks_total = 0
        self.stage_failures_total = 0
        self._tenant_events = self.registry.counter(
            "deepfm_pool_tenant_events_total", "per-tenant member lifecycle events",
            labels=("tenant", "event"))
        multi = len(specs) > 1
        engine_name = f"{'recommend' if self.funnel else 'predict'}[{group}/{member}]"
        # one admission controller across every tenant's engine: the
        # tenants share the member's card and buckets
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
            self.predictor = None
            self.mesh = [int(data_parallel), self.ctx.model_parallel]
            self.device = self._scorer.device
            ts = _TenantState(specs[0].name, specs[0].source or source, 0)
            ts.holder, ts.engine = self._scorer.holder, self._scorer.engine
            self._tenants[ts.name] = ts
        else:
            self._scorer = None
            _, self.predictor, holder, self.ctx = load_sharded_servable(
                servable_dir, data_parallel, model_parallel, device=device,
                exchange=exchange, buckets=buckets, tenants=len(specs))
            self.mesh = [self.ctx.data_parallel, self.ctx.model_parallel]
            self.device = self.ctx.device
            self._canary = _canary_batch(self.ctx.true_feature_size, self.ctx.cfg.field_size,
                                         buckets[0])
            from ..reload import SwappableParams

            for i, spec in enumerate(specs):
                ts = _TenantState(spec.name, spec.source or source, i * MEMBER_SLOTS)
                # every tenant starts on its first slot, all holding the
                # boot servable until its own versions are swapped in
                ts.holder = holder if i == 0 else SwappableParams(ts.base, version=0)
                ts.engine = MicroBatcher(
                    self._tenant_predict(ts), self.ctx.cfg.field_size, buckets=buckets,
                    max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows,
                    name=(f"predict[{group}/{member}/{spec.name}]" if multi
                          else engine_name),
                    registry=self.registry, admission=self.admission)
                self._tenants[ts.name] = ts
        self.engine = self._tenants[self._default].engine
        self.holder = self._tenants[self._default].holder
        self.dispatch = self._scorer if self.funnel else _TenantDispatch(self)
        # every (slot, bucket) graph of every tenant captured, and every
        # tenant's engine warmed up, before the socket opens (the funnel
        # scorer captured its own)
        if self.funnel:
            self.compile_secs = self._scorer.compile_secs
        else:
            capture = self.engine.run_on_worker(lambda: self._locked(self.predictor.precompile))
            self.tenant_compile_secs = {name: ts.engine.precompile()
                                        for name, ts in self._tenants.items()}
            self.compile_secs = {"capture": capture,
                                 "warm": self.tenant_compile_secs[self._default]}

    def _locked(self, fn: Callable, *args):
        with self._dispatch_lock:
            return fn(*args)

    def _tenant_predict(self, ts: _TenantState) -> Callable:
        """The engine's predict for one tenant: its live slot, under the
        dispatch lock; the replay waits for its result, so the slot is not
        released while the card still reads it."""
        predictor = self.predictor

        def predict(feat_ids, feat_vals) -> np.ndarray:
            slot, gen = ts.holder.acquire()
            try:
                with self._dispatch_lock:
                    return predictor.predict_with(slot, feat_ids, feat_vals)
            finally:
                ts.holder.release(gen)

        return predict

    # -- tenant selection (per handler thread) ------------------------------
    def tenant_names(self) -> list[str]:
        return list(self._tenants)

    def _tenant(self, name: str | None = None) -> _TenantState:
        key = name if name is not None else self.selected_tenant()
        try:
            return self._tenants[key]
        except KeyError:
            raise ValueError(f"unknown tenant {key!r} (member serves "
                             f"{list(self._tenants)})") from None

    def select_tenant(self, name: str | None) -> None:
        """Pin the calling thread's tenant (the handler sets it from
        ``X-Tenant`` for the request; None = the default)."""
        self._selected.name = name

    def selected_tenant(self) -> str:
        return getattr(self._selected, "name", None) or self._default

    # -- serving surface ----------------------------------------------------
    @property
    def generation(self) -> int:
        """The default tenant's generation (per-tenant generations are in
        ``readiness()['tenants']``)."""
        return self._tenants[self._default].generation

    @generation.setter
    def generation(self, value: int) -> None:
        self._tenants[self._default].generation = int(value)

    @property
    def staged(self):
        return self._tenants[self._default].staged

    @property
    def prev(self):
        return self._tenants[self._default].prev

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
        section.  ``tenant`` and ``group_generation`` are the handler
        thread's selected tenant's.  Lock-free: a probe must not queue
        behind a commit's drain."""
        ts = self._tenant()
        if self.funnel:
            from ...funnel.index import funnel_wire_bytes_est

            exchange, wire = "funnel", funnel_wire_bytes_est(self.ctx, max(self.engine.buckets))
        else:
            exchange = self.ctx.exchange
            wire = group_wire_bytes_est(self.ctx, max(self.engine.buckets))
        return {
            "shard_group": self.group,
            "member": self.member,
            "tenant": ts.name,
            "group_generation": ts.generation,
            "exchange": exchange,
            "mesh": list(self.mesh),
            "exchange_wire_bytes_est": wire,
            "skew_aborts_total": self.skew_aborts_total,
            **device_memory(),
        }

    def readiness(self) -> dict:
        # lock-free: the tenant table never changes after __init__, and a
        # /readyz that waited out a commit's drain would eject a healthy
        # member
        doc = {"ready": True, "engine_compiled": True, "weights_loaded": True,
               "model_version": self.holder.version,
               "tenants": {name: {"generation": ts.generation,
                                  "model_version": ts.holder.version}
                           for name, ts in self._tenants.items()}}
        if self.funnel:
            doc["retrieval_mode"] = self.ctx.retrieval_mode
        return doc

    def reload_status(self) -> dict:
        ts = self._tenant()
        staged = ts.staged
        return {
            "model_version": ts.holder.version,
            "tenant": ts.name,
            "swaps_total": self.swaps_total,
            "rollbacks_total": self.rollbacks_total,
            "stage_failures_total": self.stage_failures_total,
            "staged_version": None if staged is None else staged[1].version,
            "live_slot": ts.holder.get(),
            "graphs": self.graph_count,
            "last_stage_ms": ts.last_stage_ms,
            "last_canary_ms": ts.last_canary_ms,
            "last_swap_ms": ts.last_swap_ms,
            "tenant_timings": {
                name: {"last_stage_ms": t.last_stage_ms, "last_canary_ms": t.last_canary_ms,
                       "last_swap_ms": t.last_swap_ms}
                for name, t in self._tenants.items()},
        }

    def tenants_snapshot(self) -> dict:
        """The ``tenants`` section of ``/v1/metrics`` (JAX's keys).
        Lock-free like ``readiness``."""
        out = {}
        for ts in self._tenants.values():
            staged = ts.staged
            out[ts.name] = {
                "generation": ts.generation,
                "model_version": ts.holder.version,
                "source": ts.source,
                "staged_version": None if staged is None else staged[1].version,
                "skew_aborts_total": ts.skew_aborts_total,
                "swaps_total": ts.swaps_total,
                "rollbacks_total": ts.rollbacks_total,
                "engine": ts.engine.metrics_snapshot(),
            }
        return out

    # -- swap protocol (member half; swap.py is the coordinator) ------------
    def _free_slot(self, ts: _TenantState) -> int:
        busy = {ts.holder.get()}
        if ts.prev is not None:
            busy.add(ts.prev[0])
        if ts.staged is not None:
            busy.add(ts.staged[0])
        return next(s for s in range(ts.base, ts.base + MEMBER_SLOTS) if s not in busy)

    def stage(self, version: int, source: str | None = None, tenant: str | None = None) -> dict:
        """Fetch, verify and canary ``version`` into a free slot of
        ``tenant`` (default: the first tenant) and hold it staged.  Raises
        on any failure; the slot was never live."""
        ts = self._tenant(tenant)
        root = source or ts.source or self._source
        if not root:
            raise ValueError(f"no publish root: tenant {ts.name!r} has no configured "
                             f"source and the stage request named none")
        with self._lock:
            # a re-stage replaces the staged slot, never the live or the kept one
            ts.staged = None
            slot = self._free_slot(ts)
        try:
            t0 = time.perf_counter()
            if self.funnel:
                slot, manifest = self._scorer.stage_version(root, int(version),
                                                            self._staging, slot=slot)
                ts.last_stage_ms = self._scorer.last_stage_ms
                ts.last_canary_ms = self._scorer.last_canary_ms
            else:
                manifest = self._stage_ctr(ts, root, int(version), slot, t0)
        except Exception as e:
            with self._lock:
                self.stage_failures_total += 1
                ts.stage_failures_total += 1
            self._tenant_events.labels(ts.name, "stage_failed").inc()
            obs_flight.record("swap_stage_failed", subsystem="pool", group=self.group,
                              member=self.member, tenant=ts.name, version=int(version),
                              error=f"{type(e).__name__}: {e}")
            raise
        with self._lock:
            ts.staged = (slot, manifest)
            gen = ts.generation
        obs_flight.record("swap_stage", subsystem="pool", group=self.group,
                          member=self.member, tenant=ts.name, version=manifest.version,
                          slot=slot)
        return {"staged_version": manifest.version, "tenant": ts.name,
                "group_generation": gen}

    def _stage_ctr(self, ts: _TenantState, root: str, version: int, slot: int, t0: float):
        from ...convert import params_to_jax
        from ...core.config import load_config, tenant_spec_divergence
        from ...online.publisher import param_tree_hash, resolve_version
        from ..export import read_params
        from .sharded import stage_sharded_payload

        # the staging cache is per tenant: two tenants publishing the same
        # version number from different roots must not share a fetch
        staging = os.path.join(self._staging, ts.name)
        manifest, local = resolve_version(root, version, staging)
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
            if os.path.abspath(local).startswith(os.path.abspath(staging) + os.sep):
                shutil.rmtree(local, ignore_errors=True)
            raise
        ctx = self.ctx
        # the runtime half of the fleet's spec gate: a version whose model
        # section diverges on an executable-spec field cannot go into the
        # member's captured slots
        true_cfg = dataclasses.replace(ctx.cfg, feature_size=ctx.true_feature_size)
        diff = tenant_spec_divergence(dataclasses.asdict(true_cfg),
                                      dataclasses.asdict(served))
        if diff:
            raise ValueError(
                f"version {version} diverges from the group's executable spec on {diff} "
                f"— not hot-swappable onto shared executables "
                f"(core.config.EXECUTABLE_SPEC_FIELDS)")
        staged = stage_sharded_payload(ctx, state)
        live = self.predictor.slot_specs()
        if live != {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in staged.items()}:
            raise ValueError(f"version {version} parameter tree differs from the member's "
                             f"graphs': swapping would need a re-capture; redeploy")
        ts.engine.run_on_worker(lambda: self._locked(self.predictor.load_slot, slot, staged))
        t1 = time.perf_counter()
        probs = ts.engine.run_on_worker(
            lambda: self._locked(self.predictor.predict_with, slot, *self._canary))
        ts.last_stage_ms = round(1e3 * (t1 - t0), 3)
        ts.last_canary_ms = round(1e3 * (time.perf_counter() - t1), 3)
        if not np.isfinite(probs).all():
            raise ValueError(f"canary probe produced non-finite scores "
                             f"({int((~np.isfinite(probs)).sum())}/{probs.size} bad)")
        if ((probs < 0.0) | (probs > 1.0)).any():
            raise ValueError("canary probe produced out-of-range scores")
        return manifest

    def commit(self, generation: int, version: int, tenant: str | None = None,
               drain_timeout_secs: float = 30.0) -> dict:
        """Make ``tenant``'s staged slot live and adopt ``generation`` on
        that tenant; it must advance (a respawned member's repair jumps
        forward).  The previous slot is kept for one rollback.  Only the
        tenant's own generation, holder and slots move."""
        ts = self._tenant(tenant)
        with self._lock:
            generation = int(generation)
            if ts.staged is None:
                raise SwapProtocolError(f"commit without a staged payload (tenant "
                                        f"{ts.name!r} at generation {ts.generation})")
            slot, manifest = ts.staged
            if manifest.version != int(version):
                raise SwapProtocolError(f"commit names version {version} but tenant "
                                        f"{ts.name!r} staged {manifest.version}")
            if generation <= ts.generation:
                raise SwapProtocolError(f"commit generation {generation} does not advance "
                                        f"tenant {ts.name!r}'s {ts.generation}")
            prev = (ts.holder.get(), ts.holder.version, ts.generation, ts.holder.manifest)
            # the generation first: a request pinned to the old one that
            # arrives during the drain is refused, not scored on new weights
            ts.generation = generation
            t0 = time.perf_counter()
            drained = ts.holder.swap(slot, version=manifest.version, manifest=manifest,
                                     drain_timeout_secs=drain_timeout_secs)
            ts.last_swap_ms = round(1e3 * (time.perf_counter() - t0), 3)
            ts.prev, ts.staged = prev, None
            ts.swaps_total += 1
            self.swaps_total += 1
            self._tenant_events.labels(ts.name, "swap").inc()
            obs_flight.record("swap_commit", subsystem="pool", group=self.group,
                              member=self.member, tenant=ts.name, generation=generation,
                              version=manifest.version, drained=bool(drained))
            return {"group_generation": generation, "tenant": ts.name,
                    "model_version": ts.holder.version, "drained": bool(drained)}

    def rollback(self, tenant: str | None = None) -> dict:
        """Back to ``tenant``'s kept slot, its version and generation;
        every other tenant is untouched."""
        ts = self._tenant(tenant)
        with self._lock:
            if ts.prev is None:
                raise SwapProtocolError(f"nothing to roll back for tenant {ts.name!r}")
            slot, version, gen, manifest = ts.prev
            ts.generation = gen
            ts.holder.swap(slot, version=version, manifest=manifest)
            ts.prev = None
            ts.rollbacks_total += 1
            self.rollbacks_total += 1
            self._tenant_events.labels(ts.name, "rollback").inc()
            obs_flight.record("swap_rollback", subsystem="pool", group=self.group,
                              member=self.member, tenant=ts.name, generation=gen,
                              version=version)
            return {"group_generation": gen, "tenant": ts.name,
                    "model_version": ts.holder.version}

    def abort(self, tenant: str | None = None) -> dict:
        ts = self._tenant(tenant)
        with self._lock:
            had = ts.staged is not None
            ts.staged = None
            gen = ts.generation
        if had:
            obs_flight.record("swap_abort", subsystem="pool", group=self.group,
                              member=self.member, tenant=ts.name, generation=gen)
        return {"aborted": had, "tenant": ts.name, "group_generation": gen}

    def close(self) -> None:
        for ts in self._tenants.values():
            ts.engine.close()


def make_member_handler(member: GroupMember, model_name: str):
    """serve/server.py's handler with the member's ``group_status``, plus
    the admin verbs, the ``X-Tenant`` selection and the (tenant,
    generation) skew gate on ``:predict``, ``:predict_binary`` and
    (funnel members) ``/v1/recommend``."""
    from ...funnel.serve import RECOMMEND_PATH, handle_recommend

    base = make_handler(member.dispatch, model_name,
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
        _attrib_tenant = None

        def do_POST(self):  # noqa: N802 (http.server API)
            try:
                return self._member_post()
            finally:
                # keep-alive reuses the handler: the guard and the tenant
                # are per request
                self._attrib_generation = self._attrib_tenant = None
                member.select_tenant(None)

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
            if tenant is not None and tenant not in member._tenants:
                self._drain_body()
                return self._send(400, {"error": f"unknown tenant {tenant!r}",
                                        "tenants": member.tenant_names()})
            # the header picks which slots score the request; the handler
            # thread stays on that tenant while the response is assembled
            member.select_tenant(tenant)
            ts = member._tenant()
            pinned = self.headers.get("X-Pinned-Generation")
            if pinned is not None:
                try:
                    want = int(pinned)
                except ValueError:
                    self._drain_body()
                    return self._send(400, {"error": f"bad X-Pinned-Generation {pinned!r}"})
                live = ts.generation
                if want != live:
                    # the skew abort: refuse, never score.  Keyed by
                    # (tenant, generation): tenant A mid-commit cannot make
                    # B's correctly pinned requests abort.  Lock-free: a
                    # refusal must stay fast while a commit drains
                    member.skew_aborts_total += 1
                    ts.skew_aborts_total += 1
                    obs_flight.record("skew_abort", subsystem="pool", group=member.group,
                                      member=member.member, tenant=ts.name,
                                      pinned_generation=want, group_generation=live)
                    self._drain_body()
                    return self._send(409, {"error": "generation skew",
                                            "pinned_generation": want,
                                            "shard_group": member.group,
                                            "tenant": ts.name,
                                            "group_generation": live})
            # arm the attribution guard (_send): the generation the gate let in
            self._attrib_tenant, self._attrib_generation = ts.name, ts.generation
            if member.funnel:
                with traced_request(self, member.tracer, "recommend"):
                    return self._do_recommend()
            return super().do_POST()

        def _send(self, code, doc, extra_headers=None):
            # a JSON 200 whose tenant's generation moved while it was
            # scored would carry the new label on possibly old scores: 409
            # instead (the router re-pins and retries)
            t, gen = self._attrib_tenant, self._attrib_generation
            if t is not None and code == 200 and member._tenant(t).generation != gen:
                ts = member._tenant(t)
                live = ts.generation
                member.skew_aborts_total += 1
                ts.skew_aborts_total += 1
                obs_flight.record("skew_abort", subsystem="pool", phase="response",
                                  group=member.group, member=member.member, tenant=t,
                                  pinned_generation=gen, group_generation=live)
                return super()._send(409, {"error": "generation moved mid-request",
                                           "shard_group": member.group,
                                           "tenant": t,
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
                doc.update(shard_group=member.group, tenant=self._attrib_tenant,
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
            except (ValueError, KeyError, TypeError) as e:
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
                  f"{gm.group_status()['exchange']}, tenants {gm.tenant_names()}, "
                  f"{gm.graph_count} graphs, capture {gm.compile_secs})", file=sys.stderr)
            httpd.serve_forever()
    finally:
        gm.close()
