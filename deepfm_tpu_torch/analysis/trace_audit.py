"""Trace-time contracts of the port's captured paths: engine 2 of
``deepfm_tpu/analysis/trace_audit.py`` restated for what the port runs.

JAX audits lowered executables without running them.  The port's
counterparts of those executables are CUDA graphs (serve/graphs.py, the
train step's ``StepGraph`` in train/step.py, the paged step of
tiered/step.py), so the audit builds the real entry points at a small
width, runs a few steps, and holds them to the same contracts:

* **transfer** (``trace-transfer``): the train steps are captured under
  ``torch.cuda.set_sync_debug_mode("error")``, so a host sync inside a
  step raises during the capture; the audit reports a capture that
  failed.  The paged step's only host inputs are its declared static
  buffers: the slot ids, values, labels and the stage pack.
* **donation** (``trace-donation``): every parameter, optimizer slot,
  lazy moment, batch-norm buffer and hot-cache tensor keeps its
  ``data_ptr`` over the steps (JAX donates the state; here the step
  updates it in place, which is what lets a graph replay write it and a
  checkpoint read it).
* **dtype** (``trace-dtype``): no float64 in the state or the metrics,
  and no state tensor changes dtype or shape in a step.
* **graphed = eager** (``trace-parity``): the graphed step equals the
  eager step bit for bit over several steps from one initial state and
  one generator state (on batches of distinct ids, where the backward
  kernel's float32 atomics add one term a row); the paged step equals the
  resident lazy step bit for bit across forced evictions.
* **buckets** (``trace-recompile``, JAX ``audit_predict`` and
  ``audit_buckets``): the server's ``GraphedPredictor`` holds exactly
  ``SLOTS x len(buckets)`` graphs, every request size the batcher admits
  maps onto a captured bucket, and a ``HotSwapper`` swap captures nothing
  (``fused_ctr.captured`` is unchanged).
* **the pool members** (JAX ``audit_group_buckets``,
  ``audit_sharded_predict``, ``audit_control_plane``): a member holds
  three slots x every bucket of graphs and refuses a bucket that does not
  divide by ``dp``; its row-sharded predict reads nothing back to the
  host (the all-to-all's psum fallback is a device select, captured under
  the sync guard on the card, run under a host-read guard on the CPU),
  equals the single-process predict bit for bit on spread and
  overflowing batches, reads its weights from the slot, and a swap
  captures nothing; admission, hedging, the shed gate and the autoscaler
  import no torch, and a degraded funnel dispatch replays the degraded
  retrieve captured at boot.
* **the fleet** (JAX ``audit_multitenant``, restated for graphs): a
  member's tenants share one graph set, so two distinct same-spec tenant
  payloads record the same launches per replay (on the card); a tenant
  whose tree differs from the member's slots is refused, naming the
  diverging executable-spec fields; a ``copy_`` of a new payload into
  tenant B's slot changes B's answers, leaves A's bit for bit and captures
  nothing (``trace-recompile``); every slot of every tenant captures under
  ``set_sync_debug_mode("error")`` on the card (``trace-transfer``).
* **the region front** (JAX ``audit_region_front``): no module of
  ``region/`` imports torch (an AST walk), the front runs fed as plain
  host code, and with it alive the graphed serving predict still captures
  under the sync guard (on the card; on the CPU its body runs under a
  host-read guard) and answers the same twice (``trace-region-front``).
* **the funnel** (JAX ``audit_funnel``, restated for graphs): both
  stages of every (slot, bucket) are captured under
  ``set_sync_debug_mode("error")`` (``trace-transfer``); the index is a
  parameter: a ``copy_`` of a distinct same-spec payload into a slot
  changes its answers and captures nothing (``trace-recompile``); at
  ``model_parallel`` 2 no tensor with a corpus-sized dimension crosses
  shards, only ``[B, K]`` packs and the ``[B, D]`` queries
  (``trace-collective``); under int8 the retrieve graph's pool stays
  under ``B·rows_local·4`` bytes, so no corpus-sized f32 result exists
  (``trace-quantized``, on the card).

On the CPU the structural contracts run (in place, dtype, one body: the
eager step and the CPU path of the graphed step are one function); the
capture contracts run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  :func:`run_trace_audit` returns every finding.

* **the elastic reshard** (JAX ``audit_elastic``, as far as it applies):
  on every audited move the plan stays under the gather-to-one-place
  bytes and a same-width shrink plans zero table bytes
  (``trace-collective``); a restore at another ``model_parallel`` copies
  no table slice of more rows than the rank's new window out of the
  checkpoint (``trace-transfer``).  JAX's no-host-round-trip clause is
  waived: the port restores each window from the commit's memory-mapped
  files on the host, by design.

* **observability** (``trace-observability``, JAX ``audit_observability``):
  the bodies the graphs capture (``GraphedPredictor``'s forward body from
  its ``_bodies`` factory, and ``resident_body``, dense and lazy) run once
  with every record path of ``obs/`` (metrics, trace spans, the flight
  recorder) and the host timers (``time.perf_counter`` and its kin)
  instrumented, on the auditing thread, with a trace active: none may be
  reached, since a graph records a body's Python once and never runs it
  again.  And two runs from copies of one state on the same inputs must
  be bit-equal: a host value folded into a tensor would bake a different
  constant into each capture.

* **the grid step's collectives** (JAX ``audit_spmd_exchange`` and
  ``audit_zero_update``, ``trace-collective``): the steps of a ``[data x
  model]`` grid stay eager (each reads host flags every step: the
  exchange's overflow flag, ``parallel/embedding.py``; the step's flags
  and the lazy pack's flag, ``parallel/spmd.py``), so instead of a capture
  one eager step each of dense psum, dense alltoall, lazy alltoall and
  dense ZeRO runs on a spawned ``[2, 2]`` world of gloo ranks with every
  ``torch.distributed`` call recorded (analysis/collectives.py), and JAX's
  rules read the record: in alltoall mode no dense row tensor moves
  outside the overflow fallback's arm and the all-to-all is there; the
  lazy step gathers the full slot stream only in its ``update_full`` arm;
  under ZeRO every planned leaf is reduce-scattered and gathered back over
  the data group, no data-group all-reduce carries a gradient, the moments
  are 1/dp windows, and the update reads nothing back to the host
  (``trace-transfer``) and keeps its tensors in place (``trace-donation``).

**Waived** (:data:`WAIVERS`): the online trainer (``online/trainer.py``)
stays eager, and so does the elastic trainer; the elastic reshard's host
round trip is by design.  No audit here claims them.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from .findings import Finding

# what the audit does not claim, and why
WAIVERS = {
    "online_trainer": (
        "online/trainer.py steps eagerly: its loop reads the stream's cursor "
        "and commit flags between steps; so does the elastic trainer "
        "(elastic/controller.py), which also agrees four host flags with the "
        "other ranks before every batch"),
    "audit_elastic.host_round_trip": (
        "the reshard restores each rank's row window from the commit's "
        "memory-mapped row files on the host (checkpoint/reshard.py), by "
        "design: the drain commit is the exactly-once resume point, so the "
        "rows come from it, not device to device"),
}

# small but structurally faithful: the flagship's MLP, dtype and dropout,
# a table small enough for a CPU test
_AUDIT_MODEL = {"feature_size": 997, "field_size": 8, "embedding_size": 16}
_AUDIT_BATCH = 64
_AUDIT_STEPS = 5  # > train.step.WARMUP_STEPS: the capture and replays run


def _finding(rule: str, message: str, where: str, slug: str, hint: str = "") -> Finding:
    return Finding(rule=rule, path=where, line=0, col=0, message=message, hint=hint,
                   source=slug)


def audit_cfg(lazy: bool = False, **model):
    from ..core.config import Config

    return Config().with_overrides(
        model={**_AUDIT_MODEL, **model},
        optimizer={"lazy_embedding_updates": lazy},
        data={"batch_size": _AUDIT_BATCH})


def distinct_batches(cfg, n: int, seed: int = 0) -> list[dict]:
    """``n`` host batches whose B·F ids are distinct within each batch
    (pinned where the card runs)."""
    b, f, v = cfg.data.batch_size, cfg.model.field_size, cfg.model.feature_size
    if b * f > v:
        raise ValueError(f"{b}x{f} distinct ids need a vocabulary of {b * f}, got {v}")
    rng = np.random.default_rng(seed)
    return [{"feat_ids": torch.from_numpy(rng.permutation(v)[:b * f].reshape(b, f)),
             "feat_vals": torch.from_numpy(rng.random((b, f), dtype=np.float32)),
             "label": torch.from_numpy((rng.random(b) < 0.3).astype(np.float32))}
            for _ in range(n)]


def state_tensors(state) -> dict[str, torch.Tensor]:
    """Every tensor a train state carries from step to step, by name:
    parameters and buffers, optimizer slots, lazy moments, scalars."""
    out = {f"model.{k}": v for k, v in state.model.state_dict(keep_vars=True).items()}
    for name, slots in state.optimizer.slots.items():
        out.update({f"optimizer.{name}.{s}": t for s, t in slots.items()})
    lazy = getattr(state, "lazy", None)
    if lazy is not None:
        for part in ("m", "v"):
            out.update({f"lazy.{part}.{k}": t for k, t in getattr(lazy, part).items()})
    hot = getattr(state, "hot", None)
    if hot is not None:
        out.update({f"hot.rows.{k}": t for k, t in hot.rows.items()})
    if state.scalars is not None:
        out["scalars"] = state.scalars
    return out


def _layout(tensors: dict) -> dict:
    """Each tensor with its dtype and shape.  The snapshot holds the tensors
    themselves, so none of their memory is freed while the audit runs: a
    tensor that a step rebinds can then never sit at an address the
    snapshot names."""
    return {k: (t, t.dtype, tuple(t.shape)) for k, t in tensors.items()}


def check_in_place(before: dict, state, where: str, what: str) -> list[Finding]:
    """``trace-donation`` and ``trace-dtype`` findings of ``state`` against
    its ``_layout`` before the steps."""
    out = []
    after = state_tensors(state)
    for name, (was, dtype, shape) in before.items():
        now = after.get(name)
        if now is None or now.data_ptr() != was.data_ptr():
            out.append(_finding(
                "trace-donation", f"{what}: {name} was rebound by a step, not "
                f"updated in place", where, f"{what}:donation:{name}",
                hint="update the tensor with an in-place op (copy_, add_, "
                     "index_copy_); a replay writes the captured memory"))
        elif (now.dtype, tuple(now.shape)) != (dtype, shape):
            out.append(_finding(
                "trace-dtype", f"{what}: {name} went from {dtype} {shape} to "
                f"{now.dtype} {tuple(now.shape)} in a step", where, f"{what}:drift:{name}"))
    return out


def check_dtypes(state, metrics: dict, where: str, what: str) -> list[Finding]:
    out = []
    named = {**state_tensors(state), **{f"metrics.{k}": v for k, v in metrics.items()}}
    for name, t in named.items():
        if t.dtype == torch.float64:
            out.append(_finding("trace-dtype", f"{what}: {name} is float64", where,
                                f"{what}:f64:{name}",
                                hint="keep the state and metrics float32"))
    return out


def _capture_findings(step_fn, state, batch, where: str, what: str):
    """Run one step, turning a failed capture on the card into a
    ``trace-transfer`` finding; returns (metrics or None, findings)."""
    if state.model.fm_b.device.type != "cuda":
        return step_fn(state, batch), []
    try:
        return step_fn(state, batch), []
    except RuntimeError as e:
        return None, [_finding("trace-transfer", f"{what}: the capture failed: "
                               f"{str(e).splitlines()[0][:300]}", where, f"{what}:capture")]


# the other CTR families' widths in the audit (their CIN and cross layers
# run inside the same StepGraph and bucket graphs as DeepFM's head)
_AUDIT_VARIANT = {"cin_layers": (32, 32), "cross_layers": 2}


def audit_train_step(device="cpu", *, lazy: bool = False, state=None, step=None,
                     steps: int = _AUDIT_STEPS, model_name: str = "deepfm") -> list[Finding]:
    """The single-card step's contracts (JAX ``audit_train_step``): in
    place, dtype, and graphed = eager, for ``model_name``'s family.
    ``state`` (default: a fresh state of :func:`audit_cfg`) and ``step``
    (default ``graphed_train_step``) let a test seed a regression."""
    from ..train.step import create_train_state, graphed_train_step, train_step

    where = "deepfm_tpu_torch/train/step.py"
    what = "lazy step" if lazy else "dense step"
    if model_name != "deepfm":
        what = f"{model_name} {what}"
    cfg = (audit_cfg(lazy) if model_name == "deepfm"
           else audit_cfg(lazy, model_name=model_name, **_AUDIT_VARIANT))
    step = step or graphed_train_step
    state = state or create_train_state(cfg, device)
    twin = create_train_state(cfg, device)
    twin.generator.set_state(state.generator.get_state())
    batches = distinct_batches(cfg, steps)
    out = check_dtypes(state, {}, where, what)
    if out:  # a float64 state does not step: report it as it is
        return out
    before = None
    for i, batch in enumerate(batches):
        metrics, failed = _capture_findings(step, state, batch, where, what)
        if failed:
            return failed
        if before is None:  # the scalar buffer exists from the first step
            before = _layout(state_tensors(state))
        eager = train_step(twin, batch)
        for k in metrics:
            if not torch.equal(metrics[k], eager[k]):
                out.append(_finding("trace-parity", f"{what}: step {i + 1}'s {k} differs "
                                    f"from the eager step's", where, f"{what}:parity:{k}"))
                break
    out += check_in_place(before, state, where, what)
    out += check_dtypes(state, metrics, where, what)
    mine, eager_t = state_tensors(state), state_tensors(twin)
    for name, t in mine.items():
        if name in eager_t and not torch.equal(t, eager_t[name]):
            out.append(_finding("trace-parity", f"{what}: {name} after {steps} graphed "
                                f"steps differs from the eager steps'", where,
                                f"{what}:parity:{name}"))
    if torch.device(device).type == "cuda":
        graph = state.graph
        if graph is None or graph.graph is None or graph.replays < 1:
            out.append(_finding("trace-transfer", f"{what}: {steps} steps on the card "
                                f"replayed no graph", where, f"{what}:replayed"))
    return out


def audit_buckets(device="cpu", buckets=None, model_name: str = "deepfm") -> list[Finding]:
    """The serving graphs (JAX ``audit_predict``/``audit_buckets``) of
    ``model_name``'s family: the graph count, every admissible size on a
    captured bucket, and on the card a hot swap that captures nothing."""
    from ..models.base import get_model
    from ..serve.batcher import DEFAULT_BUCKETS, pick_bucket
    from ..serve.export import build_graphed_batcher, export_servable
    from ..serve.graphs import SLOTS

    where = "deepfm_tpu_torch/serve/graphs.py"
    buckets = tuple(buckets or DEFAULT_BUCKETS)
    cfg = (audit_cfg() if model_name == "deepfm"
           else audit_cfg(model_name=model_name, **_AUDIT_VARIANT))
    out: list[Finding] = []
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="trace_audit_") as tmp:
        sd = get_model(cfg.model).build(cfg.model, device="cpu").state_dict()
        servable = export_servable(cfg.model, sd, os.path.join(tmp, "v0"))
        batcher, predictor, holder, mcfg, _ = build_graphed_batcher(
            servable, device=device, buckets=buckets)
        try:
            want = SLOTS * len(buckets) if cuda else 0
            if predictor.graph_count != want:
                out.append(_finding("trace-recompile", f"{predictor.graph_count} bucket "
                                    f"graphs, expected {want}", where, "graph-count"))
            captured = ({b for g in predictor._slots.graphs for b in g} if cuda
                        else set(buckets))
            for n in range(1, buckets[-1] + 1):
                b = pick_bucket(buckets, n)
                if b < n or b not in captured:
                    out.append(_finding("trace-recompile", f"a request of {n} rows maps "
                                        f"onto bucket {b}, not a captured one", where,
                                        f"bucket:{n}"))
                    break
            if cuda:
                out += _audit_swap(batcher, predictor, holder, mcfg, cfg, tmp, where)
        finally:
            batcher.close()
    return out


def _audit_swap(batcher, predictor, holder, mcfg, cfg, tmp, where) -> list[Finding]:
    from ..models.base import get_model
    from ..online.publisher import ModelPublisher
    from ..ops import fused_ctr
    from ..serve.reload import HotSwapper

    pub = os.path.join(tmp, "pub")
    g = torch.Generator().manual_seed(1)
    ModelPublisher(pub).publish(cfg, get_model(cfg.model).build(
        cfg.model, device="cpu", generator=g).state_dict(), step=1)
    graphs, captured = predictor.graph_count, fused_ctr.captured
    swapper = HotSwapper(holder, predictor, pub, mcfg, run=batcher.run_on_worker,
                         staging_dir=os.path.join(tmp, "staging"))
    swapped = swapper.poll_once()
    out = []
    if not swapped or holder.version != 1:
        out.append(_finding("trace-recompile", "the audit's published version did "
                            "not swap in", "deepfm_tpu_torch/serve/reload.py", "swap"))
    if fused_ctr.captured != captured or predictor.graph_count != graphs:
        out.append(_finding("trace-recompile", f"a hot swap captured "
                            f"{fused_ctr.captured - captured} forwards "
                            f"({predictor.graph_count} graphs, {graphs} before)", where,
                            "swap-captured"))
    return out


def audit_paged_step(device="cpu", *, steps: int = _AUDIT_STEPS) -> list[Finding]:
    """The paged step's contracts (JAX ``audit_paged_step``): its inputs
    are its declared static buffers, the hot cache is updated in place,
    no float64, and it equals the resident lazy step bit for bit with a
    cache of one batch (evictions every step)."""
    from ..train.step import create_train_state, train_step
    from ..tiered import TieredTrainer

    where = "deepfm_tpu_torch/tiered/step.py"
    what = "paged step"
    cfg = audit_cfg(lazy=True, fused_kernel="off", tiered_embeddings=True,
                    tiered_page_rows=64)
    bf = cfg.data.batch_size * cfg.model.field_size
    resident = create_train_state(cfg, device)
    batches = distinct_batches(cfg, steps, seed=1)
    out: list[Finding] = []
    with tempfile.TemporaryDirectory(prefix="trace_audit_") as tmp, \
            TieredTrainer.from_resident_state(cfg, create_train_state(cfg, device),
                                              os.path.join(tmp, "cold"), capacity=bf,
                                              stage_rows=bf, host_rows=4 * bf) as tr:
        before = None
        for i, batch in enumerate(batches):
            metrics, failed = _capture_findings(lambda _, b: tr.train_batch(b), tr.state,
                                                batch, where, what)
            if failed:
                return failed
            if before is None:
                before = _layout(state_tensors(tr.state))
            want = train_step(resident, batch)
            if not torch.equal(metrics["loss"], want["loss"]):
                out.append(_finding("trace-parity", f"{what}: step {i + 1}'s loss differs "
                                    f"from the resident lazy step's", where,
                                    f"{what}:parity:loss"))
                break
        out += check_in_place(before, tr.state, where, what)
        out += check_dtypes(tr.state, metrics, where, what)
        graph = tr.state.graph
        if graph is not None:
            declared = {"slot_ids", "feat_vals", "label", "stage_slots", "stage_records"}
            if set(graph.static) != declared:
                out.append(_finding("trace-transfer", f"{what}: static inputs "
                                    f"{sorted(graph.static)}, declared {sorted(declared)}",
                                    where, f"{what}:inputs"))
        if torch.device(device).type == "cuda" and (graph is None or graph.replays < 1):
            out.append(_finding("trace-transfer", f"{what}: {steps} steps on the card "
                                f"replayed no graph", where, f"{what}:replayed"))
        if tr.pager.stats()["evictions"] == 0:
            out.append(_finding("trace-parity", f"{what}: the audit's cache never "
                                f"evicted, so the parity ran without writebacks", where,
                                f"{what}:evictions"))
        rows, _, _ = tr.export_tables()
        for k in ("fm_w", "fm_v"):
            got = torch.from_numpy(rows[k])
            if not torch.equal(got, getattr(resident.model, k).detach().cpu()):
                out.append(_finding("trace-parity", f"{what}: {k} after {steps} paged steps "
                                    f"differs from the resident lazy step's", where,
                                    f"{what}:parity:{k}"))
    return out


# the funnel audit's geometry: two shards of 32,768 rows (corpus-sized
# dimensions stand out from every [B, K] and [B, D] shape), D 16 (B2's
# smallest), top 8 -> 4, oversample 2, two buckets
_FUNNEL_ITEMS, _FUNNEL_CAPACITY, _FUNNEL_SHARDS = 60_000, 65_536, 2
_FUNNEL_BUCKETS = (8, 16)


def _funnel_audit_graphs(device, mode: str, degraded_oversample: int | None = None):
    from ..core.config import ModelConfig
    from ..funnel.graphs import FunnelGraphs
    from ..funnel.index import FunnelIndex, make_funnel_context
    from ..models import DeepFM, TwoTower

    rank_cfg = ModelConfig(feature_size=_FUNNEL_CAPACITY, field_size=4, embedding_size=8,
                           deep_layers=(16,), dropout_keep=(1.0,), compute_dtype="float32")
    query_cfg = ModelConfig(model_name="two_tower", user_vocab_size=500,
                            item_vocab_size=_FUNNEL_CAPACITY, user_field_size=2,
                            item_field_size=2, tower_layers=(16,), tower_dim=16,
                            embedding_size=8, compute_dtype="float32")
    ctx = make_funnel_context(rank_cfg, query_cfg, capacity=_FUNNEL_CAPACITY, top_k=8,
                              return_n=4, retrieval=mode, oversample=2,
                              model_parallel=_FUNNEL_SHARDS)

    def version(seed: int):
        g = torch.Generator().manual_seed(seed)
        rank = DeepFM(rank_cfg, device="cpu", generator=g).state_dict()
        query = TwoTower(query_cfg, device="cpu", generator=g).state_dict()
        emb = torch.nn.functional.normalize(
            torch.randn((_FUNNEL_ITEMS, 16), generator=g), dim=1).numpy()
        ids = torch.randperm(_FUNNEL_CAPACITY, generator=g)[:_FUNNEL_ITEMS]
        return rank, query, FunnelIndex(item_ids=ids.numpy().astype(np.int32), item_emb=emb)

    graphs = FunnelGraphs(ctx, *version(0), device=device, buckets=_FUNNEL_BUCKETS,
                          degraded_oversample=degraded_oversample)
    return ctx, graphs, version(1)


def audit_funnel(device="cpu") -> list[Finding]:
    """The funnel's contracts (JAX ``audit_funnel``) on two index shards,
    exact and int8: the captures under the sync guard, the index as a
    parameter of the graphs, no corpus-sized exchange, and under int8 no
    corpus-sized f32 result in the retrieve graph's pool (on the card)."""
    from ..funnel import index as funnel_index

    where = "deepfm_tpu_torch/funnel/graphs.py"
    out: list[Finding] = []
    rng = np.random.default_rng(0)
    for mode in ("exact", "int8"):
        crossed: list[tuple] = []
        funnel_index.exchange_observer = crossed.append
        try:
            out += _audit_funnel_mode(device, mode, crossed, rng, where)
        finally:
            funnel_index.exchange_observer = None
    return out


def _audit_funnel_mode(device, mode: str, crossed: list, rng, where: str) -> list[Finding]:
    from ..funnel.index import index_shards
    from ..ops import fused_ctr, retrieval

    what = f"funnel {mode}"
    try:
        ctx, graphs, (rank, query, index) = _funnel_audit_graphs(device, mode)
        graphs.precompile()
    except Exception as e:
        return [_finding("trace-transfer", f"{what}: building or capturing the stages "
                         f"under set_sync_debug_mode('error') raised "
                         f"{type(e).__name__}: {e}", where, f"{what}:capture")]
    out: list[Finding] = []
    b = _FUNNEL_BUCKETS[0]
    fu, f = ctx.user_fields, ctx.rank_fields
    ids = np.concatenate([rng.integers(0, 500, (b, fu)),
                          rng.integers(0, ctx.rank_cfg.feature_size, (b, f))], axis=1)
    vals = np.ones((b, fu + f), np.float32)
    before = (graphs.graph_count, retrieval.captured, fused_ctr.captured)
    graphs.load_slot(1, {"rank": rank, "query": query, "shards": index_shards(ctx, index)})
    old, new = graphs.dispatch(0, ids, vals)[0], graphs.dispatch(1, ids, vals)[0]
    if np.array_equal(old, new):
        out.append(_finding("trace-recompile", f"{what}: a distinct payload copied into "
                            f"slot 1 left its answers unchanged (a baked index or "
                            f"weights)", where, f"{what}:parameter"))
    if (graphs.graph_count, retrieval.captured, fused_ctr.captured) != before:
        out.append(_finding("trace-recompile", f"{what}: loading a slot captured again "
                            f"({before} -> {graphs.graph_count} graphs)", where,
                            f"{what}:swap-captured"))
    # crossings happen where the stages are traced: at capture on the card,
    # at every dispatch on the CPU
    corpus = {ctx.capacity, ctx.rows_local}
    big = sorted({s for s in crossed if corpus & set(s)})
    if not crossed or big:
        out.append(_finding("trace-collective", f"{what}: tensors of shapes {big} crossed "
                            f"shards ({len(crossed)} crossings; corpus dims "
                            f"{sorted(corpus)})", where, f"{what}:exchange"))
    if torch.device(device).type == "cuda" and mode == "int8":
        for bucket, nbytes in sorted(graphs.retrieve_pool_bytes.items()):
            limit = bucket * ctx.rows_local * 4
            if nbytes >= limit:
                out.append(_finding("trace-quantized", f"{what}: the retrieve graph at "
                                    f"bucket {bucket} allocated {nbytes} bytes, a "
                                    f"corpus-sized f32 result needs {limit}", where,
                                    f"{what}:pool:{bucket}"))
    return out


class _HostReadGuard(torch.overrides.TorchFunctionMode):
    """Raises on a tensor read back to the host (``item``, ``tolist``,
    ``numpy``, ``cpu``, ``bool``/``int``/``float``) inside its scope: the
    CPU's stand-in for a capture under ``set_sync_debug_mode("error")``."""

    READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu,
             torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise RuntimeError(f"host read {getattr(func, '__name__', func)} inside the "
                               f"guarded predict")
        return func(*args, **(kwargs or {}))


def _member_servable(tmp: str, seed: int = 0) -> tuple[str, dict]:
    from ..models.deepfm import DeepFM
    from ..serve.export import export_servable

    cfg = audit_cfg()
    sd = DeepFM(cfg.model, device="cpu",
                generator=torch.Generator().manual_seed(seed)).state_dict()
    return export_servable(cfg.model, sd, os.path.join(tmp, f"v{seed}")), sd


def audit_group_buckets(device="cpu", buckets=(8, 64)) -> list[Finding]:
    """A member's bucket graphs (JAX ``audit_group_buckets``): three
    slots x every bucket captured on the card, every admissible size on a
    captured bucket, and a bucket that does not divide by ``dp`` refused."""
    from ..serve.batcher import pick_bucket
    from ..serve.pool.sharded import MEMBER_SLOTS, load_sharded_servable

    where = "deepfm_tpu_torch/serve/pool/sharded.py"
    out: list[Finding] = []
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="trace_audit_") as tmp:
        servable, _ = _member_servable(tmp)
        _, predictor, _, _ = load_sharded_servable(servable, 2, 2, device=device,
                                                   buckets=buckets)
        predictor.precompile()
        want = MEMBER_SLOTS * len(buckets) if cuda else 0
        if predictor.graph_count != want:
            out.append(_finding("trace-recompile", f"{predictor.graph_count} member graphs, "
                                f"expected {want}", where, "group-graph-count"))
        for n in range(1, buckets[-1] + 1):
            if pick_bucket(predictor.buckets, n) < n:
                out.append(_finding("trace-recompile", f"a request of {n} rows has no "
                                    f"member bucket", where, f"group-bucket:{n}"))
                break
        try:
            load_sharded_servable(servable, 4, 1, device=device, buckets=(2, 8))
            out.append(_finding("trace-recompile", "a bucket of 2 rows was accepted over "
                                "data_parallel=4", where, "group-indivisible"))
        except ValueError:
            pass
    return out


def audit_sharded_predict(device="cpu") -> list[Finding]:
    """The member's sharded predict (JAX ``audit_sharded_predict``), psum
    and all-to-all: no host read inside it (the psum fallback is a device
    select, so on the card it captures under the sync guard and on the CPU
    it runs under :class:`_HostReadGuard`), the single-process predict's
    answers bit for bit, on a spread batch and on one that overflows the
    all-to-all, the weights read from the slot, and a swap that captures
    nothing."""
    from ..core.config import load_config
    from ..ops import fused_ctr
    from ..serve.export import read_params
    from ..serve.graphs import GraphedPredictor
    from ..serve.pool.sharded import load_sharded_servable, stage_sharded_payload

    where = "deepfm_tpu_torch/serve/pool/sharded.py"
    out: list[Finding] = []
    buckets = (16, 64)
    rng = np.random.default_rng(0)
    f = _AUDIT_MODEL["field_size"]
    with tempfile.TemporaryDirectory(prefix="trace_audit_") as tmp:
        servable, _ = _member_servable(tmp)
        _, other = _member_servable(tmp, seed=1)
        single = GraphedPredictor(load_config(servable), read_params(servable),
                                  device=device, buckets=buckets)
        single.precompile()
        spread = rng.integers(0, _AUDIT_MODEL["feature_size"], (16, f))
        # every id on the first of two shards, more distinct rows than a
        # bucket of the all-to-all holds: the fallback must take over
        skewed = np.arange(16 * f).reshape(16, f) % (_AUDIT_MODEL["feature_size"] // 2)
        vals = rng.random((16, f)).astype(np.float32)
        for dp, mp, exchange in ((1, 2, "psum"), (2, 2, "alltoall"), (1, 2, "alltoall")):
            what = f"[{dp}, {mp}] {exchange}"
            try:
                _, pred, _, ctx = load_sharded_servable(servable, dp, mp, device=device,
                                                        exchange=exchange, buckets=buckets)
                pred.precompile()
                if torch.device(device).type == "cpu":
                    with _HostReadGuard(), torch.no_grad():
                        pred._models[0](torch.from_numpy(skewed), torch.from_numpy(vals))
            except Exception as e:
                out.append(_finding("trace-transfer", f"{what}: the sharded predict read "
                                    f"the host or failed to capture: {type(e).__name__}: "
                                    f"{e}", where, f"{what}:capture"))
                continue
            for name, ids in (("spread", spread), ("skewed", skewed)):
                got = pred.predict_with(0, ids, vals)
                if not np.array_equal(got, single.predict_with(0, ids, vals)):
                    out.append(_finding("trace-parity", f"{what}: the {name} batch's answers "
                                        f"differ from the single-process predict", where,
                                        f"{what}:{name}"))
            before = (pred.graph_count, fused_ctr.captured)
            pred.load_slot(1, stage_sharded_payload(ctx, other))
            if np.array_equal(pred.predict_with(1, spread, vals),
                              pred.predict_with(0, spread, vals)):
                out.append(_finding("trace-recompile", f"{what}: another version copied "
                                    f"into slot 1 left its answers unchanged (weights "
                                    f"baked into the graphs)", where, f"{what}:parameter"))
            if (pred.graph_count, fused_ctr.captured) != before:
                out.append(_finding("trace-recompile", f"{what}: loading a slot captured "
                                    f"again", where, f"{what}:swap-captured"))
    return out


# host-policy modules of the serving control plane: none may touch torch
_CONTROL_MODULES = ("serve/control/admission.py", "serve/control/autoscale.py",
                    "serve/control/cost.py", "serve/control/hedge.py",
                    "serve/pool/router.py", "serve/pool/swap.py")


def audit_control_plane(device="cpu") -> list[Finding]:
    """The SLO control plane stays out of the graphs (JAX
    ``audit_control_plane``): admission, hedging, the shed gate and the
    autoscaler import no torch, and a funnel whose admission degrades
    replays the degraded retrieve graph captured at boot: dispatching
    under a forced degrade captures nothing and answers as the degraded
    stages do eagerly."""
    from ..ops import fused_ctr, retrieval
    from ..serve.control.admission import AdmissionController
    from ..serve.control.cost import BucketCostModel

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out: list[Finding] = []
    for rel in _CONTROL_MODULES:
        with open(os.path.join(root, rel)) as fh:
            text = fh.read()
        if "import torch" in text or "from torch" in text:
            out.append(_finding("trace-transfer", f"{rel} imports torch: the control plane "
                                f"must stay host policy", f"deepfm_tpu_torch/{rel}",
                                f"control-import:{rel}"))
    where = "deepfm_tpu_torch/funnel/graphs.py"
    adm = AdmissionController(BucketCostModel(_FUNNEL_BUCKETS), degrade_util=0.5,
                              shed_shadow_util=0.4, shed_predict_util=0.99)
    ctx, graphs, _ = _funnel_audit_graphs(device, "int8", degraded_oversample=1)
    graphs.precompile()
    before = (graphs.graph_count, retrieval.captured, fused_ctr.captured)
    for _ in range(50):
        adm.observe_utilization(_FUNNEL_BUCKETS[-1] * 16, _FUNNEL_BUCKETS[-1] * 16)
    rng = np.random.default_rng(1)
    b = _FUNNEL_BUCKETS[0]
    ids = np.concatenate([rng.integers(0, 500, (b, ctx.user_fields)),
                          rng.integers(0, ctx.rank_cfg.feature_size, (b, ctx.rank_fields))],
                         axis=1)
    vals = np.ones(ids.shape, np.float32)
    if adm.degrade_factor() >= 1.0:
        out.append(_finding("trace-recompile", "the audit could not force admission's "
                            "degrade", where, "control-degrade"))
    pack = graphs.dispatch(0, ids, vals, degraded=True)[0]
    if not np.array_equal(pack, graphs.eager(0, ids, vals, degraded=True)[0]):
        out.append(_finding("trace-parity", "the degraded retrieve graph does not answer as "
                            "the degraded stages do eagerly", where, "control-degraded"))
    if (graphs.graph_count, retrieval.captured, fused_ctr.captured) != before:
        out.append(_finding("trace-recompile", "a degraded dispatch captured a graph under "
                            "load", where, "control-captured"))
    return out


def audit_multitenant(device="cpu", *, tenant_models=None,
                      predictor_builder=None) -> list[Finding]:
    """The fleet's graph-sharing contract (JAX ``audit_multitenant``,
    restated for graphs; module docstring).  ``tenant_models`` (each
    tenant's model overrides, default two same-spec tenants) and
    ``predictor_builder(ctx, state_dict, buckets, tenants)`` (default
    ``ShardedPredictor``) let the tests seed a spec-divergent tenant and a
    slot model that bakes its weights through the same checks."""
    import dataclasses

    from ..core.config import tenant_spec_divergence
    from ..models.deepfm import DeepFM
    from ..ops import fused_ctr
    from ..serve import graphs as serve_graphs
    from ..serve.graphs import leaf_specs
    from ..serve.pool.sharded import (MEMBER_SLOTS, ShardedPredictor, make_serve_context,
                                      stage_sharded_payload)

    where = "deepfm_tpu_torch/fleet/registry.py"
    out: list[Finding] = []
    overrides = list(tenant_models) if tenant_models is not None else [{}, {}]
    base = audit_cfg().model
    ctx = make_serve_context(base, 1, 2, device=device)
    buckets = (8,)
    init = DeepFM(base, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    build = predictor_builder or (lambda c, sd, b, n: ShardedPredictor(c, sd, buckets=b,
                                                                       tenants=n))
    try:
        pred = build(ctx, init, buckets, len(overrides))
        pred.precompile()
    except Exception as e:
        return [_finding("trace-transfer", f"a {len(overrides)}-tenant member failed to "
                         f"capture its slots under the sync guard: {type(e).__name__}: {e}",
                         where, "multitenant-capture")]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, base.feature_size, (buckets[0], base.field_size))
    vals = rng.random((buckets[0], base.field_size)).astype(np.float32)
    base_dict = dataclasses.asdict(base)
    placed, runs = [], {}
    for i, ov in enumerate(overrides):
        diff = tenant_spec_divergence(base_dict, ov)
        t_model = dataclasses.replace(base, **ov) if ov else base
        sd = DeepFM(t_model, device="cpu",
                    generator=torch.Generator().manual_seed(i + 1)).state_dict()
        try:
            payload = stage_sharded_payload(make_serve_context(t_model, 1, 2, device=device),
                                            sd)
            if leaf_specs(payload) != pred.slot_specs():
                raise ValueError("its slot tree differs from the member's")
            pred.load_slot(i * MEMBER_SLOTS, payload)
        except Exception as e:
            out.append(_finding(
                "trace-recompile", f"tenant {i} cannot go into the member's captured slots "
                f"({type(e).__name__}: {e}): a spec-divergent tenant is claiming one graph "
                f"set" + (f" (diverging fields: {diff})" if diff else ""), where,
                f"multitenant-{i}-spec",
                hint="same-spec tenants only: serve a divergent spec from its own pool "
                     "(core.config.EXECUTABLE_SPEC_FIELDS)"))
            continue
        before = serve_graphs.graph_kernel_runs["forward"] + fused_ctr.launches
        pred.predict_with(i * MEMBER_SLOTS, ids, vals)
        runs[i] = serve_graphs.graph_kernel_runs["forward"] + fused_ctr.launches - before
        placed.append(i)
    if len(set(runs.values())) > 1:
        out.append(_finding("trace-recompile", f"same-spec tenants run different B1 "
                            f"launches per replay {runs}: tenant identity leaked into the "
                            f"graphs", where, "multitenant-launches"))
    if len(placed) < 2:
        return out
    a, b = (s * MEMBER_SLOTS for s in placed[:2])
    counts = (pred.graph_count, fused_ctr.captured)
    a0, b0 = pred.predict_with(a, ids, vals), pred.predict_with(b, ids, vals)
    fresh = DeepFM(base, device="cpu", generator=torch.Generator().manual_seed(99)).state_dict()
    pred.load_slot(b, stage_sharded_payload(ctx, fresh))
    a1, b1 = pred.predict_with(a, ids, vals), pred.predict_with(b, ids, vals)
    if np.array_equal(b0, b1):
        out.append(_finding("trace-recompile", "a new payload copied into tenant B's slot "
                            "left B's answers unchanged: the slot's weights were baked in "
                            "at capture", where, "multitenant-baked",
                            hint="the bodies must read the slot's tensors, which a swap "
                                 "copy_s into (serve/graphs.py load_leaves)"))
    if not np.array_equal(a0, a1):
        out.append(_finding("trace-recompile", "swapping tenant B changed tenant A's "
                            "answers", where, "multitenant-crosstalk"))
    if (pred.graph_count, fused_ctr.captured) != counts:
        out.append(_finding("trace-recompile", "a tenant's swap captured again", where,
                            "multitenant-swap-captured"))
    return out


# the region layer's modules: none may import torch
_REGION_MODULES = ("region/__init__.py", "region/__main__.py", "region/front.py",
                   "region/replicator.py")


def _torch_imports(text: str) -> list[str]:
    import ast

    bad = []
    for node in ast.walk(ast.parse(text)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        bad += [n for n in names if n == "torch" or n.startswith("torch.")]
    return bad


def audit_region_front(device="cpu", *, region_sources=None,
                       predict_builder=None) -> list[Finding]:
    """The cross-region contract (JAX ``audit_region_front``; module
    docstring): the region layer is host control plane.  ``region_sources``
    (module name -> source text, default the files of ``region/``) and
    ``predict_builder(cfg, state_dict, device)`` (default the serving
    ``GraphedPredictor``) let the tests seed an importing module and a
    predict that reads the host."""
    from ..fleet.split import rendezvous_arm, rendezvous_ranking
    from ..models.deepfm import DeepFM
    from ..region.front import RegionFront
    from ..serve.graphs import GraphedPredictor

    where = "deepfm_tpu_torch/region"
    out: list[Finding] = []
    if region_sources is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        region_sources = {}
        for rel in _REGION_MODULES:
            with open(os.path.join(root, rel)) as fh:
                region_sources[rel] = fh.read()
    for name, text in region_sources.items():
        bad = _torch_imports(text)
        if bad:
            out.append(_finding(
                "trace-region-front", f"{name} imports {bad[0]}: the region layer is pure "
                f"control plane and must stay importable (and correct) with no device "
                f"runtime", where, "region-torch-import",
                hint="route, replicate and drain on host state; model bytes never touch "
                     "the front path"))
    try:
        regions = {n: {"router_url": f"http://invalid.test:1/{n}", "store_root": ""}
                   for n in ("use1", "euw1", "apne1")}
        front = RegionFront(regions, max_version_skew=2, readmit_version_skew=0)
        for i in range(16):
            key = f"user-{i}"
            if rendezvous_arm(key, sorted(regions)) != rendezvous_ranking(
                    key, sorted(regions))[0]:
                raise AssertionError(f"{key}: the arm is not the ranking's head")
        for n in regions:
            front.note_store_version(n, 5)
        front.note_home_version(5)
        front.plan("user-0")
        front.home("user-0")
        front.note_home_version(9)            # skew 4 > 2: the drain edge
        front.note_store_version("use1", 9)   # and the catch-up edge
        front.retry_budget.note_request()
        front.retry_budget.try_spend()
        front.status()
    except Exception as e:
        out.append(_finding(
            "trace-region-front", f"constructing or feeding the region front raised "
            f"{type(e).__name__}: {e}: the region layer must run as plain host code", where,
            "region-host-policy"))
        return out
    # with that front alive, the serving predict captures as it would
    # without one, and answers the same twice
    cfg = audit_cfg()
    sd = DeepFM(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    build = predict_builder or (lambda c, state, dev: GraphedPredictor(
        c.model, state, device=dev, buckets=(8,)))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.model.feature_size, (8, cfg.model.field_size))
    vals = rng.random((8, cfg.model.field_size)).astype(np.float32)
    try:
        pred = build(cfg, sd, device)
        pred.precompile()
        if torch.device(device).type == "cpu":
            with _HostReadGuard(), torch.no_grad():
                pred._forward(0, torch.from_numpy(ids), torch.from_numpy(vals))
        answers = [pred.predict_with(0, ids, vals) for _ in range(2)]
    except Exception as e:
        out.append(_finding(
            "trace-region-front", f"the serving predict with the region front active "
            f"failed to capture under the sync guard: {type(e).__name__}: {e}", where,
            "region-predict-capture",
            hint="home picks, drain edges and failover spends read host state; none of "
                 "them may read a device tensor inside the predict"))
        return out
    if not np.array_equal(*answers):
        out.append(_finding(
            "trace-region-front", "two runs of the serving predict differ under the live "
            "region front: a region reading was folded into the predict", where,
            "region-predict-nondeterministic"))
    return out


_ELASTIC_AUDIT_MOVES = (
    ((2, 4), (1, 4)),   # shrink, width stable: zero table bytes
    ((1, 4), (2, 4)),   # grow back
    ((2, 4), (4, 2)),   # width change: windows re-cut, overlap kept
)


def audit_elastic(device="cpu", *, planner=None) -> list[Finding]:
    """JAX's ``audit_elastic`` as far as it applies to the port (module
    docstring): plan minimality on every audited move, and a restore at
    another ``model_parallel`` (one rank's context at a time, no group)
    that copies no table slice larger than the rank's window.  ``planner``
    replaces ``elastic.plan.plan_reshard`` (the seeded-violation tests)."""
    from ..checkpoint import Checkpointer, reshard
    from ..elastic.plan import Grid, plan_reshard, state_leaves
    from ..models.deepfm import window_multiple
    from ..parallel import spmd
    from ..parallel.mesh import DistContext
    from ..train.step import create_train_state

    planner = planner or plan_reshard
    cfg = audit_cfg()
    where = "deepfm_tpu_torch/elastic/plan.py"
    wm = window_multiple(cfg.model)
    state = create_train_state(cfg, device)
    out: list[Finding] = []
    for (dp_a, mp_a), (dp_b, mp_b) in _ELASTIC_AUDIT_MOVES:
        move = f"{dp_a}x{mp_a}->{dp_b}x{mp_b}"
        pv = spmd.padded_vocab(cfg.model.feature_size, mp_a, wm)
        old = Grid((dp_a, mp_a), pv, tuple(range(dp_a * mp_a)))
        new = Grid((dp_b, mp_b), spmd.padded_vocab(cfg.model.feature_size, mp_b, wm),
                   tuple(range(dp_b * mp_b)))
        params = {n: ((pv,) + tuple(p.shape[1:]) if n in ("fm_w", "fm_v") else tuple(p.shape),
                      p.element_size()) for n, p in state.model.named_parameters()}
        plan = planner(old, new, state_leaves(params, dp=dp_a, lazy=False, zero=dp_a > 1))
        if plan.host_round_trip or plan.moved_bytes >= plan.naive_bytes:
            out.append(_finding(
                "trace-collective",
                f"elastic reshard plan {move} is not minimal-traffic: moved "
                f"{plan.moved_bytes} bytes vs gather-to-one-place {plan.naive_bytes}",
                hint="the planner must move only new_window - held_rows per device",
                where=where, slug=f"elastic-{move}-plan-not-minimal"))
        if mp_a == mp_b and dp_b < dp_a and plan.moved_bytes != 0:
            out.append(_finding(
                "trace-collective",
                f"same-width shrink {move} plans {plan.moved_bytes} table bytes: the "
                f"surviving shards already own their windows",
                where=where, slug=f"elastic-{move}-shrink-moves-bytes"))
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save(state, block=True)
        for mp in (2, 4):
            for index in range(mp):
                ctx = DistContext(mp, index, index, mp, state.model.fm_v.device,
                                  model_parallel=mp)
                target = spmd.create_dp_train_state(cfg, ctx)
                Checkpointer(tmp, ctx=ctx).restore(target)
                window = target.sharding.rows
                big = [(leaf, n) for leaf, n in reshard.last_restore["slices"] if n > window]
                if big:
                    out.append(_finding(
                        "trace-transfer",
                        f"the restore at [1, {mp}] (model index {index}, window {window} "
                        f"rows) copied {big} out of the checkpoint",
                        where="deepfm_tpu_torch/checkpoint/reshard.py",
                        slug=f"elastic-restore-1x{mp}-{index}-over-window"))
    return out


# the host timers a captured body must not read
_TIMERS = ("perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns", "time",
           "time_ns")


def _obs_hooks() -> list[tuple[object, str]]:
    """Every record path of ``obs/`` and the host timers, as (owner, name)."""
    from ..obs import flight, metrics, trace

    return [(metrics.Counter, "inc"), (metrics.Gauge, "set"), (metrics.Gauge, "inc"),
            (metrics.Gauge, "dec"), (metrics.Histogram, "observe"),
            (metrics.SlidingWindow, "record"), (metrics.MetricsRegistry, "_register"),
            (trace.TraceContext, "add_span"), (trace.Tracer, "begin"),
            (trace.Tracer, "finish"), (flight.FlightRecorder, "record"),
            *((time, name) for name in _TIMERS)]


class _ObsProbe:
    """While entered, records in :attr:`calls` every call of an
    :func:`_obs_hooks` path made on the entering thread, with a trace
    context active so a ``span`` records.  Other threads run unrecorded."""

    def __init__(self):
        self.calls: list[str] = []

    def __enter__(self) -> "_ObsProbe":
        from ..obs import trace

        ctx = trace.TraceContext("audit_observability", "trace_audit")
        self._token = trace._CURRENT.set(ctx)
        me, calls = threading.get_ident(), self.calls
        self._saved = []
        for owner, name in _obs_hooks():
            orig = getattr(owner, name)
            label = f"{getattr(owner, '__name__', owner)}.{name}"

            def hooked(*args, _orig=orig, _label=label, **kwargs):
                if threading.get_ident() == me:
                    calls.append(_label)
                return _orig(*args, **kwargs)

            self._saved.append((owner, name, orig))
            setattr(owner, name, hooked)
        return self

    def __exit__(self, *exc) -> None:
        from ..obs import trace

        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        trace._CURRENT.reset(self._token)


def _obs_findings(name: str, calls: list[str], outs: list, where: str) -> list[Finding]:
    slug = name.replace(" ", "-")
    out = []
    if calls:
        out.append(_finding(
            "trace-observability",
            f"the captured {name} body reached {sorted(set(calls))}: a graph records "
            f"its Python once, so the metric, span or timer runs at capture and "
            f"never again", where, f"obs-{slug}-instrumented",
            hint="record metrics and time AROUND the replay on the host "
                 "(serve/batcher.py, train/loop.py), never inside a captured body"))
    if any(not torch.equal(a, b) for a, b in zip(outs[0], outs[1])):
        out.append(_finding(
            "trace-observability",
            f"two runs of the captured {name} body from copies of one state on one "
            f"input differ: a host value (a clock reading, a sequence number) was "
            f"folded into a tensor, and each capture would bake another constant",
            where, f"obs-{slug}-nondeterministic",
            hint="pass host values in through a static buffer, read on the card"))
    return out


def audit_observability(device="cpu", *, predict_builder=None,
                        step_builder=None) -> list[Finding]:
    """The observability contract (JAX ``audit_observability``) on the
    bodies the graphs capture: no instrumentation inside them, and two
    runs from copies of one state bit-equal (module docstring).

    ``predict_builder(predictor)`` returns a ``bodies(slot, st)`` factory
    (default: the predictor's own, ``GraphedPredictor._bodies``) and
    ``step_builder(cfg)`` a ``body(state, batch, scalars)`` (default
    ``train.step.resident_body``), so the tests feed seeded violations
    through the same checks."""
    from ..models.deepfm import DeepFM
    from ..serve.graphs import GraphedPredictor
    from ..train.step import _scalar_buffer, create_train_state, load_scalars, resident_body

    where = "deepfm_tpu_torch/obs/metrics.py"
    out: list[Finding] = []
    cfg = audit_cfg()
    dev = torch.device(device)
    # -- the serving forward: slots 0 and 1 hold copies of one state --------
    b, f, v = 16, cfg.model.field_size, cfg.model.feature_size
    rng = np.random.default_rng(0)
    st = SimpleNamespace(
        bucket=b, ids=torch.from_numpy(rng.integers(0, v, (b, f))).to(dev),
        vals=torch.from_numpy(rng.random((b, f), dtype=np.float32)).to(dev),
        out=torch.zeros((b,), dtype=torch.float32, device=dev))
    sd = DeepFM(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    predictor = GraphedPredictor(cfg.model, sd, device=dev, buckets=(b,))
    bodies = (predict_builder or (lambda p: p._bodies))(predictor)
    probe, outs = _ObsProbe(), []
    try:
        with torch.no_grad():
            for body in bodies(0, st):  # the warm-up a capture is preceded by
                body()
            for slot in (0, 1):
                with probe:
                    for body in bodies(slot, st):
                        body()
                outs.append([st.out.clone()])
    except Exception as e:
        return [_finding("trace-observability", f"running the captured predict body "
                         f"raised {type(e).__name__}: {e}", where, "obs-predict-run")]
    out += _obs_findings("predict", probe.calls, outs, where)
    # -- the train body, dense and lazy --------------------------------------
    body = (step_builder or (lambda c: resident_body))(cfg)
    for lazy in (False, True):
        name = "lazy train step" if lazy else "train step"
        scfg = audit_cfg(lazy)
        states = [create_train_state(scfg, device) for _ in range(3)]
        for s in states[1:]:
            s.generator.set_state(states[0].generator.get_state())
        batch = {k: t.to(dev) for k, t in distinct_batches(scfg, 1, seed=2)[0].items()}
        probe, outs = _ObsProbe(), []
        try:
            for i, state in enumerate(states):
                scalars = _scalar_buffer(state)
                load_scalars(state, scalars)
                if i == 0:  # the warm-up
                    body(state, batch, scalars)
                    continue
                with probe:
                    metrics = body(state, batch, scalars)
                outs.append([metrics[k] for k in sorted(metrics)]
                            + list(state_tensors(state).values()))
        except Exception as e:
            out.append(_finding("trace-observability", f"running the captured {name} "
                                f"body raised {type(e).__name__}: {e}", where,
                                f"obs-{name.replace(' ', '-')}-run"))
            continue
        out += _obs_findings(name, probe.calls, outs, where)
    return out


# -- the grid step's collective contracts (JAX audit_spmd_exchange and
# audit_zero_update), on a record of its eager step (analysis/collectives.py)

# per-mode expected collective sets for the grid's train step: the contract
# the audit enforces, recorded as data so tests, docs and the finding
# messages share one source of truth.  The port's dense row tensors, from its
# own layout: the exchange assembles [N, W], N = b·F the lookups of one data
# index (the ranks of a model group share its batch), W the width of the
# tables looked up together (fm_v's K columns and fm_w's one); the psum path
# all-reduces it forward and backward.  The lazy step's update_full arm
# all-gathers every slot of the data group: the slot rows [width] and their
# gradients [width, W], width = max(b·F, M·C + 1) under alltoall (the
# response buffer and its zero row) and b·F under psum; its update_dedup arm
# gathers a pack of at most C = capacity·b·F distinct rows, [C] and [C, W].
EXCHANGE_CONTRACT = {
    "psum": {
        "requires": "all_reduce over the dense [N, W] row tensor (zeros-plus-"
                    "psum assembly, fwd+bwd)",
        "forbids": None,
    },
    "alltoall": {
        "requires": "all_to_all request/response pair in the exchange arm",
        "forbids": "all_reduce/all_gather of the dense [N, W] row tensor "
                   "outside the exchange.fallback arm (the capacity-overflow "
                   "fallback)",
    },
    "alltoall_lazy": {
        "requires": "all_to_all forward exchange; all_gather only of the "
                    "capacity-bounded unique pack",
        "forbids": "all_gather of the full [width, W] slot-gradient stream "
                   "outside the lazy.update_full arm",
    },
}

# the audit world's jobs, on WORLD_SHAPE: JAX's three exchange lowerings and
# its zero-update lowering, one eager step each
_GRID_JOBS = (("psum", {"shard_exchange": "psum"}, False, "off"),
              ("alltoall", {"shard_exchange": "alltoall"}, False, "off"),
              ("lazy", {"shard_exchange": "alltoall"}, True, "off"),
              ("zero", {"shard_exchange": "alltoall"}, False, "on"))
# ids drawn from this many distinct rows: no bucket of the all-to-all
# overflows at the default capacity, and the lazy step takes the unique pack
_GRID_HOT_ROWS = 96


def grid_cfg(model=None, *, lazy: bool = False, zero: str = "off"):
    """The audit's config on the audit world's mesh, its batch one data
    index's share of ``_AUDIT_BATCH``."""
    from .collectives import WORLD_SHAPE

    dp, mp = WORLD_SHAPE
    return audit_cfg(lazy).with_overrides(
        model=model or {}, optimizer={"zero_sharding": zero},
        data={"batch_size": _AUDIT_BATCH // dp},
        mesh={"data_parallel": dp, "model_parallel": mp})


def grid_job(name: str, *, model=None, lazy: bool = False, zero: str = "off",
             builder=None) -> dict:
    """One job of :class:`..collectives.World` (:func:`grid_cfg`): a
    global batch of ``_AUDIT_BATCH`` rows, ids among ``_GRID_HOT_ROWS`` rows
    of the vocabulary.  ``zero == "on"`` makes it the ZeRO contract's job."""
    cfg = grid_cfg(model, lazy=lazy, zero=zero)
    rng = np.random.default_rng(0)
    f, v = cfg.model.field_size, cfg.model.feature_size
    hot = rng.permutation(v)[:_GRID_HOT_ROWS]
    batch = {"feat_ids": hot[rng.integers(0, _GRID_HOT_ROWS, (_AUDIT_BATCH, f))],
             "feat_vals": rng.random((_AUDIT_BATCH, f), dtype=np.float32),
             "label": (rng.random(_AUDIT_BATCH) < 0.3).astype(np.float32)}
    return {"name": name, "cfg": cfg.to_dict(), "batch": batch, "builder": builder,
            "zero_contract": zero == "on"}


def start_grid_world(device="cpu", extra: tuple = ()):
    """The audit world, started (:class:`..collectives.World`): one spawned
    ``[2, 2]`` world runs the four jobs, and ``extra`` jobs after them but
    before the ZeRO job (whose sync guard, tripped, leaves the ranks out of
    step)."""
    from .collectives import World

    jobs = [grid_job(name, model=model, lazy=lazy, zero=zero)
            for name, model, lazy, zero in _GRID_JOBS]
    return World(device, jobs[:-1] + list(extra) + jobs[-1:])


def grid_world(device="cpu", extra: tuple = ()) -> dict[str, dict]:
    """The audit world's results by job name (:func:`start_grid_world`)."""
    with start_grid_world(device, extra) as world:
        return world.results()


def exchange_dense_shapes(cfg, widths: int, *, lazy: bool = False) -> set[tuple[int, ...]]:
    """The dense row tensors of the grid's step on ``cfg``'s mesh (the
    comment above :data:`EXCHANGE_CONTRACT`); ``widths`` is W."""
    from ..parallel.embedding import exchange_capacity

    n = cfg.data.batch_size * cfg.model.field_size
    shapes = {(n, widths)}
    if lazy:
        mp = cfg.mesh.model_parallel
        width = n
        if mp > 1 and cfg.model.shard_exchange == "alltoall":
            width = max(n, mp * exchange_capacity(n, mp, cfg.model.shard_exchange_capacity)
                        + 1)
        shapes |= {(width, widths), (width,)}
    return shapes


def _n_elems(shapes) -> int:
    best = 0
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        best = max(best, n)
    return best


def check_exchange_collectives(
    record: list[dict],
    dense_shapes: set[tuple[int, ...]],
    *,
    mode: str,
    variant: str = "dense",
    where: str = "deepfm_tpu_torch/parallel/embedding.py",
) -> list[Finding]:
    """Hold one recorded train step (:func:`..collectives.merge_records`) to
    the per-mode collective contract (:data:`EXCHANGE_CONTRACT`).  Factored
    out of :func:`audit_spmd_exchange` so the seeded-violation test can feed
    a psum-mode record through the alltoall contract and watch it get
    caught.  JAX's ``check_exchange_collectives`` with the arms of the host
    branches for its ``stablehlo.case`` branches: a step that overflowed
    ran the fallback arm in place of the all_to_all, which JAX's lowering
    holds beside it."""
    seen = sorted({(c["kind"], c["arm"] or "main") for c in record})

    def is_dense(c):
        return (c["kind"] in ("all_reduce", "all_gather")
                and any(tuple(s) in dense_shapes for s in c["shapes"]))

    out: list[Finding] = []
    if mode == "psum":
        if not any(is_dense(c) for c in record):
            out.append(_finding(
                "trace-collective",
                f"psum-mode train step record shows NO dense row-tensor "
                f"all-reduce/all-gather (expected {sorted(dense_shapes)}) "
                f"— the collective detector or the step drifted; "
                f"observed collectives: {seen}",
                where, f"{variant}-psum-detector-blind",
                hint="update the audit's shape derivation "
                     "(exchange_dense_shapes) or the recorder "
                     "(analysis/collectives.py)"))
        return out
    # alltoall contract: the main line may never move the dense row tensor;
    # dense collectives may live only in a fallback arm, never alongside the
    # all_to_all exchange
    contract = EXCHANGE_CONTRACT["alltoall_lazy" if variant == "lazy" else "alltoall"]
    main_dense = [c for c in record if is_dense(c) and c["arm"] is None]
    if main_dense:
        out.append(_finding(
            "trace-collective",
            f"{variant} train step in shard_exchange='alltoall' still "
            f"moves the dense row tensor on the UNCONDITIONAL main line: "
            f"{[(c['kind'], c['shapes']) for c in main_dense]} (dense "
            f"shapes {sorted(dense_shapes)}); contract: "
            f"{contract['forbids']}; observed collectives: {seen}",
            where, f"{variant}-alltoall-dense-collective",
            hint="the exchange must dedup and route owned rows via "
                 "all_to_all; dense collectives belong only in the "
                 "overflow fallback arm"))
    arms: dict = {}
    for c in record:
        if c["arm"] is not None:
            a = arms.setdefault(c["arm"], {"a2a": False, "dense": False})
            a["a2a"] = a["a2a"] or c["kind"] == "all_to_all"
            a["dense"] = a["dense"] or is_dense(c)
    leaky = sorted(k for k, a in arms.items() if a["a2a"] and a["dense"])
    if leaky:
        out.append(_finding(
            "trace-collective",
            f"{variant} train step in shard_exchange='alltoall' has "
            f"arm(s) {leaky} carrying BOTH the all_to_all exchange and a "
            f"dense row-tensor collective — the dense traffic leaked into "
            f"the exchange arm; observed collectives: {seen}",
            where, f"{variant}-alltoall-dense-in-exchange-arm",
            hint="only the fallback arm may be dense"))
    if not any(c["kind"] == "all_to_all" or c["arm"] == "exchange.fallback"
               for c in record):
        out.append(_finding(
            "trace-collective",
            f"{variant} train step in shard_exchange='alltoall' ran "
            f"WITHOUT any all_to_all (and no overflow fallback) — the "
            f"exchange is not in effect; observed collectives: {seen}",
            where, f"{variant}-alltoall-missing",
            hint="check resolve_shard_exchange wiring "
                 "(parallel/embedding.py, parallel/spmd.py)"))
    return out


def _world_failed(result: dict, where: str, slug: str) -> list[Finding]:
    return [_finding("trace-collective", f"the audit world's {result['name']} step "
                     f"failed: {result['error']}", where, slug)]


def audit_spmd_exchange(device="cpu", world: dict | None = None) -> list[Finding]:
    """Collective-traffic contract of the grid's train step (JAX
    ``audit_spmd_exchange``): one eager step each of dense psum, dense
    alltoall and lazy alltoall on the audit world (``world``, the results of
    :func:`grid_world`, run here when None), recorded and held to
    :data:`EXCHANGE_CONTRACT`."""
    where = "deepfm_tpu_torch/parallel/embedding.py"
    world = world or grid_world(device)
    out: list[Finding] = []
    for name, mode, lazy, variant in (("psum", "psum", False, "dense"),
                                      ("alltoall", "alltoall", False, "dense"),
                                      ("lazy", "alltoall", True, "lazy")):
        result = world[name]
        if "error" in result:
            out += _world_failed(result, where, f"{variant}-{mode}-step-failed")
            continue
        cfg = grid_cfg({"shard_exchange": mode}, lazy=lazy)
        shapes = exchange_dense_shapes(cfg, result["ranks"][0]["widths"], lazy=lazy)
        out += check_exchange_collectives(result["record"], shapes, mode=mode,
                                          variant=variant, where=where)
    return out


# the arms whose data-group all-reduce carries no gradient of a planned
# leaf (parallel/branch.py): the ZeRO step's buffer of BN statistics,
# metrics and flags, and an ineligible leaf's replicated update
ZERO_ALLREDUCE_ARMS = ("sync.stats", "zero.ineligible")


def check_zero_collectives(
    record: list[dict], *, dp: int, mp: int, n_sharded_leaves: int,
    where: str = "deepfm_tpu_torch/parallel/spmd.py",
) -> list[Finding]:
    """Hold one recorded train step to the sharded-weight-update traffic
    contract (JAX ``check_zero_collectives``): dense grads must
    REDUCE-SCATTER over the data group (one collective per planned leaf),
    the fresh 1/dp param windows must ALL-GATHER back, and NO data-group
    all-reduce may carry a gradient of a planned leaf.  Model-group
    collectives (the row exchange, the replicated part's broadcast) are out
    of scope.

    The all-reduces that carry no planned leaf's gradient are told apart
    by the arm they were issued in, which their source stamps
    (:data:`ZERO_ALLREDUCE_ARMS`), never by their size.  JAX exempts
    1-element all-reduces (its metric scalars), and so does this rule; the
    port's step also all-reduces one flat buffer over the data group with
    ZeRO (parallel/spmd.py ``pmean_grads`` called without gradients by
    ``_sync``: the BN moving statistics, the four metrics and the five
    flags), which is the ``sync.stats`` arm, and a leaf without a ZeRO
    window takes the replicated update (train/optimizer.py
    ``ZeroOptimizer.step``), the ``zero.ineligible`` arm.  A data-group
    all-reduce of more than one element anywhere else is caught: the same
    ``pmean_grads`` with gradients (the replicated step), or a planned
    leaf's gradient all-reduced alone whatever its size.  Factored out of :func:`audit_zero_update` so the
    seeded-violation test can feed a replicated-path (zero off) record
    through the same checks."""
    from .collectives import collective_axis

    out: list[Finding] = []
    data_ar = [
        c for c in record
        if c["kind"] == "all_reduce"
        and collective_axis(c.get("groups"), dp, mp) == "data"
        and _n_elems(c["shapes"]) > 1 and c["arm"] not in ZERO_ALLREDUCE_ARMS
    ]
    if data_ar:
        out.append(_finding(
            "trace-collective",
            f"zero-sharded train step still ALL-REDUCES {len(data_ar)} "
            f"grad-sized tensor(s) over the data group "
            f"({[(c['kind'], c['shapes'], c['arm'] or 'main') for c in data_ar[:4]]}; "
            f"only the arms {list(ZERO_ALLREDUCE_ARMS)} carry no planned leaf's "
            f"gradient) — the replicated "
            f"update's collective survived; the sharded update must "
            f"reduce-scatter instead",
            where, "zero-dense-allreduce",
            hint="raw local grads must reach the ZeRO optimizer "
                 "(parallel/spmd.py _sync must not pmean them when "
                 "sharding.zero is on; train/optimizer.py ZeroOptimizer)"))
    rs = [c for c in record if c["kind"] == "reduce_scatter"
          and collective_axis(c.get("groups"), dp, mp) == "data"]
    if len(rs) < n_sharded_leaves:
        out.append(_finding(
            "trace-collective",
            f"zero-sharded train step records {len(rs)} data-group "
            f"reduce-scatter(s) for {n_sharded_leaves} sharded param "
            f"leaves — grads are not reduce-scattered per leaf",
            where, "zero-reduce-scatter-missing",
            hint="dist.reduce_scatter_tensor per leaf in "
                 "train/optimizer.py ZeroOptimizer.step"))
    ag = [c for c in record if c["kind"] == "all_gather"
          and collective_axis(c.get("groups"), dp, mp) == "data"]
    if len(ag) < n_sharded_leaves:
        out.append(_finding(
            "trace-collective",
            f"zero-sharded train step records {len(ag)} data-group "
            f"all-gather(s) for {n_sharded_leaves} sharded param leaves "
            f"— the fresh 1/dp param windows are not gathered back to "
            f"full width",
            where, "zero-allgather-missing",
            hint="dist.all_gather_into_tensor of the updated windows in "
                 "train/optimizer.py ZeroOptimizer.step"))
    return out


def check_zero_state_sharding(layout: dict | None, *, dp: int,
                              where: str = "deepfm_tpu_torch/parallel/spmd.py"
                              ) -> list[Finding]:
    """The moment-residency half of the zero contract (JAX
    ``check_zero_state_sharding``), on a rank's
    :func:`..collectives.zero_layout`: the optimizer must plan ZeRO windows
    (its ``plans``, the port's ``zero_dp`` marker), and every moment slot of
    a planned leaf must hold at most 1/dp of the padded leaf,
    ``ceil(n / dp)`` entries.  No planned leaf (a replicated optimizer)
    fails the marker check; a full-size slot behind a plan fails the
    sizing."""
    planned = {name: leaf for name, leaf in (layout or {}).items() if leaf["planned"]}
    bad: list[str] = []
    for name, leaf in sorted(planned.items()):
        padded = -(-leaf["numel"] // dp) * dp
        for slot, n in sorted(leaf["slots"].items()):
            if n * dp > padded:
                bad.append(f"{name}.{slot}: {n}/{padded} per rank")
    if not planned:
        return [_finding(
            "trace-collective",
            "the optimizer plans NO dp-partitioned (ZeRO) moment windows "
            "— the optimizer state is fully replicated across the data "
            "group (every rank redundantly holds and updates all moments)",
            where, "zero-moments-unsharded",
            hint="build the train state with optimizer.zero_sharding on|auto "
                 "(parallel/spmd.py create_dp_train_state)")]
    if bad:
        return [_finding(
            "trace-collective",
            f"{len(bad)} zero-layout moment slot(s) are NOT dp-sharded "
            f"(per-rank size exceeds padded/dp): {bad[:4]} — the moments "
            f"are replicated despite the sharded-update layout",
            where, "zero-moments-replicated",
            hint="ZeroOptimizer must keep a ceil(n/dp) window of each "
                 "planned leaf's moments (train/optimizer.py)")]
    return []


def audit_zero_update(device="cpu", context_builder=None,
                      world: dict | None = None) -> list[Finding]:
    """The ZeRO weight-update contract (JAX ``audit_zero_update``,
    train/optimizer.py ``ZeroOptimizer`` + parallel/spmd.py): one eager step
    of the dense grid step with ``optimizer.zero_sharding='on'`` on the
    audit world, recorded:

    * **reduce-scatter, not all-reduce**: :func:`check_zero_collectives`;
    * **dp-sharded moments**: :func:`check_zero_state_sharding` on every
      rank's optimizer;
    * **transfer-guard-clean** (``zero-transfer-guard``): the update
      (``ZeroOptimizer.step``) runs under
      ``torch.cuda.set_sync_debug_mode("error")`` on the card, and under a
      guard on host reads (:class:`_HostReadGuard`) on the CPU; a
      collective runs with the guard lifted (analysis/collectives.py: gloo
      stages through the host by design).  The step's host flags outside
      the update are by design;
    * **in place** (``zero-not-donated``): every parameter and moment
      window keeps its storage over the step (:func:`check_in_place`), the
      port's counterpart of JAX's donation.

    ``world`` is :func:`grid_world`'s results (run here when None).
    ``context_builder(cfg, ctx)`` builds the rank's train state in place
    of ``parallel.spmd.create_dp_train_state`` (it runs in the spawned
    ranks, so it must be importable there): the seeded-violation tests feed
    replicated moments through the same checks, on a world of their own."""
    from .collectives import WORLD_SHAPE, run_world

    dp, mp = WORLD_SHAPE
    where = "deepfm_tpu_torch/parallel/spmd.py"
    if context_builder is None:
        result = (world or grid_world(device))["zero"]
    else:
        result = run_world(device, [grid_job("zero", model=dict(_GRID_JOBS[-1][1]),
                                             zero="on", builder=context_builder)])["zero"]
    if "error" in result:
        if "sync guard" in result["error"]:
            return [_finding(
                "trace-transfer",
                f"the zero-sharded update under the sync guard raised "
                f"{result['error']} — the sharded update moved host data "
                f"implicitly", where, "zero-transfer-guard",
                hint="the windowed update must stay on the device "
                     "(train/optimizer.py ZeroOptimizer.step)")]
        return _world_failed(result, where, "zero-step-failed")
    ranks = result["ranks"]
    out: list[Finding] = []
    seen: set[str] = set()
    for rank in ranks:
        for f in check_zero_state_sharding(rank["zero"], dp=dp, where=where):
            if f.source not in seen:
                seen.add(f.source)
                out.append(f)
    r0 = ranks[0]
    out += check_zero_collectives(result["record"], dp=dp, mp=mp,
                                  n_sharded_leaves=r0["n_planned"], where=where)
    moved = sorted({f.source.rsplit(":", 1)[-1] for rank in ranks for f in rank["in_place"]
                    if f.rule == "trace-donation"})
    if moved:
        out.append(_finding(
            "trace-donation",
            f"{len(moved)} zero-sharded train-state tensor(s) are NOT updated "
            f"in place ({moved[:4]}) — the dp-partitioned moments would copy "
            f"every step instead of updating in place",
            where, "zero-not-donated",
            hint="ZeroOptimizer.step must write the windows and parameters "
                 "in place (copy_, the inner optimizer's in-place update)"))
    out += [f for rank in ranks[:1] for f in rank["in_place"] if f.rule == "trace-dtype"]
    return out


def run_trace_audit(device="cpu") -> list[Finding]:
    """Every contract above on ``device`` (the capture contracts only
    where it is the card); the waived ones are in :data:`WAIVERS`.  The
    collective contracts' world starts first and runs beside the others."""
    with start_grid_world(device) as world:
        variants = [f for name in ("xdeepfm", "dcnv2")
                    for f in (audit_train_step(device, model_name=name)
                              + audit_train_step(device, lazy=True, model_name=name)
                              + audit_buckets(device, model_name=name))]
        found = (audit_train_step(device) + audit_train_step(device, lazy=True)
                 + variants + audit_buckets(device) + audit_paged_step(device)
                 + audit_funnel(device) + audit_group_buckets(device)
                 + audit_sharded_predict(device) + audit_control_plane(device)
                 + audit_multitenant(device) + audit_region_front(device)
                 + audit_elastic(device) + audit_observability(device))
        waited = time.perf_counter()
        results = world.results()
        return found + grid_audits(device, results, time.perf_counter() - waited)


def grid_audits(device, world: dict, waited: float = 0.0) -> list[Finding]:
    """Both collective contracts on the audit world's results; on stderr
    (``chip_smoke.py`` reads them) the world's seconds, its stages and its
    ranks' B1 and B1' launches, and how long its caller ``waited`` for it
    after its own work."""
    import sys

    ran = [r for r in world.values() if "seconds" in r]
    b1 = sum(rank["launches"][0] for r in ran for rank in r["ranks"])
    b1b = sum(rank["launches"][1] for r in ran for rank in r["ranks"])
    print(f"analysis: the collective world took "
          + (f"{ran[0]['seconds']:.3f} s" if ran else "no time (every job failed)")
          + f" on {device}; its ranks launched B1 {b1}, B1' {b1b} times", file=sys.stderr)
    if ran:
        print("analysis: the collective world's stages (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ran[0]["stages"].items())
              + f"; waited for {waited:.3f}", file=sys.stderr)
    return (audit_spmd_exchange(device, world=world)
            + audit_zero_update(device, world=world))
