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
  retrieve captured at boot.  JAX's ``audit_multitenant`` is waived
  (ROADMAP A18).
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

**Waived** (:data:`WAIVERS`): JAX's ``audit_spmd_exchange`` and
``audit_zero_update``.  The steps of a ``[data x model]`` grid and the
data-parallel step stay eager: each reads host flags every step (the
exchange's overflow flag, ``parallel/embedding.py``; the step's
next-batch, stop and eval flags and the lazy pack's flag,
``parallel/spmd.py``), which a graph cannot read.  The online trainer
(``online/trainer.py``) stays eager too.  No audit here claims them.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .findings import Finding

# what the audit does not claim, and why
WAIVERS = {
    "audit_spmd_exchange": (
        "the grid step (parallel/spmd.py, parallel/embedding.py) stays eager: "
        "it reads the exchange's overflow flag, the step's flags and the lazy "
        "pack's flag on the host every step; its collectives are held to the "
        "single-card step by tests/test_torch_sharded*.py and chip_smoke.py's "
        "sharded phase, not by a capture"),
    "audit_zero_update": (
        "the ZeRO update runs inside the eager grid step (train/optimizer.py "
        "ZeroOptimizer); not captured"),
    "online_trainer": (
        "online/trainer.py steps eagerly: its loop reads the stream's cursor "
        "and commit flags between steps"),
    "audit_multitenant": (
        "a pool member serves one tenant (serve/pool/worker.py); multi-tenant "
        "members sharing one graph set are ROADMAP A18"),
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
    return {k: (t.data_ptr(), t.dtype, tuple(t.shape)) for k, t in tensors.items()}


def check_in_place(before: dict, state, where: str, what: str) -> list[Finding]:
    """``trace-donation`` and ``trace-dtype`` findings of ``state`` against
    its ``_layout`` before the steps."""
    out = []
    after = _layout(state_tensors(state))
    for name, (ptr, dtype, shape) in before.items():
        now = after.get(name)
        if now is None or now[0] != ptr:
            out.append(_finding(
                "trace-donation", f"{what}: {name} was rebound by a step, not "
                f"updated in place", where, f"{what}:donation:{name}",
                hint="update the tensor with an in-place op (copy_, add_, "
                     "index_copy_); a replay writes the captured memory"))
        elif now[1:] != (dtype, shape):
            out.append(_finding(
                "trace-dtype", f"{what}: {name} went from {dtype} {shape} to "
                f"{now[1]} {now[2]} in a step", where, f"{what}:drift:{name}"))
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


def audit_train_step(device="cpu", *, lazy: bool = False, state=None, step=None,
                     steps: int = _AUDIT_STEPS) -> list[Finding]:
    """The single-card step's contracts (JAX ``audit_train_step``): in
    place, dtype, and graphed = eager.  ``state`` (default: a fresh state
    of :func:`audit_cfg`) and ``step`` (default ``graphed_train_step``)
    let a test seed a regression."""
    from ..train.step import create_train_state, graphed_train_step, train_step

    where = "deepfm_tpu_torch/train/step.py"
    what = "lazy step" if lazy else "dense step"
    cfg = audit_cfg(lazy)
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


def audit_buckets(device="cpu", buckets=None) -> list[Finding]:
    """The serving graphs (JAX ``audit_predict``/``audit_buckets``): the
    graph count, every admissible size on a captured bucket, and on the
    card a hot swap that captures nothing."""
    from ..models.deepfm import DeepFM
    from ..serve.batcher import DEFAULT_BUCKETS, pick_bucket
    from ..serve.export import build_graphed_batcher, export_servable
    from ..serve.graphs import SLOTS

    where = "deepfm_tpu_torch/serve/graphs.py"
    buckets = tuple(buckets or DEFAULT_BUCKETS)
    cfg = audit_cfg()
    out: list[Finding] = []
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="trace_audit_") as tmp:
        sd = DeepFM(cfg.model, device="cpu").state_dict()
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
    from ..models.deepfm import DeepFM
    from ..online.publisher import ModelPublisher
    from ..ops import fused_ctr
    from ..serve.reload import HotSwapper

    pub = os.path.join(tmp, "pub")
    g = torch.Generator().manual_seed(1)
    ModelPublisher(pub).publish(cfg, DeepFM(cfg.model, device="cpu",
                                            generator=g).state_dict(), step=1)
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


def run_trace_audit(device="cpu") -> list[Finding]:
    """Every contract above on ``device`` (the capture contracts only
    where it is the card); the waived ones are in :data:`WAIVERS`."""
    return (audit_train_step(device) + audit_train_step(device, lazy=True)
            + audit_buckets(device) + audit_paged_step(device) + audit_funnel(device)
            + audit_group_buckets(device) + audit_sharded_predict(device)
            + audit_control_plane(device))
