"""The collectives of the grid's eager steps, recorded: what the trace
audit (trace_audit.py ``audit_spmd_exchange``, ``audit_zero_update``)
holds to JAX's two collective contracts.

JAX reads the collectives of the ``[data x model]`` step from its lowered
StableHLO.  The port's grid step is eager and reads host flags every step
(parallel/spmd.py), so it is not captured; instead
:class:`CollectiveRecorder` records every ``torch.distributed`` call of one
real step:

* while active it replaces the ``torch.distributed`` functions the port
  calls (:data:`OPS`).  The port's modules call them as ``dist.<name>`` at
  call time, so the calls inside an ``autograd.Function``'s backward are
  recorded too; the originals come back on exit, also on an exception;
* an entry holds the op (JAX's name in ``kind``), the input shapes, the
  dtype, the reduce op, the group's ranks and the **arm** of the host
  branch it was issued in (parallel/branch.py: ``exchange.alltoall``,
  ``exchange.fallback``, ``lazy.update_dedup``, ``lazy.update_full``;
  None on the main line): the port's stand-in for JAX's
  ``stablehlo.case`` branch.

:func:`merge_records` joins the ranks' records of one step (they issue the
same collectives in the same order) into one, whose entries carry every
rank's group: JAX's ``replica_groups``.  :func:`collective_axis` is JAX's
classifier of those groups on the data-major layout both packages use
(rank ``r`` at ``(r // mp, r % mp)``, parallel/mesh.py).

:class:`World` spawns a ``[2, 2]`` world of gloo ranks (a ``FileStore``
in a temporary directory, a deadline that kills the ranks) on the CPU or,
all four sharing it, on the card, and runs each job's step there under the
recorder (:func:`_world_rank`); it runs beside its caller until
:meth:`World.results` waits for it.  The rank bodies live here because the
analyser runs without the repository's tests.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..parallel import branch

# the torch.distributed functions the port calls, by JAX's op name, and the
# argument each takes its input in
OPS = {"all_reduce": ("all_reduce", "tensor"), "broadcast": ("broadcast", "tensor"),
       "all_gather": ("all_gather", "tensor"),
       "all_gather_into_tensor": ("all_gather", "input_tensor"),
       "reduce_scatter_tensor": ("reduce_scatter", "input"),
       "all_to_all_single": ("all_to_all", "input")}

# the world the contracts are held on, and how long its ranks may take
WORLD_SHAPE = (2, 2)
WORLD_TIMEOUT_S = 300.0


class CollectiveRecorder:
    """``with CollectiveRecorder() as rec: step(...)``; ``rec.entries``.
    ``lift_sync_guard``: a collective runs with the card's sync debug mode
    off (gloo stages a CUDA tensor through host memory by design, on its
    own thread; NCCL does not), so that a guard around the step holds the
    step's own code."""

    def __init__(self, *, lift_sync_guard: bool = False):
        self.entries: list[dict] = []
        self._lift = lift_sync_guard
        self._saved: dict = {}

    def _wrap(self, name: str, fn):
        kind, arg = OPS[name]
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            t = a[arg]
            op = a.get("op")
            group = a.get("group")
            self.entries.append({
                "op": name, "kind": kind, "shapes": [tuple(t.shape)],
                "dtype": str(t.dtype).removeprefix("torch."),
                "reduce_op": None if op is None else getattr(op, "name", str(op)),
                "ranks": tuple(dist.get_process_group_ranks(
                    group if group is not None else dist.group.WORLD)),
                "arm": branch.current_arm()})
            mode = torch.cuda.get_sync_debug_mode() if self._lift else 0
            if mode:
                torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*args, **kwargs)
            finally:
                if mode:
                    torch.cuda.set_sync_debug_mode(mode)

        return call

    def __enter__(self) -> "CollectiveRecorder":
        self._saved = {name: getattr(dist, name) for name in OPS}
        for name, fn in self._saved.items():
            setattr(dist, name, self._wrap(name, fn))
        branch.watch(True)
        return self

    def __exit__(self, *exc) -> None:
        branch.watch(False)
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        self._saved = {}


def merge_records(records: list[list[dict]]) -> list[dict]:
    """One step's record from every rank's: rank 0's entries, each with
    ``groups``, the distinct groups the ranks issued it over (JAX's
    ``replica_groups``).  Raises when the ranks' records diverge."""
    if len({len(r) for r in records}) > 1:
        raise ValueError(f"the ranks recorded {[len(r) for r in records]} collectives")
    out = []
    for i, first in enumerate(records[0]):
        same = [r[i] for r in records]
        if len({(e["op"], e["arm"]) for e in same}) > 1:
            raise ValueError(f"collective {i} differs over the ranks: "
                             f"{[(e['op'], e['arm']) for e in same]}")
        out.append({**first, "groups": sorted({tuple(e["ranks"]) for e in same})})
    return out


def collective_axis(groups, dp: int, mp: int) -> str | None:
    """Classify a collective's replica groups on a [dp, mp] mesh laid out
    data-major (parallel/mesh.py): the DATA axis groups are mp many, each
    dp ranks stride mp apart; the MODEL axis groups are dp many, each mp
    consecutive ranks.  None = no groups; 'other' = neither single axis
    (e.g. a both-axes collective).  JAX's ``collective_axis``."""
    if not groups:
        return None
    sizes = {len(g) for g in groups}
    if sizes == {dp} and len(groups) == mp and all(
        g[i + 1] - g[i] == mp for g in groups for i in range(len(g) - 1)
    ):
        return "data"
    if sizes == {mp} and len(groups) == dp and all(
        g[i + 1] - g[i] == 1 for g in groups for i in range(len(g) - 1)
    ):
        return "model"
    return "other"


def zero_layout(optimizer, params: dict) -> dict | None:
    """The optimizer's moments as trace_audit.py
    ``check_zero_state_sharding`` reads them: for each parameter of
    ``params`` it updates, its element count on this rank, whether the
    optimizer plans a ZeRO window for it, and each slot's element count;
    None for an optimizer without plans (the replicated update)."""
    plans = getattr(optimizer, "plans", None)
    if plans is None:
        return None
    return {name: {"numel": int(params[name].numel()), "planned": plan is not None,
                   "slots": {s: int(t.numel()) for s, t in optimizer.slots[name].items()}}
            for name, plan in plans.items()}


def _run_job(job: dict, cfg, ctx) -> dict:
    """One job on this rank: its state (``job["builder"](cfg, ctx)`` or the
    grid's own), its data index's rows of the global batch, and one
    recorded step."""
    from ..ops import fused_ctr
    from ..parallel import spmd
    from .trace_audit import _HostReadGuard, _layout, check_in_place, state_tensors

    state = (job.get("builder") or spmd.create_dp_train_state)(cfg, ctx)
    n = len(job["batch"]["label"])
    d, dp = ctx.data_index, ctx.data_parallel
    batch = {k: torch.from_numpy(v[d * n // dp:(d + 1) * n // dp]).to(ctx.device)
             for k, v in job["batch"].items()}
    opt, params = state.optimizer, dict(state.model.named_parameters())
    info = {"widths": sum(t.shape[1] if t.dim() == 2 else 1
                          for t in state.model.tables().values()),
            "n_planned": sum(plan is not None
                             for plan in getattr(opt, "plans", {}).values()),
            "zero": zero_layout(opt, params), "in_place": []}
    before = _layout(state_tensors(state))
    cuda = ctx.device.type == "cuda"
    if job.get("zero_contract") and info["zero"] is not None:
        inner = opt.step

        def guarded(params, grads):
            """The update under the card's sync guard (the CPU's stand-in:
            a guard on host reads)."""
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                with contextlib.nullcontext() if cuda else _HostReadGuard():
                    inner(params, grads)
            except RuntimeError as e:
                msg = str(e).splitlines()[0][:300]
                if "synchroniz" not in msg and "host read" not in msg:
                    raise
                raise RuntimeError(f"sync guard: {msg}") from e
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)

        opt.step = guarded
    launches = fused_ctr.launches, fused_ctr.backward_launches
    with CollectiveRecorder(lift_sync_guard=cuda) as rec:
        spmd.train_step(state, batch, ctx)
    info["launches"] = (fused_ctr.launches - launches[0],
                        fused_ctr.backward_launches - launches[1])
    if job.get("zero_contract"):
        info["in_place"] = check_in_place(before, state, "deepfm_tpu_torch/parallel/spmd.py",
                                          "zero update")
    return {"record": rec.entries, **info}


# the milestones a rank of :class:`World` stamps, in order
_MILESTONES = ("started", "imported", "device", "group")


def _world_rank(rank: int, world: int, store: str, out: str, device: str,
                jobs: list) -> None:
    """A rank of :class:`World` (a spawned process): imports what the jobs
    run, starts its device, joins the gloo group over ``store``, forms the
    grid of the first job's mesh, runs every job and saves its results (an
    ``error`` where a job raised: the rest are not run, since the ranks are
    then out of step) with the wall-clock time of each milestone."""
    import datetime

    stamps = {"started": time.time()}
    from ..core.config import Config
    from ..ops import fused_ctr  # noqa: F401  (what _run_job runs)
    from ..parallel import spmd  # noqa: F401
    from ..parallel.mesh import initialize_distributed
    from . import trace_audit  # noqa: F401

    stamps["imported"] = time.time()
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
        torch.zeros(1, device=device)  # the card's context
    stamps["device"] = time.time()
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S / 2))
    try:
        results, ctx = [], None
        for job in jobs:
            cfg = Config.from_dict(job["cfg"])
            if ctx is None:
                ctx = initialize_distributed(cfg.mesh, device)
                stamps["group"] = time.time()
            try:
                results.append(_run_job(job, cfg, ctx))
            except Exception as e:
                results.append({"error": f"{type(e).__name__}: {e}"[:500]})
                break
            stamps[job["name"]] = time.time()
        torch.save({"results": results, "stamps": stamps},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class World:
    """``jobs`` (each ``{"name", "cfg", "batch", "builder",
    "zero_contract"}``: a config dict at :data:`WORLD_SHAPE`'s mesh, a
    global batch of numpy arrays, an optional state builder, and whether
    the ZeRO update runs under the sync guard with its tensors watched in
    place) on one spawned world of ``dp·mp`` gloo ranks on ``device``,
    started at construction.  :meth:`results` waits for the ranks; leaving
    the ``with`` block (or :meth:`close`) kills any rank still alive."""

    def __init__(self, device: str, jobs: list[dict]):
        import torch.multiprocessing as tmp

        dp, mp = WORLD_SHAPE
        self.jobs, self.world = jobs, dp * mp
        self._dir = tempfile.TemporaryDirectory(prefix="collectives_")
        self.t0 = time.time()
        self._ctx = tmp.start_processes(
            _world_rank, args=(self.world, os.path.join(self._dir.name, "store"),
                               self._dir.name, device, jobs),
            nprocs=self.world, join=False, start_method="spawn")
        self._deadline = time.monotonic() + WORLD_TIMEOUT_S

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()
        self._dir.cleanup()

    def results(self) -> dict[str, dict]:
        """Each job's result by its name: ``{"name", "record"`` (merged),
        ``"ranks"`` (each rank's other results), ``"seconds"`` (the world's,
        from the spawn to the last rank's last job), ``"stages"`` (those
        seconds split at the slowest rank's milestones: spawn, imports,
        device start, gloo group, then each job)``}``, or ``{"name",
        "error"}``.  Raises when a rank dies or the deadline passes."""
        while not self._ctx.join(timeout=0.5):
            if time.monotonic() > self._deadline:
                dp, mp = WORLD_SHAPE
                raise TimeoutError(f"the [{dp}, {mp}] world's ranks ran past "
                                   f"{WORLD_TIMEOUT_S:.0f} s")
        per_rank = [torch.load(os.path.join(self._dir.name, f"rank{r}.pt"),
                               weights_only=False) for r in range(self.world)]
        names = ("spawn", "imports", "device", "group")
        stages, last = {}, self.t0
        for milestone, name in [*zip(_MILESTONES, names), *((j["name"],) * 2
                                                             for j in self.jobs)]:
            at = [r["stamps"][milestone] for r in per_rank if milestone in r["stamps"]]
            if at:
                stages[name], last = max(at) - last, max(at)
        out = {}
        for i, job in enumerate(self.jobs):
            got = [r["results"][i] if i < len(r["results"]) else {"error": "not run"}
                   for r in per_rank]
            errors = [g["error"] for g in got if "error" in g]
            if errors:
                out[job["name"]] = {"name": job["name"], "error": errors[0]}
                continue
            out[job["name"]] = {
                "name": job["name"], "record": merge_records([g["record"] for g in got]),
                "ranks": [{k: v for k, v in g.items() if k != "record"} for g in got],
                "seconds": last - self.t0, "stages": stages}
        return out


def run_world(device: str, jobs: list[dict]) -> dict[str, dict]:
    """:class:`World`'s results, waited for."""
    with World(device, jobs) as w:
        return w.results()
