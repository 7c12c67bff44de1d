"""Per-bucket CUDA graphs over two weight slots: the port's counterpart of
the JAX server's per-bucket XLA executables with the parameter payload
passed as an argument (``deepfm_tpu/serve/reload.py``, ``serve/batcher.py``).

The JAX server compiles one executable per bucket shape and swaps weights
under them without recompiling.  Here:

* **Two weight slots** on the card, each a DeepFM holding its own copy of
  the parameters and BN buffers (about 17 MB at the flagship width).  A
  slot is what a JAX "payload" is: :meth:`GraphedPredictor.predict_with`
  takes the slot to score with.
* **One** ``torch.cuda.CUDAGraph`` **per (slot, bucket, stage)**, captured
  once by :class:`SlotGraphs`, largest bucket first, into one memory pool
  per slot, each bucket warmed up on a side stream first (the cuBLAS
  workspace, the kernel library), under ``set_sync_debug_mode("error")``.
  The predictor has one stage, the forward; the funnel (funnel/graphs.py)
  has two.  The forward launches kernel B1 (ops/fused_ctr.py) on the
  current stream, which is what makes it capturable; nothing in it waits
  on the host.
* **Static inputs and outputs.**  Each bucket has device buffers for ids,
  vals and the output that every graph of that bucket reads or writes,
  and pinned host buffers for staging.  A dispatch fills the pinned
  buffers, issues one async host-to-device copy each, replays the graphs,
  issues one async device-to-host copy of the output and waits for the
  stream.
* **A swap is a** ``copy_`` **into the idle slot** (:func:`load_leaves`).
  Nothing is ever captured again.

Graphs that share a pool, and graphs that share the static buffers, must
never replay at the same time.  So every call here runs on one thread:
the micro-batcher's worker (serve/batcher.py), which runs traffic,
captures, uploads and canaries one after another (``run_on_worker``).

On the CPU the same interface runs the slot's model eagerly: that is what
the CPU tests exercise.  On the card a capture or replay failure raises;
there is no eager fallback.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.platform import resolve_device
from ..ops import fused_ctr, retrieval
from .batcher import DEFAULT_BUCKETS, pick_bucket

SLOTS = 2
# eager runs of each bucket's stages on a side stream before its capture
WARMUP_CALLS = 3

# B1's runs inside :class:`GraphedPredictor` and shard-group member
# (serve/pool/sharded.py) replays since import (or since a caller reset
# them): each replay adds the launches its capture recorded (the wrapper
# counts those as captured, not launched)
graph_kernel_runs = {"forward": 0}


def leaf_specs(leaves: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """name -> (shape, dtype) of tensors or host arrays."""
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in leaves.items()}


def load_leaves(live: dict[str, torch.Tensor], staged: dict) -> None:
    """``copy_`` ``staged`` (host arrays or tensors of ``live``'s names,
    shapes and dtypes) into ``live``'s tensors and wait for the copies.
    Another tree is refused: the graphs read these tensors, so it would
    need new graphs."""
    want, got = leaf_specs(live), leaf_specs(staged)
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:4]
        raise ValueError(f"the staged tree differs from the slot's (first diffs: {diff}): "
                         f"swapping would need a re-capture; redeploy instead")
    with torch.no_grad():
        for name, dst in live.items():
            dst.copy_(torch.as_tensor(staged[name]))
    for dev in {t.device for t in live.values()}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _capture(body: Callable[[], None], pool) -> torch.cuda.CUDAGraph:
    """``body`` captured into ``pool`` under the sync guard: a host sync
    in it raises here.  Python's cyclic collector is off meanwhile: a
    predictor and its ``SlotGraphs`` refer to each other, so a dropped one
    is freed by the collector, and its graphs' teardown inside another
    capture is not permitted (the collection ``torch.cuda.graph`` runs
    on entry happens first)."""
    graph = torch.cuda.CUDAGraph()
    prev = torch.cuda.get_sync_debug_mode()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            try:
                torch.cuda.set_sync_debug_mode("error")
                body()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
    finally:
        if collecting:
            gc.enable()
    return graph


class Staging:
    """One bucket's static buffers: device ``ids`` and ``vals`` [B, F]
    that every graph of the bucket reads, device ``out`` (f32
    [out_size]) that its graphs write, their pinned host buffers with
    numpy views, and a CUDA event before and after each stage."""

    def __init__(self, bucket: int, fields: int, out_size: int, stages: int,
                 device: torch.device):
        self.bucket = bucket
        self.ids = torch.zeros((bucket, fields), dtype=torch.int64, device=device)
        self.vals = torch.zeros((bucket, fields), dtype=torch.float32, device=device)
        self.out = torch.zeros((out_size,), dtype=torch.float32, device=device)
        self.h_ids = torch.zeros((bucket, fields), dtype=torch.int64).pin_memory()
        self.h_vals = torch.zeros((bucket, fields), dtype=torch.float32).pin_memory()
        self.h_out = torch.zeros((out_size,), dtype=torch.float32).pin_memory()
        self.np_ids, self.np_vals = self.h_ids.numpy(), self.h_vals.numpy()
        self.np_out = self.h_out.numpy()
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(stages + 1)]


class SlotGraphs:
    """``slots`` (default ``SLOTS``) x bucket x stage CUDA graphs on the
    card ``device``, one memory pool a slot, one :class:`Staging` a
    bucket.  ``bodies(slot, st)`` gives a slot's stages at bucket
    ``st.bucket``: ``stages`` zero-argument callables, run in order, that
    read ``st.ids`` and ``st.vals`` and between them write ``st.out``.
    The predictor here, the funnel's (funnel/graphs.py) and the pool
    members' (serve/pool/sharded.py, three slots: live, staged and the
    retained previous version) capture and replay through it."""

    def __init__(self, device: torch.device, buckets: Sequence[int], fields: int,
                 out_size: Callable[[int], int], stages: int,
                 bodies: Callable[[int, Staging], Sequence[Callable[[], None]]],
                 slots: int = SLOTS, default_stages: Sequence[int] | None = None):
        self.device = device
        self.buckets = tuple(buckets)
        self.bodies = bodies
        self.slots = int(slots)
        self.staging = {b: Staging(b, fields, out_size(b), stages, device)
                        for b in self.buckets}
        self.graphs: list[dict[int, tuple[torch.cuda.CUDAGraph, ...]]] = [
            {} for _ in range(self.slots)]
        # the stages a replay runs unless it names others (the funnel's
        # degraded retrieve is a third stage replayed in place of the first)
        self.default_stages = tuple(range(stages) if default_stages is None
                                    else default_stages)
        # replays since construction, the B2 and B1 launches each stage
        # runs (recorded by the kernels' wrappers during the capture: their
        # ``launches`` count no replay, so a caller counts their runs
        # through the graphs as replays x launches), and the bytes each
        # stage's capture allocated at its peak, by bucket
        self.replays = 0
        self.launches_per_stage = [{"retrieval": 0, "forward": 0} for _ in range(stages)]
        self.pool_bytes: dict[int, list[int]] = {}

    def launches(self, stages: Sequence[int] | None = None) -> dict[str, int]:
        """B2 and B1 launches a replay of ``stages`` (default: the default
        stages) runs."""
        picked = self.default_stages if stages is None else stages
        return {name: sum(self.launches_per_stage[i][name] for i in picked)
                for name in ("retrieval", "forward")}

    @property
    def launches_per_replay(self) -> dict[str, int]:
        return self.launches()

    @property
    def count(self) -> int:
        return sum(len(stages) for slot in self.graphs for stages in slot.values())

    def capture(self) -> dict[str, float]:
        """Capture every (slot, bucket): ``{"slot<s>/<bucket>": seconds}``
        with each bucket's warm-up."""
        if self.count:
            raise RuntimeError("the bucket graphs are already captured")
        timings = {}
        side = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device), torch.no_grad():
            stream = torch.cuda.current_stream(self.device)
            for slot in range(self.slots):
                pool = torch.cuda.graph_pool_handle()
                for b in reversed(self.buckets):  # the largest first
                    st = self.staging[b]
                    bodies = self.bodies(slot, st)
                    t0 = time.perf_counter()
                    side.wait_stream(stream)
                    with torch.cuda.stream(side):
                        for _ in range(WARMUP_CALLS):
                            for body in bodies:
                                body()
                    stream.wait_stream(side)
                    torch.cuda.synchronize(self.device)
                    graphs, nbytes = [], []
                    for i, body in enumerate(bodies):
                        b2, b1 = retrieval.captured, fused_ctr.captured
                        base = torch.cuda.memory_allocated(self.device)
                        torch.cuda.reset_peak_memory_stats(self.device)
                        graphs.append(_capture(body, pool))
                        nbytes.append(torch.cuda.max_memory_allocated(self.device) - base)
                        self.launches_per_stage[i] = {"retrieval": retrieval.captured - b2,
                                                      "forward": fused_ctr.captured - b1}
                    self.pool_bytes[b] = [max(x, y) for x, y in
                                          zip(self.pool_bytes.get(b, nbytes), nbytes)]
                    self.graphs[slot][b] = tuple(graphs)
                    timings[f"slot{slot}/{b}"] = round(time.perf_counter() - t0, 4)
            torch.cuda.synchronize(self.device)
        return timings

    def replay(self, slot: int, ids: np.ndarray, vals: np.ndarray,
               stages: Sequence[int] | None = None) -> tuple[Staging, tuple[float, ...]]:
        """[k, F] rows (k at most the largest bucket) through ``slot``'s
        graphs of ``stages`` (default: the default stages), in order, at
        the smallest bucket that holds them, zero rows padding it.
        Returns the bucket's staging (``np_out`` holds the result) and
        each stage's stream time between its events: the device's time
        plus any host gap before a launch."""
        graphs = self.graphs[slot]
        if not graphs:
            raise RuntimeError("the bucket graphs are not captured: call precompile() first")
        k = ids.shape[0]
        if k > self.buckets[-1]:
            raise ValueError(f"{k} rows exceed the largest bucket {self.buckets[-1]}")
        st = self.staging[pick_bucket(self.buckets, k)]
        st.np_ids[:k] = ids
        st.np_vals[:k] = vals
        st.np_ids[k:] = 0
        st.np_vals[k:] = 0
        captured = graphs[st.bucket]
        stages = [captured[i] for i in (self.default_stages if stages is None else stages)]
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            st.ids.copy_(st.h_ids, non_blocking=True)
            st.vals.copy_(st.h_vals, non_blocking=True)
            st.events[0].record(stream)
            for i, graph in enumerate(stages):
                graph.replay()
                st.events[i + 1].record(stream)
            st.h_out.copy_(st.out, non_blocking=True)
            stream.synchronize()
        self.replays += 1
        return st, tuple(st.events[i].elapsed_time(st.events[i + 1]) / 1e3
                         for i in range(len(stages)))


class GraphedPredictor:
    """A DeepFM servable's predict behind CUDA graphs, in ``slots``
    (default ``SLOTS``) weight slots on ``device`` (default: the card;
    ``"cpu"`` runs eagerly).

    Every slot starts from ``state_dict``.  Call :meth:`precompile` (on
    the thread that will replay) before :meth:`predict_with`.  A slot's
    model comes from :meth:`_slot_model` and its tensors from
    :meth:`_leaves`: a pool member's predictor (serve/pool/sharded.py)
    overrides both with row-sharded tables."""

    def __init__(self, cfg: ModelConfig, state_dict: dict, *, device=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, slots: int = SLOTS):
        if cfg.model_name != "deepfm":
            raise ValueError(f"GraphedPredictor serves DeepFM, got {cfg.model_name!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self._models = [self._slot_model(state_dict) for _ in range(int(slots))]
        self._slots = (SlotGraphs(self.device, self.buckets, cfg.field_size, lambda b: b, 1,
                                  self._bodies, slots=int(slots))
                       if self.device.type == "cuda" else None)

    def _slot_model(self, state_dict: dict) -> torch.nn.Module:
        from .export import model_from_state

        model = model_from_state(self.cfg, state_dict, self.device)
        model.requires_grad_(False)
        return model

    def _leaves(self, slot: int) -> dict[str, torch.Tensor]:
        return self._models[slot].state_dict()

    @property
    def slots(self) -> int:
        return len(self._models)

    @property
    def graph_count(self) -> int:
        return self._slots.count if self._slots is not None else 0

    @property
    def replays(self) -> int:
        return self._slots.replays if self._slots is not None else 0

    @property
    def kernel_launches_per_replay(self) -> int:
        """B1 launches each graph replay runs."""
        return self._slots.launches_per_replay["forward"] if self._slots is not None else 0

    def _forward(self, slot: int, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._models[slot](ids, vals))

    def _bodies(self, slot: int, st: Staging):
        return (lambda: st.out.copy_(self._forward(slot, st.ids, st.vals)),)

    def precompile(self) -> dict[str, float]:
        """Capture every (slot, bucket) graph: ``{"slot<s>/<bucket>":
        seconds}`` with each bucket's warm-up.  On the CPU there is nothing
        to capture ({})."""
        return self._slots.capture() if self._slots is not None else {}

    def predict_with(self, slot: int, feat_ids, feat_vals) -> np.ndarray:
        """[N, F] int64 ids and f32 vals -> [N] f32 probabilities from
        ``slot``'s weights: on the card through that slot's bucket graphs
        (rows chunked by the largest bucket, each chunk zero-padded to its
        bucket), waiting for the result."""
        ids = np.asarray(feat_ids, np.int64)
        vals = np.asarray(feat_vals, np.float32)
        if self._slots is None:
            with torch.inference_mode():
                return self._forward(slot, torch.from_numpy(ids),
                                     torch.from_numpy(vals)).numpy()
        n = ids.shape[0]
        out = np.empty((n,), np.float32)
        cap = self.buckets[-1]
        for s in range(0, n, cap):
            k = min(cap, n - s)
            st, _ = self._slots.replay(slot, ids[s:s + k], vals[s:s + k])
            graph_kernel_runs["forward"] += self._slots.launches_per_replay["forward"]
            out[s:s + k] = st.np_out[:k]
        return out

    def slot_specs(self) -> dict[str, tuple[tuple[int, ...], str]]:
        """Name -> (shape, dtype) of every slot's tensors."""
        return leaf_specs(self._leaves(0))

    def slot_state(self, slot: int) -> dict[str, torch.Tensor]:
        """A slot's tensors, as CPU copies."""
        return {k: v.detach().to("cpu", copy=True) for k, v in self._leaves(slot).items()}

    def load_slot(self, slot: int, state_dict: dict) -> None:
        """``copy_`` ``state_dict`` (numpy arrays or tensors with the
        slot's names, shapes and dtypes) into ``slot``'s tensors and wait
        for the copies.  The graphs read those tensors, so the next replay
        of the slot scores with the new weights."""
        load_leaves(self._leaves(slot), state_dict)
