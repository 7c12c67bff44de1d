"""Per-bucket CUDA graphs over two weight slots: the port's counterpart of
the JAX server's per-bucket XLA executables with the parameter payload
passed as an argument (``deepfm_tpu/serve/reload.py``, ``serve/batcher.py``).

The JAX server compiles one executable per bucket shape and swaps weights
under them without recompiling.  Here:

* **Two weight slots** on the card, each a DeepFM holding its own copy of
  the parameters and BN buffers (about 17 MB at the flagship width).  A
  slot is what a JAX "payload" is: :meth:`GraphedPredictor.predict_with`
  takes the slot to score with.
* **One** ``torch.cuda.CUDAGraph`` **per (slot, bucket)**, captured once by
  :meth:`GraphedPredictor.precompile`, largest bucket first, into one
  memory pool per slot, each bucket warmed up on a side stream first (the
  cuBLAS workspace, the kernel library).  The forward launches kernel B1
  (ops/fused_ctr.py) on the current stream, which is what makes it
  capturable; nothing in the forward waits on the host.
* **Static inputs and outputs.**  Each bucket has device buffers for ids
  and vals that every graph of that bucket reads, and pinned host buffers
  for staging.  A dispatch fills the pinned buffers, issues one async
  host-to-device copy each, replays the graph, issues one async
  device-to-host copy of the probabilities and waits for the stream.
* **A swap is a** ``copy_`` **into the idle slot** (:meth:`load_slot`).
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

import time
from typing import Sequence

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.platform import resolve_device
from ..ops import fused_ctr
from .batcher import DEFAULT_BUCKETS, pick_bucket

SLOTS = 2
# eager forwards of each bucket on a side stream before its capture
WARMUP_CALLS = 3


class _Staging:
    """One bucket's static device buffers, read by every graph of the
    bucket, and its pinned host buffers with their numpy views."""

    def __init__(self, bucket: int, fields: int, device: torch.device):
        self.ids = torch.zeros((bucket, fields), dtype=torch.int64, device=device)
        self.vals = torch.zeros((bucket, fields), dtype=torch.float32, device=device)
        self.h_ids = torch.zeros((bucket, fields), dtype=torch.int64).pin_memory()
        self.h_vals = torch.zeros((bucket, fields), dtype=torch.float32).pin_memory()
        self.h_out = torch.zeros((bucket,), dtype=torch.float32).pin_memory()
        self.np_ids, self.np_vals = self.h_ids.numpy(), self.h_vals.numpy()
        self.np_out = self.h_out.numpy()


class GraphedPredictor:
    """A DeepFM servable's predict behind CUDA graphs, in ``SLOTS`` weight
    slots on ``device`` (default: the card; ``"cpu"`` runs eagerly).

    Every slot starts from ``state_dict``.  Call :meth:`precompile` (on
    the thread that will replay) before :meth:`predict_with`."""

    def __init__(self, cfg: ModelConfig, state_dict: dict, *, device=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        from .export import model_from_state

        if cfg.model_name != "deepfm":
            raise ValueError(f"GraphedPredictor serves DeepFM, got {cfg.model_name!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self._models = []
        for _ in range(SLOTS):
            model = model_from_state(cfg, state_dict, self.device)
            model.requires_grad_(False)
            self._models.append(model)
        self._graphs: list[dict[int, torch.cuda.CUDAGraph]] = [{} for _ in range(SLOTS)]
        self._outs: list[dict[int, torch.Tensor]] = [{} for _ in range(SLOTS)]
        self._staging = ({b: _Staging(b, cfg.field_size, self.device) for b in self.buckets}
                         if self.device.type == "cuda" else {})
        # graph replays since construction, and the B1 launches each one
        # runs (recorded by the kernel's wrapper during the capture: B1's
        # ``launches`` counts no replay, so a caller counts B1's runs
        # through the graphs as replays x kernel_launches_per_replay)
        self.replays = 0
        self.kernel_launches_per_replay = 0

    @property
    def graph_count(self) -> int:
        return sum(len(g) for g in self._graphs)

    def _forward(self, slot: int, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._models[slot](ids, vals))

    def precompile(self) -> dict[str, float]:
        """Capture every (slot, bucket) graph: ``{"slot<s>/<bucket>":
        seconds}`` with each bucket's warm-up.  On the CPU there is nothing
        to capture ({})."""
        if self.device.type != "cuda":
            return {}
        if self.graph_count:
            raise RuntimeError("the bucket graphs are already captured")
        timings = {}
        side = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device), torch.no_grad():
            for slot in range(SLOTS):
                pool = torch.cuda.graph_pool_handle()
                for b in reversed(self.buckets):  # the largest first
                    st = self._staging[b]
                    t0 = time.perf_counter()
                    side.wait_stream(torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(side):
                        for _ in range(WARMUP_CALLS):
                            self._forward(slot, st.ids, st.vals)
                    torch.cuda.current_stream(self.device).wait_stream(side)
                    graph = torch.cuda.CUDAGraph()
                    before = fused_ctr.captured
                    with torch.cuda.graph(graph, pool=pool,
                                          capture_error_mode="thread_local"):
                        out = self._forward(slot, st.ids, st.vals)
                    self.kernel_launches_per_replay = fused_ctr.captured - before
                    self._graphs[slot][b] = graph
                    self._outs[slot][b] = out
                    timings[f"slot{slot}/{b}"] = round(time.perf_counter() - t0, 4)
            torch.cuda.synchronize(self.device)
        return timings

    def predict_with(self, slot: int, feat_ids, feat_vals) -> np.ndarray:
        """[N, F] int64 ids and f32 vals -> [N] f32 probabilities from
        ``slot``'s weights: on the card through that slot's bucket graphs
        (rows chunked by the largest bucket, each chunk zero-padded to its
        bucket), waiting for the result."""
        ids = np.asarray(feat_ids, np.int64)
        vals = np.asarray(feat_vals, np.float32)
        if self.device.type != "cuda":
            with torch.inference_mode():
                return self._forward(slot, torch.from_numpy(ids),
                                     torch.from_numpy(vals)).numpy()
        graphs = self._graphs[slot]
        if not graphs:
            raise RuntimeError("the bucket graphs are not captured: call precompile() first")
        n = ids.shape[0]
        out = np.empty((n,), np.float32)
        cap = self.buckets[-1]
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            for s in range(0, n, cap):
                k = min(cap, n - s)
                b = pick_bucket(self.buckets, k)
                st = self._staging[b]
                st.np_ids[:k] = ids[s:s + k]
                st.np_vals[:k] = vals[s:s + k]
                if k < b:
                    st.np_ids[k:] = 0
                    st.np_vals[k:] = 0
                st.ids.copy_(st.h_ids, non_blocking=True)
                st.vals.copy_(st.h_vals, non_blocking=True)
                graphs[b].replay()
                st.h_out.copy_(self._outs[slot][b], non_blocking=True)
                stream.synchronize()
                out[s:s + k] = st.np_out[:k]
                self.replays += 1
        return out

    def slot_specs(self) -> dict[str, tuple[tuple[int, ...], str]]:
        """``state_dict`` name -> (shape, dtype) of every slot's tensors."""
        return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in self._models[0].state_dict().items()}

    def slot_state(self, slot: int) -> dict[str, torch.Tensor]:
        """A slot's parameters and BN buffers, as CPU copies."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self._models[slot].state_dict().items()}

    def load_slot(self, slot: int, state_dict: dict) -> None:
        """``copy_`` ``state_dict`` (numpy arrays or tensors with the
        slot's names and shapes) into ``slot``'s parameters and buffers and
        wait for the copies.  The graphs read those tensors, so the next
        replay of the slot scores with the new weights."""
        live = self._models[slot].state_dict()
        if set(state_dict) != set(live):
            raise ValueError(
                f"state_dict names differ from the slot's: missing "
                f"{sorted(set(live) - set(state_dict))}, unexpected "
                f"{sorted(set(state_dict) - set(live))}")
        with torch.no_grad():
            for name, dst in live.items():
                src = torch.as_tensor(state_dict[name])
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)}, the slot "
                                     f"holds {tuple(dst.shape)}")
                dst.copy_(src)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
