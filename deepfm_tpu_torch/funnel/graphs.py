"""The funnel's CUDA graphs over two weight slots: the serving path's
bucket-graph design (serve/graphs.py ``SlotGraphs``) applied to the
retrieve and rank stages, the port's counterpart of JAX's funnel
executables with the payload passed as an argument
(``deepfm_tpu/funnel/serve.py``).

* **Two slots** on the card, each a whole funnel payload
  (funnel/index.py ``stage_funnel_payload``): the ranker, the query
  tower, and the index shards padded to the capacity (``item_ids``,
  ``item_emb``, and under int8 ``item_codes`` and ``item_scales``), every
  shard on the serving card.  A slot is what a JAX payload is:
  :meth:`FunnelGraphs.dispatch` takes the slot to serve from.
* **Two graphs a (slot, bucket)**: **retrieve** encodes the queries and
  runs B2 plus the f32 rescore (or the exact scorer) over every shard and
  the merge, into the bucket's static ``[B, K]`` scores and ids, and
  writes the merge-overflow flag (a pad among all K candidates) as a
  device scalar; **rank** fans the candidates out, runs the ranker
  through B1, the sigmoid and the top N, into the static ``[B, 3, N]``
  pack.  Under admission control with int8 retrieval a third graph, the
  retrieve at the degraded oversample, is captured at boot and replayed
  in place of the first while admission degrades (never a capture under
  load).
* **A dispatch** fills pinned staging buffers, replays the two graphs
  with CUDA events between them (the stage times need no host sync in
  the middle), and copies the pack and the flag back in one
  device-to-host copy.
* **A swap** is a ``copy_`` of every leaf into the idle slot
  (:meth:`FunnelGraphs.load_slot`).  Nothing is ever captured again.

Every call here runs on the micro-batcher's worker (``run_on_worker``),
as in serve/graphs.py.  On the CPU the same interface runs the stages
eagerly; on the card a capture or replay failure raises and nothing
falls back to the eager stages.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..core.platform import resolve_device
from ..serve.batcher import DEFAULT_BUCKETS
from ..serve.graphs import SLOTS, SlotGraphs, Staging, load_leaves
from .index import (FunnelContext, FunnelIndex, build_rank_topn_with,
                    build_retrieve_with, stage_funnel_payload)

# B2's and B1's runs inside funnel graph replays since import (or since a
# caller reset them): each replay adds the launches its capture recorded
# (the wrappers count those as captured, not launched)
graph_kernel_runs = {"retrieval": 0, "forward": 0}


def _flat_leaves(tree: dict) -> dict:
    """A slot's tree (``{"rank": state_dict, "query": state_dict,
    "shards": [leaves, ...]}``, tensors or host arrays) by flat name:
    ``"rank.<name>"``, ``"query.<name>"``, ``"shards.<i>.<name>"``."""
    out = {f"{part}.{k}": v for part in ("rank", "query") for k, v in tree[part].items()}
    for i, shard in enumerate(tree["shards"]):
        out.update({f"shards.{i}.{k}": v for k, v in shard.items()})
    return out


class FunnelGraphs:
    """The funnel's two stages behind CUDA graphs in ``slots`` (default
    ``SLOTS``; a pool member takes three) weight slots on ``device``
    (default: the card; ``"cpu"`` runs them eagerly).  With
    ``degraded_oversample`` a third graph a (slot, bucket), the retrieve at
    that oversample, is captured beside the others and replayed in place
    of the full retrieve on a degraded dispatch.  ``data_parallel`` splits
    every bucket into that many row slices, each retrieved and ranked on
    its own (every bucket must divide by it).

    Every slot starts from the ranker's and the query tower's
    ``state_dict``s and ``index``.  Call :meth:`precompile` (on the
    thread that will replay) before :meth:`dispatch`."""

    def __init__(self, ctx: FunnelContext, rank_state: dict, query_state: dict,
                 index: FunnelIndex, *, device=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, slots: int = SLOTS,
                 degraded_oversample: int | None = None, data_parallel: int = 1):
        from ..serve.export import model_from_state

        self.ctx = ctx
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.data_parallel = int(data_parallel)
        bad = [b for b in self.buckets if b % self.data_parallel]
        if bad:
            raise ValueError(
                f"bucket sizes {bad} are not divisible by the funnel's data_parallel="
                f"{self.data_parallel}: every dispatch must split evenly into data slices")
        self._retrieve = build_retrieve_with(ctx)
        self._rank = build_rank_topn_with(ctx)
        # the shed ladder's degraded retrieve: the int8 shortlist at a
        # smaller oversample, a third stage captured at boot beside the
        # full one and replayed in its place (None: no degraded stage)
        self.degraded_oversample = degraded_oversample
        self._retrieve_degraded = (
            None if degraded_oversample is None
            else build_retrieve_with(ctx._replace(oversample=int(degraded_oversample))))
        self._payloads = []
        for _ in range(int(slots)):
            models = []
            for cfg, state in ((ctx.rank_cfg, rank_state), (ctx.query_cfg, query_state)):
                model = model_from_state(cfg, state, self.device)
                model.requires_grad_(False)
                models.append(model)
            self._payloads.append(stage_funnel_payload(ctx, *models, index))
        self._slots = None
        if self.device.type == "cuda":
            k = ctx.top_k
            # each bucket's [B, K] candidates, passed from retrieve to rank
            self._cands = {b: (torch.zeros((b, k), dtype=torch.float32, device=self.device),
                               torch.zeros((b, k), dtype=torch.int32, device=self.device))
                           for b in self.buckets}
            # out: the [B, 3, N] pack, then the overflow flag
            self._slots = SlotGraphs(self.device, self.buckets,
                                     ctx.user_fields + ctx.rank_fields,
                                     lambda b: b * 3 * ctx.return_n + 1,
                                     2 if self._retrieve_degraded is None else 3,
                                     self._bodies, slots=int(slots), default_stages=(0, 1))

    @property
    def slots(self) -> int:
        return len(self._payloads)

    @property
    def graph_count(self) -> int:
        return self._slots.count if self._slots is not None else 0

    @property
    def launches_per_replay(self) -> dict[str, int]:
        """B2 (``retrieval``) and B1 (``forward``) launches a dispatch's
        replays run."""
        return dict(self._slots.launches_per_replay) if self._slots is not None else {}

    @property
    def retrieve_pool_bytes(self) -> dict[int, int]:
        """By bucket, the bytes the retrieve graph's capture allocated at
        its peak (its share of the slot's pool)."""
        return ({b: v[0] for b, v in self._slots.pool_bytes.items()}
                if self._slots is not None else {})

    def payload(self, slot: int) -> dict:
        """The slot's payload (models and index shards), for references."""
        return self._payloads[slot]

    def _sliced(self, fn, *tensors):
        """``fn`` on each of the ``data_parallel`` row slices of
        ``tensors``, the results concatenated (one slice: ``fn`` alone)."""
        dp = self.data_parallel
        if dp == 1:
            return fn(*tensors)
        per = tensors[0].shape[0] // dp
        outs = [fn(*(t[i * per:(i + 1) * per] for t in tensors)) for i in range(dp)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(x) for x in zip(*outs))
        return torch.cat(outs)

    def _bodies(self, slot: int, st: Staging):
        """The retrieve and rank stages of ``slot`` at ``st``'s bucket,
        then the degraded retrieve when there is one."""
        fu = self.ctx.user_fields
        payload = self._payloads[slot]
        scores, cand = self._cands[st.bucket]

        def retriever(fn):
            def retrieve():
                s, c = self._sliced(lambda i, v: fn(payload, i, v),
                                    st.ids[:, :fu], st.vals[:, :fu])
                scores.copy_(s)
                cand.copy_(c)
                # the merge returned pads among all K candidates (the pack's
                # N alone cannot tell: pads rank last and fall out of it)
                st.out[-1:].copy_((c < 0).any().to(torch.float32).reshape(1))
            return retrieve

        def rank():
            pack = self._sliced(lambda i, v, c, s: self._rank(payload, i, v, c, s),
                                st.ids[:, fu:], st.vals[:, fu:], cand, scores)
            st.out[:-1].copy_(pack.reshape(-1))

        if self._retrieve_degraded is None:
            return retriever(self._retrieve), rank
        return retriever(self._retrieve), rank, retriever(self._retrieve_degraded)

    def precompile(self) -> dict[str, float]:
        """Capture both graphs of every (slot, bucket): ``{"slot<s>/<b>":
        seconds}`` with each bucket's warm-up.  On the CPU there is
        nothing to capture ({})."""
        return self._slots.capture() if self._slots is not None else {}

    def _eager(self, slot: int, ids: np.ndarray, vals: np.ndarray, degraded: bool = False):
        fu = self.ctx.user_fields
        payload = self._payloads[slot]
        retrieve = self._retrieve_degraded if degraded else self._retrieve
        tids = torch.from_numpy(np.ascontiguousarray(ids)).to(self.device)
        tvals = torch.from_numpy(np.ascontiguousarray(vals)).to(self.device)
        with torch.no_grad():
            t0 = time.perf_counter()
            scores, cand = self._sliced(lambda i, v: retrieve(payload, i, v),
                                        tids[:, :fu], tvals[:, :fu])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            pack = self._sliced(lambda i, v, c, s: self._rank(payload, i, v, c, s),
                                tids[:, fu:], tvals[:, fu:], cand, scores)
            pack = pack.cpu().numpy()
            t2 = time.perf_counter()
        return pack, scores.cpu().numpy(), cand.cpu().numpy(), (t1 - t0, t2 - t1)

    def eager(self, slot: int, ids, vals, *, degraded: bool = False) -> tuple[np.ndarray, bool]:
        """The two stages run eagerly on ``slot``'s payload (on the card:
        the kernels launched one by one): ``(pack [B, 3, N], overflow)``."""
        pack, _, cand, _ = self._eager(slot, ids, vals, degraded)
        return pack, bool((cand < 0).any())

    def dispatch(self, slot: int, ids, vals, *, full: bool = False, degraded: bool = False):
        """[B, Fu+F] int64 ids and f32 vals (B at most the largest bucket)
        -> ``(pack [B, 3, N], overflow, (retrieve s, rank s))`` from
        ``slot``'s payload: on the card through that slot's graphs at the
        smallest bucket that holds B (zero rows pad it), each stage's time
        the stream's between CUDA events; on the CPU eagerly, on the host
        clock.  ``degraded`` runs the degraded retrieve in place of the
        full one.  ``full`` adds the ``[B, K]`` retrieval scores and ids
        (the canary reads them)."""
        ids = np.asarray(ids, np.int64)
        vals = np.asarray(vals, np.float32)
        if degraded and self._retrieve_degraded is None:
            raise ValueError("this funnel has no degraded retrieve (no admission, "
                             "exact retrieval, or oversample 1)")
        if self._slots is None:
            pack, scores, cand, secs = self._eager(slot, ids, vals, degraded)
            overflow = bool((cand < 0).any())
            return (pack, overflow, secs, scores, cand) if full else (pack, overflow, secs)
        stages = (2, 1) if degraded else (0, 1)
        st, secs = self._slots.replay(slot, ids, vals, stages)
        for name, n in self._slots.launches(stages).items():
            graph_kernel_runs[name] += n
        k = ids.shape[0]
        pack = st.np_out[:-1].reshape(st.bucket, 3, self.ctx.return_n)[:k].copy()
        overflow = bool(st.np_out[-1] != 0)
        if not full:
            return pack, overflow, secs
        scores, cand = (t[:k].cpu().numpy() for t in self._cands[st.bucket])
        return pack, overflow, secs, scores, cand

    def load_slot(self, slot: int, staged: dict) -> None:
        """``copy_`` a staged version (``{"rank": state_dict, "query":
        state_dict, "shards": [leaves, ...]}``, host arrays or tensors of
        the slot's names, shapes and dtypes; another tree is refused) into
        ``slot``'s tensors and wait for the copies.  The graphs read those
        tensors, so the slot's next replay serves the new version."""
        p = self._payloads[slot]
        live = {"rank": p["rank"].state_dict(), "query": p["query"].state_dict(),
                "shards": p["shards"]}
        load_leaves(_flat_leaves(live), _flat_leaves(staged))
