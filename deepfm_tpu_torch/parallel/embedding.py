"""Row-sharded embedding tables: counterpart of
``deepfm_tpu/parallel/embedding.py`` (``permute_ids``,
``resolve_shard_exchange``, ``exchange_capacity``,
``exchange_wire_bytes_est``, ``ExchangePlan``, ``exchange_plan``,
``sharded_lookup`` with its psum and all-to-all exchanges, and
``lookup_fn_from_config`` as ``tables_from_config``), over
``torch.distributed``.  JAX's ``sharded_l2`` is
:meth:`ShardedTables.table_sum`: the model psums both tables' local sums
of squares in one all_reduce.

fm_w and fm_v are split by rows over the ``model_parallel`` ranks of a
model group (parallel/mesh.py): shard ``j`` owns rows ``[j·R, (j+1)·R)``.
Every rank of the group holds the same ids (they read the same batches),
and a lookup assembles the rows of those ids on every one of them, in one
of two ways (``model.shard_exchange``):

``psum``::

    each shard gathers the ids it owns, zeros elsewhere      [N, W]
    one all_reduce over the model group                       [N, W]

``alltoall`` (the deduplicated, owned-rows-only exchange)::

    sort the ids into distinct rows (ops/embedding.py sort_segments)
    one request bucket of C slots per owner: its local row ids   [M, C]
    all_to_all_single -> the owner gathers what it was asked     [M, C, W]
    all_to_all_single -> the rows come back                      [M, C, W]

W is the width of the tables looked up together (fm_v's K plus fm_w's 1:
one exchange serves both).  A batch whose distinct rows crowd one owner
past its C slots (``plan.overflow``) takes the psum path instead; the
ranks of the model group agree on the flag with one all_reduce (MAX)
before they branch, so they all run the same collectives.  JAX's
``lax.cond`` is this host branch.

What a lookup hands back is a COMPACT table and a slot for each lookup
(:class:`Exchanged`): under alltoall the response buffer plus one zero row
(``[M·C + 1, W]``; a lookup's slot is where its row came back, the zero
row for an invalid id), under psum the assembled rows themselves
(``[N, W]``, slot ``arange(N)``).  The model runs its fused gather + FM
kernel (B1, ops/fused_ctr.py) on the compact table with the slots as ids,
and the kernel's backward (B1') writes one summed gradient per slot: under
alltoall exactly the per-distinct-row sums the reverse all_to_all_single
sends to the owners, which add them into their shard's gradient.  No
``[B, F, W]`` row gradient is sent and no dense gradient of another
shard's rows exists.

The backward of each exchange is its transpose, as JAX's autodiff takes
it under ``shard_map(check_vma=False)``: the all_reduce's is an
all_reduce, the all_to_all's the reverse all_to_all.  Every rank of the
model group computes the same loss, so the owner receives the same
gradient from each of the M ranks: a row-sharded table's gradient is M
times the one-card gradient, in JAX and here (the L2 term's psum does the
same).

Ids outside ``[0, M·R)`` gather zero rows and train no row on both paths.
``permute_ids`` is the host-side bijection that spreads Zipf-hot ids over
the shards (the input pipeline applies it with ``data.permute_ids``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.embedding import sort_segments

# odd multiplier for the bijective id-spreading permutation (Knuth-style)
_HASH_MULT = 0x9E3779B1

# collective traffic of this process's exchanges since import (or since a
# caller reset them): lookups, psum fallbacks, and the bytes each kind of
# collective sent to OTHER ranks (an all_to_all_single sends (M-1)/M of its
# buffer; an all_reduce counts as a ring's 2·(M-1)/M of it)
counters = {"lookups": 0, "fallbacks": 0, "alltoall_bytes": 0, "allreduce_bytes": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def permute_ids(ids, vocab_size: int, enabled: bool) -> np.ndarray:
    """Bijective multiplicative-hash permutation of ids within
    ``[0, vocab_size)`` (host numpy, int64 out when enabled)."""
    ids = np.asarray(ids)
    if not enabled:
        return ids
    mult = _HASH_MULT
    while np.gcd(mult, vocab_size) != 1:  # bijectivity needs gcd(a, V) == 1
        mult += 2
    return (ids.astype(np.int64) * mult) % vocab_size


def resolve_shard_exchange(cfg, data_parallel: int, device_type: str) -> str:
    """``model.shard_exchange`` with "auto" resolved: "alltoall" where rows
    cross a wire between cards (``model_parallel > 1``, or the lazy step's
    data-group gather at ``data_parallel > 1``), "psum" on the CPU (gloo
    between processes; JAX's "auto" keeps psum for cross-process CPU
    collectives too) and where nothing is exchanged."""
    mode = cfg.model.shard_exchange
    if mode != "auto":
        return mode
    sharded = cfg.mesh.model_parallel > 1 or (
        cfg.optimizer.lazy_embedding_updates and data_parallel > 1)
    if not sharded or device_type == "cpu":
        return "psum"
    return "alltoall"


def exchange_capacity(n_ids: int, num_shards: int, fraction: float) -> int:
    """Request slots per owner: ``ceil(fraction·n_ids)``, or with fraction
    0 ``ceil(n_ids / num_shards)``, in ``[1, n_ids]``."""
    if fraction and fraction > 0:
        cap = int(np.ceil(fraction * n_ids))
    else:
        cap = -(-n_ids // max(1, num_shards))
    return max(1, min(cap, n_ids))


def exchange_wire_bytes_est(n_ids: int, num_shards: int, capacity_fraction: float,
                            widths: tuple[int, ...], *, exchange: str = "alltoall",
                            itemsize: int = 4) -> int:
    """JAX's estimate of the collective bytes leaving one shard for one
    forward lookup of an ``n_ids``-long id stream: ``(M-1)·C·(K+1)·itemsize``
    a table of width K under alltoall (the request and the response legs),
    ``2·N·K·itemsize`` under psum (a ring all-reduce)."""
    if num_shards <= 1:
        return 0
    total = 0
    if exchange == "alltoall":
        cap = exchange_capacity(n_ids, num_shards, capacity_fraction)
        for k in widths:
            total += (num_shards - 1) * cap * (int(k) + 1) * itemsize
    else:
        for k in widths:
            total += 2 * n_ids * int(k) * itemsize
    return total


class ModelAxis(NamedTuple):
    """The model group a lookup exchanges over: its process group, its
    size M and this rank's index in it."""

    group: object
    size: int
    index: int


class ExchangePlan(NamedTuple):
    """The deduplicated routing of one id stream, every tensor ``[N]`` but
    ``counts [M]`` and ``overflow []``: ``order``/``seg``/``row_id`` from
    ``sort_segments`` (the live segments first), ``unique_valid`` (a live
    segment of an in-range id), ``owner`` (M for the rest), ``slot`` (the
    segment's place in its owner's bucket), ``counts`` (distinct rows per
    owner) and ``overflow`` (some owner's count exceeds the capacity)."""

    order: torch.Tensor
    seg: torch.Tensor
    row_id: torch.Tensor
    unique_valid: torch.Tensor
    owner: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def exchange_plan(flat_ids: torch.Tensor, rows: int, num_shards: int,
                  capacity: int) -> ExchangePlan:
    """The plan for ``flat_ids`` over ``num_shards`` shards of ``rows``
    rows.  Ids outside ``[0, rows·num_shards)`` share one trailing segment
    of the sentinel ``rows·num_shards`` and are routed nowhere.  Row ids
    ascend over the live segments, so each owner's requests are contiguous
    and ``searchsorted`` finds the buckets."""
    n = flat_ids.shape[0]
    total = rows * num_shards
    flat = flat_ids.long()
    in_range = (flat >= 0) & (flat < total)
    order, seg, row_id, valid_seg = sort_segments(torch.where(in_range, flat, total))
    unique_valid = valid_seg & (row_id < total)
    owner = torch.where(unique_valid, row_id // rows, num_shards).to(torch.int32)
    q = torch.arange(num_shards, dtype=torch.int32, device=flat.device)
    start = torch.searchsorted(owner, q, side="left").to(torch.int32)
    end = torch.searchsorted(owner, q, side="right").to(torch.int32)
    counts = end - start
    slot = (torch.arange(n, dtype=torch.int32, device=flat.device)
            - start[owner.clamp(0, num_shards - 1).long()])
    return ExchangePlan(order=order, seg=seg, row_id=row_id, unique_valid=unique_valid,
                        owner=owner, slot=slot, counts=counts,
                        overflow=(counts > capacity).any())


def probe_ids(plan: ExchangePlan) -> tuple[torch.Tensor, torch.Tensor]:
    """``(row_id, unique_valid)``: the plan's deduplicated id stream, the
    cache-probe keys of the tiered store (tiered/): one sort gives both
    the owners' routing and the distinct rows a batch needs resident.
    ``row_id`` is valid on the ``unique_valid`` prefix; both are ``[N]``.
    The sort is a stable int64 sort, so ids of 2**24 and more group as
    any others do (JAX packs them into a uint32 key where they fit)."""
    return plan.row_id, plan.unique_valid


def _gather_rows(tables, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[n, W]``: each table's rows at ``idx`` side by side (a 1-D table as
    one column), zero where ``mask`` is false."""
    cols = [t[idx] if t.dim() == 2 else t[idx][:, None] for t in tables]
    out = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
    return torch.where(mask[:, None], out, 0.0)


def _scatter_rows(tables, idx: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                  table_grad: str) -> list[torch.Tensor]:
    """Each table's gradient: the rows of ``g [n, W]`` where ``mask`` added
    into ``idx``.  ``scatter`` adds every entry; ``segsum`` sums equal rows
    first and adds once a row.  A masked-out entry adds zeros to a spread
    row (its position mod the rows), so no one row takes every padding
    add."""
    rows = tables[0].shape[0]
    n = idx.shape[0]
    spread = torch.arange(n, device=idx.device) % rows
    if table_grad == "segsum":
        order, seg, row_id, valid = sort_segments(torch.where(mask, idx, rows))
        g = torch.zeros_like(g).index_add_(0, seg, g[order])
        mask = valid & (row_id < rows)
        idx = row_id
    target = torch.where(mask, idx, spread)
    g = torch.where(mask[:, None], g, 0.0)
    out, col = [], 0
    for t in tables:
        w = 1 if t.dim() == 1 else t.shape[1]
        piece = g[:, col:col + w]
        out.append(torch.zeros_like(t).index_add_(
            0, target, piece[:, 0] if t.dim() == 1 else piece))
        col += w
    return out


def _ring_bytes(t: torch.Tensor, m: int) -> int:
    return 2 * (m - 1) * t.numel() * t.element_size() // m


def _a2a_bytes(t: torch.Tensor, m: int) -> int:
    return (m - 1) * t.numel() * t.element_size() // m


class _PsumRows(torch.autograd.Function):
    """Owned rows, zeros elsewhere, summed over the model group; the
    backward all-reduces the row gradient and each owner adds its rows."""

    @staticmethod
    def forward(ctx, flat_ids, axis, table_grad, *tables):
        rows = tables[0].shape[0]
        local = flat_ids.long() - axis.index * rows
        in_range = (local >= 0) & (local < rows)
        idx = local.clamp(0, rows - 1)
        out = _gather_rows(tables, idx, in_range).contiguous()
        dist.all_reduce(out, group=axis.group)
        counters["allreduce_bytes"] += _ring_bytes(out, axis.size)
        ctx.axis, ctx.table_grad = axis, table_grad
        ctx.save_for_backward(idx, in_range, *tables)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, in_range, *tables = ctx.saved_tensors
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        counters["allreduce_bytes"] += _ring_bytes(g, ctx.axis.size)
        return (None, None, None,
                *_scatter_rows(tables, idx, in_range, g, ctx.table_grad))


class _AllToAllRows(torch.autograd.Function):
    """The owner's side of the exchange: the requests in, the owned rows
    out; the backward takes the per-slot gradients back from every
    requester and adds them into the shard."""

    @staticmethod
    def forward(ctx, reqbuf, axis, table_grad, *tables):
        rows = tables[0].shape[0]
        recv = torch.empty_like(reqbuf)
        dist.all_to_all_single(recv, reqbuf, group=axis.group)
        mask = recv < rows
        idx = recv.long().clamp(0, rows - 1)
        got = _gather_rows(tables, idx, mask).contiguous()
        resp = torch.empty_like(got)
        dist.all_to_all_single(resp, got, group=axis.group)
        counters["alltoall_bytes"] += (_a2a_bytes(reqbuf, axis.size)
                                       + _a2a_bytes(got, axis.size))
        ctx.axis, ctx.table_grad = axis, table_grad
        ctx.save_for_backward(idx, mask, *tables)
        return resp

    @staticmethod
    def backward(ctx, g_resp):
        idx, mask, *tables = ctx.saved_tensors
        g_resp = g_resp.contiguous()
        g_got = torch.empty_like(g_resp)
        dist.all_to_all_single(g_got, g_resp, group=ctx.axis.group)
        counters["alltoall_bytes"] += _a2a_bytes(g_resp, ctx.axis.size)
        return (None, None, None,
                *_scatter_rows(tables, idx, mask, g_got, ctx.table_grad))


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward is an ``all_reduce`` (JAX's psum
    transpose under ``check_vma=False``)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Differentiable sum over the model group."""
    return _AllReduceSum.apply(x, axis.group)


class Exchanged(NamedTuple):
    """A lookup's result: the ``compact`` table ``[n, W]``, each lookup's
    ``slot [N]`` in it (int32), each slot's global row (``slot_row [n]``,
    ``rows·M`` where the slot holds no row)."""

    compact: torch.Tensor
    slot: torch.Tensor
    slot_row: torch.Tensor


def _psum_exchange(tables, flat_ids, axis, table_grad) -> Exchanged:
    n = flat_ids.shape[0]
    total = tables[0].shape[0] * axis.size
    flat = flat_ids.long()
    compact = _PsumRows.apply(flat, axis, table_grad, *tables)
    slot_row = torch.where((flat >= 0) & (flat < total), flat, total)
    slot = torch.arange(n, dtype=torch.int32, device=flat.device)
    return Exchanged(compact, slot, slot_row)


def _alltoall_exchange(tables, plan: ExchangePlan, cap: int, axis, table_grad) -> Exchanged:
    rows = tables[0].shape[0]
    m, n = axis.size, plan.order.shape[0]
    dev = plan.order.device
    mc = m * cap
    ok = plan.unique_valid & (plan.slot < cap)
    owner = plan.owner.long()
    # each segment's place in the [M, C] buffer; distinct out-of-buffer
    # places for the rest, cut off below
    scat = torch.where(ok, owner * cap + plan.slot.long(),
                       mc + torch.arange(n, device=dev))
    req = torch.full((mc + n,), rows, dtype=torch.int32, device=dev)
    req.scatter_(0, scat, torch.where(ok, plan.row_id - owner * rows, rows).to(torch.int32))
    resp = _AllToAllRows.apply(req[:mc].contiguous(), axis, table_grad, *tables)
    compact = torch.cat([resp, resp.new_zeros(1, resp.shape[1])])
    # lookup position -> its segment -> its row's place (mc: the zero row)
    seg_of_pos = torch.empty_like(plan.seg).scatter_(0, plan.order, plan.seg)
    slot = torch.where(ok, scat, mc)[seg_of_pos].to(torch.int32)
    total = rows * m
    row_of = torch.full((mc + n,), total, dtype=torch.long, device=dev)
    row_of.scatter_(0, scat, torch.where(ok, plan.row_id, total))
    slot_row = torch.cat([row_of[:mc], row_of.new_full((1,), total)])
    return Exchanged(compact, slot, slot_row)


def exchange_rows(tables, flat_ids: torch.Tensor, axis: ModelAxis, *,
                  exchange: str = "psum", capacity: float = 0.0,
                  table_grad: str = "scatter") -> Exchanged:
    """Assemble the rows of ``flat_ids [N]`` from the local shards
    ``tables`` (each ``[R]`` or ``[R, K]``, the same R) over ``axis``.
    Differentiable in the tables.  ``exchange`` is "psum" or "alltoall"
    (resolve "auto" first); ``capacity`` the fraction of N a bucket holds
    (0: ``ceil(N/M)``)."""
    if exchange not in ("psum", "alltoall"):
        raise ValueError(f"exchange must be 'psum' or 'alltoall' (resolve 'auto' via "
                         f"resolve_shard_exchange first), got {exchange!r}")
    counters["lookups"] += 1
    if exchange == "psum":
        return _psum_exchange(tables, flat_ids, axis, table_grad)
    rows = tables[0].shape[0]
    n = flat_ids.shape[0]
    cap = exchange_capacity(n, axis.size, capacity)
    plan = exchange_plan(flat_ids, rows, axis.size, cap)
    # a shard owns at most ``rows`` rows and a batch has at most ``n``
    # distinct ones: at that capacity no bucket overflows
    if cap < min(n, rows):
        flag = plan.overflow.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=axis.group)
        if int(flag.item()):
            counters["fallbacks"] += 1
            return _psum_exchange(tables, flat_ids, axis, table_grad)
    return _alltoall_exchange(tables, plan, cap, axis, table_grad)


def sharded_lookup(local_table: torch.Tensor, ids: torch.Tensor, axis: ModelAxis, *,
                   table_grad: str = "scatter", exchange: str = "psum",
                   capacity: float = 0.0) -> torch.Tensor:
    """JAX's ``sharded_lookup``: the rows of ``ids`` (any shape) from the
    row-sharded ``local_table`` (``[R]`` or ``[R, K]``), as
    ``ids.shape + local_table.shape[1:]``, on every rank of the group."""
    ex = exchange_rows((local_table,), ids.reshape(-1), axis, exchange=exchange,
                       capacity=capacity, table_grad=table_grad)
    rows = ex.compact[ex.slot.long()]
    return rows.reshape(ids.shape + local_table.shape[1:])


class ShardedTables:
    """The DeepFM model's row-sharded fm_w/fm_v (models/deepfm.py reads
    it): ``lookup`` runs one exchange for both tables and returns the
    compact tables and the slots for the fused kernel, ``table_sum`` the
    psum of a local sum."""

    def __init__(self, axis: ModelAxis, *, exchange: str, capacity: float,
                 table_grad: str):
        self.axis = axis
        self.exchange = exchange
        self.capacity = capacity
        self.table_grad = table_grad

    def lookup(self, fm_w: torch.Tensor, fm_v: torch.Tensor, ids: torch.Tensor):
        """``(compact fm_w [n], compact fm_v [n, K], slots [B, F] int32)``."""
        ex = exchange_rows((fm_v, fm_w), ids.reshape(-1), self.axis,
                           exchange=self.exchange, capacity=self.capacity,
                           table_grad=self.table_grad)
        k = fm_v.shape[1]
        return (ex.compact[:, k].contiguous(), ex.compact[:, :k].contiguous(),
                ex.slot.view(ids.shape))

    def table_sum(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, self.axis)


def tables_from_config(cfg, axis: ModelAxis, data_parallel: int,
                       device_type: str) -> ShardedTables:
    """JAX's ``lookup_fn_from_config``: table_grad, the resolved exchange
    and the capacity, demoted to psum where the model group has one
    rank."""
    mode = resolve_shard_exchange(cfg, data_parallel, device_type)
    if axis.size <= 1:
        mode = "psum"
    return ShardedTables(axis, exchange=mode, capacity=cfg.model.shard_exchange_capacity,
                         table_grad=cfg.model.table_grad)
