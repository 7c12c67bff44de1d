"""Host-side pager: id to slot translation, eviction, writeback and
staging; the port's copy of ``deepfm_tpu/tiered/pager.py`` (that module
imports no JAX).

The pager owns the hot cache's map (row to slot) and the card its data.
For each step, between steps, it:

1. deduplicates the batch's ids (the probe-key stream),
2. probes the slot map: hits are marked used; misses take free slots
   first, then approximate-LRU victims among slots this batch does not
   use,
3. writes dirty victims back: one fixed-shape gather on the card
   (``step.make_readback``) copies their records to the host, on the
   stream that runs the steps, so it reads them after the last step
   that wrote them and before the next step's swap overwrites them, and
   they land in the host tier,
4. fetches the misses' records from the host tier (which faults pages in
   from the cold tier),
5. fills one of two staging packs (the pack the card may still be
   copying from for one step is never the one filled for the next) and
   returns the batch's slot ids and the pack for the step's swap.

The pack is ``stage_rows`` records at a fixed shape, in pinned memory on
the card's side so the step's copy of it does not hold the host up:
``slots [P]`` int32 (the misses' slots, ascending, then the pad entries,
which all name the sink row ``capacity`` that no lookup reads) and
``records [P, width]`` float32 (``RecordLayout`` records; the pad entries
zero).  JAX pads with distinct out-of-range slots that its scatter drops;
``index_copy_`` takes in-range indices only, hence the sink row.

Everything here is host numpy; the card never sees a global row id.
:class:`SlotMap` is the bare bookkeeping (probe, victim choice,
assignment), shared with the serving cache (``serving.py``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..obs import flight as obs_flight
from ..obs.metrics import MetricsRegistry
from .host import HostTier
from .store import RecordLayout


class SlotMap:
    """Row to slot bookkeeping: probe, pinned-LRU victim choice,
    assignment.  No I/O, no locking: the training pager and the serving
    cache hold their own locks and write back or fetch around these.

    ``begin()`` opens a translation epoch; every row probed or assigned
    in it carries ``slot_use == clock`` and cannot be evicted before the
    next epoch, so a batch never evicts its own rows."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._slot_of: dict[int, int] = {}
        self.slot_row = np.full(self.capacity, -1, np.int64)
        self.slot_use = np.zeros(self.capacity, np.int64)
        self._free = list(range(self.capacity - 1, -1, -1))
        self.clock = 0

    def __len__(self) -> int:
        return len(self._slot_of)

    def begin(self) -> None:
        self.clock += 1

    def probe(self, uniq: np.ndarray) -> tuple[np.ndarray, list[int]]:
        """``(slots, miss_ix)``: each unique row's slot (-1 for a miss,
        whose position lands in ``miss_ix``); hits are pinned for the
        epoch."""
        slots = np.full(uniq.size, -1, np.int64)
        miss_ix: list[int] = []
        for j, r in enumerate(uniq):
            s = self._slot_of.get(int(r))
            if s is None:
                miss_ix.append(j)
            else:
                slots[j] = s
                self.slot_use[s] = self.clock
        return slots, miss_ix

    def select(self, n: int, what: str = "slots") -> np.ndarray:
        """``n`` reusable slots: free ones first, then approximate-LRU
        victims among occupied slots not pinned this epoch.  Victims stay
        mapped: the caller reads ``slot_row[victims]`` (writeback), then
        calls :meth:`release`."""
        take: list[int] = []
        while self._free and len(take) < n:
            take.append(self._free.pop())
        need = n - len(take)
        if need > 0:
            cand = np.flatnonzero((self.slot_row >= 0) & (self.slot_use < self.clock))
            if cand.size < need:
                raise ValueError(
                    f"cache of {self.capacity} {what} cannot hold one translation's "
                    f"unique rows (need {need} more evictable slots, have "
                    f"{cand.size}); raise the capacity")
            if cand.size > need:
                cand = cand[np.argpartition(self.slot_use[cand], need - 1)[:need]]
            take.extend(int(s) for s in cand)
        return np.asarray(take[:n], np.int64)

    def release(self, slots: np.ndarray) -> None:
        """Drop the mappings of the occupied slots among ``slots``."""
        for s in slots:
            r = int(self.slot_row[s])
            if r >= 0:
                del self._slot_of[r]
                self.slot_row[s] = -1

    def assign(self, slots: np.ndarray, rows: np.ndarray) -> None:
        for s, r in zip(slots, rows):
            self._slot_of[int(r)] = int(s)
            self.slot_row[s] = int(r)
            self.slot_use[s] = self.clock


class StagePack:
    """One staging pack: ``slots [P]`` int32 and ``records [P, width]``
    float32, torch tensors (pinned when ``pin``) with numpy views."""

    def __init__(self, rows: int, width: int, pin: bool):
        self.slots = torch.empty(rows, dtype=torch.int32, pin_memory=pin)
        self.records = torch.empty((rows, width), dtype=torch.float32, pin_memory=pin)
        self.np_slots, self.np_records = self.slots.numpy(), self.records.numpy()
        # set by the step after its copy of the pack: waited on before the
        # pack is filled again
        self.copied: torch.cuda.Event | None = None

    def tensors(self) -> dict:
        return {"stage_slots": self.slots, "stage_records": self.records}


class DevicePager:
    def __init__(self, *, capacity: int, layout: RecordLayout, host: HostTier,
                 stage_rows: int, readback_fn, vocab: int, pin: bool = False,
                 registry: MetricsRegistry | None = None):
        if stage_rows < 1:
            raise ValueError("stage_rows must be >= 1")
        self.capacity = int(capacity)
        self.stage_rows = int(stage_rows)
        self.layout = layout
        self.host = host
        self.vocab = int(vocab)
        self._readback = readback_fn
        self._map = SlotMap(self.capacity)
        self._slot_dirty = np.zeros(self.capacity, bool)
        self._lock = threading.Lock()
        self._packs = [StagePack(self.stage_rows, layout.width, pin) for _ in range(2)]
        self._pack_ix = 0
        # the counters live in the obs registry (one labelled family a
        # unit), so GET /metrics scrapes them; stats() renders them
        self.registry = registry if registry is not None else MetricsRegistry()
        events = self.registry.counter("deepfm_paging_events_total",
                                       "pager lifecycle events by kind", labels=("event",))
        rows = self.registry.counter("deepfm_paging_rows_total",
                                     "rows moved between tiers", labels=("kind",))
        byts = self.registry.counter("deepfm_paging_bytes_total",
                                     "bytes moved between tiers", labels=("kind",))
        self._stats = {
            "probe_ids": events.labels("probe_ids"),
            "probe_unique": events.labels("probe_unique"),
            "hits": events.labels("hit"),
            "misses": events.labels("miss"),
            "evictions": events.labels("eviction"),
            "writeback_rows": rows.labels("writeback"),
            "staged_rows": rows.labels("staged"),
            "stage_bytes": byts.labels("stage"),
            "writeback_bytes": byts.labels("writeback"),
            "steps": events.labels("step"),
        }

    # -- the per-step probe and translation ------------------------------------
    def translate(self, ids: np.ndarray, hot) -> tuple[np.ndarray, StagePack]:
        """The batch's ids as slots, misses resolved.  ``hot`` is the
        current hot cache (``PagedHot``), read to write dirty victims back
        before their slots are reused.  Returns ``(slot_ids int32, pack)``
        for the step's swap."""
        with self._lock:
            # da:allow[blocking-under-lock] a page fault must complete under the lock: the slot map mutation is atomic with the miss fill, and the step cannot proceed without its rows anyway (stall-don't-corrupt, mirrors HostTier)
            return self._translate_locked(ids, hot)

    def _translate_locked(self, ids: np.ndarray, hot):
        shape = np.asarray(ids).shape
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        np.clip(ids, 0, self.vocab - 1, out=ids)
        uniq, inv = np.unique(ids, return_inverse=True)
        self._map.begin()
        self._stats["steps"].inc()
        self._stats["probe_ids"].inc(int(ids.size))
        self._stats["probe_unique"].inc(int(uniq.size))

        slots, miss_ix = self._map.probe(uniq)
        n_miss = len(miss_ix)
        self._stats["hits"].inc(int(uniq.size) - n_miss)
        self._stats["misses"].inc(n_miss)
        if n_miss > self.stage_rows:
            obs_flight.record("paging_stage_overflow", subsystem="tiered",
                              misses=n_miss, stage_rows=self.stage_rows)
            raise ValueError(f"batch needs {n_miss} staged rows > stage capacity "
                             f"{self.stage_rows}; raise tiered_stage_rows")

        pack = self._packs[self._pack_ix]
        self._pack_ix ^= 1
        if pack.copied is not None:
            pack.copied.synchronize()
        if n_miss:
            victims = self._take_slots(n_miss, hot)
            miss_rows = uniq[miss_ix]
            recs = self.host.get_records(miss_rows)
            # ascending slots: the swap writes in slot order
            order = np.argsort(victims, kind="stable")
            pack.np_slots[:n_miss] = victims[order]
            pack.np_records[:n_miss] = recs[order]
            self._map.assign(victims, miss_rows)
            slots[miss_ix] = victims
            self._stats["staged_rows"].inc(n_miss)
            self._stats["stage_bytes"].inc(n_miss * self.layout.width * 4)
        pack.np_slots[n_miss:] = self.capacity  # the sink row
        pack.np_records[n_miss:] = 0.0
        # every batch slot takes the lazy update: dirty
        self._slot_dirty[slots] = True
        return slots[inv].astype(np.int32).reshape(shape), pack

    def _take_slots(self, n: int, hot) -> np.ndarray:
        """``n`` reusable slots (:class:`SlotMap` victims); dirty victims
        write back before their mappings drop."""
        take = self._map.select(n, "hot slots")
        victims = take[self._map.slot_row[take] >= 0]
        if victims.size:
            dirty = victims[self._slot_dirty[victims]]
            if dirty.size:
                self._writeback(dirty, hot)
            self._map.release(victims)
            self._stats["evictions"].inc(int(victims.size))
        return take

    def _writeback(self, slots: np.ndarray, hot) -> None:
        """Dirty slots read back in ``stage_rows`` chunks into the host
        tier."""
        for lo in range(0, slots.size, self.stage_rows):
            chunk = slots[lo:lo + self.stage_rows]
            padded = np.full(self.stage_rows, self.capacity, np.int32)
            padded[:chunk.size] = chunk
            recs = self._readback(hot, padded)[:chunk.size]
            self.host.put_records(self._map.slot_row[chunk], recs)
            self._stats["writeback_rows"].inc(chunk.size)
            self._stats["writeback_bytes"].inc(chunk.size * self.layout.width * 4)
        self._slot_dirty[slots] = False

    # -- the checkpoint and publish barrier ----------------------------------
    def writeback_all(self, hot) -> int:
        """Write every dirty slot back to the host tier (the cache stays
        warm): the hot-to-host leg of the flush.  Returns the rows."""
        with self._lock:
            dirty = np.flatnonzero(self._slot_dirty & (self._map.slot_row >= 0))
            if dirty.size:
                # da:allow[blocking-under-lock] checkpoint/publish barrier (see HostTier.flush): every dirty slot must be durable before the barrier returns; a translate racing the flush must wait
                self._writeback(dirty, hot)
        obs_flight.record("paging_flush", subsystem="tiered", rows=int(dirty.size))
        return int(dirty.size)

    def resident(self) -> tuple[np.ndarray, np.ndarray]:
        """``(slots, rows)``: the occupied slots and the rows they hold."""
        with self._lock:
            slots = np.flatnonzero(self._map.slot_row >= 0)
            return slots, self._map.slot_row[slots].copy()

    def stats(self) -> dict:
        out = {k: int(c.value) for k, c in self._stats.items()}
        out["hit_rate"] = round(out["hits"] / max(1, out["probe_unique"]), 6)
        return out
