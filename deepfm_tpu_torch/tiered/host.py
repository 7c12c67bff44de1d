"""Host tier: the backing store between the card's hot cache and the cold
tier.  A copy of ``deepfm_tpu/tiered/host.py`` (that module imports no
JAX; the port keeps its own copy), with one repair: a row that a
synchronous read needs is pinned until the read returns, and a prefetch
makes one pass.

One preallocated ``[capacity, record_width]`` float32 buffer in host
memory holds row records faulted in from the cold tier and rows written
back from the hot cache (the pager stages a step's misses into pinned
memory of its own).  Rows are
the residency unit; cold fetches are PAGE-granular (one ranged read
services every missing row of that page) and dirty evictions/flushes are
page-granular read-modify-write against the cold tier's COW overlays.

Concurrency: the pager's synchronous miss path and the input pipeline's
ahead-of-time id-stream prefetcher share this tier.  The lock is dropped
around cold-tier I/O so a prefetch stalled on a dead store never blocks a
hit, and an in-flight page set + condition variable deduplicates
concurrent fetches of the same page (the second caller waits, then reads
the first caller's rows).

Without pins the two livelock once a step's rows and the next step's
prefetch outgrow the tier: each fill evicts the least recently used rows,
which are the other's fresh ones (their use stamps tie), and
``get_records`` refetches until every row is present at once.  So the
rows of a ``get_records`` call stay resident until it returns, and a
prefetch, being advisory, inserts what it fetched and returns rather
than refetching rows that were evicted meanwhile.
"""

from __future__ import annotations

import threading

import numpy as np

from .store import ColdTier


class HostTier:
    def __init__(self, cold: ColdTier, capacity_rows: int):
        if capacity_rows < cold.page_rows:
            raise ValueError(
                f"host tier capacity {capacity_rows} below one page "
                f"({cold.page_rows} rows) cannot make progress"
            )
        self.cold = cold
        self.capacity = int(capacity_rows)
        width = cold.layout.width
        self._buf = np.zeros((self.capacity, width), np.float32)
        self._idx_of: dict[int, int] = {}          # global row -> buf index
        self._row_at = np.full(self.capacity, -1, np.int64)
        self._dirty = np.zeros(self.capacity, bool)
        self._use = np.zeros(self.capacity, np.int64)
        self._clock = 0
        self._free = list(range(self.capacity - 1, -1, -1))
        self._cond = threading.Condition()
        self._inflight: set[int] = set()           # pages being cold-fetched
        # write-backs a page has taken: a fetch that read the page before a
        # write-back landed holds stale rows and must not insert them
        self._page_writes: dict[int, int] = {}
        self._pins: dict[int, int] = {}            # global row -> reads that need it
        self._stats = {
            "host_hits": 0, "host_misses": 0, "host_evictions": 0,
            "host_flushed_rows": 0, "prefetched_rows": 0,
        }

    # -- read path ---------------------------------------------------------
    def max_request_rows(self) -> int:
        """Largest single-call row set the tier can serve: one eviction
        chunk (``capacity // 16``) must remain displaceable or a fill
        could evict its own rows and loop forever."""
        return self.capacity - max(1, self.capacity // 16)

    def get_records(self, rows: np.ndarray) -> np.ndarray:
        """Records for ``rows`` (unique, in-range), faulting misses in from
        the cold tier page-by-page.  Blocks while the cold tier is down —
        the training-side stall-then-resume behavior."""
        rows = np.asarray(rows, np.int64)
        if rows.size > self.max_request_rows():
            raise ValueError(
                f"one request of {rows.size} rows exceeds the host tier's "
                f"serviceable window ({self.max_request_rows()} of "
                f"{self.capacity} rows): eviction would displace the "
                f"request's own rows; raise tiered_host_rows"
            )
        with self._cond:
            for r in rows.tolist():
                self._pins[r] = self._pins.get(r, 0) + 1
        try:
            first = True
            while True:
                self._ensure(rows, prefetch=not first)
                first = False
                with self._cond:
                    # pinned rows are never evicted, so a second pass
                    # only finds a fetch that failed or was deduplicated
                    if any(int(r) not in self._idx_of for r in rows):
                        continue
                    self._clock += 1
                    idx = np.fromiter(
                        (self._idx_of[int(r)] for r in rows), np.int64, len(rows)
                    )
                    self._use[idx] = self._clock
                    return self._buf[idx].copy()
        finally:
            with self._cond:
                for r in rows.tolist():
                    left = self._pins[r] - 1
                    if left:
                        self._pins[r] = left
                    else:
                        del self._pins[r]

    def prefetch(self, rows: np.ndarray) -> int:
        """Make ``rows`` resident without returning them (the id-stream
        prefetch hook).  Returns how many rows were actually fetched."""
        rows = np.unique(np.asarray(rows, np.int64))
        rows = rows[(rows >= 0) & (rows < self.cold.rows)]
        n = self._ensure(rows, prefetch=True, once=True)
        with self._cond:
            self._stats["prefetched_rows"] += n
        return n

    def _ensure(self, rows: np.ndarray, *, prefetch: bool, once: bool = False) -> int:
        """Fault the missing subset of ``rows`` in.  Lock dropped around
        cold reads; concurrent fetches of one page deduplicate via the
        in-flight set.  ``once``: return after the first pass that
        inserted rows, whatever was evicted meanwhile (a prefetch)."""
        fetched = 0
        while True:
            with self._cond:
                missing = [int(r) for r in rows if int(r) not in self._idx_of]
                if not prefetch:
                    # newer-than-everything-older use stamp: rows inserted
                    # by THIS fill can only be evicted once strictly older
                    # residents are exhausted: which the request-size
                    # window (max_request_rows) guarantees never happens
                    # mid-fill, so a fill cannot displace its own rows
                    self._clock += 1
                    self._stats["host_hits"] += len(rows) - len(missing)
                    self._stats["host_misses"] += len(missing)
                    prefetch = True  # count only the first pass
                if not missing:
                    return fetched
                pages = {r // self.cold.page_rows for r in missing}
                mine = sorted(pages - self._inflight)
                if not mine:
                    # someone else is fetching every page we need
                    self._cond.wait(timeout=0.5)
                    continue
                self._inflight.update(mine)
                writes = {page: self._page_writes.get(page, 0) for page in mine}
            try:
                got = {}
                for page in mine:
                    got[page] = self.cold.read_page(page)  # no lock held
            finally:
                with self._cond:
                    self._inflight.difference_update(mine)
                    self._cond.notify_all()
            with self._cond:
                for page, recs in got.items():
                    if self._page_writes.get(page, 0) != writes[page]:
                        # a dirty row of the page was written back (and
                        # evicted) while it was read: this copy is stale,
                        # the next pass reads the page again
                        continue
                    lo = page * self.cold.page_rows
                    want = [r for r in missing
                            if r // self.cold.page_rows == page
                            and r not in self._idx_of]
                    for r in want:
                        # the eviction flush runs under the lock (see
                        # _alloc_locked): a victim slot is not reused before
                        # its dirty rows reach the cold tier
                        i = self._alloc_locked()
                        self._buf[i] = recs[r - lo]
                        self._idx_of[r] = i
                        self._row_at[i] = r
                        self._dirty[i] = False
                        self._use[i] = self._clock
                        fetched += 1
            if once:
                return fetched

    # -- write path --------------------------------------------------------
    def put_records(self, rows: np.ndarray, recs: np.ndarray) -> None:
        """Absorb device-evicted (or checkpoint-flushed) dirty records.
        Rows the tier already dropped are re-inserted: the device copy is
        the freshest version wherever it exists."""
        rows = np.asarray(rows, np.int64)
        with self._cond:
            self._clock += 1
            for r, rec in zip(rows, recs):
                r = int(r)
                i = self._idx_of.get(r)
                if i is None:
                    i = self._alloc_locked()
                    self._idx_of[r] = i
                    self._row_at[i] = r
                self._buf[i] = rec
                self._dirty[i] = True
                self._use[i] = self._clock

    def _alloc_locked(self) -> int:
        """One free buffer index; evicts (approximate-)LRU rows when full,
        flushing dirty victims' pages to the cold tier first.  Caller
        holds the lock; the flush I/O runs under it too: eviction under a
        dead cold tier stalls the writer, never corrupts."""
        if self._free:
            return self._free.pop()
        live = np.flatnonzero(self._row_at >= 0)
        if self._pins:
            pinned = np.fromiter(self._pins, np.int64, len(self._pins))
            live = live[~np.isin(self._row_at[live], pinned)]
        if not live.size:
            raise RuntimeError(
                f"every row of the host tier ({self.capacity}) is pinned by "
                f"reads in flight; raise tiered_host_rows")
        n_evict = min(max(1, self.capacity // 16), live.size)
        order = (live if n_evict == live.size else
                 live[np.argpartition(self._use[live], n_evict)[:n_evict]])
        dirty = order[self._dirty[order]]
        if dirty.size:
            self._flush_indices_locked(dirty)
        for i in order:
            del self._idx_of[int(self._row_at[i])]
            self._row_at[i] = -1
            self._dirty[i] = False
            self._free.append(int(i))
        self._stats["host_evictions"] += int(order.size)
        return self._free.pop()

    def _flush_indices_locked(self, idx: np.ndarray) -> None:
        """Read-modify-write the dirty rows at ``idx`` into their cold
        pages (grouped, one overlay write per touched page)."""
        rows = self._row_at[idx]
        order = np.argsort(rows)
        idx, rows = idx[order], rows[order]
        pages = rows // self.cold.page_rows
        for page in np.unique(pages):
            sel = pages == page
            recs = self.cold.read_page(int(page))
            recs[rows[sel] - int(page) * self.cold.page_rows] = \
                self._buf[idx[sel]]
            self.cold.write_page(int(page), recs)
            self._page_writes[int(page)] = self._page_writes.get(int(page), 0) + 1
            self._stats["host_flushed_rows"] += int(sel.sum())
        self._dirty[idx] = False

    def flush(self) -> int:
        """Write EVERY dirty row back to the cold tier (checkpoint /
        publish barrier).  Returns rows flushed."""
        with self._cond:
            dirty = np.flatnonzero(self._dirty & (self._row_at >= 0))
            before = self._stats["host_flushed_rows"]
            if dirty.size:
                # the checkpoint and publish barrier: every dirty row is on
                # the cold tier when it returns
                self._flush_indices_locked(dirty)
            return self._stats["host_flushed_rows"] - before

    def stats(self) -> dict:
        with self._cond:
            out = dict(self._stats)
            out["host_resident_rows"] = len(self._idx_of)
        return out
