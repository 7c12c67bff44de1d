"""Cold tier: row pages on a local directory or an object-store prefix,
with ranged reads and copy-on-write overlays.  The port's copy of
``deepfm_tpu/tiered/store.py`` (that module imports no JAX; the port keeps
its own copy).  A root with a scheme (``http://host:port/bucket/prefix``)
puts every segment and overlay at ``join_url(root, name)`` through
``data/object_store.py HttpObjectStore``, with its retry policy: a page
read of a base segment is one ranged GET, an overlay one GET, a write one
PUT, a segment probe one HEAD.  Object names and bytes are the local
tier's file names and bytes.

The cold tier is the system of record for every row the hot and host
tiers do not hold.  Rows are grouped into fixed-size **pages**
(``page_rows`` rows of ``RecordLayout.width`` float32s each), stored two
ways:

* **base segments**: immutable files of ``pages_per_segment`` pages each
  (``segments/<seg>.bin``), written once by :meth:`ColdTier.import_dense`.
  A page read reads only its byte span of the segment.
* **page overlays**: copy-on-write files ``pages/<page>.v<ver>.bin`` of
  dirty pages written back from the host tier.  ``page_versions`` maps a
  page to its committed overlay version; a reader holding a snapshot of
  that map sees a consistent table whatever the writer flushes afterwards
  (the property the publisher's manifest records, ``snapshot()``).

A page in neither comes from ``init_fn(page) -> [rows, width]``, so a
table nobody wrote never exists on disk.  Reads and writes are counted in
``stats()``.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

from ..data.object_store import HttpObjectStore, is_url, join_url

# a cold read slower than this counts its excess toward ``stall_secs``
_STALL_BUDGET_SECS = 0.5

_ITEM = np.dtype(np.float32).itemsize


class RecordLayout:
    """A row's record: ``[value | m | v]`` of each table, the tables one
    after another.

    One record carries a row of every lazy table and both Adam moments, so
    one page read (and one writeback) moves the whole co-evicted unit.
    ``widths`` maps a table to its row width (fm_w 1, fm_v K), in an order
    every tier shares."""

    def __init__(self, widths: dict[str, int]):
        if not widths:
            raise ValueError("RecordLayout needs at least one table")
        self.widths = dict(widths)
        self.keys = tuple(widths)
        self._off: dict[str, int] = {}
        off = 0
        for k, w in widths.items():
            self._off[k] = off
            off += 3 * int(w)
        self.width = off  # floats a record

    def value_slice(self, key: str) -> slice:
        """The columns of table ``key``'s row value."""
        o, w = self._off[key], self.widths[key]
        return slice(o, o + w)

    def moment_slices(self, key: str) -> tuple[slice, slice]:
        o, w = self._off[key], self.widths[key]
        return slice(o + w, o + 2 * w), slice(o + 2 * w, o + 3 * w)

    def pack(self, rows: dict, m: dict, v: dict) -> np.ndarray:
        """dicts of [n(, w)] arrays -> [n, width] records."""
        n = np.asarray(rows[self.keys[0]]).shape[0]
        out = np.empty((n, self.width), np.float32)
        for k in self.keys:
            w = self.widths[k]
            for sl, src in zip((self.value_slice(k), *self.moment_slices(k)),
                               (rows[k], m[k], v[k])):
                out[:, sl] = np.asarray(src, np.float32).reshape(n, w)
        return out

    def unpack(self, recs: np.ndarray) -> tuple[dict, dict, dict]:
        """[n, width] records -> (rows, m, v) dicts shaped like the tables
        ([n] for width-1 tables, [n, w] otherwise)."""
        rows, m, v = {}, {}, {}
        for k in self.keys:
            w = self.widths[k]
            msl, vsl = self.moment_slices(k)
            parts = [recs[:, self.value_slice(k)], recs[:, msl], recs[:, vsl]]
            if w == 1:
                parts = [a[:, 0] for a in parts]
            rows[k], m[k], v[k] = parts
        return rows, m, v


class ColdTier:
    """Page-granular row storage under ``root``: a local directory, or an
    object-store prefix whose requests ``retry`` (a ``utils/retry.py``
    policy; default the store's own) governs."""

    def __init__(self, root: str, *, rows: int, layout: RecordLayout,
                 page_rows: int = 1024, pages_per_segment: int = 64, init_fn=None,
                 retry=None, page_versions: dict[int, int] | None = None):
        if page_rows < 1 or pages_per_segment < 1:
            raise ValueError("page_rows and pages_per_segment must be >= 1")
        self.root = os.fspath(root).rstrip("/")
        self._remote = is_url(self.root)
        self._store = HttpObjectStore(retry=retry) if self._remote else None
        self.rows = int(rows)
        self.layout = layout
        self.page_rows = int(page_rows)
        self.pages_per_segment = int(pages_per_segment)
        self.num_pages = -(-self.rows // self.page_rows)
        self._init_fn = init_fn
        self._lock = threading.Lock()
        self._page_versions: dict[int, int] = dict(page_versions or {})
        self._superseded: dict[int, list[int]] = {}
        self._next_version = 1 + max(self._page_versions.values(), default=0)
        self._seg_exists: dict[int, bool] = {}
        self._stats = {
            "cold_reads": 0, "cold_read_bytes": 0, "cold_read_secs": 0.0,
            "cold_writes": 0, "cold_write_bytes": 0, "init_pages": 0,
            "stall_secs": 0.0,
        }

    # -- keys ----------------------------------------------------------------
    def _key(self, name: str) -> str:
        return (join_url(self.root, name) if self._remote
                else os.path.join(self.root, *name.split("/")))

    def _seg_key(self, seg: int) -> str:
        return self._key(f"segments/{seg:06d}.bin")

    def _page_key(self, page: int, version: int) -> str:
        return self._key(f"pages/{page:08d}.v{version:06d}.bin")

    def page_len(self, page: int) -> int:
        return min(self.page_rows, self.rows - page * self.page_rows)

    # -- read ----------------------------------------------------------------
    def read_page(self, page: int) -> np.ndarray:
        """One page's records ``[page_len, width]``: its committed overlay
        if any, else its span of the base segment, else ``init_fn``."""
        if not 0 <= page < self.num_pages:
            raise IndexError(f"page {page} out of range [0, {self.num_pages})")
        eff = self.page_len(page)
        nbytes = eff * self.layout.width * _ITEM
        with self._lock:
            version = self._page_versions.get(page)
        t0 = time.monotonic()
        data = None
        if version is not None:
            data = self._read_object(self._page_key(page, version))
        else:
            seg = page // self.pages_per_segment
            if self._segment_exists(seg):
                off = (page % self.pages_per_segment) * self.page_rows \
                    * self.layout.width * _ITEM
                data = self._read_range(self._seg_key(seg), off, nbytes)
        elapsed = time.monotonic() - t0
        if data is None:
            if self._init_fn is None:
                raise KeyError(f"page {page} has no overlay, no base segment, and no "
                               f"init_fn under {self.root}")
            arr = np.asarray(self._init_fn(page), np.float32)
            if arr.shape != (eff, self.layout.width):
                raise ValueError(f"init_fn(page={page}) returned {arr.shape}, expected "
                                 f"{(eff, self.layout.width)}")
            with self._lock:
                self._stats["init_pages"] += 1
            return arr
        with self._lock:
            self._stats["cold_reads"] += 1
            self._stats["cold_read_bytes"] += len(data)
            self._stats["cold_read_secs"] += elapsed
            if elapsed > _STALL_BUDGET_SECS:
                self._stats["stall_secs"] += elapsed - _STALL_BUDGET_SECS
        return np.frombuffer(data, np.float32).reshape(eff, self.layout.width).copy()

    def _segment_exists(self, seg: int) -> bool:
        with self._lock:
            if self._seg_exists.get(seg):
                return True
        key = self._seg_key(seg)
        found = self._store.exists(key) if self._remote else os.path.isfile(key)
        with self._lock:
            # only a positive probe is cached: a segment written later must
            # stay discoverable
            if found:
                self._seg_exists[seg] = True
        return found

    def _read_object(self, key: str) -> bytes:
        if self._remote:
            return self._store.get(key)
        with open(key, "rb") as f:
            return f.read()

    def _read_range(self, key: str, offset: int, length: int) -> bytes:
        if self._remote:
            return self._store.get_range(key, offset, length)
        with open(key, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def _write_object(self, key: str, data: bytes) -> None:
        """One object (a PUT) or file (written aside, then renamed)."""
        if self._remote:
            self._store.put(key, data)
            return
        os.makedirs(os.path.dirname(key), exist_ok=True)
        tmp = key + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, key)

    def _delete_object(self, key: str) -> None:
        if self._remote:
            self._store.delete(key)
        else:
            os.remove(key)

    # -- write ---------------------------------------------------------------
    def write_page(self, page: int, recs: np.ndarray) -> int:
        """Commit a dirty page as a new overlay version (copy-on-write:
        readers pinned to an older ``page_versions`` snapshot keep reading
        their version).  Returns the committed version."""
        eff = self.page_len(page)
        recs = np.ascontiguousarray(recs, np.float32)
        if recs.shape != (eff, self.layout.width):
            raise ValueError(f"page {page} write has shape {recs.shape}, expected "
                             f"{(eff, self.layout.width)}")
        with self._lock:
            version = self._next_version
            self._next_version += 1
            if page in self._page_versions:
                self._superseded.setdefault(page, []).append(self._page_versions[page])
        data = recs.tobytes()
        self._write_object(self._page_key(page, version), data)
        with self._lock:
            self._page_versions[page] = version
            self._stats["cold_writes"] += 1
            self._stats["cold_write_bytes"] += len(data)
        # the superseded overlay stays: a manifest or checkpoint pinning the
        # old page_versions keeps reading it (gc_overlays reclaims it)
        return version

    def gc_overlays(self, pinned: list[dict] | None = None) -> int:
        """Delete superseded overlays that neither the live map nor any
        ``pinned`` snapshot (``snapshot()`` dicts) references.  Returns how
        many were deleted; a failure is skipped (an orphan costs space,
        never correctness)."""
        keep: set[tuple[int, int]] = set()
        for snap in pinned or []:
            for p, ver in snap.get("page_versions", {}).items():
                keep.add((int(p), int(ver)))
        with self._lock:
            keep.update(self._page_versions.items())
            doomed = [(p, ver) for p, vers in self._superseded.items()
                      for ver in vers if (p, ver) not in keep]
            self._superseded = {}
        deleted = 0
        for p, ver in doomed:
            try:
                self._delete_object(self._page_key(p, ver))
                deleted += 1
            except OSError:
                logging.getLogger(__name__).warning(
                    "cold tier: could not gc overlay page=%d v=%d", p, ver)
        return deleted

    # -- bulk import / export --------------------------------------------------
    def import_dense(self, rows: dict, m: dict, v: dict) -> int:
        """Write a whole table and its moments as base segments; returns
        the segments written."""
        seg_rows = self.page_rows * self.pages_per_segment
        n_segs = -(-self.rows // seg_rows)
        for seg in range(n_segs):
            lo, hi = seg * seg_rows, min(self.rows, (seg + 1) * seg_rows)
            recs = self.layout.pack(
                {k: np.asarray(rows[k])[lo:hi] for k in self.layout.keys},
                {k: np.asarray(m[k])[lo:hi] for k in self.layout.keys},
                {k: np.asarray(v[k])[lo:hi] for k in self.layout.keys})
            self._write_object(self._seg_key(seg), np.ascontiguousarray(recs).tobytes())
            with self._lock:
                self._seg_exists[seg] = True
        return n_segs

    def export_dense(self) -> tuple[dict, dict, dict]:
        """The whole table and its moments (small vocabularies only)."""
        rows = {k: np.empty((self.rows,) if w == 1 else (self.rows, w), np.float32)
                for k, w in self.layout.widths.items()}
        m = {k: np.empty_like(a) for k, a in rows.items()}
        v = {k: np.empty_like(a) for k, a in rows.items()}
        for page in range(self.num_pages):
            lo = page * self.page_rows
            hi = lo + self.page_len(page)
            pr, pm, pv = self.layout.unpack(self.read_page(page))
            for k in self.layout.keys:
                rows[k][lo:hi], m[k][lo:hi], v[k][lo:hi] = pr[k], pm[k], pv[k]
        return rows, m, v

    # -- snapshot / stats ------------------------------------------------------
    def snapshot(self) -> dict:
        """Everything a reader needs to see exactly the rows committed so
        far (the publisher's manifest and the paged checkpoint keep it)."""
        with self._lock:
            return {
                "root": self.root,
                "rows": self.rows,
                "page_rows": self.page_rows,
                "pages_per_segment": self.pages_per_segment,
                "widths": dict(self.layout.widths),
                "page_versions": {str(p): int(ver)
                                  for p, ver in self._page_versions.items()},
            }

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)
