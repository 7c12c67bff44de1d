"""Read-only tiered serving: scores against a published tiered snapshot;
the port's counterpart of ``deepfm_tpu/tiered/serving.py``
(``TieredScorer``).

``TieredScorer`` is the serving side's pager: a small row cache on the
card (values only: moments never leave the training tiers), its own host
tier, and a cold tier pinned to the ``page_versions`` snapshot that the
publisher's manifest recorded after the trainer's flush barrier, so a
live trainer writing new overlays never changes the rows it reads.

A request's misses fault in through host and cold tier outside the
scorer's lock; the slot map's bookkeeping and the device work (the cache
refill by ``index_copy_`` and the forward, kernel B1 on the cache with
slot ids) run under it, so a refill never rewrites a slot that a forward
in flight reads (JAX rebinds immutable arrays for the same end).  A cold
tier that fails fails only the request that faults on it
(``cold_errors``).

It is an engine of ``serve/server.py``'s ``make_handler``
(``score`` / ``score_instances`` / ``metrics_snapshot``); ``/v1/metrics``
carries its ``paging_snapshot`` and ``GET /metrics`` its gauges
(``registry``).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..core.config import Config
from ..core.platform import resolve_device
from ..obs.metrics import MetricsRegistry
from .host import HostTier
from .pager import SlotMap
from .step import make_paged_predict
from .store import ColdTier, RecordLayout

REST_FILE = "rest.pt"


class TieredScorer:
    """Scores through a paged row cache of ``capacity`` slots on ``device``
    (default: the card) over ``cold``, with the model's non-table part
    ``model`` (a DeepFM whose own tables are never read)."""

    _FAULT_ROUNDS = 4

    def __init__(self, cfg: Config, cold: ColdTier, *, model, capacity: int = 0,
                 host_rows: int = 0, registry: MetricsRegistry | None = None):
        from .trainer import resolve_tiered

        sizes = resolve_tiered(cfg)
        self.cfg = cfg
        self.cold = cold
        self.capacity = int(capacity or sizes["capacity"])
        self.host = HostTier(cold, int(host_rows or sizes["host_rows"]))
        self.model = model.eval()
        self.device = model.fm_b.device
        self._predict = make_paged_predict()
        self._lock = threading.Lock()
        self._map = SlotMap(self.capacity)
        # one more row than slots, as the training cache (never read here)
        self._hot = {k: torch.zeros((self.capacity + 1,) if w == 1 else (self.capacity + 1, w),
                                    dtype=torch.float32, device=self.device)
                     for k, w in cold.layout.widths.items()}
        self._stats = {"requests": 0, "scored_rows": 0, "hits": 0, "misses": 0,
                       "evictions": 0, "cold_errors": 0, "refill_bytes": 0}
        self.registry = registry if registry is not None else MetricsRegistry()
        paging = self.registry.gauge("deepfm_serving_paging", "the tiered scorer's "
                                     "paging counters and hit rate", labels=("kind",))
        self.registry.on_collect(lambda: [paging.labels(k).set(v)
                                          for k, v in self._flat_paging().items()])

    @classmethod
    def from_publish(cls, root: str, staging_dir: str, *, version: int | None = None,
                     cold_root: str | None = None, init_fn=None, capacity: int = 0,
                     host_rows: int = 0, device=None,
                     registry: MetricsRegistry | None = None) -> "TieredScorer":
        """A scorer of a ``ModelPublisher.publish_tiered`` version (default:
        the latest): the manifest's ``extra["tiered"]`` snapshot pins the
        cold tier's ``page_versions``, the version's tree gives the config
        and the non-table weights."""
        from ..online import publisher as pub
        from .trainer import _template

        manifest = (pub.read_manifest(root, version) if version is not None
                    else pub.latest_manifest(root))
        if manifest is None:
            raise FileNotFoundError(f"no committed versions under {root}")
        snap = manifest.extra.get("tiered")
        if not snap:
            raise ValueError(f"version {manifest.version} under {root} is not a tiered "
                             f"publish (no extra['tiered'] snapshot)")
        art = pub.fetch_version(root, manifest.version, staging_dir)
        cfg = Config.from_json(os.path.join(art, "config.json"))
        template = _template(cfg, resolve_device(device))
        template.model.load_state_dict(
            torch.load(os.path.join(art, REST_FILE), weights_only=True), strict=False)
        layout = RecordLayout({k: int(w) for k, w in snap["widths"].items()})
        cold = ColdTier(cold_root or snap["root"], rows=int(snap["rows"]), layout=layout,
                        page_rows=int(snap["page_rows"]),
                        pages_per_segment=int(snap["pages_per_segment"]), init_fn=init_fn,
                        page_versions={int(p): int(v)
                                       for p, v in snap["page_versions"].items()})
        return cls(cfg, cold, model=template.model, capacity=capacity,
                   host_rows=host_rows, registry=registry)

    # -- the engine protocol -----------------------------------------------------
    def score(self, ids: np.ndarray, vals: np.ndarray, **_slo) -> np.ndarray:
        """Probabilities [B] of ids and vals [B, F].  Misses fault in
        through host and cold tier; a failing cold tier fails only a
        request that faults on it."""
        ids = np.asarray(ids)
        vals = torch.as_tensor(np.asarray(vals, np.float32).reshape(ids.shape))
        uniq, inv = self._unique(ids)
        for round_ in range(self._FAULT_ROUNDS):
            with self._lock:
                slots, miss_ix = self._probe(uniq, count=round_ == 0)
                if not miss_ix:
                    self._stats["requests"] += 1
                    self._stats["scored_rows"] += int(ids.shape[0])
                    slot_ids = torch.from_numpy(slots[inv].astype(np.int32).reshape(ids.shape))
                    return self._predict(self.model, self._hot, slot_ids.to(self.device),
                                         vals.to(self.device)).cpu().numpy()
            self._fault_in(uniq, miss_ix)
        raise RuntimeError(
            f"slot translation did not converge in {self._FAULT_ROUNDS} rounds: the "
            f"serving cache of {self.capacity} slots thrashes under concurrent "
            f"requests; raise its capacity")

    def score_instances(self, instances: list[dict], **slo) -> np.ndarray:
        from ..serve.batcher import instances_to_arrays

        return self.score(*instances_to_arrays(instances), **slo)

    # -- paging --------------------------------------------------------------------
    def _unique(self, ids: np.ndarray):
        flat = np.asarray(ids).reshape(-1).astype(np.int64)
        np.clip(flat, 0, self.cold.rows - 1, out=flat)
        return np.unique(flat, return_inverse=True)

    def _probe(self, uniq: np.ndarray, count: bool):
        """Under the lock: each unique row's slot and the misses'
        positions, in a new translation epoch that pins the hits."""
        self._map.begin()
        slots, miss_ix = self._map.probe(uniq)
        if count:
            self._stats["hits"] += uniq.size - len(miss_ix)
            self._stats["misses"] += len(miss_ix)
        return slots, miss_ix

    def _fault_in(self, uniq: np.ndarray, miss_ix: list[int]) -> None:
        """The misses' values read outside the lock (host and cold I/O),
        then, under it, those still missing put into free or evicted slots
        (a refill by ``index_copy_``; this request's resident rows stay
        pinned)."""
        try:
            recs = self.host.get_records(uniq[miss_ix])
        except Exception:
            with self._lock:
                self._stats["cold_errors"] += 1
            raise
        values, _, _ = self.cold.layout.unpack(recs)
        pos = {j: i for i, j in enumerate(miss_ix)}
        with self._lock:
            _, still = self._map.probe(uniq)
            gap = [j for j in still if j in pos]
            take = self._map.select(len(gap), "serving slots")
            self._stats["evictions"] += int((self._map.slot_row[take] >= 0).sum())
            self._map.release(take)
            sel = np.asarray([pos[j] for j in gap], np.int64)
            idx = torch.from_numpy(take).to(self.device)
            for k, hot in self._hot.items():
                src = np.ascontiguousarray(np.asarray(values[k])[sel])
                hot.index_copy_(0, idx, torch.from_numpy(src).to(self.device))
            self._map.assign(take, uniq[gap])
            self._stats["refill_bytes"] += int(len(gap) * self.cold.layout.width * 4)

    # -- metrics ---------------------------------------------------------------------
    def paging_snapshot(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["hit_rate"] = round(out["hits"] / max(1, out["hits"] + out["misses"]), 6)
            out["resident_slots"] = len(self._map)
        out["host"] = self.host.stats()
        out["cold"] = self.cold.stats()
        return out

    def _flat_paging(self) -> dict:
        snap = self.paging_snapshot()
        flat = {k: v for k, v in snap.items() if not isinstance(v, dict)}
        for tier in ("host", "cold"):
            flat.update({f"{tier}.{k}": v for k, v in snap[tier].items()})
        return flat

    def metrics_snapshot(self) -> dict:
        snap = self.paging_snapshot()
        return {"requests": snap["requests"], "paging": snap}
