"""The tiered trainer: batches through the pager into the paged step, with
the streaming checkpoint and the publisher's flush barrier; the port's
counterpart of ``deepfm_tpu/tiered/trainer.py`` (``resolve_tiered``,
``_check_cfg``, ``TieredTrainer``, ``default_init_fn``).

:class:`TieredTrainer` owns the cold tier, the host tier, the pager and
the paged step, with the resident loop's rhythm: ``train_batch`` a host
batch, ``save``/``restore`` for a stop and a resume, and ``flush``, the
barrier the publisher runs before it writes a manifest.

A checkpoint streams the tiers instead of gathering the table: dirty hot
records go back to the host tier, dirty host rows to cold-tier page
overlays, and a small record (the cold tier's snapshot, the model's
non-table part, its optimizer, the dropout generator and the step)
commits last.  What it moves scales with the dirty rows, not with the
table.  A restore starts with the cache cold; the tiers refill on demand,
and training goes on bit for bit (tests/test_torch_tiered.py).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading

import numpy as np
import torch

from ..core.config import Config
from ..core.platform import resolve_device
from ..train.step import LAZY_TABLE_KEYS, TrainState, create_train_state
from .host import HostTier
from .pager import DevicePager
from .step import PagedState, init_hot, make_readback, paged_train_step
from .store import ColdTier, RecordLayout

_META = "tiered_meta.json"
_LEAVES = "tiered_leaves.pt"


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def resolve_tiered(cfg: Config) -> dict:
    """The tier sizes of ``cfg`` (0 = auto in the config): the hot cache
    holds at least one batch's B·F ids (auto: the next power of two >=
    2·B·F), the staging pack one batch's worst-case misses (auto: B·F),
    the host tier 8 hot caches (at least a page)."""
    bf = cfg.data.batch_size * cfg.model.field_size
    capacity = cfg.model.tiered_hot_slots or _next_pow2(2 * bf)
    return {
        "capacity": int(capacity),
        "stage_rows": int(cfg.model.tiered_stage_rows or bf),
        "host_rows": int(cfg.model.tiered_host_rows
                         or max(8 * capacity, cfg.model.tiered_page_rows)),
        "page_rows": int(cfg.model.tiered_page_rows),
    }


def _check_cfg(cfg: Config) -> None:
    """JAX's refusals (``tiered/trainer.py:71-81``)."""
    if cfg.model.fused_kernel != "off":
        raise ValueError(f"tiered embeddings with fused_kernel={cfg.model.fused_kernel!r}:"
                         " the JAX package refuses this pair, so the port does too (its "
                         "paged step runs the fused CUDA kernels on the hot cache either "
                         "way); use fused_kernel='off'")
    if cfg.optimizer.name.lower() != "adam":
        raise ValueError("tiered embeddings co-evict lazy-Adam moments; optimizer "
                         f"must be Adam, got {cfg.optimizer.name!r}")


def _template(cfg: Config, device) -> TrainState:
    """A resident lazy train state at a vocabulary of 2: every non-table
    part (MLP, fm_b, batch norm, their optimizer, the dropout generator)
    at its real shape, and tables too small to matter."""
    small = cfg.with_overrides(model={"feature_size": 2},
                               optimizer={"lazy_embedding_updates": True})
    return create_train_state(small, device)


def _widths(cfg: Config) -> dict[str, int]:
    return {k: (1 if k == "fm_w" else cfg.model.embedding_size) for k in LAZY_TABLE_KEYS}


def rest_state_dict(model) -> dict:
    """The model's state_dict without the tables: what a paged state
    keeps and publishes."""
    return {k: v for k, v in model.state_dict().items() if k not in LAZY_TABLE_KEYS}


class TieredTrainer:
    """The tiered trainer (module docstring) on ``device`` (default: the
    card).  ``state`` is a template train state (:func:`_template`) whose
    non-table part the paged state takes over."""

    def __init__(self, cfg: Config, cold: ColdTier, *, state: TrainState, step0: int = 0,
                 capacity: int = 0, stage_rows: int = 0, host_rows: int = 0):
        _check_cfg(cfg)
        self.cfg = cfg
        self.cold = cold
        sizes = resolve_tiered(cfg)
        self.capacity = capacity or sizes["capacity"]
        bf = cfg.data.batch_size * cfg.model.field_size
        if self.capacity < bf:
            raise ValueError(f"tiered_hot_slots={self.capacity} cannot hold one batch's "
                             f"id stream (batch_size*field_size={bf})")
        self.device = state.model.fm_b.device
        self.host = HostTier(cold, host_rows or sizes["host_rows"])
        self.pager = DevicePager(
            capacity=self.capacity, layout=cold.layout, host=self.host,
            stage_rows=stage_rows or sizes["stage_rows"],
            readback_fn=make_readback(cold.layout), vocab=cfg.model.feature_size,
            pin=self.device.type == "cuda")
        if self.host.max_request_rows() < self.pager.stage_rows:
            raise ValueError(
                f"host tier of {self.host.capacity} rows (serviceable window "
                f"{self.host.max_request_rows()}) cannot satisfy a full "
                f"{self.pager.stage_rows}-row miss pack; raise tiered_host_rows")
        self.state = PagedState(step=int(step0), model=state.model,
                                optimizer=state.optimizer, generator=state.generator,
                                hot=init_hot(cold.layout.widths, self.capacity, self.device),
                                layout=cold.layout)
        # cold-to-host prefetch ahead of the step, fed by the input
        # pipeline's id stream (:meth:`observer`)
        self._prefetch_q: queue.Queue = queue.Queue(maxsize=64)
        self._prefetch_dropped = 0
        self._prefetch_stop = threading.Event()
        self._prefetch_thread = threading.Thread(target=self._prefetch_worker,
                                                 daemon=True)
        self._prefetch_thread.start()

    # -- constructors ----------------------------------------------------------
    @classmethod
    def from_resident_state(cls, cfg: Config, state: TrainState, cold_root: str,
                            **sizes) -> "TieredTrainer":
        """Seed the cold tier from a resident lazy train state (its tables
        and moments as base segments) and go on paged from its step,
        weights, optimizer and dropout generator."""
        if state.lazy is None:
            raise ValueError("tiered embeddings continue the LAZY optimizer layout; "
                             "build the source state with lazy_embedding_updates=True")
        model = state.model
        layout = RecordLayout(_widths(cfg))
        cold = ColdTier(cold_root, rows=cfg.model.feature_size, layout=layout,
                        page_rows=resolve_tiered(cfg)["page_rows"])
        n = cfg.model.feature_size
        cold.import_dense(
            {k: getattr(model, k).detach()[:n].cpu().numpy() for k in layout.keys},
            {k: state.lazy.m[k][:n].cpu().numpy() for k in layout.keys},
            {k: state.lazy.v[k][:n].cpu().numpy() for k in layout.keys})
        template = _template(cfg, model.fm_b.device)
        template.model.load_state_dict(rest_state_dict(model), strict=False)
        template.optimizer.load_state_dict(state.optimizer.state_dict())
        template.generator.set_state(state.generator.get_state())
        return cls(cfg, cold, state=template, step0=state.step, **sizes)

    @classmethod
    def create_virtual(cls, cfg: Config, cold_root: str, *, init_fn=None, device=None,
                       **sizes) -> "TieredTrainer":
        """A fresh trainer whose table never exists whole: a cold page comes
        from ``init_fn(page) -> [rows, width]`` (default
        :func:`default_init_fn`) until it is first written back."""
        _check_cfg(cfg)
        layout = RecordLayout(_widths(cfg))
        page_rows = resolve_tiered(cfg)["page_rows"]
        cold = ColdTier(cold_root, rows=cfg.model.feature_size, layout=layout,
                        page_rows=page_rows,
                        init_fn=init_fn or default_init_fn(cfg, layout, page_rows))
        return cls(cfg, cold, state=_template(cfg, resolve_device(device)), **sizes)

    # -- training --------------------------------------------------------------
    def _tensor(self, x, dtype) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x), dtype=dtype)
        return t.pin_memory() if self.device.type == "cuda" else t

    def train_batch(self, batch: dict) -> dict:
        """One optimizer step on a host batch (``feat_ids``, ``feat_vals``,
        ``label``; numpy or CPU tensors): translation and miss paging here,
        between steps, then the paged step.  Returns its metrics as device
        scalars."""
        ids = batch["feat_ids"]
        ids = ids.numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
        slot_ids, pack = self.pager.translate(ids, self.state.hot)
        inputs = {"slot_ids": self._tensor(slot_ids, torch.int32),
                  "feat_vals": self._tensor(batch["feat_vals"], torch.float32),
                  "label": self._tensor(batch["label"], torch.float32),
                  **pack.tensors()}
        return paged_train_step(self.state, inputs, pack)

    # -- the id-stream prefetch --------------------------------------------------
    def observer(self):
        """A callable for the input feed: it sees each host batch before
        the step takes it and queues its ids for the cold-to-host
        prefetcher."""
        return lambda batch: self.prefetch_ids(batch.get("feat_ids"))

    def prefetch_ids(self, ids) -> None:
        if ids is None:
            return
        try:
            self._prefetch_q.put_nowait(np.asarray(ids).reshape(-1))
        except queue.Full:
            # advisory: the miss path still faults the rows in
            self._prefetch_dropped += 1

    def _prefetch_worker(self) -> None:
        while not self._prefetch_stop.is_set():
            try:
                ids = self._prefetch_q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self.host.prefetch(np.clip(ids, 0, self.cfg.model.feature_size - 1))
            except Exception:
                logging.getLogger(__name__).warning(
                    "tiered prefetch failed; misses fault in on the step's path",
                    exc_info=True)

    # -- the flush barrier and the checkpoint ---------------------------------------
    def flush(self) -> dict:
        """Every dirty row and moment hot to host to cold; returns the cold
        tier's snapshot with the step: the barrier before a manifest, so a
        reader pinned to its page_versions sees exactly this step's rows."""
        self.pager.writeback_all(self.state.hot)
        self.host.flush()
        snap = self.cold.snapshot()
        snap["step"] = int(self.state.step)
        return snap

    def save(self, directory: str) -> dict:
        """The streaming paged checkpoint: flush the tiers, then commit the
        non-table state and the metadata (the metadata file last).  No
        table is gathered."""
        os.makedirs(directory, exist_ok=True)
        snap = self.flush()
        st = self.state
        leaves = {"model": {k: v.detach().cpu() for k, v in rest_state_dict(st.model).items()},
                  "optimizer": {"count": st.optimizer.count,
                                "slots": {n: {s: t.detach().cpu() for s, t in sl.items()}
                                          for n, sl in st.optimizer.slots.items()}},
                  "generator": st.generator.get_state()}
        tmp = os.path.join(directory, _LEAVES + ".tmp")
        torch.save(leaves, tmp)
        os.replace(tmp, os.path.join(directory, _LEAVES))
        meta = {"step": int(st.step), "cold": snap}
        tmp = os.path.join(directory, _META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(directory, _META))  # the commit point
        return meta

    @classmethod
    def restore(cls, cfg: Config, directory: str, *, cold_root: str | None = None,
                init_fn=None, virtual: bool = False, device=None,
                **sizes) -> "TieredTrainer":
        """Resume from a paged checkpoint with the cache cold.  ``cold_root``
        overrides the recorded root; ``virtual=True`` reinstates the
        default page initializer of a trainer made by
        :meth:`create_virtual` (pages never written come from it)."""
        with open(os.path.join(directory, _META)) as f:
            meta = json.load(f)
        snap = meta["cold"]
        layout = RecordLayout({k: int(w) for k, w in snap["widths"].items()})
        if init_fn is None and virtual:
            init_fn = default_init_fn(cfg, layout, int(snap["page_rows"]))
        cold = ColdTier(cold_root or snap["root"], rows=int(snap["rows"]), layout=layout,
                        page_rows=int(snap["page_rows"]),
                        pages_per_segment=int(snap["pages_per_segment"]),
                        init_fn=init_fn,
                        page_versions={int(p): int(v)
                                       for p, v in snap["page_versions"].items()})
        template = _template(cfg, resolve_device(device))
        leaves = torch.load(os.path.join(directory, _LEAVES), weights_only=True)
        template.model.load_state_dict(leaves["model"], strict=False)
        template.optimizer.load_state_dict(leaves["optimizer"])
        template.generator.set_state(leaves["generator"])
        return cls(cfg, cold, state=template, step0=int(meta["step"]), **sizes)

    # -- introspection ---------------------------------------------------------
    def export_tables(self) -> tuple[dict, dict, dict]:
        """Flush, then the whole (rows, m, v) (small vocabularies only)."""
        self.flush()
        return self.cold.export_dense()

    def paging_snapshot(self) -> dict:
        return {"pager": self.pager.stats(), "host": self.host.stats(),
                "cold": self.cold.stats(), "prefetch_dropped": self._prefetch_dropped}

    def close(self) -> None:
        self._prefetch_stop.set()
        self._prefetch_thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def default_init_fn(cfg: Config, layout: RecordLayout, page_rows: int):
    """The page-seeded initializer of a virtual table: normal rows
    (glorot-like scale), zero moments, the same for a page every time
    (so a resume reads what the first run read) without the table ever
    existing; not the resident glorot init."""
    k = cfg.model.embedding_size
    rows = cfg.model.feature_size
    std_v = float(np.sqrt(2.0 / (rows + k)))
    std_w = float(np.sqrt(2.0 / (rows + 1)))
    seed = cfg.run.seed

    def init_fn(page: int) -> np.ndarray:
        eff = min(page_rows, rows - page * page_rows)
        rng = np.random.default_rng((seed, page))
        out = np.zeros((eff, layout.width), np.float32)
        for key in layout.keys:
            w = layout.widths[key]
            std = std_w if w == 1 else std_v
            out[:, layout.value_slice(key)] = rng.normal(0.0, std, (eff, w)).astype(np.float32)
        return out

    return init_fn
