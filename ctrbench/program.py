"""The system under test: the port's single-card train state, built and
stepped through its normal entry points (``parallel/spmd.py``
``create_dp_train_state`` and ``train_step``, ``data/pipeline.py``
``Prefetcher``), and read through the checkpoint layout
(``local_state``/``load_local_state``).  Nothing else of the program is
touched."""

from __future__ import annotations

import torch

from deepfm_tpu_torch.core.config import Config, MeshConfig
from deepfm_tpu_torch.data.pipeline import Prefetcher
from deepfm_tpu_torch.parallel import spmd
from deepfm_tpu_torch.parallel.mesh import initialize_distributed, shutdown

__all__ = ["Program", "Prefetcher"]


class Program:
    """The port's train state for ``model``/``optimizer`` (the
    configuration file's sections) at ``batch_size``, on ``device``."""

    def __init__(self, model: dict, optimizer: dict, batch_size: int, device: str):
        self.cfg = Config().with_overrides(model=model, optimizer=optimizer,
                                           data={"batch_size": batch_size})
        self.ctx = initialize_distributed(MeshConfig(), device=device)
        self.state = spmd.create_dp_train_state(self.cfg, self.ctx)
        self.device = self.state.model.fm_v.device

    def load(self, weights: dict, dropout_seed: int) -> None:
        """Start again from ``weights`` (by leaf name; a table with pad
        rows takes zeros there) with fresh optimizer state, step 0 and the
        dropout generator seeded ``dropout_seed``."""
        local = spmd.local_state(self.state)
        model = {}
        for name, t in local["model"].items():
            w = weights[name].to(t.device)
            if w.shape != t.shape:
                w = torch.cat([w, w.new_zeros((t.shape[0] - w.shape[0],) + tuple(w.shape[1:]))])
            model[name] = w
        slots = {n: {s: torch.zeros_like(v) for s, v in d.items()}
                 for n, d in local["optimizer"]["slots"].items()}
        spmd.load_local_state(self.state, {"model": model, "lazy": None,
                                           "optimizer": {"count": 0, "slots": slots}})
        self.state.step = 0
        self.state.generator.manual_seed(dropout_seed)

    def step(self, batch: dict) -> dict:
        """One train step on a pinned host batch, as the train task takes
        it (the single-card step copies it into its graph itself)."""
        return spmd.train_step(self.state, batch, self.ctx)

    def leaves(self) -> dict:
        return {k: v for k, v in spmd.local_state(self.state)["model"].items()}

    def grad_norms(self) -> dict:
        """Each leaf's first gradient as Adam holds it after one step
        (``mu / (1 - b1)``): its norm."""
        b1 = self.cfg.optimizer.adam_b1
        slots = spmd.local_state(self.state)["optimizer"]["slots"]
        return {k: float(d["mu"].double().norm()) / (1.0 - b1) for k, d in slots.items()}

    def table_shapes(self) -> tuple[int, int, int]:
        """(fm_w rows, fm_v rows, K) of the state's tables."""
        fm_v = self.state.model.fm_v
        return self.state.model.fm_w.shape[0], fm_v.shape[0], fm_v.shape[1]

    def close(self) -> None:
        shutdown(self.ctx)
        self.state = None
