"""DeepFM: counterpart of ``apply_deepfm``, ``apply_mlp`` and
``deepfm_l2_penalty`` in ``deepfm_tpu/models/deepfm.py``, in train and
eval mode (``module.train()`` / ``module.eval()``).

    logits = fm_b + Σ_f w_f·x_f + 0.5Σ_k((Σ_f e)²−Σ_f e²) + MLP(flatten(e))
    e_fk   = V[id_f]_k · x_f

The gathers and both FM terms always go through
``ops.fused_ctr.fused_ctr_interaction``, forward and backward (the Hopper
kernels on the card).  A model whose fm_w and fm_v are row shards
(``sharded``, a ``parallel/embedding.py ShardedTables``) first assembles
the batch's rows over its model group and runs the kernels on that
compact table, with each lookup's slot as its id; its L2 penalty sums the
shards over the group.  The MLP follows the JAX dtype flow: input, kernels
and biases cast to ``compute_dtype``, the bias added in that dtype after
the product, relu there too, batch norm (when on) in float32, dropout (train
mode, keep probability < 1) in ``compute_dtype``, and the head cast back to
float32.  Parameters stay float32.

Dropout draws its masks from the module's own ``dropout_generator`` (on the
module's device, seeded from the init generator), keeps each unit with
probability ``keep`` and divides the kept values by ``keep``.  The JAX
package folds its PRNG key per step instead; the two give different bits.

Parameter names follow the JAX pytree, so ``convert.params_from_jax`` maps
one onto the other: ``fm_b``, ``fm_w``, ``fm_v``,
``mlp.layer_<i>.{kernel,bias}``, ``mlp.out.{kernel,bias}``,
``bn.layer_<i>.{scale,bias,moving_mean,moving_var}``.  Kernels are
``[in, out]``, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.platform import resolve_device
from ..ops.batch_norm import BNParams, BNState, batch_norm
from ..ops.embedding import narrow_ids
from ..ops.fused_ctr import fused_ctr_interaction
from ..ops.initializers import glorot_normal, glorot_uniform
from .base import register_model


def window_multiple(cfg: ModelConfig) -> int:
    """The row multiple of a window-padded fm_v: 128/K when ``fused_kernel
    != "off"`` and K divides 128, else 1.  A grid pads every family's
    tables to it (JAX ``_window_multiple``, parallel/spmd.py
    ``padded_vocab``)."""
    k = cfg.embedding_size
    return 128 // k if cfg.fused_kernel != "off" and 128 % k == 0 else 1


def fm_v_rows(cfg: ModelConfig) -> int:
    """Rows of the fm_v table: ``feature_size``, plus, for DeepFM, zero pad
    rows up to a multiple of :func:`window_multiple` (the JAX init pads on
    the config value, so a checkpoint's shape follows its config; JAX's
    xDeepFM and DCN-v2 draw ``[feature_size, K]``)."""
    if cfg.model_name != "deepfm":
        return cfg.feature_size
    return cfg.feature_size + (-cfg.feature_size) % window_multiple(cfg)


def dropout(h: torch.Tensor, keep: float, generator: torch.Generator) -> torch.Tensor:
    """TF1 dropout with keep probability ``keep``: each unit is kept with
    probability ``keep`` (mask drawn from ``generator``) and divided by
    ``keep``; the rest are 0.  ``h``'s dtype is kept."""
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


class Dense(nn.Module):
    """``h @ kernel + bias`` with both cast to ``h``'s dtype first."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(glorot_uniform((d_in, d_out), generator))
        self.bias = nn.Parameter(torch.zeros(d_out, device=generator.device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.kernel.to(h.dtype) + self.bias.to(h.dtype)


class BatchNorm(nn.Module):
    """Batch norm with moving statistics (ops/batch_norm.py).  In train
    mode it normalizes by the batch statistics and updates its
    ``moving_mean``/``moving_var`` buffers IN PLACE with the TF1 decay (the
    JAX function returns the new state instead); in eval mode it reads
    them."""

    def __init__(self, width: int, device: torch.device, decay: float = 0.9):
        super().__init__()
        self.decay = decay
        self.scale = nn.Parameter(torch.ones(width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))
        self.register_buffer("moving_mean", torch.zeros(width, device=device))
        self.register_buffer("moving_var", torch.ones(width, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, new = batch_norm(x, BNParams(self.scale, self.bias),
                            BNState(self.moving_mean, self.moving_var),
                            train=self.training, decay=self.decay)
        if self.training:
            self.moving_mean.copy_(new.moving_mean)
            self.moving_var.copy_(new.moving_var)
        return y


class CTRModel(nn.Module):
    """What the CTR families share: ``fm_b``, the deep tower (``mlp``,
    ``bn``, dropout from ``dropout_generator``), :meth:`prepare`, the row
    shards of a grid (``sharded``) and the family hook
    :meth:`table_logits`, which maps the tables the family declares in
    ``TABLES`` (a subset of ``("fm_w", "fm_v")``), ``[B, F]`` ids that are
    rows of them and ``[B, F]`` float32 vals to ``[B]`` float32 logits.
    The forward, the lazy step (train/step.py) and the grid's lazy step
    (parallel/spmd.py) all call the hook: on the model's own tables, on
    the lazy step's compact rows, or on the rows a grid assembled."""

    TABLES: tuple[str, ...] = ()

    def _init_deep(self, cfg: ModelConfig, in_dim: int, g: torch.Generator) -> None:
        dims = [in_dim, *cfg.deep_layers]
        self.mlp = nn.ModuleDict({
            f"layer_{i}": Dense(d_in, d_out, g)
            for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:]))
        })
        self.mlp["out"] = Dense(dims[-1], 1, g)
        if cfg.batch_norm:
            self.bn = nn.ModuleDict({
                f"layer_{i}": BatchNorm(w, g.device, cfg.batch_norm_decay)
                for i, w in enumerate(cfg.deep_layers)
            })

    def _finish(self, device, g: torch.Generator) -> None:
        """Move to ``device``, seed the dropout generator from ``g`` after
        the weights, eval mode."""
        self.to(device)
        seed = int(torch.randint(0, 2**62, (1,), generator=g))
        self.dropout_generator = torch.Generator(device=device).manual_seed(seed)
        # row-sharded tables (parallel/spmd.py shard_model); None: whole tables
        self.sharded = None
        self.eval()

    def prepare(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor):
        """[.., F] ids and vals -> ([B, F] narrowed ids, [B, F] float32 vals)."""
        f = self.cfg.field_size
        ids = narrow_ids(feat_ids.reshape(-1, f), self.cfg.feature_size,
                         self.cfg.narrow_ids)
        return ids.contiguous(), feat_vals.reshape(-1, f).to(torch.float32).contiguous()

    def deep(self, x: torch.Tensor) -> torch.Tensor:
        """The deep tower on ``x`` [B, D] -> [B] float32."""
        h = x.to(self.compute_dtype)
        for i in range(len(self.cfg.deep_layers)):
            h = torch.relu(self.mlp[f"layer_{i}"](h))
            if self.cfg.batch_norm:
                h = self.bn[f"layer_{i}"](h.to(torch.float32)).to(self.compute_dtype)
            keep = self.cfg.dropout_keep[i]
            if self.training and keep < 1.0:
                h = dropout(h, keep, self.dropout_generator)
        return self.mlp["out"](h)[:, 0].to(torch.float32)

    def tables(self) -> dict[str, torch.Tensor]:
        """The family's tables by name."""
        return {k: getattr(self, k) for k in self.TABLES}

    def table_logits(self, tables: dict, ids: torch.Tensor, vals: torch.Tensor
                     ) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor) -> torch.Tensor:
        ids, vals = self.prepare(feat_ids, feat_vals)
        tables = self.tables()
        if self.sharded is not None:
            tables, ids = self.sharded.lookup(tables, ids)
        return self.table_logits(tables, ids, vals)


class DeepFM(CTRModel):
    """DeepFM on ``device`` (default: the card; ``"cpu"`` runs the plain
    versions of the kernels), in eval mode until ``train()`` is called.
    Weights are drawn from ``generator`` (default: a CPU generator seeded 0)
    with the reference's initializers: zero bias, glorot normal FM_W/FM_V,
    glorot uniform MLP kernels, zero MLP biases.  The dropout generator is
    seeded from the same generator after the weights."""

    TABLES = ("fm_w", "fm_v")

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        fields, k = cfg.field_size, cfg.embedding_size
        self.fm_b = nn.Parameter(torch.zeros(1, device=g.device))
        self.fm_w = nn.Parameter(glorot_normal((cfg.feature_size,), g))
        fm_v = glorot_normal((cfg.feature_size, k), g)
        pad = fm_v_rows(cfg) - cfg.feature_size
        if pad:
            fm_v = torch.cat([fm_v, fm_v.new_zeros(pad, k)])
        self.fm_v = nn.Parameter(fm_v)
        self._init_deep(cfg, fields * k, g)
        self._finish(device, g)

    def head(self, emb: torch.Tensor, y_w: torch.Tensor, y_v: torch.Tensor) -> torch.Tensor:
        """The deep tower on flattened ``emb`` plus the FM terms -> [B] logits."""
        y_d = self.deep(emb.reshape(emb.shape[0], -1))
        return self.fm_b[0] + y_w + y_v + y_d

    def table_logits(self, tables: dict, ids: torch.Tensor, vals: torch.Tensor
                     ) -> torch.Tensor:
        """B1 (``fused_ctr_interaction``) on the tables, then :meth:`head`."""
        return self.head(*fused_ctr_interaction(tables["fm_w"], tables["fm_v"], ids, vals))


def deepfm_l2_penalty(model: CTRModel, l2_reg: float) -> torch.Tensor:
    """``l2_reg·(½Σfm_w² + ½Σfm_v²)`` over the tables the family has
    (DCN-v2 has no fm_w): the tables only, as in the reference (its MLP L2
    was never added to the loss); over every shard of row-sharded
    tables."""
    total = sum(t.square().sum() for t in model.tables().values())
    if model.sharded is not None:
        total = model.sharded.table_sum(total)
    return l2_reg * 0.5 * total


register_model("deepfm", DeepFM, deepfm_l2_penalty)
