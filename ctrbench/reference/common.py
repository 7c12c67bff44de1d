"""What the reference families share, in plain float32 PyTorch: the
precision a forward runs in, the dense layer, dropout masks, the loss and
Adam.  Nothing here imports the program."""

from __future__ import annotations

import torch

# the reference's float32 products stay float32 (no TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Float32:
    """The reference's own precision: every value float32."""

    def table(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _round_trip(x: torch.Tensor, dtype: torch.dtype, scaled: bool) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32; with ``scaled`` by
    one per-tensor scale that puts its largest magnitude at the format's
    largest finite value (the usual fp8 recipe)."""
    if not scaled:
        return x.to(dtype).to(torch.float32)
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Rounded(torch.autograd.Function):
    """Forward rounded to one format, the incoming gradient to another."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, scaled):
        ctx.bwd, ctx.scaled = bwd, scaled
        return _round_trip(x, fwd, scaled)

    @staticmethod
    def backward(ctx, g):
        return _round_trip(g, ctx.bwd, ctx.scaled), None, None, None


class Lowered:
    """One step below the configuration's precisions: the float32 table
    rows in bfloat16, and every value of the bfloat16 parts (the products'
    operands and results, the activations) in fp8: e4m3 forward, e5m2
    gradients, each tensor scaled to the format's range.  The control
    runs the reference in it."""

    def table(self, x: torch.Tensor) -> torch.Tensor:
        return _Rounded.apply(x, torch.bfloat16, torch.bfloat16, False)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        return _Rounded.apply(x, torch.float8_e4m3fn, torch.float8_e5m2, True)


def dense(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, prec) -> torch.Tensor:
    """``h @ kernel + bias``, its operands and result in ``prec``."""
    return prec.mm(prec.mm(h) @ prec.mm(kernel) + bias)


def dropout_masks(generator: torch.Generator, batch: int, widths, keeps) -> list:
    """One step's keep masks, layer by layer: ``rand([batch, width]) <
    keep`` drawn from ``generator`` for every layer whose keep is under 1
    (None for the others)."""
    masks = []
    for width, keep in zip(widths, keeps):
        masks.append(torch.rand((batch, width), generator=generator,
                                device=generator.device) < keep if keep < 1.0 else None)
    return masks


def mlp(h: torch.Tensor, p: dict, widths, keeps, masks, prec) -> torch.Tensor:
    """The deep tower: ReLU layers with TF1 dropout (kept units divided by
    keep), then one output unit -> ``[B]``."""
    for i in range(len(widths)):
        h = torch.relu(dense(h, p[f"mlp.layer_{i}.kernel"], p[f"mlp.layer_{i}.bias"], prec))
        if masks[i] is not None:
            h = torch.where(masks[i], h / keeps[i], torch.zeros_like(h))
    return dense(h, p["mlp.out.kernel"], p["mlp.out.bias"], prec)[:, 0]


def mlp_leaves(in_dim: int, widths) -> list[tuple]:
    """``(name, shape, init, fan_in, fan_out)`` of the deep tower."""
    dims = [in_dim, *widths]
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"mlp.layer_{i}.kernel", (a, b), "uniform", a, b),
                (f"mlp.layer_{i}.bias", (b,), "zeros", 0, 0)]
    out += [("mlp.out.kernel", (dims[-1], 1), "uniform", dims[-1], 1),
            ("mlp.out.bias", (1,), "zeros", 0, 0)]
    return out


def sigmoid_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``tf.nn.sigmoid_cross_entropy_with_logits``, elementwise."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


class Adam:
    """optax ``adam`` in float32: bias corrections from the count,
    ``ε`` outside the root."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            p.sub_(self.lr * (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + self.eps))
