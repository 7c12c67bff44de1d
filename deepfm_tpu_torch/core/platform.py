"""Device resolution: every entry point runs on the card unless the caller
asks for the CPU.

There is no silent fallback.  With no CUDA device, or a card older than
Hopper (compute capability 9.0, the ``sm_90a`` target the kernels are built
for), a call that did not ask for the CPU raises.
"""

from __future__ import annotations

import torch

MIN_CAPABILITY = (9, 0)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> that card, checked; ``"cpu"`` ->
    the CPU.

    On the card it also pins the matmul precision the port is held to:
    float32 products in full float32 (no TF32), and bf16 products reduced
    in float32 (``allow_bf16_reduced_precision_reduction = False``), which
    is how XLA accumulates the JAX package's bf16 MLP."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}; the port's kernels need sm_90a (Hopper)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
