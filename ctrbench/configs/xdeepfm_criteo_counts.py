"""Operations of xDeepFM (``xdeepfm_criteo.json``), from its shapes."""


def mlp_flops(in_dim: int, widths) -> int:
    """The deep tower's products (2·in·out) and bias adds, one example."""
    dims = [in_dim, *widths, 1]
    return sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:]))


def cin_flops(f: int, k: int, layers) -> int:
    """The CIN, one example: each layer's outer product (H·F·K
    multiplies), its contraction (2·H·F·H_out·K) and its sum over K
    (H_out·K), then the output unit over the pooled maps."""
    total, h = 0, f
    for h_out in layers:
        total += h * f * k + 2 * h * f * h_out * k + h_out * k
        h = h_out
    return total + 2 * sum(layers) + 1


def forward_flops_per_example(m: dict) -> int:
    """e = v·x (F·K), the first-order term (2F), the CIN, the deep tower
    and the three adds of the logit."""
    f, k = m["field_size"], m["embedding_size"]
    return (f * k + 2 * f + cin_flops(f, k, m["cin_layers"])
            + mlp_flops(f * k, m["deep_layers"]) + 3)
