"""Operations of DeepFM (``deepfm_criteo.json``), from its shapes."""


def mlp_flops(in_dim: int, widths) -> int:
    """The deep tower's products (2·in·out) and bias adds, one example."""
    dims = [in_dim, *widths, 1]
    return sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:]))


def forward_flops_per_example(m: dict) -> int:
    """One example's forward: e = v·x (F·K), the first-order term (2F),
    the second-order term (Σ_f e and Σ_f e² as F·K adds and F·K fused
    multiply-adds, then square, subtract and sum over K: 3F·K + 3K), the
    deep tower, and the three adds of the logit."""
    f, k = m["field_size"], m["embedding_size"]
    return f * k + 2 * f + 3 * f * k + 3 * k + mlp_flops(f * k, m["deep_layers"]) + 3
