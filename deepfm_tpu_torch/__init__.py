"""PyTorch/CUDA port of DeepFM training and serving, for NVIDIA Hopper
(sm_90a).

Module names follow ``deepfm_tpu`` so each file's counterpart is easy to
find.  The package imports ``torch`` and never ``jax``, and nothing from
``deepfm_tpu``: what it needs from that package's JAX-free modules it keeps
as its own trimmed copy.

    python -m deepfm_tpu_torch --task_type train ...     (launch/cli.py)
    python -m torch.distributed.run --nproc_per_node N -m deepfm_tpu_torch ...
        (data parallel, one rank a card: parallel/)
    python -m deepfm_tpu_torch.serve.server --servable DIR   (:predict, or
        /v1/recommend for a recommendation funnel servable, funnel/)

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (core/platform.py).  On CUDA tensors the gather + FM
interaction and its backward always launch the hand-written kernels in
``csrc/fused_ctr.cu``, and the funnel's int8 retrieval score + top-k the
one in ``csrc/retrieval_topk.cu``; on CPU tensors they run their plain
PyTorch versions.
"""
