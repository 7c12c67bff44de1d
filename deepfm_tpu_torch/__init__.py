"""PyTorch/CUDA port of DeepFM training and serving, for NVIDIA Hopper
(sm_90a).

Module names follow ``deepfm_tpu`` so each file's counterpart is easy to
find.  The package imports ``torch`` and never ``jax``, and nothing from
``deepfm_tpu``: what it needs from that package's JAX-free modules it keeps
as its own trimmed copy.

    python -m deepfm_tpu_torch --task_type train|eval|infer|export|serve ...
        (launch/cli.py; checkpoints and resume in --model_dir, records
        read by the C++ reader in native/)
    python -m deepfm_tpu_torch --task_type online-train|feedback-train ...
        (online/trainer.py: an event log in, {weights, cursor} commits and
        published versions out)
    python -m deepfm_tpu_torch.flywheel.join --impressions I --clicks C --out J
        (the delayed-label join feedback-train trains on)
    python -m torch.distributed.run --nproc_per_node N -m deepfm_tpu_torch ...
        (data parallel, one rank a card: parallel/)
    python -m deepfm_tpu_torch.serve.server --servable DIR   (:predict and
        :predict_binary through one CUDA graph a bucket, serve/graphs.py;
        hot reload with --reload-url from online/publisher.py's versions;
        /metrics and traces, obs/; /v1/recommend for a funnel servable)

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (core/platform.py).  On CUDA tensors the gather + FM
interaction and its backward always launch the hand-written kernels in
``csrc/fused_ctr.cu``, and the funnel's int8 retrieval score + top-k the
one in ``csrc/retrieval_topk.cu``; on CPU tensors they run their plain
PyTorch versions.
"""
