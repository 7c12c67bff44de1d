"""PyTorch/CUDA port of the DeepFM serving path, for NVIDIA Hopper (sm_90a).

Module names follow ``deepfm_tpu`` so each file's counterpart is easy to
find.  The package imports ``torch`` and never ``jax``, and nothing from
``deepfm_tpu``: what it needs from that package's JAX-free modules it keeps
as its own trimmed copy.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (core/platform.py).  On a CUDA tensor the gather + FM
interaction always launches the hand-written kernel in
``csrc/fused_ctr.cu``; on a CPU tensor it runs the plain PyTorch version.
"""
