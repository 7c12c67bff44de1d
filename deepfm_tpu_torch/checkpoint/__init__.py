"""Checkpoints: counterpart of ``deepfm_tpu/checkpoint``.  A local model
directory only; object-store directories (``checkpoint/remote.py``) and
the cross-topology reshard (``checkpoint/reshard.py``) are ROADMAP A15."""

from .ckpt import Checkpointer, make_checkpointer, maybe_clear  # noqa: F401
