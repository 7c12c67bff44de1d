"""Checkpoints: counterpart of ``deepfm_tpu/checkpoint``.  A local model
directory (``ckpt.py``), an object-store URL through a staging mirror
(``remote.py``), and the restore of a checkpoint written at another
``model_parallel`` (``reshard.py``)."""

from .ckpt import Checkpointer  # noqa: F401
from .remote import RemoteCheckpointer, make_checkpointer, maybe_clear  # noqa: F401
from .reshard import (ReshardDataLossError, restore_resharded,  # noqa: F401
                      restore_resharded_payload)
