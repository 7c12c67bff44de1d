"""The tiered embedding store: the port's counterpart of
``deepfm_tpu/tiered``.  The family's tables (fm_w and fm_v, DCN-v2's
fm_v alone) and their lazy-Adam moments page through three tiers
instead of living on the card whole:

* **hot**: a fixed-capacity cache of row records on the card
  (``step.py``); the steady-state step is the lazy step on the cache with
  slot ids, one CUDA graph on the card;
* **host**: a host-memory backing store (``host.py``), filled on a miss
  and ahead of the step by the input's id stream (``trainer.py``
  ``observer``);
* **cold**: pages of records in a local directory or under an
  object-store prefix (``store.py``): base segments read by byte range
  and copy-on-write page overlays.

The pager (``pager.py``) translates a batch's ids to slots between steps,
writes dirty victims back and stages the misses.  A checkpoint streams the
tiers (``TieredTrainer.save``), and the publisher's flush barrier pins a
consistent snapshot for serving (``online/publisher.py publish_tiered``,
``serving.py TieredScorer``).
"""

from .host import HostTier
from .pager import DevicePager, SlotMap
from .serving import TieredScorer
from .step import (PagedHot, PagedState, init_hot, make_paged_predict, make_readback,
                   paged_train_step)
from .store import ColdTier, RecordLayout
from .trainer import TieredTrainer, resolve_tiered

__all__ = [
    "ColdTier", "DevicePager", "HostTier", "PagedHot", "PagedState", "RecordLayout",
    "SlotMap", "TieredScorer", "TieredTrainer", "init_hot", "make_paged_predict",
    "make_readback", "paged_train_step", "resolve_tiered",
]
