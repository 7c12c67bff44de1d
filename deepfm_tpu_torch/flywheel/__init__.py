"""Data flywheel: serve → log → join → train on our own traffic (the
port's copy of ``deepfm_tpu/flywheel``).

* :mod:`.records` — the impression and click record codecs on the
  ``tf.train.Example`` wire format, and the hash-stable per-id sampling
  gate that the logger and the join both recompute;
* :mod:`.join` — ``python -m deepfm_tpu_torch.flywheel.join``: matches
  clicks to impressions inside an attribution window, emits negatives when
  the window expires under a watermark of segment publish times, and
  writes the labeled stream that ``--task_type feedback-train`` trains on,
  exactly once across a kill and a resume;
* :mod:`.impressions` — the router-side ``ImpressionLogger``: the
  shard-group pool's router (serve/pool/router.py) offers it every
  answered request, and it writes the sampled impressions as segments
  that the join reads.
"""

from .impressions import ImpressionLogger  # noqa: F401
from .join import JoinService  # noqa: F401
from .records import (impression_sampled, parse_click, parse_impression,  # noqa: F401
                      serialize_click, serialize_impression)
