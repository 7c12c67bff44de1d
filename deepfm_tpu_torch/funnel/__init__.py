"""Recommendation funnel on one card: top-K retrieval over the two-tower
index, then ranking through the DeepFM.  Counterpart of
``deepfm_tpu/funnel``.

* ``index.py`` - the index, the exact and int8 retrieval stages (int8
  through kernel B2, ops/retrieval.py), the rank stage (kernel B1) and
  the brute-force reference;
* ``publish.py`` - the funnel servable (rank/, query/, index.npz,
  funnel.json) and the int8 recall gate;
* ``serve.py`` - ``/v1/recommend`` behind the micro-batching engine;
* ``quant.py``, ``recall.py`` - the int8 codec and the recall harness.
"""

from .index import (  # noqa: F401
    FunnelContext,
    FunnelIndex,
    brute_force_topk,
    build_index,
    build_rank_topn_with,
    build_retrieve_with,
    index_hash,
    make_funnel_context,
    stage_funnel_payload,
)
from .publish import (  # noqa: F401
    export_funnel_servable,
    is_funnel_servable,
    load_funnel_artifact,
)
