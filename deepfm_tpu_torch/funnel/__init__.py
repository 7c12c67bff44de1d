"""Recommendation funnel: top-K retrieval over the two-tower index (on one
card or row-sharded), then ranking through a CTR model (DeepFM, xDeepFM
or DCN-v2).  Counterpart of
``deepfm_tpu/funnel``.

* ``index.py`` - the index (row-sharded over ``model_parallel`` shards),
  the exact and int8 retrieval stages (int8 through kernel B2,
  ops/retrieval.py) with the candidate-pack merge, the rank stage (kernel
  B1 for a DeepFM or xDeepFM ranker) and the brute-force reference;
* ``graphs.py`` - both stages as CUDA graphs in two weight slots;
* ``publish.py`` - the funnel servable (rank/, query/, index.npz,
  funnel.json), the int8 recall gate and ``FunnelPublisher``'s versions;
* ``serve.py`` - ``/v1/recommend`` behind the micro-batching engine, and
  the versioned hot swap (``FunnelSwapper``);
* ``quant.py``, ``recall.py`` - the int8 codec and the recall harness.
"""

from .index import (  # noqa: F401
    FunnelContext,
    FunnelIndex,
    brute_force_topk,
    build_index,
    build_rank_topn_with,
    build_retrieve_with,
    funnel_wire_bytes_est,
    index_hash,
    index_shards,
    make_funnel_context,
    stage_funnel_payload,
)
from .publish import (  # noqa: F401
    FunnelPublisher,
    export_funnel_servable,
    is_funnel_servable,
    load_funnel_artifact,
    query_param_hash,
    rank_param_hash,
)
