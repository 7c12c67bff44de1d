from .batch_norm import BNParams, BNState, batch_norm, bn_init  # noqa: F401
from .embedding import dense_lookup, narrow_ids, scaled_embedding  # noqa: F401
from .fm import fm_first_order, fm_second_order  # noqa: F401
from .fused_ctr import fused_ctr_interaction, fused_ctr_plain  # noqa: F401
from .initializers import glorot_normal, glorot_uniform  # noqa: F401
