from .auc import AUCState, auc_init, auc_merge, auc_update, auc_value, exact_auc  # noqa: F401
from .batch_norm import BNParams, BNState, batch_norm, bn_init  # noqa: F401
from .embedding import dense_lookup, narrow_ids, scaled_embedding  # noqa: F401
from .fm import fm_first_order, fm_second_order  # noqa: F401
from .fused_ctr import (fused_ctr_backward, fused_ctr_backward_plain,  # noqa: F401
                        fused_ctr_interaction, fused_ctr_plain)
from .initializers import glorot_normal, glorot_uniform  # noqa: F401
