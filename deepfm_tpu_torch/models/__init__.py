from .base import ModelDef, get_model, register_model, registered_models  # noqa: F401
from .deepfm import CTRModel, DeepFM, deepfm_l2_penalty, fm_v_rows  # noqa: F401
from .xdeepfm import CIN, XDeepFM  # noqa: F401
from .dcnv2 import Cross, DCNv2  # noqa: F401
from .two_tower import TwoTower, encode_items, encode_queries, encode_tower  # noqa: F401
