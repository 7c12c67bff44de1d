from .base import ModelDef, get_model, register_model  # noqa: F401
from .deepfm import DeepFM, deepfm_l2_penalty, fm_v_rows  # noqa: F401
from .two_tower import TwoTower, encode_items, encode_queries, encode_tower  # noqa: F401
