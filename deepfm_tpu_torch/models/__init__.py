from .base import ModelDef, get_model, register_model  # noqa: F401
from .deepfm import DeepFM, fm_v_rows  # noqa: F401
