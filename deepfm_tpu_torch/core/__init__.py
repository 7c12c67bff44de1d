from .config import ModelConfig, load_config  # noqa: F401
from .platform import resolve_device  # noqa: F401
