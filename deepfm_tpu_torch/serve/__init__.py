from .batcher import MicroBatcher, OverloadedError  # noqa: F401
from .export import export_servable, load_model, load_servable  # noqa: F401
