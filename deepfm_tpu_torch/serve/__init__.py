from .batcher import MicroBatcher, OverloadedError  # noqa: F401
from .export import (export_servable, load_batching_servable, load_model,  # noqa: F401
                     load_retrieval_servable, load_servable)
