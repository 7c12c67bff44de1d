from .example_proto import decode_ctr_batch, parse_example, serialize_ctr_example  # noqa: F401
from .libsvm import generate_synthetic_ctr  # noqa: F401
from .pipeline import (Prefetcher, batched_ctr_batches, discover_files,  # noqa: F401
                       eval_batches, make_input_pipeline, record_stream)
from .tfrecord import TFRecordWriter, read_records  # noqa: F401
