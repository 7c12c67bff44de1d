from .criteo import (CriteoHashEncoder, CriteoVocabEncoder,  # noqa: F401
                     build_criteo_vocab, convert_criteo_to_tfrecords, parse_criteo_line)
from .example_proto import decode_ctr_batch, parse_example, serialize_ctr_example  # noqa: F401
from .libsvm import (generate_synthetic_ctr, libsvm_to_tfrecord,  # noqa: F401
                     parse_libsvm_line, tfrecord_to_libsvm)
from .pipeline import (Prefetcher, batched_ctr_batches, discover_files,  # noqa: F401
                       eval_batches, make_input_pipeline, record_stream)
from .tfrecord import TFRecordWriter, read_records, write_records  # noqa: F401
