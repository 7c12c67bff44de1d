"""Online training and the train -> serve hand-off: event logs with durable
cursors (stream.py), the online trainer that commits {weights, cursor} and
publishes versions (trainer.py), and versioned servables with manifests
written last (publisher.py)."""

from .publisher import (Manifest, ModelPublisher, latest_manifest,  # noqa: F401
                        list_versions, param_tree_hash, read_manifest, resolve_version,
                        version_location)
from .stream import (DirectoryTail, EventLogReader, SegmentWriter,  # noqa: F401
                     StreamCursor, append_segment, open_tail, publish_segment,
                     segment_name)
from .trainer import OnlinePayload, OnlineTrainer  # noqa: F401
