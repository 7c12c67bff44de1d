"""Publishing for the train -> serve hand-off: versioned servables with
manifests written last (publisher.py).  The online trainer is ROADMAP A10."""

from .publisher import (Manifest, ModelPublisher, latest_manifest,  # noqa: F401
                        list_versions, param_tree_hash, read_manifest,
                        version_location)
