"""Versioned model manifests with marker-last publish: the port's copy of
``deepfm_tpu/online/publisher.py`` for local publish roots.

Each version is a complete servable under ``versions/<v>/`` and a
``MANIFEST-<v>.json`` written last (a temporary file renamed into place),
so a reader that lists manifests and takes the largest version always
finds a whole artifact.  A version tree here is a port servable
(``config.json`` + ``params.npz``, serve/export.py); the manifests are
the JAX package's, byte for byte:

    {version, step, param_hash, field_size, feature_size, model_name,
     created_unix, cursor, watermark, extra, index}

``param_hash`` is the JAX package's SHA-256 over the parameter tree (leaf
path, shape, dtype and bytes, in sorted path order), computed on the
JAX-layout tree of ``convert.params_to_jax``: the same weights hash the
same in both packages, and the hot reloader (serve/reload.py) refuses a
version whose staged weights do not match it.  A JAX publisher's root
reads here unchanged (its version trees hold Orbax payloads, which the
port converts with ``convert.params_from_jax``).

Retention keeps the newest ``max(keep, keep_window)`` versions, deleting
manifest first, so a half-deleted version is invisible; ``keep_window``
(``regions.publish_keep_window``) widens it so that a reader catching up
still finds the versions it is behind by.  Object-store roots (a URL) raise:
ROADMAP A6 and A15.  :meth:`ModelPublisher.publish_tiered` publishes a
tiered model (a consistent cold-tier snapshot in the manifest's
``extra["tiered"]``); the publisher's fence is ROADMAP A15.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from dataclasses import asdict, dataclass, field
from typing import Any

import numpy as np
import torch

_MANIFEST = "MANIFEST-"
_VERSIONS = "versions"


def _version_name(version: int) -> str:
    return f"{int(version):08d}"


def check_local_root(root: str) -> str:
    """``root`` if it is a local directory path; a URL raises."""
    if "://" in str(root):
        raise NotImplementedError(
            f"{root!r}: object-store roots are not ported yet "
            f"(ROADMAP A6, A15); give a local directory")
    return str(root)


def _leaves(node, path: str, out: list) -> None:
    """``(path, leaf)`` pairs with JAX's ``keystr`` paths: ``['key']`` for
    a dict entry, ``.field`` for a NamedTuple field, ``[i]`` for a list or
    tuple item; ``None`` is no leaf."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _leaves(node[k], f"{path}[{k!r}]", out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for name in node._fields:
            _leaves(getattr(node, name), f"{path}.{name}", out)
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            _leaves(x, f"{path}[{i}]", out)
    else:
        out.append((path, node))


def param_tree_hash(params: Any, model_state: Any = None) -> str:
    """SHA-256 over (path, shape, dtype, bytes) of every leaf of
    ``{"params": params, "model_state": model_state}``, sorted by path: a
    content address for the exact weights a version serves, equal to the
    JAX package's for the same tree (``convert.params_to_jax``)."""
    h = hashlib.sha256()
    entries: list = []
    _leaves({"params": params, "model_state": model_state}, "", entries)
    for key, leaf in sorted(entries, key=lambda kv: kv[0]):
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        h.update(key.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


@dataclass(frozen=True)
class Manifest:
    version: int
    step: int
    param_hash: str
    field_size: int
    feature_size: int
    model_name: str
    created_unix: float
    cursor: dict | None = None
    watermark: float = 0.0
    extra: dict = field(default_factory=dict)
    # a funnel version's retrieval index; None for CTR versions
    index: dict | None = None

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        d = json.loads(text)
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


# -- read side (serve/reload.py) --------------------------------------------

def list_versions(root: str) -> list[int]:
    """Committed (manifest-bearing) versions under ``root``, ascending.
    A ``versions/<v>/`` tree without its manifest is invisible."""
    check_local_root(root)
    if not os.path.isdir(root):
        return []
    versions = []
    for name in os.listdir(root):
        if name.startswith(_MANIFEST) and name.endswith(".json"):
            try:
                versions.append(int(name[len(_MANIFEST):-len(".json")]))
            except ValueError:
                continue
    return sorted(versions)


def _manifest_path(root: str, version: int) -> str:
    return os.path.join(root, f"{_MANIFEST}{_version_name(version)}.json")


def version_location(root: str, version: int) -> str:
    return os.path.join(check_local_root(root), _VERSIONS, _version_name(version))


def read_manifest(root: str, version: int) -> Manifest:
    with open(_manifest_path(check_local_root(root), version)) as f:
        return Manifest.from_json(f.read())


def latest_manifest(root: str) -> Manifest | None:
    versions = list_versions(root)
    return read_manifest(root, versions[-1]) if versions else None


def fetch_version(root: str, version: int, staging_dir: str) -> str:
    """Version ``version``'s servable directory, readable locally: a local
    root's version is read in place (``staging_dir`` is where a remote
    version would be downloaded, ROADMAP A6/A15)."""
    return version_location(root, version)


def resolve_version(root: str, version: int, staging_dir: str) -> tuple[Manifest, str]:
    """``(manifest, local artifact directory)`` of one named committed
    version: the manifest first (a missing manifest means the version is
    not committed, and the read fails before any byte moves), then the
    artifact through :func:`fetch_version`.  A funnel's ``stage_version``
    names its version this way instead of racing ``latest_manifest``."""
    manifest = read_manifest(root, version)
    return manifest, fetch_version(root, version, staging_dir)


# -- write side --------------------------------------------------------------

class ModelPublisher:
    """Single-writer publisher of versioned port servables under a local
    ``root``, keeping the newest ``max(keep, keep_window)`` versions."""

    def __init__(self, root: str, *, keep: int = 3, keep_window: int = 0):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if keep_window < 0:
            raise ValueError(f"keep_window must be >= 0, got {keep_window}")
        self.root = check_local_root(root)
        self._keep = max(keep, keep_window)
        os.makedirs(self.root, exist_ok=True)

    def next_version(self) -> int:
        versions = list_versions(self.root)
        return (versions[-1] + 1) if versions else 1

    def publish(self, cfg, state_dict: dict, *, step: int = 0,
                cursor: dict | None = None, watermark: float = 0.0,
                extra: dict | None = None) -> Manifest:
        """Write ``state_dict`` (a DeepFM's, for ``cfg``: a port ``Config``
        or its ``ModelConfig``) as the next version's servable, then its
        manifest last.  A crash before the manifest leaves an invisible
        partial tree, which the next publish of that number overwrites."""
        from ..convert import params_to_jax
        from ..serve.export import export_servable

        model_cfg = getattr(cfg, "model", cfg)
        version = self.next_version()
        manifest = Manifest(
            version=version,
            step=int(step),
            param_hash=param_tree_hash(*params_to_jax(state_dict, model_cfg)),
            field_size=model_cfg.field_size,
            feature_size=model_cfg.feature_size,
            model_name=model_cfg.model_name,
            created_unix=time.time(),
            cursor=cursor,
            watermark=float(watermark),
            extra=dict(extra or {}),
        )
        return self._publish_artifact(
            manifest, lambda dest: export_servable(model_cfg, state_dict, dest))

    def publish_tiered(self, cfg, trainer, *, cursor: dict | None = None,
                       watermark: float = 0.0, extra: dict | None = None) -> Manifest:
        """Publish a tiered model (tiered/trainer.py ``TieredTrainer``):
        the trainer's flush barrier first (dirty rows and moments hot to
        host to cold), then a manifest whose ``extra["tiered"]`` holds the
        cold tier's ``page_versions`` snapshot, so a reader pinned to it
        (tiered/serving.py ``TieredScorer``) sees exactly this step's rows
        whatever the trainer flushes afterwards (overlays are
        copy-on-write).  The version's tree holds only ``config.json`` and
        the model's non-table weights (``rest.pt``); the tables stay in
        the cold tier, referenced, not copied.  ``param_hash`` covers those
        weights."""
        from ..tiered.serving import REST_FILE
        from ..tiered.trainer import rest_state_dict

        snapshot = trainer.flush()  # the consistency barrier, before the manifest
        rest = {k: v.detach().cpu() for k, v in
                rest_state_dict(trainer.state.model).items()}
        manifest = Manifest(
            version=self.next_version(),
            step=int(trainer.state.step),
            param_hash=param_tree_hash(rest),
            field_size=cfg.model.field_size,
            feature_size=cfg.model.feature_size,
            model_name=cfg.model.model_name,
            created_unix=time.time(),
            cursor=cursor,
            watermark=float(watermark),
            extra={**(extra or {}), "tiered": snapshot},
        )

        def write_tree(dest: str) -> None:
            os.makedirs(dest)
            with open(os.path.join(dest, "config.json"), "w") as f:
                json.dump(cfg.to_dict(), f, indent=2)
            torch.save(rest, os.path.join(dest, REST_FILE))

        return self._publish_artifact(manifest, write_tree)

    def _publish_artifact(self, manifest: Manifest, write_tree) -> Manifest:
        """``write_tree(dest)`` writes the version's tree, then the manifest
        lands last."""
        dest = version_location(self.root, manifest.version)
        shutil.rmtree(dest, ignore_errors=True)  # an orphan from a crash
        write_tree(dest)
        path = _manifest_path(self.root, manifest.version)
        with open(path + ".tmp", "w") as f:
            f.write(manifest.to_json())
        os.replace(path + ".tmp", path)  # the publish point
        self._retain()
        return manifest

    def _retain(self) -> None:
        versions = list_versions(self.root)
        for v in versions[:max(0, len(versions) - self._keep)]:
            # manifest first: a version without it is invisible to readers
            try:
                os.remove(_manifest_path(self.root, v))
            except FileNotFoundError:
                pass
            shutil.rmtree(version_location(self.root, v), ignore_errors=True)
