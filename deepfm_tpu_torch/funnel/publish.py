"""The funnel servable: counterpart of ``funnel_meta``,
``resolve_retrieval_section``, ``write_funnel_tree``,
``load_funnel_artifact`` and ``export_funnel_servable`` in
``deepfm_tpu/funnel/publish.py``.

    funnel/
      rank/        CTR ranking servable (the port's format:
                   config.json + params.npz, serve/export.py)
      query/       two-tower servable (query encoder + the item tower the
                   index was built from), same format
      index.npz    item_ids int32 [N] + item_emb f32 [N, D]
      funnel.json  serving geometry (item_field, top_k/return_n defaults,
                   capacity, field widths, the retrieval section)

The layout is the JAX one; only ``rank/`` and ``query/`` hold the port's
servable format (``convert.funnel_from_jax`` writes a JAX funnel this
way).  :class:`FunnelPublisher` publishes such a tree as one version of a
publish root (online/publisher.py: the tree under ``versions/<v>/``, then
``MANIFEST-<v>.json`` last), whose manifest carries the ranker's
``param_hash`` and an ``index`` section (``items``, ``dim``, ``sha256``,
``query_param_hash``, ``retrieval``): ranking weights and the index they
were built for are one version, and every hash equals the one JAX's
publisher computes on the same weights.  The funnel's hot swap
(funnel/serve.py ``FunnelSwapper``) stages such versions.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from ..core.config import ModelConfig
from ..online.publisher import Manifest, ModelPublisher, param_tree_hash
from .index import FunnelIndex, index_hash

FUNNEL_META = "funnel.json"
INDEX_NPZ = "index.npz"
# probe queries of the int8 recall gate (half random, half corpus rows)
RECALL_QUERIES = 256


def is_funnel_servable(directory: str) -> bool:
    """A funnel servable is marked by its ``funnel.json``."""
    return os.path.isfile(os.path.join(directory, FUNNEL_META))


def funnel_meta(*, item_field: int, top_k: int, return_n: int, capacity: int,
                index: FunnelIndex, user_fields: int, rank_fields: int,
                retrieval: dict | None = None) -> dict:
    meta = {
        "item_field": int(item_field),
        "top_k": int(top_k),
        "return_n": int(return_n),
        "capacity": int(capacity),
        "items": int(index.item_ids.shape[0]),
        "dim": int(index.item_emb.shape[1]),
        "user_field_size": int(user_fields),
        "rank_field_size": int(rank_fields),
    }
    if retrieval is not None:
        meta["retrieval"] = dict(retrieval)
    return meta


def resolve_retrieval_section(index: FunnelIndex, *, capacity: int, top_k: int,
                              retrieval: str = "exact", oversample: int = 4,
                              min_recall: float = 0.95) -> dict:
    """The funnel.json ``retrieval`` section, with the quality gate for
    int8: the mode resolves against the capacity, the quantization error
    bound is computed from the rows, and the recall harness
    (funnel/recall.py) measures recall@top_k of the quantized path against
    ``brute_force_topk`` on this corpus.  Recall under ``min_recall``
    raises before anything is written."""
    from .quant import quantization_stats, quantize_rows, resolve_retrieval_mode
    from .recall import measure_recall

    mode = resolve_retrieval_mode(retrieval, capacity)
    min_recall = float(min_recall)
    if not 0.0 < min_recall <= 1.0:
        raise ValueError(f"funnel min_recall={min_recall} must lie in (0, 1]")
    section = {"mode": mode, "oversample": int(oversample) if mode == "int8" else 1,
               "min_recall": min_recall}
    if mode != "int8":
        return section
    codes, scales = quantize_rows(index.item_emb)
    section.update(quantization_stats(index.item_emb, codes, scales))
    measured = measure_recall(index.item_emb, index.item_ids, int(top_k),
                              oversample=int(oversample), n_queries=RECALL_QUERIES)
    section["measured_recall"] = measured["recall"]
    section["worst_query_recall"] = measured["worst_query_recall"]
    section["recall_queries"] = measured["n_queries"]
    if measured["recall"] < min_recall:
        raise ValueError(
            f"int8 retrieval recall@{top_k} = {measured['recall']:.4f} on "
            f"this corpus falls under the min_recall gate {min_recall} "
            f"(oversample={oversample}, worst query "
            f"{measured['worst_query_recall']:.4f}); refusing to export an "
            f"index that would degrade retrieval quality: raise the "
            f"oversample or fix the corpus"
        )
    return section


def write_funnel_tree(dest: str, rank_cfg: ModelConfig, rank_state: dict,
                      query_cfg: ModelConfig, query_state: dict,
                      index: FunnelIndex, meta: dict) -> str:
    """Write one funnel tree from two ``state_dict``s, the index and the
    meta; returns the directory."""
    from ..serve.export import export_servable

    dest = os.path.abspath(dest)
    os.makedirs(dest, exist_ok=True)
    export_servable(rank_cfg, rank_state, os.path.join(dest, "rank"))
    export_servable(query_cfg, query_state, os.path.join(dest, "query"))
    with open(os.path.join(dest, INDEX_NPZ), "wb") as f:
        np.savez(f, item_ids=index.item_ids, item_emb=index.item_emb)
    with open(os.path.join(dest, FUNNEL_META), "w") as f:
        json.dump(meta, f, indent=2)
    return dest


class FunnelArtifact(NamedTuple):
    """A funnel tree read back on the host."""

    rank_cfg: ModelConfig
    rank_state: dict         # state_dict name -> float32 ndarray
    query_cfg: ModelConfig
    query_state: dict
    index: FunnelIndex
    meta: dict


def _read_servable(directory: str) -> tuple[ModelConfig, dict]:
    from ..core.config import load_config
    from ..serve.export import read_params

    return load_config(directory), read_params(directory)


def load_funnel_artifact(directory: str) -> FunnelArtifact:
    """Read a funnel tree (rank and query servables, index, meta)."""
    directory = os.path.abspath(directory)
    if not is_funnel_servable(directory):
        raise ValueError(f"{directory!r} is not a funnel servable (no {FUNNEL_META})")
    with open(os.path.join(directory, FUNNEL_META)) as f:
        meta = json.load(f)
    rank_cfg, rank_state = _read_servable(os.path.join(directory, "rank"))
    if rank_cfg.model_name == "two_tower":
        raise ValueError("the funnel's rank/ servable must be a CTR model")
    query_cfg, query_state = _read_servable(os.path.join(directory, "query"))
    if query_cfg.model_name != "two_tower":
        raise ValueError("the funnel's query/ servable must be two_tower")
    with np.load(os.path.join(directory, INDEX_NPZ)) as z:
        index = FunnelIndex(item_ids=np.asarray(z["item_ids"], np.int32),
                            item_emb=np.asarray(z["item_emb"], np.float32))
    return FunnelArtifact(rank_cfg=rank_cfg, rank_state=rank_state,
                          query_cfg=query_cfg, query_state=query_state,
                          index=index, meta=meta)


def export_funnel_servable(directory: str, rank_cfg: ModelConfig, rank_state: dict,
                           query_cfg: ModelConfig, query_state: dict,
                           index: FunnelIndex, *, item_field: int | None = None,
                           top_k: int = 32, return_n: int = 0, capacity: int = 0,
                           retrieval: str = "exact", oversample: int = 4,
                           min_recall: float = 0.95) -> str:
    """Write the funnel servable the server boots from.  ``item_field``
    (default: the ranker's last field) carries the candidate id;
    ``capacity`` fixes the index row budget the funnel's graphs are
    captured for (0: the corpus), so a later version may grow the corpus
    up to it without a new capture.  ``retrieval`` / ``oversample`` /
    ``min_recall`` stamp the retrieval section into funnel.json, and an
    int8 export runs the recall gate first (the rule of
    :meth:`FunnelPublisher.publish_funnel`)."""
    f = rank_cfg.field_size
    cap = capacity or index.item_ids.shape[0]
    meta = funnel_meta(
        item_field=f - 1 if item_field is None else item_field,
        top_k=top_k, return_n=return_n or top_k, capacity=cap, index=index,
        user_fields=query_cfg.user_field_size, rank_fields=f,
        retrieval=resolve_retrieval_section(
            index, capacity=cap, top_k=top_k, retrieval=retrieval,
            oversample=oversample, min_recall=min_recall),
    )
    return write_funnel_tree(directory, rank_cfg, rank_state, query_cfg,
                             query_state, index, meta)


def rank_param_hash(rank_cfg: ModelConfig, rank_state: dict) -> str:
    """The manifest's ``param_hash`` of a ranker ``state_dict``: JAX's
    hash over its JAX-layout tree (``convert.params_to_jax``)."""
    from ..convert import params_to_jax

    return param_tree_hash(*params_to_jax(rank_state, rank_cfg))


def query_param_hash(query_cfg: ModelConfig, query_state: dict) -> str:
    """The manifest's ``index.query_param_hash`` of a two-tower
    ``state_dict``: JAX's ``param_tree_hash(params, None)`` over its
    JAX-layout params (``convert.two_tower_params_to_jax``)."""
    from ..convert import two_tower_params_to_jax

    return param_tree_hash(two_tower_params_to_jax(query_state, query_cfg), None)


class FunnelPublisher(ModelPublisher):
    """Versioned funnel publisher: the online publisher's marker-last
    commit, carrying ranking weights and the retrieval index in one
    version.  ``param_hash`` covers the ranker (the hot swap's check); the
    manifest's ``index`` section covers the rest: the index bytes
    (``sha256``) and the query tower (``query_param_hash``)."""

    def publish_funnel(self, rank_cfg: ModelConfig, rank_state: dict,
                       query_cfg: ModelConfig, query_state: dict, index: FunnelIndex, *,
                       item_field: int | None = None, top_k: int = 32, return_n: int = 0,
                       capacity: int = 0, retrieval: str = "exact", oversample: int = 4,
                       min_recall: float = 0.95, step: int = 0, cursor: dict | None = None,
                       watermark: float = 0.0, extra: dict | None = None) -> Manifest:
        """Publish one funnel version (``rank_state`` and ``query_state``
        are ``state_dict``s).  The recall gate runs before anything is
        written: an int8 corpus that misses ``min_recall`` raises and no
        version, not even a torn one, exists for it."""
        import time

        f = rank_cfg.field_size
        cap = capacity or index.item_ids.shape[0]
        section = resolve_retrieval_section(
            index, capacity=cap, top_k=top_k, retrieval=retrieval,
            oversample=oversample, min_recall=min_recall)
        meta = funnel_meta(
            item_field=f - 1 if item_field is None else item_field,
            top_k=top_k, return_n=return_n or top_k, capacity=cap, index=index,
            user_fields=query_cfg.user_field_size, rank_fields=f, retrieval=section)
        manifest = Manifest(
            version=self.next_version(),
            step=int(step),
            param_hash=rank_param_hash(rank_cfg, rank_state),
            field_size=f,
            feature_size=rank_cfg.feature_size,
            model_name=rank_cfg.model_name,
            created_unix=time.time(),
            cursor=cursor,
            watermark=float(watermark),
            extra=dict(extra or {}),
            index={
                "items": int(index.item_ids.shape[0]),
                "dim": int(index.item_emb.shape[1]),
                "sha256": index_hash(index),
                "query_param_hash": query_param_hash(query_cfg, query_state),
                "retrieval": section,
            },
        )
        return self._publish_artifact(
            manifest, lambda dest: write_funnel_tree(dest, rank_cfg, rank_state, query_cfg,
                                                     query_state, index, meta))
