"""The port's servable: counterpart of ``deepfm_tpu/serve/export.py``.

    servable/
      config.json   — the JAX schema (``{"model": {...}}``; other sections
                      written by the JAX package are ignored on load)
      params.npz    — float32 arrays keyed by ``state_dict`` name

A DeepFM or a two-tower servable (``model_name`` picks the family); a
recommendation funnel is a tree of two such servables plus its index
(funnel/publish.py).

:func:`load_servable` is the eager predict (the eval, infer and stdin
paths, and the CPU); :func:`build_graphed_batcher` is what the server
runs: the micro-batcher over the CUDA-graphed predict (serve/graphs.py),
and :func:`load_batching_servable` its embeddable form;
:func:`load_retrieval_servable` loads a two-tower servable's encoders.
:func:`write_predictions` writes the infer task's ``pred.txt``.

JAX's Orbax checkpoint is not read here (the card's machine has neither
JAX nor Orbax): convert one with ``convert.params_from_jax`` and write it
with :func:`export_servable`.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from ..convert import expected_shapes
from ..core.config import ModelConfig, load_config
from ..core.platform import resolve_device
from ..models.base import get_model

PARAMS_FILE = "params.npz"


def export_servable(cfg: ModelConfig, state_dict: dict,
                    directory: str | os.PathLike) -> str:
    """Write ``config.json`` and ``params.npz``; returns the directory."""
    directory = os.path.abspath(directory)
    want = expected_shapes(cfg)
    if set(state_dict) != set(want):
        raise ValueError(
            f"state_dict keys differ from the config's: missing "
            f"{sorted(set(want) - set(state_dict))}, unexpected "
            f"{sorted(set(state_dict) - set(want))}"
        )
    arrays = {k: v.detach().to("cpu", torch.float32).numpy()
              if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
              for k, v in state_dict.items()}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"model": cfg.to_dict()}, f, indent=2)
    np.savez(os.path.join(directory, PARAMS_FILE), **arrays)
    return directory


def read_params(directory: str | os.PathLike) -> dict[str, np.ndarray]:
    """The servable's ``params.npz`` as float32 arrays by ``state_dict``
    name."""
    path = os.path.join(os.path.abspath(directory), PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: a JAX servable (Orbax params/) must be "
            f"converted with deepfm_tpu_torch.convert.params_from_jax and "
            f"written with export_servable first"
        )
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def model_from_state(cfg: ModelConfig, state_dict: dict, device=None) -> torch.nn.Module:
    """The config's model (any registered family) on ``device`` (default:
    the card), in eval mode, with ``state_dict``'s weights."""
    model = get_model(cfg).build(cfg, device=resolve_device(device))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return model


def load_model(directory: str | os.PathLike, device=None) -> torch.nn.Module:
    """The servable's model on ``device`` (default: the card), infer mode."""
    return model_from_state(load_config(directory), read_params(directory), device)


def load_servable(directory: str | os.PathLike,
                  device=None) -> tuple[Callable, ModelConfig]:
    """Load a CTR servable: (predict, config).

    ``predict(feat_ids [B, F] int64 ndarray, feat_vals [B, F] f32 ndarray)
    -> probs [B] f32 ndarray`` runs on ``device`` (default: the card) and
    waits for the result.  It uses CUDA on whichever thread calls it."""
    model = load_model(directory, device)
    if model.cfg.model_name == "two_tower":
        raise ValueError(
            f"{directory} is a two-tower servable: load it with "
            f"load_retrieval_servable (:encode_user/:encode_item/:retrieve), "
            f"or as the query encoder of a recommendation funnel, not "
            f"behind :predict"
        )
    dev = model.fm_v.device

    def predict(feat_ids, feat_vals) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(feat_ids, np.int64)).to(dev)
        vals = torch.as_tensor(np.asarray(feat_vals, np.float32)).to(dev)
        with torch.inference_mode():
            probs = torch.sigmoid(model(ids, vals))
        return probs.cpu().numpy()

    return predict, model.cfg


class GraphedServable(NamedTuple):
    """What :func:`build_graphed_batcher` returns."""
    batcher: object      # serve.batcher.MicroBatcher over the graphed predict
    predictor: object    # serve.graphs.GraphedPredictor, captured
    holder: object       # serve.reload.SwappableParams: the live slot
    cfg: ModelConfig
    warm: dict           # {"capture": {graph: s}, "warm": {bucket: s}}


def build_graphed_batcher(directory: str | os.PathLike, *, device=None,
                          buckets: tuple[int, ...] | None = None,
                          max_wait_ms: float = 2.0,
                          max_queue_rows: int | None = None,
                          registry=None) -> GraphedServable:
    """A CTR servable behind the micro-batching engine over the graphed
    predict, its bucket graphs captured on the engine's worker thread and
    one zero batch a bucket run through them before it returns: on the
    card every bucket's forward is a CUDA graph (serve/graphs.py); on the
    CPU the same engine runs the model eagerly.
    The predictor and the live-slot holder come with it, for a
    :class:`~.reload.HotSwapper`.  ``serve_forever`` and
    :func:`load_batching_servable` both build their engine here."""
    from .batcher import DEFAULT_BUCKETS, MicroBatcher
    from .reload import load_swappable_servable

    buckets = DEFAULT_BUCKETS if buckets is None else tuple(buckets)
    predict, predictor, holder, cfg = load_swappable_servable(
        directory, device=device, buckets=buckets)
    batcher = MicroBatcher(predict, cfg.field_size, buckets=buckets,
                           max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows,
                           registry=registry)
    try:
        warm = {"capture": batcher.run_on_worker(predictor.precompile),
                "warm": batcher.precompile()}
    except BaseException:
        batcher.close()
        raise
    return GraphedServable(batcher, predictor, holder, cfg, warm)


def load_batching_servable(directory: str | os.PathLike, *, device=None,
                           buckets: tuple[int, ...] | None = None,
                           max_wait_ms: float = 2.0,
                           max_queue_rows: int | None = None):
    """A CTR servable behind the micro-batching engine, its bucket graphs
    captured before any traffic: ``(MicroBatcher, ModelConfig)``.  The
    embeddable form of what ``serve_forever`` runs behind HTTP."""
    built = build_graphed_batcher(directory, device=device, buckets=buckets,
                                  max_wait_ms=max_wait_ms,
                                  max_queue_rows=max_queue_rows)
    return built.batcher, built.cfg


def load_retrieval_servable(directory: str | os.PathLike, device=None
                            ) -> tuple[Callable, Callable, ModelConfig]:
    """A two-tower servable: ``(encode_user, encode_item, config)``.
    ``encode_user(user_ids [B, Fu] int64, user_vals [B, Fu] f32) -> [B, D]
    f32`` (L2-normalized) on ``device`` (default: the card), and likewise
    for items; each waits for its result."""
    from ..models.two_tower import encode_tower

    model = load_model(directory, device)
    if model.cfg.model_name != "two_tower":
        raise ValueError(f"servable holds model {model.cfg.model_name!r}; use "
                         f"load_servable")
    dev = model.user_embedding.device

    def encoder(side: str) -> Callable:
        def encode(ids, vals) -> np.ndarray:
            tids = torch.as_tensor(np.asarray(ids, np.int64)).to(dev)
            tvals = torch.as_tensor(np.asarray(vals, np.float32)).to(dev)
            with torch.inference_mode():
                return encode_tower(model, tids, tvals, side=side).cpu().numpy()
        return encode

    return encoder("user"), encoder("item"), model.cfg


def write_predictions(probs: Iterable, path: str | os.PathLike) -> int:
    """The infer task's output: one probability a line as ``%.6f``, streamed
    batch by batch from ``probs`` (arrays or floats); returns the lines
    written.  An object-store URL uploads the finished file with
    ``put_stream``, spooled through a temporary file, so memory stays that
    of the spool buffer, as in the local write."""
    from ..data.object_store import get_store, is_url

    def lines():
        for p in probs:
            for v in np.atleast_1d(np.asarray(p)):
                yield f"{float(v):.6f}\n"

    count = 0
    if is_url(path):
        import tempfile

        with tempfile.SpooledTemporaryFile(max_size=1 << 24, mode="w+b") as f:
            for line in lines():
                f.write(line.encode())
                count += 1
            length = f.tell()
            f.seek(0)
            get_store().put_stream(str(path), f, length)
        return count
    with open(path, "w") as f:
        for line in lines():
            f.write(line)
            count += 1
    return count
