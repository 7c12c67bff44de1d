"""The one traffic generator: synthetic Criteo-shaped records, made in bulk
on the run's device from the seed, as a ring of pinned host batches.

Every mix (``ctrbench/traffic/<mix>.json``) is a set of parameters for
this generator:

* ``batch_size`` records a step, ``ring_batches`` batches in the ring,
  cycled as epochs;
* ``numeric_fields`` fields whose ids are always ``1..numeric_fields``
  with values uniform in [0, 1), then the categorical fields with value
  1.0, and labels that are 1 with probability ``label_rate``;
* ``layout``, how the categorical ids are drawn:

  - ``"per_field"``: each categorical field owns one contiguous slice of
    the ids past the numeric ones, as a Criteo encoder with a dictionary
    a field lays them out (``deepfm_tpu_torch.data.criteo
    CriteoVocabEncoder``).  A field of ``field_cardinalities[j]`` values
    keeps all of them where they fit; the fields that do not fit share
    what is left equally (:func:`field_sizes`).  Inside its slice a
    field's ids follow Zipf(``zipf_a``) truncated to the slice, rank 1
    at the slice's first id.
  - ``"shared"``: Zipf(``zipf_a``) ids over the whole categorical range,
    folded into it with ``fmod``, every field alike: the distribution of
    ``deepfm_tpu_torch.data.libsvm generate_synthetic_ctr`` (made to
    stress hot rows), drawn with numpy's Zipf rejection rule, vectorised.

The same seed gives the same ring on the same kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

# sub-seeds of one run seed, one per use
WEIGHTS, RING, DROPOUT = 0, 1, 2
_ZIPF_ROUNDS = 64


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one use (``WEIGHTS``, ``RING``, ``DROPOUT``) of
    the run seed.  Any whole number is a run seed."""
    words = np.random.SeedSequence([seed % 2**64, purpose]).generate_state(2, np.uint32)
    return (int(words[0]) << 31 ^ int(words[1])) % 2**63


def zipf(a: float, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` Zipf(``a``) draws as float64 integers >= 1, by numpy's
    rejection rule (``random_zipf``), every round drawn at full size so
    that the sequence depends on the seed alone."""
    dev = generator.device
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.zeros(n, dtype=torch.float64, device=dev)
    pending = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(_ZIPF_ROUNDS):
        u = 1.0 - torch.rand(n, dtype=torch.float64, generator=generator, device=dev)
        v = torch.rand(n, dtype=torch.float64, generator=generator, device=dev)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x >= 1.0) & (x <= 2.0**62) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out = torch.where(pending & ok, x, out)
        pending &= ~ok
        if not bool(pending.any()):
            return out
    raise RuntimeError(f"zipf: draws still pending after {_ZIPF_ROUNDS} rounds")


def field_sizes(cardinalities: list[int], ids: int) -> list[int]:
    """How many of ``ids`` categorical ids each field gets: all its
    values where the fields' values fit, else water-filled: a field with
    fewer values than an equal share of what the smaller fields leave
    keeps them all, and the rest split the remainder equally (the first
    of them one id more, so the sizes sum to ``ids``)."""
    if len(cardinalities) > ids:
        raise ValueError(f"{len(cardinalities)} fields do not fit in {ids} ids")
    if sum(cardinalities) <= ids:
        return list(cardinalities)
    left, order = ids, sorted(cardinalities)
    for i, c in enumerate(order):
        share = left // (len(order) - i)
        if c > share:
            break
        left -= c
    big = [j for j, c in enumerate(cardinalities) if c > share]
    sizes = list(cardinalities)
    for n, j in enumerate(big):
        sizes[j] = left // len(big) + (n < left % len(big))
    return sizes


def _per_field(traffic: dict, n: int, numeric: int, fields: int, vocab: int,
               g: torch.Generator) -> torch.Tensor:
    cards = traffic["field_cardinalities"]
    if len(cards) != fields:
        raise ValueError(f"{len(cards)} field_cardinalities for {fields} categorical fields")
    dev = g.device
    u = torch.rand((n, fields), dtype=torch.float64, generator=g, device=dev)
    ids = torch.empty((n, fields), dtype=torch.int64, device=dev)
    start = numeric + 1
    for j, size in enumerate(field_sizes(cards, vocab - start)):
        cdf = torch.arange(1, size + 1, dtype=torch.float64, device=dev).pow(-traffic["zipf_a"])
        cdf = cdf.cumsum(0)
        cdf /= cdf[-1].clone()
        rank = torch.searchsorted(cdf, u[:, j].contiguous(), right=True).clamp_max_(size - 1)
        ids[:, j] = start + rank
        start += size
    return ids


def _shared(traffic: dict, n: int, numeric: int, fields: int, vocab: int,
            g: torch.Generator) -> torch.Tensor:
    z = zipf(traffic["zipf_a"], n * fields, g).view(n, fields)
    return (numeric + 1 + torch.fmod(z, vocab - numeric - 1)).long()


LAYOUTS = {"per_field": _per_field, "shared": _shared}


def make_records(traffic: dict, model: dict, seed: int, device: torch.device) -> dict:
    """``batch_size x ring_batches`` records on ``device``: ``feat_ids``
    ``[N, F]`` int64, ``feat_vals`` ``[N, F]`` float32, ``label`` ``[N]``
    float32."""
    n = traffic["batch_size"] * traffic["ring_batches"]
    f, vocab = model["field_size"], model["feature_size"]
    numeric = min(traffic["numeric_fields"], f)
    if vocab <= numeric + 1:
        raise ValueError(f"feature_size {vocab} leaves no categorical ids past "
                         f"{numeric} numeric fields")
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, RING))
    label = (torch.rand(n, generator=g, device=device) < traffic["label_rate"]).float()
    num_vals = torch.rand((n, numeric), generator=g, device=device)
    cat = LAYOUTS[traffic["layout"]](traffic, n, numeric, f - numeric, vocab, g)
    num_ids = torch.arange(1, numeric + 1, device=device).expand(n, numeric)
    ids = torch.cat([num_ids, cat], 1)
    vals = torch.cat([num_vals, torch.ones((n, f - numeric), device=device)], 1)
    return {"feat_ids": ids.contiguous(), "feat_vals": vals.contiguous(), "label": label}


def host_ring(records: dict, batch_size: int, *, pin: bool) -> list[dict]:
    """The records as a list of host batches (views of one page-locked
    buffer per key when ``pin``), in record order."""
    host = {}
    for k, t in records.items():
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        h.copy_(t)
        host[k] = h
    n = next(iter(host.values())).shape[0] // batch_size
    return [{k: h[i * batch_size:(i + 1) * batch_size] for k, h in host.items()}
            for i in range(n)]


class Ring:
    """The ring's batches forever, in order: batch ``i`` of the run is
    ``ring[i % len(ring)]``."""

    def __init__(self, ring: list[dict]):
        self.ring = ring
        self.i = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self.ring[self.i % len(self.ring)]
        self.i += 1
        return batch
