"""Hash-stable sampling: the port's trimmed copy of
``deepfm_tpu/fleet/split.py`` (``SPACE``, ``split_point``, ``sampled``).

A key maps to a point of ``[0, SPACE)`` through md5 of its bytes, so every
process, in either package, takes the same decision for the same key with
no state to share.  ``TrafficSplit`` and the rendezvous ranking are the
multi-tenant fleet's (ROADMAP A18); the serving pool serves one tenant."""

from __future__ import annotations

import hashlib

# hash-space granularity: percentages resolve to 1e-4 of traffic
SPACE = 1_000_000


def split_point(key: str, salt: str = "") -> int:
    """Deterministic uniform point in ``[0, SPACE)`` for ``key``; ``salt``
    decouples independent decisions on the same keys."""
    h = hashlib.md5(f"{salt}|{key}".encode()).digest()
    return int.from_bytes(h[:8], "big") % SPACE


def sampled(key: str, percent: float, salt: str = "shadow") -> bool:
    """Hash-stable Bernoulli(percent / 100) decision for ``key``: the same
    keys are always the sampled slice."""
    return split_point(key, salt) < int(percent / 100.0 * SPACE)
