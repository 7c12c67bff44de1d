"""Hash-stable traffic splitting: key -> tenant arm, stable forever (the
port's copy of ``deepfm_tpu/fleet/split.py``, with the same md5 point, so
both packages give every key the same arm, the same sample and the same
rendezvous ranking).

The router needs three properties no round-robin or random pick gives:

* **Stickiness**: a user (routing key) always lands on the same arm, across
  requests, router restarts and routers: the arm is a pure function of the
  key bytes and the declared percentages.
* **Exactness**: arm shares converge to the declared percentages because
  keys map uniformly onto a fixed integer space (``SPACE`` points) that the
  arms partition by cumulative percentage.
* **Minimal movement on re-split**: changing percentages moves only the
  keys in the boundary windows that shifted, because arms keep their
  declared order and only the cumulative boundaries move.

Pure control plane: no torch, importable anywhere the router runs.
"""

from __future__ import annotations

import bisect
import hashlib
import threading

# hash-space granularity: percentages resolve to 1e-4 of traffic
SPACE = 1_000_000


def split_point(key: str, salt: str = "") -> int:
    """Deterministic uniform point in ``[0, SPACE)`` for ``key`` — a pure
    function of the bytes (md5, like the routing ring), so the same key
    lands on the same point on every router, forever.  ``salt`` decouples
    independent decisions on the same key stream (the shadow sampler must
    not correlate with the split arms)."""
    h = hashlib.md5(f"{salt}|{key}".encode()).digest()
    return int.from_bytes(h[:8], "big") % SPACE


def sampled(key: str, percent: float, salt: str = "shadow") -> bool:
    """Hash-stable Bernoulli(percent/100) decision for ``key`` — the
    shadow scorer's sampling gate: the SAME keys are always the sampled
    slice, so challenger-vs-incumbent divergence compares like with
    like."""
    return split_point(key, salt) < int(percent / 100.0 * SPACE)


def rendezvous_ranking(key: str, arms, salt: str = "region") -> list[str]:
    """All ``arms`` ordered by descending rendezvous (highest-random-
    weight) score for ``key`` — the home-region assignment primitive.

    Each (key, arm) pair gets an independent uniform score from the same
    ``split_point`` hash the split arms ride; the winner is the key's
    home, and the rest are its deterministic failover order.  Unlike
    ``TrafficSplit``'s cumulative boundaries, removing an arm moves ONLY
    the keys that ranked it first (they fall through to their
    pre-computed second choice, already next in this list); every other
    key's full ranking is unchanged, and re-adding the arm restores the
    exact original assignment — the ring-churn discipline without a ring.
    Score ties (astronomically rare at SPACE resolution) break by arm
    name so every caller agrees."""
    ranked = sorted(
        arms,
        key=lambda a: (-split_point(key, salt=f"{salt}|{a}"), a),
    )
    if not ranked:
        raise ValueError("rendezvous_ranking needs at least one arm")
    return ranked


def rendezvous_arm(key: str, arms, salt: str = "region") -> str:
    """The highest-random-weight winner for ``key`` over ``arms`` — a
    pure function of the key bytes and the arm NAMES (declaration order
    irrelevant), minimal-movement under arm add/remove."""
    return rendezvous_ranking(key, arms, salt=salt)[0]


class TrafficSplit:
    """Percentage split over named arms with hash-stable assignment.

    ``arms`` maps arm name → percent (must sum to 100); iteration order is
    the DECLARED order and is part of the contract: boundaries are
    cumulative in that order, so two routers built from the same config
    agree on every key, and a percentage change moves only the boundary
    windows (``set_percentages`` keeps retained arms in their original
    positions; new arms append)."""

    def __init__(self, arms: dict[str, float]):
        self._lock = threading.Lock()
        self._order: list[str] = []
        self._percent: dict[str, float] = {}
        self._bounds: list[int] = []
        with self._lock:
            self._rebuild(dict(arms))

    @staticmethod
    def _validate(arms: dict[str, float]) -> None:
        if not arms:
            raise ValueError("a traffic split needs at least one arm")
        for name, p in arms.items():
            if p < 0:
                raise ValueError(f"arm {name!r}: percent must be >= 0, "
                                 f"got {p}")
        total = sum(arms.values())
        if abs(total - 100.0) > 1e-6:
            raise ValueError(
                f"split percentages must sum to 100, got {total:g} over "
                f"{list(arms)}"
            )

    def _rebuild(self, arms: dict[str, float]) -> None:
        # caller holds self._lock; retained arms keep their positions so
        # cumulative boundaries — and therefore key assignments outside
        # the shifted windows — stay put
        self._validate(arms)
        order = [a for a in self._order if a in arms]
        order += [a for a in arms if a not in order]
        bounds, cum = [], 0.0
        for name in order:
            cum += arms[name]
            bounds.append(min(SPACE, int(round(cum / 100.0 * SPACE))))
        bounds[-1] = SPACE  # rounding must never strand the top of space
        self._order, self._percent, self._bounds = order, dict(arms), bounds

    def arm(self, key: str) -> str:
        """The arm ``key`` lands on — stable across restarts (pure hash),
        minimal-move across re-splits (cumulative boundaries)."""
        p = split_point(key)
        with self._lock:
            return self._order[bisect.bisect_right(self._bounds, p)]

    def arms(self) -> dict[str, float]:
        with self._lock:
            return {a: self._percent[a] for a in self._order}

    def set_percentages(self, arms: dict[str, float]) -> dict[str, float]:
        """Re-split live traffic; returns the new arms.  Only keys whose
        split point sits in a shifted boundary window change arms — the
        minimal re-assignment for the declared change."""
        with self._lock:
            self._rebuild(dict(arms))
            return {a: self._percent[a] for a in self._order}
