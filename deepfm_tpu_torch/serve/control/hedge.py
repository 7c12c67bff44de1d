"""Hedged tail requests + the shared retry/hedge token budget: the port's
copy of ``deepfm_tpu/serve/control/hedge.py`` (host policy, no device
work; the pool router, serve/pool/router.py, is its caller).

**The budget** is the brownout guard: every routed request accrues a
fractional token (``ratio`` = budget percent / 100), every cross-group
retry and every hedge spends one.  Steady state, retries+hedges are
capped at ``ratio`` of the live request rate; in a pool-wide brownout
the bucket drains and the router FAILS FAST (503 + Retry-After) instead
of multiplying the offered load by the retry factor exactly when
capacity is scarcest — the amplification stays sub-linear by
construction.

**Hedging** tames the tail when ONE group is degraded (a paging stall,
a mid-swap drain) without ejecting it: when the first-choice group's
live p95 exceeds the SLO budget, the router arms a hedge to the next
healthy candidate, fires it only after the primary has outlived an
adaptive delay (``hedge_after_pct`` of that p95), takes the first
answer, and counts the loser as cancelled.  The delay keeps the extra
load near zero on a healthy pool; the token budget hard-caps it under
stress.
"""

from __future__ import annotations

import threading


class TokenBudget:
    """Request-rate-proportional token bucket; thread-safe.

    ``note_request()`` accrues ``ratio`` tokens (so the spend rate is
    capped at ``ratio`` of the recent request rate with burst headroom
    ``burst``); ``try_spend()`` takes one or answers False — callers
    MUST fail fast on False, never block."""

    def __init__(self, ratio: float, *, burst: float = 16.0,
                 initial: float | None = None):
        if ratio < 0:
            raise ValueError(f"budget ratio must be >= 0, got {ratio}")
        self._ratio = float(ratio)
        self._burst = max(1.0, float(burst))
        self._lock = threading.Lock()
        self._tokens = self._burst if initial is None else float(initial)
        self.spent_total = 0
        self.exhausted_total = 0

    def note_request(self) -> None:
        with self._lock:
            self._tokens = min(self._burst, self._tokens + self._ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent_total += 1
                return True
            self.exhausted_total += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ratio": self._ratio,
                "tokens": round(self._tokens, 3),
                "burst": self._burst,
                "spent_total": self.spent_total,
                "exhausted_total": self.exhausted_total,
            }


class HedgeController:
    """The hedge decision: whether to arm, and after what delay.

    ``plan(p95_ms)`` consults the first-choice group's live p95
    (router-measured sliding window): under the SLO budget the answer is
    None (no hedge state, no threads, no cost); over it, the adaptive
    delay is ``hedge_after_pct`` of that p95 — the hedge fires only for
    requests already slower than most of the degraded group's own
    traffic.  Token spend is the caller's (the budget is shared with
    retries); win/loss accounting lives here."""

    def __init__(self, *, slo_budget_ms: float,
                 after_pct: float = 95.0,
                 budget: TokenBudget | None = None):
        if slo_budget_ms <= 0:
            raise ValueError(
                f"hedging needs a positive SLO budget, got {slo_budget_ms}"
            )
        self._slo_ms = float(slo_budget_ms)
        self._after = max(0.0, float(after_pct)) / 100.0
        self.budget = budget
        self._lock = threading.Lock()
        self.fired_total = 0
        self.wins_total = 0
        self.cancelled_total = 0
        self.suppressed_budget_total = 0

    def plan(self, p95_ms: float | None) -> float | None:
        """Delay in SECONDS before the hedge fires, or None (group
        healthy: p95 inside the SLO budget, or no signal yet)."""
        if p95_ms is None or p95_ms <= self._slo_ms:
            return None
        return (p95_ms * self._after) / 1e3

    def try_fire(self) -> bool:
        """Spend a budget token for one hedge (False = suppressed)."""
        if self.budget is not None and not self.budget.try_spend():
            with self._lock:
                self.suppressed_budget_total += 1
            return False
        with self._lock:
            self.fired_total += 1
        return True

    def record_outcome(self, *, hedge_won: bool) -> None:
        """First answer decided the race: the loser counts as
        cancelled (its group did the work; nobody consumed it)."""
        with self._lock:
            if hedge_won:
                self.wins_total += 1
            self.cancelled_total += 1

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "slo_budget_ms": self._slo_ms,
                "after_pct": self._after * 100.0,
                "fired_total": self.fired_total,
                "wins_total": self.wins_total,
                "cancelled_total": self.cancelled_total,
                "suppressed_budget_total": self.suppressed_budget_total,
            }
        if self.budget is not None:
            out["budget"] = self.budget.snapshot()
        return out
