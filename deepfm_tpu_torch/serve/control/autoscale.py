"""Elastic shard-group autoscaling, the decision logic: the port's copy of
``deepfm_tpu/serve/control/autoscale.py``.

Pure policy, deliberately separated from execution: this class watches
(utilization, p95, group count) samples and answers "up", "down", or
None; the pool supervisor (serve/pool/__main__.py) owns the machinery —
spawning a member process, waiting out its ``/readyz`` gate, admitting
it to the router, or draining the emptiest group through the existing
stop-admitting → wait-in-flight → terminate discipline.  The split
keeps the policy unit-testable with an injected clock and keeps every
process-management hazard in the one file that already handles them.

Hysteresis on BOTH edges: a breach must persist for
``up_window_secs`` before a scale-up (one burst must not buy a group),
slack must persist for ``down_window_secs`` before a scale-down (much
longer — capacity should linger after a spike, not chase it), and a
``cooldown_secs`` refractory period follows every action so the new
topology's signal settles before the next decision.  Bounds are
absolute: never below ``min_groups``, never above ``max_groups``.
"""

from __future__ import annotations

from ...obs import flight as obs_flight


class AutoScaler:
    """Sustained-breach / sustained-slack scaling decisions.

    ``observe(now, groups=..., util=..., p95_ms=...)`` folds one control
    sample in and returns ``"up"``, ``"down"`` or ``None``.  A breach is
    utilization over ``up_util`` OR p95 over ``slo_ms`` (when set);
    slack is utilization under ``down_util`` AND no p95 breach.  The
    caller reports the action's completion via ``note_scaled(now)``
    which starts the cooldown."""

    def __init__(
        self,
        *,
        min_groups: int = 1,
        max_groups: int = 4,
        up_util: float = 0.75,
        down_util: float = 0.25,
        slo_ms: float = 0.0,
        up_window_secs: float = 5.0,
        down_window_secs: float = 30.0,
        cooldown_secs: float = 10.0,
    ):
        if min_groups < 1 or max_groups < min_groups:
            raise ValueError(
                f"need 1 <= min_groups <= max_groups, got "
                f"[{min_groups}, {max_groups}]"
            )
        if down_util >= up_util:
            raise ValueError(
                f"down_util={down_util} must stay below up_util="
                f"{up_util} (the hysteresis band)"
            )
        self.min_groups = int(min_groups)
        self.max_groups = int(max_groups)
        self._up_util = float(up_util)
        self._down_util = float(down_util)
        self._slo_ms = float(slo_ms)
        self._up_window = float(up_window_secs)
        self._down_window = float(down_window_secs)
        self._cooldown = float(cooldown_secs)
        self._breach_since: float | None = None
        self._slack_since: float | None = None
        self._cooldown_until: float = 0.0
        self.scale_ups_total = 0
        self.scale_downs_total = 0

    def note_scaled(self, now: float) -> None:
        self._breach_since = None
        self._slack_since = None
        self._cooldown_until = now + self._cooldown

    def observe(self, now: float, *, groups: int, util: float,
                p95_ms: float | None = None) -> str | None:
        slo_breach = (self._slo_ms > 0 and p95_ms is not None
                      and p95_ms > self._slo_ms)
        breach = util > self._up_util or slo_breach
        slack = util < self._down_util and not slo_breach
        # windows accumulate even during cooldown — a breach that spans
        # the refractory period acts the moment it ends, it does not
        # restart the clock
        self._breach_since = (
            (self._breach_since if self._breach_since is not None else now)
            if breach else None
        )
        self._slack_since = (
            (self._slack_since if self._slack_since is not None else now)
            if slack else None
        )
        if now < self._cooldown_until:
            return None
        if (breach and groups < self.max_groups
                and now - self._breach_since >= self._up_window):
            self.scale_ups_total += 1
            obs_flight.record(
                "autoscale_decision", subsystem="slo", action="up",
                groups=groups, util=round(util, 4),
                p95_ms=None if p95_ms is None else round(p95_ms, 2),
                breach_secs=round(now - self._breach_since, 2),
            )
            return "up"
        if (slack and groups > self.min_groups
                and now - self._slack_since >= self._down_window):
            self.scale_downs_total += 1
            obs_flight.record(
                "autoscale_decision", subsystem="slo", action="down",
                groups=groups, util=round(util, 4),
                p95_ms=None if p95_ms is None else round(p95_ms, 2),
                slack_secs=round(now - self._slack_since, 2),
            )
            return "down"
        return None

    def snapshot(self) -> dict:
        return {
            "min_groups": self.min_groups,
            "max_groups": self.max_groups,
            "up_util": self._up_util,
            "down_util": self._down_util,
            "slo_ms": self._slo_ms,
            "scale_ups_total": self.scale_ups_total,
            "scale_downs_total": self.scale_downs_total,
            "in_breach": self._breach_since is not None,
            "in_slack": self._slack_since is not None,
        }
