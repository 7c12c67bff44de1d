"""Typed, labeled metrics registry and the sliding-window percentile: the
port's copy of ``deepfm_tpu/obs/metrics.py`` (the module imports no JAX;
the port keeps its own copy, ROADMAP working rules).

:class:`SlidingWindow` is the one percentile implementation, and
:class:`MetricsRegistry` the one place counters, gauges and histograms
live: every ``/v1/metrics`` JSON section re-renders from registry values,
and ``GET /metrics`` serves the same registry in the Prometheus text
exposition format (:meth:`MetricsRegistry.render_prometheus`), line for
line as the JAX package renders it.

Locks: each metric child owns one small lock around its own mutation; the
registry lock guards only family creation and collection.  Names follow
``deepfm_<area>_<what>``, ``_total`` for counters, ``_seconds`` for
latency histograms.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Sequence

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# the quantiles every latency section reports — one definition, like the
# serving engine's DEFAULT_BUCKETS
DEFAULT_QUANTILES = (0.50, 0.95, 0.99)


class SlidingWindow:
    """Fixed ring of the last ``size`` observations with percentile
    snapshots — recent-traffic truth, O(size) to compute, never grows
    with uptime.  NOT internally locked: callers (the Histogram child,
    the legacy lock-holding snapshot paths) own synchronization.
    """

    def __init__(self, size: int = 2048):
        if size < 1:
            raise ValueError(f"window size must be >= 1, got {size}")
        self._buf = np.zeros(size, np.float64)
        self._n = 0  # total recorded (ring write cursor)

    @property
    def count(self) -> int:
        return self._n

    def record(self, value: float) -> None:
        self._buf[self._n % self._buf.size] = value
        self._n += 1

    def quantiles(
        self, qs: Sequence[float] = DEFAULT_QUANTILES
    ) -> dict[float, float]:
        """Raw (unscaled) quantile values over the window; {} when empty.
        Index math is the historical snapshot's: ``sorted[int((n-1)*q)]``."""
        n = min(self._n, self._buf.size)
        if not n:
            return {}
        w = np.sort(self._buf[:n])
        return {float(q): float(w[int((n - 1) * q)]) for q in qs}

    def snapshot(
        self,
        *,
        quantiles: Sequence[float] = DEFAULT_QUANTILES,
        scale: float = 1e3,
        digits: int = 3,
        include_max: bool = False,
    ) -> dict:
        """The legacy ``latency_ms`` document: ``{"count": N[, "p50": ...,
        "p95": ..., "p99": ...[, "max": ...]]}`` — seconds recorded,
        milliseconds reported (``scale``).  ``count`` is TOTAL recorded,
        not window occupancy (the pinned schema)."""
        n = min(self._n, self._buf.size)
        out: dict = {"count": int(self._n)}
        if n:
            w = np.sort(self._buf[:n])
            for q in quantiles:
                out[f"p{int(round(q * 100))}"] = round(
                    scale * float(w[int((n - 1) * q)]), digits
                )
            if include_max:
                out["max"] = round(scale * float(w[-1]), digits)
        return out


def _escape_label(v: str) -> str:
    return (
        str(v)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r"\"")
    )


def _fmt_labels(names: tuple[str, ...], values: tuple[str, ...],
                extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter:
    """Monotonic counter child: ``inc(amount)``; negative increments are
    refused (a decreasing 'counter' corrupts every rate() downstream)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value child: ``set``/``inc``/``dec``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Sliding-window distribution child: ``observe(v)`` records into the
    shared :class:`SlidingWindow`; exported as a Prometheus *summary*
    (quantile series + ``_sum``/``_count``) and snapshot as the pinned
    ``latency_ms``-style JSON document."""

    def __init__(self, window: int = 2048,
                 quantiles: Sequence[float] = DEFAULT_QUANTILES):
        self._lock = threading.Lock()
        self._window = SlidingWindow(window)
        self._quantiles = tuple(quantiles)
        self._sum = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._window.record(value)
            self._sum += value

    @property
    def count(self) -> int:
        with self._lock:
            return self._window.count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile_values(self) -> dict[float, float]:
        with self._lock:
            return self._window.quantiles(self._quantiles)

    def snapshot(self, *, scale: float = 1e3, digits: int = 3,
                 include_max: bool = False,
                 quantiles: Sequence[float] | None = None) -> dict:
        with self._lock:
            return self._window.snapshot(
                quantiles=self._quantiles if quantiles is None else quantiles,
                scale=scale, digits=digits, include_max=include_max,
            )


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric family: label names + a child per label-value
    tuple.  ``labels(...)`` is get-or-create and cached; families with no
    labels proxy the child API directly (``family.inc()``)."""

    def __init__(self, kind: str, name: str, help: str,
                 label_names: tuple[str, ...], child_kw: dict):
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = label_names
        self._child_kw = child_kw
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not label_names:
            self._default = self._make_child(())
        else:
            self._default = None

    def _make_child(self, key: tuple[str, ...]):
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind](**self._child_kw)
                self._children[key] = child
            return child

    def labels(self, *values) -> object:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: got {len(key)} label value(s) for label "
                f"names {self.label_names}"
            )
        child = self._children.get(key)
        return child if child is not None else self._make_child(key)

    def children(self) -> dict[tuple[str, ...], object]:
        with self._lock:
            return dict(self._children)

    # unlabeled convenience proxies
    def _only(self):
        if self._default is None:
            raise ValueError(
                f"{self.name} is labeled {self.label_names}; call "
                f".labels(...) first"
            )
        return self._default

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    @property
    def value(self) -> float:
        return self._only().value

    @property
    def count(self) -> int:
        return self._only().count

    @property
    def sum(self) -> float:
        return self._only().sum

    def snapshot(self, **kw) -> dict:
        return self._only().snapshot(**kw)


class MetricsRegistry:
    """Instance-scoped registry: each serving/training process composes
    ONE and threads it through its components (engine, swapper, pager,
    router) so ``GET /metrics`` renders that process's full picture, and
    tests stay hermetic (no cross-test global counter bleed).

    ``counter``/``gauge``/``histogram`` are get-or-create on (name): a
    second call with the same name returns the same family; a call that
    disagrees on kind or label names raises — silent divergence between
    two call sites claiming one name is how metrics rot."""

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._collect_hooks: list[Callable[[], None]] = []

    def _register(self, kind: str, name: str, help: str,
                  labels: Sequence[str], child_kw: dict) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        label_names = tuple(labels)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != label_names:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}, requested "
                        f"{kind}{label_names}"
                    )
                return fam
            fam = _Family(kind, name, help, label_names, child_kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._register("counter", name, help, labels, {})

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._register("gauge", name, help, labels, {})

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), *, window: int = 2048,
                  quantiles: Sequence[float] = DEFAULT_QUANTILES) -> _Family:
        return self._register(
            "histogram", name, help, labels,
            {"window": window, "quantiles": quantiles},
        )

    def on_collect(self, hook: Callable[[], None]) -> None:
        """Register a pre-scrape hook (e.g. refresh queue-depth gauges);
        runs at every :meth:`render_prometheus`."""
        with self._lock:
            self._collect_hooks.append(hook)

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4).  Counters/gauges
        render one sample per child; histograms render as summaries
        (quantile series + ``_sum``/``_count``)."""
        with self._lock:
            hooks = list(self._collect_hooks)
        for hook in hooks:
            try:
                hook()
            except Exception as e:
                # a broken gauge refresher must not take down the scrape
                # of every healthy metric; surface it once per scrape
                import logging

                logging.getLogger(__name__).warning(
                    "metrics collect hook failed: %s: %s",
                    type(e).__name__, e)
        lines: list[str] = []
        for fam in self.families():
            ptype = "summary" if fam.kind == "histogram" else fam.kind
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {ptype}")
            for key, child in sorted(fam.children().items()):
                lbl = _fmt_labels(fam.label_names, key)
                if fam.kind == "histogram":
                    for q, v in sorted(child.quantile_values().items()):
                        qlbl = _fmt_labels(
                            fam.label_names, key,
                            extra=(("quantile", f"{q:g}"),),
                        )
                        lines.append(f"{fam.name}{qlbl} {v:g}")
                    lines.append(f"{fam.name}_sum{lbl} {child.sum:g}")
                    lines.append(f"{fam.name}_count{lbl} {child.count}")
                else:
                    lines.append(f"{fam.name}{lbl} {child.value:g}")
        return "\n".join(lines) + "\n"
