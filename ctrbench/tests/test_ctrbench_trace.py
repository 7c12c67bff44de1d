"""The trace's reduction on a hand-made timeline (times in µs, as Chrome
traces give them)."""

import pytest

from conftest import ROOT
from ctrbench import trace


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


EVENTS = [
    _ev("user_annotation", trace.WINDOW, 100.0, 100.0),
    _ev("cpu_op", "aten::copy_", 100.0, 20.0),
    _ev("cuda_runtime", "cudaGraphLaunch", 130.0, 30.0),
    _ev("cpu_op", "aten::copy_", 150.0, 5.0, tid=2),          # another thread
    _ev("kernel", "void k1<int>(float const*)", 90.0, 30.0, tid=7),   # 100-120 inside
    _ev("kernel", "void k2(float)", 115.0, 10.0, tid=7),      # overlaps k1: union 100-125
    _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 170.0, 10.0, tid=7),
    _ev("kernel", "void k1<int>(float const*)", 195.0, 20.0, tid=7),  # 195-200 inside
]


def test_busy_is_the_union_inside_the_window():
    t = trace.reduce_events(EVENTS, steps=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((25 + 10 + 5) * 1e-6)
    assert t.device_seconds(lambda n: "k1" in n) == pytest.approx(25e-6)
    assert t.count(lambda n: "k1" in n) == 2


def test_gaps_go_to_what_the_main_thread_was_doing():
    t = trace.reduce_events(EVENTS, steps=2)
    # 125-170 starts inside cudaGraphLaunch (130-160 covers 125? no: the
    # copy ended at 120, so nothing covers 125), 180-195 inside nothing
    assert t.gaps == pytest.approx({"host: none": 60e-6})
    later = EVENTS + [_ev("cpu_op", "aten::fill_", 120.0, 10.0)]
    assert trace.reduce_events(later, steps=2).gaps["aten::fill_"] == pytest.approx(45e-6)


def test_top_lists_sum_by_short_name():
    t = trace.reduce_events(EVENTS, steps=2)
    ops = dict(t.top_ops())
    assert ops["k1<int>"] == pytest.approx(25e-6) and "Memcpy HtoD (Pinned -> Device)" in ops


def test_one_window_or_none():
    with pytest.raises(RuntimeError, match="spans"):
        trace.reduce_events(EVENTS[1:], steps=1)


def test_idle_shares():
    """``step_idle_pct``: the card's busy time a traced step against the
    measured window's time a step, not the traced window's length (which
    the profiler's host cost stretches); ``device_idle_pct``: the traced
    window's own share."""
    from types import SimpleNamespace

    from ctrbench.cell import reader
    from ctrbench.trace import Trace

    traced = Trace(window_s=0.6, busy_s=0.21, steps=300)  # 2 ms a traced step
    run = SimpleNamespace(trace=traced, steps=10_000, window_s=7.5)  # 0.75 ms a step
    assert abs(reader(ROOT, "step_idle_pct")(run) - 100.0 * (1 - 0.7 / 0.75)) < 1e-9
    assert abs(reader(ROOT, "device_idle_pct")(run) - 65.0) < 1e-9
    for name in ("step_idle_pct", "device_idle_pct"):
        assert reader(ROOT, name)(SimpleNamespace(trace=None, steps=1, window_s=1.0)) is None
