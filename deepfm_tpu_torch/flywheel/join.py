"""Delayed-label join: impressions ⋈ clicks → a labeled training stream.
The port's copy of ``deepfm_tpu/flywheel/join.py`` for local log roots.

    python -m deepfm_tpu_torch.flywheel.join --impressions I --clicks C \
        --out J --window SECS [--sample-rate R] [--roll-bytes N] \
        [--checkpoint-every N] [--follow [--idle-timeout S]] [--drain] \
        [--config cfg.json]

The positive label of an impression arrives later (a click) or never.
The service tails two event logs (``online/stream.py`` segments), scored
impressions and click events, and resolves every sampled impression to one
labeled example:

* a click inside the **attribution window** → a positive, emitted when the
  click is read (a click read before its impression waits in an
  early-click buffer for one window);
* the window expiring with no click → a **negative**;
* a click after the negative was emitted → a counted **label flip**
  (metric and flight event), never a second example.

**Watermark.**  Time is segment publish time (mtime), not event time: the
click watermark is the publish time of the newest consumed click segment,
and an impression expires once it passes the impression's own segment's
publish time plus the window.  Only segment publish order matters.

**Exactly once.**  The schedule (the two logs' heads merged by publish
time, what is emitted, where output segments split: a byte roll only, no
age roll) is a pure function of (checkpoint, log contents).  Each
checkpoint flushes the output writer, then commits ``{cursors, pending
window, counters, next output seq}`` to ``_join_state.json`` (a temporary
file renamed into place).  A crash between the two re-runs the interval
and re-publishes byte-identical segments under the same names; a crash
before the flush loses only work that replay regenerates.  So the output
after a kill anywhere and a resume is byte-equal to an uninterrupted run's,
and to the JAX package's join over the same input directories.

Object-store roots raise (ROADMAP A6, A15).  Metrics go to a
``MetricsRegistry`` (obs/metrics.py), flips and stalls to the flight
recorder (obs/flight.py).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from collections import deque

from ..data.example_proto import serialize_ctr_example
from ..data.tfrecord import read_records
from ..obs import flight as obs_flight
from ..obs.metrics import MetricsRegistry
from ..online.publisher import check_local_root
from ..online.stream import SegmentWriter, StreamCursor, open_tail
from .records import impression_sampled, parse_click, parse_impression

STATE_NAME = "_join_state.json"

_EVENTS = ("positive", "negative", "flip", "orphan_click", "sampled_out", "duplicate")
# a follow-mode watermark standing this long with impressions pending is a
# stall (counted, recorded in the flight recorder)
STALL_FLIGHT_SECS = 30.0


def _state_path(output_root: str) -> str:
    return os.path.join(check_local_root(output_root), STATE_NAME)


def load_status(output_root: str) -> dict | None:
    """The join's latest committed checkpoint as an observability document
    (None before the first checkpoint)."""
    state = load_state(output_root)
    if state is None:
        return None
    wm = float(state.get("watermark", 0.0))
    return {
        "watermark": wm,
        "lag_seconds": round(max(0.0, time.time() - wm), 3) if wm > 0 else None,
        "pending_window": len(state.get("pending", ())),
        "early_clicks": len(state.get("early", ())),
        "next_out_seq": int(state.get("next_out_seq", 0)),
        "counters": state.get("counters", {}),
    }


def load_state(output_root: str) -> dict | None:
    """The raw committed checkpoint (None when absent or unreadable)."""
    try:
        with open(_state_path(output_root), "rb") as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


class JoinService:
    """One delayed-label join over (impression log, click log) → output
    stream.  Construct, then :meth:`run` (one shot or follow)."""

    def __init__(self, impressions_url: str, clicks_url: str, output_url: str, *,
                 attribution_window_secs: float, sample_rate: float = 1.0,
                 roll_bytes: int = 1 << 20, checkpoint_every_segments: int = 8):
        if attribution_window_secs <= 0:
            raise ValueError(
                f"attribution_window_secs must be > 0, got {attribution_window_secs}")
        if checkpoint_every_segments <= 0:
            raise ValueError(
                f"checkpoint_every_segments must be > 0, got {checkpoint_every_segments}")
        self._imp_tail = open_tail(impressions_url)
        self._click_tail = open_tail(clicks_url)
        self.output_url = check_local_root(output_url)
        self._window = float(attribution_window_secs)
        self._sample_rate = float(sample_rate)
        self._checkpoint_every = int(checkpoint_every_segments)
        self._since_checkpoint = 0
        self.registry = MetricsRegistry()
        events = self.registry.counter("deepfm_flywheel_join_events_total",
                                       "join resolutions and anomalies by kind",
                                       labels=("event",))
        self._c = {ev: events.labels(ev) for ev in _EVENTS}
        self._g_pending = self.registry.gauge(
            "deepfm_flywheel_join_pending", "impressions awaiting a click or window expiry")
        self._g_lag = self.registry.gauge(
            "deepfm_flywheel_join_lag_seconds", "wall time minus the click watermark")
        self._c_stalls = self.registry.counter(
            "deepfm_flywheel_join_stalls_total",
            "watermark stalls with a non-empty pending window")
        # test and drill hooks: raise from either to inject a crash there
        self.on_segment = None  # called with each published segment name
        self.on_checkpoint = None  # called after each committed checkpoint

        state = load_state(output_url)
        if state is None:
            self._imp_cursor = StreamCursor()
            self._click_cursor = StreamCursor()
            self._watermark = 0.0
            self._imp_watermark = 0.0
            self._pending: dict[str, dict] = {}
            self._early: dict[str, float] = {}
            self._expired: dict[str, float] = {}
            self.emitted_total = 0
            next_seq = 0
        else:
            self._imp_cursor = StreamCursor(*state["imp_cursor"])
            self._click_cursor = StreamCursor(*state["click_cursor"])
            self._watermark = float(state["watermark"])
            self._imp_watermark = float(state["imp_watermark"])
            self._pending = dict(state["pending"])
            self._early = dict(state["early"])
            self._expired = dict(state["expired"])
            counters = state.get("counters", {})
            for ev in _EVENTS:
                self._c[ev].inc(float(counters.get(ev, 0)))
            self.emitted_total = int(counters.get("emitted", 0))
            next_seq = int(state["next_out_seq"])
        # no age roll: output segment boundaries are a pure function of the
        # emitted records
        self._writer = SegmentWriter(output_url, roll_bytes=roll_bytes, roll_age_secs=0,
                                     start_seq=next_seq)

    # -- segment consumption ------------------------------------------------
    def _unconsumed(self, tail, cursor: StreamCursor) -> list[str]:
        return [n for n in tail.list_segments()
                if n != STATE_NAME and (not cursor.segment or n > cursor.segment)]

    def _read_segment(self, tail, name: str) -> list[bytes]:
        # read whole before any state changes: a failed read retries next poll
        with tail.open_segment(name) as f:
            return list(read_records(f))

    def _emit(self, label: float, ids, values) -> None:
        rolled = self._writer.append(serialize_ctr_example(label, ids, values))
        self.emitted_total += 1
        if rolled and self.on_segment is not None:
            self.on_segment(rolled)

    def _consume_impressions(self, name: str) -> None:
        records = self._read_segment(self._imp_tail, name)
        pub = self._imp_tail.segment_time(name)
        for rec in records:
            imp = parse_impression(rec)
            pid = imp.impression_id
            if not impression_sampled(pid.rsplit("#", 1)[0], self._sample_rate):
                self._c["sampled_out"].inc()
                continue
            if pid in self._pending or pid in self._expired:
                self._c["duplicate"].inc()
                continue
            entry = {"pub": pub, "ids": [int(i) for i in imp.ids],
                     "values": [float(v) for v in imp.values]}
            if pid in self._early:
                self._early.pop(pid)
                self._emit(1.0, entry["ids"], entry["values"])
                self._c["positive"].inc()
            else:
                self._pending[pid] = entry
        self._imp_watermark = max(self._imp_watermark, pub)
        self._imp_cursor = StreamCursor(name, len(records))

    def _consume_clicks(self, name: str) -> None:
        records = self._read_segment(self._click_tail, name)
        pub = self._click_tail.segment_time(name)
        for rec in records:
            pid = parse_click(rec).impression_id
            entry = self._pending.pop(pid, None)
            if entry is not None:
                self._emit(1.0, entry["ids"], entry["values"])
                self._c["positive"].inc()
            elif pid in self._expired:
                # the negative is already out: count the flip, emit nothing
                self._c["flip"].inc()
                obs_flight.record("label_flip_after_emit", subsystem="flywheel",
                                  impression_id=pid, watermark=self._watermark)
            elif not impression_sampled(pid.rsplit("#", 1)[0], self._sample_rate):
                self._c["sampled_out"].inc()
            else:
                # a click before its impression: waits up to one window
                self._early.setdefault(pid, pub)
        self._watermark = max(self._watermark, pub)
        self._click_cursor = StreamCursor(name, len(records))
        self._expire()

    def _expire(self) -> None:
        w = self._watermark
        due = sorted((e["pub"], pid) for pid, e in self._pending.items()
                     if e["pub"] + self._window <= w)
        for _, pid in due:
            entry = self._pending.pop(pid)
            self._emit(0.0, entry["ids"], entry["values"])
            self._c["negative"].inc()
            self._expired[pid] = w
        for pid in sorted(pid for pid, t in self._early.items() if t + self._window <= w):
            self._early.pop(pid)
            self._c["orphan_click"].inc()
        # an expired id is kept one more window for flip detection
        for pid in [pid for pid, t in self._expired.items() if t + self._window <= w]:
            del self._expired[pid]

    def _run_pass(self) -> int:
        """Consume every listed unconsumed segment, the two logs' heads
        merged by (publish time, stream, name): the deterministic schedule
        replay depends on."""
        imps = deque(self._unconsumed(self._imp_tail, self._imp_cursor))
        clicks = deque(self._unconsumed(self._click_tail, self._click_cursor))
        processed = 0
        while imps or clicks:
            if not clicks:
                take_click = False
            elif not imps:
                take_click = True
            else:
                take_click = ((self._click_tail.segment_time(clicks[0]), "c")
                              <= (self._imp_tail.segment_time(imps[0]), "i"))
            if take_click:
                self._consume_clicks(clicks.popleft())
            else:
                self._consume_impressions(imps.popleft())
            processed += 1
            self._since_checkpoint += 1
            if self._since_checkpoint >= self._checkpoint_every:
                self.checkpoint()
        return processed

    # -- durability ---------------------------------------------------------
    def checkpoint(self) -> None:
        """Flush the output, then commit the state (a temporary file
        renamed into place), in that order."""
        name = self._writer.flush()
        if name and self.on_segment is not None:
            self.on_segment(name)
        counters = {ev: int(self._c[ev].value) for ev in _EVENTS}
        counters["emitted"] = self.emitted_total
        state = {
            "schema": 1,
            "imp_cursor": list(self._imp_cursor),
            "click_cursor": list(self._click_cursor),
            "watermark": self._watermark,
            "imp_watermark": self._imp_watermark,
            "pending": sorted(self._pending.items()),
            "early": sorted(self._early.items()),
            "expired": sorted(self._expired.items()),
            "next_out_seq": self._writer.next_seq,
            "counters": counters,
        }
        path = _state_path(self.output_url)
        os.makedirs(self.output_url, exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            f.write(json.dumps(state).encode())
        os.replace(path + ".tmp", path)
        self._since_checkpoint = 0
        if self.on_checkpoint is not None:
            self.on_checkpoint(state)

    # -- driving ------------------------------------------------------------
    def run(self, *, follow: bool = False, stop: threading.Event | None = None,
            idle_timeout_secs: float = 0.0, poll_interval_secs: float = 0.2,
            drain_at_eof: bool = False) -> int:
        """Consume the logs; returns the segments processed.
        ``follow=False`` reads the logs as they stand, and with
        ``drain_at_eof`` then moves the watermark past every read impression
        so every pending window expires (the one-shot batch join).
        ``follow=True`` tails until ``stop`` or ``idle_timeout_secs``
        without progress, recording watermark stalls in the flight
        recorder.  A final checkpoint commits before the return."""
        total = 0
        now = time.monotonic()
        last_progress = now
        last_wm, last_wm_change, stalled = self._watermark, now, False
        while True:
            n = self._run_pass()
            total += n
            now = time.monotonic()
            if n:
                last_progress = now
            if self._watermark != last_wm:
                last_wm, last_wm_change, stalled = self._watermark, now, False
            elif (follow and self._pending and not stalled
                  and now - last_wm_change >= STALL_FLIGHT_SECS):
                self._c_stalls.inc()
                stalled = True
                obs_flight.record("join_watermark_stall", subsystem="flywheel",
                                  watermark=self._watermark, pending=len(self._pending),
                                  stalled_secs=round(now - last_wm_change, 1))
            if stop is not None and stop.is_set():
                break
            if not follow:
                break
            if idle_timeout_secs > 0 and now - last_progress >= idle_timeout_secs:
                break
            if stop is not None:
                stop.wait(poll_interval_secs)
            else:
                time.sleep(poll_interval_secs)
        if drain_at_eof and not follow and (self._pending or self._early):
            self._watermark = max(self._watermark, self._imp_watermark + self._window)
            self._expire()
        self.checkpoint()
        return total

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        wm = self._watermark
        lag = round(max(0.0, time.time() - wm), 3) if wm > 0 else None
        self._g_pending.set(len(self._pending))
        if lag is not None:
            self._g_lag.set(lag)
        return {
            "watermark": wm,
            "lag_seconds": lag,
            "pending_window": len(self._pending),
            "early_clicks": len(self._early),
            "emitted_total": self.emitted_total,
            "stalls_total": int(self._c_stalls.value),
            **{f"{ev}_total": int(self._c[ev].value) for ev in _EVENTS},
        }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepfm_tpu_torch.flywheel.join",
        description="delayed-label join: impressions + clicks -> labeled training stream")
    p.add_argument("--config", help="JSON config file; the flywheel section supplies defaults")
    p.add_argument("--impressions", help="impression log root")
    p.add_argument("--clicks", help="click-event log root")
    p.add_argument("--out", help="joined output stream root")
    p.add_argument("--window", type=float, help="attribution window seconds")
    p.add_argument("--sample-rate", type=float)
    p.add_argument("--roll-bytes", type=int)
    p.add_argument("--checkpoint-every", type=int)
    p.add_argument("--follow", action="store_true", help="tail the logs (default: one shot)")
    p.add_argument("--idle-timeout", type=float, default=0.0)
    p.add_argument("--poll-interval", type=float, default=0.2)
    p.add_argument("--drain", action="store_true",
                   help="one-shot mode: expire every pending window at end of log "
                        "(synthesizes the tail negatives)")
    args = p.parse_args(argv)

    fw = None
    if args.config:
        from ..core.config import Config

        fw = Config.from_json(args.config).flywheel

    def pick(flag, attr: str, default):
        if flag is not None:
            return flag
        return getattr(fw, attr) if fw is not None else default

    impressions = pick(args.impressions, "impression_log_url", "")
    clicks = pick(args.clicks, "click_log_url", "")
    out = pick(args.out, "join_output_url", "")
    if not (impressions and clicks and out):
        p.error("need --impressions, --clicks and --out (or a --config with a filled "
                "flywheel section)")
    svc = JoinService(
        impressions, clicks, out,
        attribution_window_secs=pick(args.window, "attribution_window_secs", 1800.0),
        sample_rate=pick(args.sample_rate, "sample_rate", 1.0),
        roll_bytes=pick(args.roll_bytes, "segment_roll_bytes", 1 << 20),
        checkpoint_every_segments=pick(args.checkpoint_every,
                                       "join_checkpoint_every_segments", 8))

    import signal

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    t0 = time.perf_counter()
    svc.run(follow=args.follow, stop=stop, idle_timeout_secs=args.idle_timeout,
            poll_interval_secs=args.poll_interval, drain_at_eof=args.drain)
    print(json.dumps({**svc.stats(), "seconds": time.perf_counter() - t0}, indent=2))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
