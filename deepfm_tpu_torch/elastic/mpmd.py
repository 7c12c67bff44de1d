"""The trainer/publisher split, the publisher half (``--task_type
publish``): the port's counterpart of ``deepfm_tpu/elastic/mpmd.py``.

Publishing only consumes committed payloads, so it can run as a program
of its own: :class:`PayloadPublisher` tails the checkpoint root the
elastic trainer commits to (``elastic.publisher_split`` keeps the trainer
from publishing), reads each newly committed payload on the host and
publishes the versioned servable.  A publish-store outage then costs
freshness, never a train step.  The publisher holds its own lease (role
``publish``) and fencing token (elastic/coord.py): a publisher of an
older incarnation is refused by the root's fence.  At start it deletes
the version trees a killed predecessor left without a manifest
(``ModelPublisher.clean_orphans``).

The read needs no grid: :func:`read_payload_tree` loads ``state.pt`` and
joins the model's table rows from the step's ``rows-<i>.pt`` files in
offset order, and :func:`servable_from_payload` cuts the tables to the
true vocabulary as the trainer's inline publish does
(``spmd.servable_state_dict``), so the same committed step publishes the
same ``param_hash``.
"""

from __future__ import annotations

import os
import threading
import time

import torch

from ..checkpoint.ckpt import STATE_FILE
from ..core.config import Config
from ..data.object_store import is_url
from ..models.deepfm import fm_v_rows
from ..obs import flight as obs_flight
from ..obs.metrics import MetricsRegistry
from ..online.publisher import ModelPublisher, latest_manifest
from ..online.trainer import cursor_from_arrays
from ..train.step import LAZY_TABLE_KEYS
from ..utils.logging import MetricLogger
from .coord import CoordClient, CoordUnreachableError, Fence, LeaseExpired, StaleFencingTokenError


def committed_steps(model_dir: str) -> list[int]:
    """The committed steps of a local checkpoint root: a step directory is
    renamed into its numeric name only once complete."""
    try:
        names = os.listdir(model_dir)
    except FileNotFoundError:
        return []
    return sorted(int(n) for n in names if n.isdigit()
                  and os.path.exists(os.path.join(model_dir, n, STATE_FILE)))


def read_payload_tree(model_dir: str, step: int | None = None) -> tuple[int, dict]:
    """``(step, tree)`` of one committed payload read on the host: the
    ``state.pt`` tree with the model's tables joined whole from the row
    files of a grid commit.  ``step=None`` takes the newest step, falling
    back past an unreadable one."""
    steps = [step] if step is not None else sorted(committed_steps(model_dir), reverse=True)
    if not steps:
        raise FileNotFoundError(f"no committed payload in {model_dir}")
    last_err: Exception | None = None
    for s in steps:
        d = os.path.join(model_dir, str(s))
        try:
            tree = torch.load(os.path.join(d, STATE_FILE), map_location="cpu",
                              weights_only=True, mmap=True)
            if "rows" in tree:
                parts = [torch.load(os.path.join(d, e["file"]), map_location="cpu",
                                    weights_only=True, mmap=True)
                         for e in sorted(tree["rows"], key=lambda e: e["offset"])]
                model = dict(tree["model"])
                for k in LAZY_TABLE_KEYS:
                    if k in parts[0]["model"]:
                        model[k] = torch.cat([p["model"][k] for p in parts])
                tree = {**tree, "model": model}
            return s, tree
        except Exception as e:  # an unreadable step: the one before
            last_err = e
    raise RuntimeError(f"no readable payload among steps {steps}; last error: "
                       f"{type(last_err).__name__}: {last_err}") from last_err


def servable_from_payload(cfg: Config, tree: dict) -> tuple[dict, dict]:
    """``(state_dict, cursor)`` to publish: the model's tables cut to the
    true vocabulary, as the trainer's inline publish cuts them."""
    sd = dict(tree["model"])
    # every table the family has (DCN-v2: fm_v alone)
    for k, rows in (("fm_w", cfg.model.feature_size), ("fm_v", fm_v_rows(cfg.model))):
        if k in sd:
            sd[k] = sd[k][:rows]
    online = tree["online"]
    cursor = cursor_from_arrays(online["cursor_segment"].numpy(),
                                online["cursor_len"].numpy(), online["cursor_record"].numpy())
    return sd, {"segment": cursor.segment, "record": cursor.record}


class PayloadPublisher:
    """Tail ``run.model_dir`` for committed payloads and publish each
    newest one into ``run.servable_model_dir``.  A failed round is counted
    and retried at the next poll; an unreachable coordinator keeps the last
    token; an expired lease is re-acquired; a stale token (a newer
    publisher owns the root) stops the loop."""

    def __init__(self, cfg: Config, *, metrics: MetricsRegistry | None = None):
        if not cfg.run.model_dir:
            raise ValueError("publisher needs run.model_dir (the checkpoint root it tails)")
        if is_url(cfg.run.model_dir):
            raise ValueError(
                f"publisher cannot tail a remote model_dir ({cfg.run.model_dir!r}): run "
                f"the `--task_type publish` process beside the trainer's local checkpoint "
                f"root (the publish root may be remote)")
        if not cfg.run.servable_model_dir:
            raise ValueError("publisher needs run.servable_model_dir (the versioned "
                             "publish root)")
        self.cfg = cfg
        self.publisher = ModelPublisher(cfg.run.servable_model_dir,
                                        keep=max(2, cfg.run.keep_checkpoints),
                                        keep_window=cfg.regions.publish_keep_window)
        self._log = MetricLogger(log_steps=cfg.run.log_steps)
        self._client: CoordClient | None = None
        if cfg.elastic.coordinator_url:
            self._client = CoordClient(cfg.elastic.coordinator_url, f"pub-{os.getpid()}",
                                       role="publish", lease_ttl_secs=cfg.elastic.lease_ttl_secs)
        m = metrics or MetricsRegistry()
        self.metrics = m
        self._m_published = m.counter("deepfm_publisher_published_total", "versions published")
        self._m_failures = m.counter("deepfm_publisher_failures_total",
                                     "publish rounds that failed after retries")
        self._m_fence_refused = m.counter("deepfm_publisher_fence_refused_total",
                                          "publishes refused by a stale fencing token")
        self._m_orphans = m.counter("deepfm_publisher_orphans_cleaned_total",
                                    "orphaned version prefixes removed at startup")
        self._m_lag = m.gauge("deepfm_publisher_lag_steps",
                              "newest committed step minus newest published step")
        self._hb_interval = cfg.elastic.heartbeat_interval_secs
        self._last_hb = -float("inf")
        # each publish's (step, seconds from its commit's rename to its manifest)
        self.lag_s: list[tuple[int, float]] = []

    def metrics_snapshot(self) -> dict:
        return {"published": int(self._m_published.value),
                "failures": int(self._m_failures.value),
                "fence_refused": int(self._m_fence_refused.value),
                "orphans_cleaned": int(self._m_orphans.value),
                "lag_steps": int(self._m_lag.value)}

    def _fence(self) -> Fence | None:
        if self._client is None or not self._client.token:
            return None
        return Fence(self.cfg.run.servable_model_dir, self._client.token,
                     holder=self._client.pid)

    def _lease_tick(self) -> None:
        """Acquire or refresh the publish lease; a new token takes the
        root's fence."""
        if self._client is None:
            return
        now = time.monotonic()
        if now - self._last_hb < self._hb_interval:
            return
        self._last_hb = now
        prev = self._client.token
        try:
            if self._client.lease_id is None:
                self._client.acquire()
            else:
                self._client.heartbeat()
            self._hb_interval = self._client.clamp_interval(
                self._hb_interval, event="publisher_heartbeat_clamped")
        except LeaseExpired:
            self._client.lease_id = None
            obs_flight.record("publisher_self_fenced", subsystem="elastic",
                              pid=self._client.pid)
            return
        except CoordUnreachableError:
            return
        if self._client.token != prev:
            fence = self._fence()
            if fence is not None:
                try:
                    fence.advance()
                except StaleFencingTokenError:
                    self._m_fence_refused.inc()

    def publish_once(self) -> int | None:
        """Publish the newest committed payload if it is newer than the
        newest published version; returns its step, or None."""
        model_dir = self.cfg.run.model_dir
        steps = committed_steps(model_dir)
        if not steps:
            return None
        manifest = latest_manifest(self.cfg.run.servable_model_dir)
        published = manifest.step if manifest is not None else -1
        self._m_lag.set(max(0, steps[-1] - published))
        if steps[-1] <= published:
            return None
        step, tree = read_payload_tree(model_dir)
        if step <= published:
            return None
        sd, cursor = servable_from_payload(self.cfg, tree)
        manifest = self.publisher.publish(
            self.cfg, sd, step=step, cursor=cursor,
            extra={"mpmd": {"publisher_pid": os.getpid(), "payload_fence_token":
                            int(tree["online"]["fence_token"])}},
            fence=self._fence())
        committed = os.path.getmtime(os.path.join(model_dir, str(step), STATE_FILE))
        self.lag_s.append((step, time.time() - committed))
        self._m_published.inc()
        self._m_lag.set(0)
        self._log.event("publish", version=manifest.version, step=manifest.step,
                        param_hash=manifest.param_hash[:12], lag_s=self.lag_s[-1][1])
        return step

    def run(self, *, stop: threading.Event | None = None, idle_timeout_secs: float = 0.0,
            max_publishes: int = 0) -> int:
        """Tail and publish until ``stop``, ``idle_timeout_secs`` without a
        new commit (counted from the first commit), or ``max_publishes``;
        returns the versions published."""
        removed = self.publisher.clean_orphans()
        if removed:
            self._m_orphans.inc(len(removed))
            self._log.event("orphans_cleaned", versions=removed)
            obs_flight.record("publisher_orphans_cleaned", subsystem="elastic",
                              versions=removed)
        published = 0
        last_progress: float | None = None
        poll = self.cfg.elastic.publish_poll_secs
        while stop is None or not stop.is_set():
            self._lease_tick()
            if last_progress is None and committed_steps(self.cfg.run.model_dir):
                last_progress = time.monotonic()
            try:
                step = self.publish_once()
            except StaleFencingTokenError:
                self._m_fence_refused.inc()
                self._log.event("fenced_out")
                obs_flight.record("publisher_fenced_out", subsystem="elastic")
                break
            except Exception as e:
                self._m_failures.inc()
                obs_flight.record("publisher_round_failed", subsystem="elastic",
                                  error=f"{type(e).__name__}: {e}"[:200])
                step = None
            if step is not None:
                published += 1
                last_progress = time.monotonic()
                if max_publishes and published >= max_publishes:
                    break
            elif idle_timeout_secs > 0 and last_progress is not None and (
                    time.monotonic() - last_progress >= idle_timeout_secs):
                break
            wait = poll if self._client is None else min(poll, self._hb_interval)
            if stop is not None:
                stop.wait(wait)
            else:
                time.sleep(wait)
        if self._client is not None:
            self._client.release()
        self._log.event("publisher_done", published=published,
                        fence_refused=int(self._m_fence_refused.value))
        return published


def run_publisher(cfg: Config) -> int:
    """The ``publish`` task (launch/cli.py): stops on SIGTERM/SIGINT or
    after ``run.online_idle_timeout_secs`` without a new commit (0: tail
    forever)."""
    import signal

    pub = PayloadPublisher(cfg)
    stop = threading.Event()
    restore: list[tuple] = []
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            restore.append((sig, signal.signal(sig, lambda *_: stop.set())))
    try:
        return pub.run(stop=stop, idle_timeout_secs=cfg.run.online_idle_timeout_secs)
    finally:
        for sig, prev in restore:
            signal.signal(sig, prev)
