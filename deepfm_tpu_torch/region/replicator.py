"""Async cross-region manifest replication: behind, never torn (the
port's copy of ``deepfm_tpu/region/replicator.py``).

One home publish root (the single fenced writer: online/publisher.py,
elastic/mpmd.py) fans out to N region stores, so each region's serving
pool hot-reloads from a store in its own failure domain.  The replicator
tails the home root's committed versions (``list_versions``: manifest-
bearing only, so a publish mid-tail is picked up next pass, never read
half-done) and mirrors each into every region with the marker-last order
kept:

    1. mirror ``versions/<v>/`` (the artifact tree) into the region;
    2. then write ``MANIFEST-<v>.json``: the home bytes verbatim, one PUT
       on a store, tmp + rename on a filesystem.

A region is therefore behind the home root (replication lag, per region
in versions and seconds) but never torn: a reader resolving manifest-first
cannot see a version whose bytes are not all there.  A replicator killed
between steps 1 and 2 leaves an invisible orphan tree, which the next
incarnation's ``clean_orphans`` removes before mirroring resumes.

Every region mirror runs under a ``RetryPolicy`` and its own
``CircuitBreaker`` (utils/retry.py): a browned-out region store stops
being hammered and the others keep replicating.  Retention follows the
home root: a version the home writer retired is pruned manifest-first.

The manifest's ``extra["fence_token"]`` (the home writer's lease token) is
mirrored verbatim and surfaced as a per-region gauge.

Pure host code: no torch in this module (``audit_region_front``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time

from ..data.object_store import get_store, is_url
from ..obs import flight
from ..online.publisher import (
    ModelPublisher,
    _manifest_path,
    fetch_version,
    list_versions,
    read_manifest,
    version_location,
)
from ..utils.retry import CircuitBreaker, CircuitOpenError, RetryPolicy


def _read_manifest_bytes(root: str, version: int) -> bytes:
    """The home manifest VERBATIM — replication must not re-serialize
    (a byte-identical mirror keeps param_hash/fence audits trivially
    transitive)."""
    path = _manifest_path(root, version)
    if is_url(root):
        return get_store().get(path)
    with open(path, "rb") as f:
        return f.read()


def _write_manifest_bytes(root: str, version: int, data: bytes) -> None:
    """The region commit point: single PUT on a store, tmp+rename on a
    filesystem — atomic either way, and always AFTER the tree."""
    path = _manifest_path(root, version)
    if is_url(root):
        get_store().put(path, data)
        return
    os.makedirs(root, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _mirror_tree(local_src: str, region_root: str, version: int) -> None:
    dest = version_location(region_root, version)
    if is_url(region_root):
        # clear residue from a prior torn mirror of this version first:
        # a stale extra object mixed into the fresh tree would fail the
        # region reader's param-hash check forever
        get_store().delete_prefix(dest + "/")
        get_store().upload_tree(local_src, dest)
    else:
        shutil.rmtree(dest, ignore_errors=True)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copytree(local_src, dest)


class ManifestReplicator:
    """Tail one home publish root into N region stores, marker-last.

    ``regions`` maps region name → store root (dir or object URL).  One
    background thread (``start``/``stop``) or explicit ``run_once``
    passes; either way each pass mirrors every committed home version a
    region is missing, oldest first, and then prunes region versions the
    home root no longer commits (manifest-first, so a half-pruned
    version is invisible, never half-readable).

    ``on_artifact(region, version)`` is the chaos seam: called between
    the artifact mirror and the manifest write — a test that raises here
    IS the kill-between-steps fault."""

    def __init__(
        self,
        home_root: str,
        regions: dict[str, str],
        *,
        poll_interval_secs: float = 1.0,
        retry: RetryPolicy | None = None,
        registry=None,
        staging_dir: str | None = None,
        breaker_window: int = 8,
        breaker_threshold: float = 0.5,
        breaker_cooldown_secs: float = 5.0,
        on_artifact=None,
    ):
        if not regions:
            raise ValueError("a replicator needs at least one region")
        self.home_root = home_root
        self.regions = dict(regions)
        self.poll_interval_secs = float(poll_interval_secs)
        self.on_artifact = on_artifact
        self._retry = retry or RetryPolicy(
            max_attempts=3, base_delay_secs=0.1, max_delay_secs=1.0)
        self._staging = staging_dir or tempfile.mkdtemp(
            prefix="deepfm_region_staging_")
        self._breakers = {
            name: CircuitBreaker(
                window=breaker_window, failure_threshold=breaker_threshold,
                min_calls=2, cooldown_secs=breaker_cooldown_secs,
                name=f"region-replicate-{name}")
            for name in self.regions
        }
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cleaned = False
        # per-region progress (under _lock)
        self._state: dict[str, dict] = {
            name: {"version": 0, "fence_token": -1, "replicated": 0,
                   "errors": 0, "lag_versions": 0, "lag_secs": 0.0}
            for name in self.regions
        }
        self._metrics = None
        if registry is not None:
            self._metrics = {
                "lag_versions": registry.gauge(
                    "region_replication_lag_versions",
                    "committed home versions a region store is missing",
                    labels=("region",)),
                "lag_secs": registry.gauge(
                    "region_replication_lag_secs",
                    "age of the oldest home version a region is missing",
                    labels=("region",)),
                "fence": registry.gauge(
                    "region_fence_token",
                    "fence token of the region's newest mirrored manifest",
                    labels=("region",)),
                "version": registry.gauge(
                    "region_store_version",
                    "newest committed version in the region store",
                    labels=("region",)),
                "replicated": registry.counter(
                    "region_versions_replicated_total",
                    "versions mirrored into a region store",
                    labels=("region",)),
                "errors": registry.counter(
                    "region_replication_errors_total",
                    "failed region mirror attempts (post-retry)",
                    labels=("region",)),
            }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="region-replicator", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception as e:  # pragma: no cover - loop guard
                flight.record("region_replicator_error",
                              error=f"{type(e).__name__}: {e}")
            self._stop.wait(self.poll_interval_secs)

    # -- the pass ----------------------------------------------------------

    def clean_orphans(self) -> dict[str, list[int]]:
        """Startup-only, per region: delete ``versions/<v>/`` trees with
        no committed region manifest — residue of a replicator killed
        between artifact mirror and manifest mirror.  Single-writer per
        region store (one replicator incarnation), so an uncommitted
        tree at boot is guaranteed residue, never a mirror in flight."""
        removed: dict[str, list[int]] = {}
        for name, root in self.regions.items():
            try:
                orphans = ModelPublisher(
                    root, retry=self._retry).clean_orphans()
            except Exception as e:
                flight.record("region_orphan_clean_error", region=name,
                              error=f"{type(e).__name__}: {e}")
                continue
            if orphans:
                removed[name] = orphans
                flight.record("region_orphan_cleaned", region=name,
                              versions=orphans)
        self._cleaned = True
        return removed

    def run_once(self) -> dict:
        """One replication pass over every region; returns the per-region
        summary ``{region: {mirrored: [...], pruned: [...], lag_versions,
        open: bool}}``."""
        if not self._cleaned:
            self.clean_orphans()
        home_versions = list_versions(self.home_root)
        home_created: dict[int, float] = {}
        out: dict[str, dict] = {}
        for name, root in self.regions.items():
            breaker = self._breakers[name]
            row = {"mirrored": [], "pruned": [], "lag_versions": 0,
                   "open": False}
            if not breaker.allow():
                row["open"] = True
                row["lag_versions"] = len(home_versions)
                out[name] = row
                self._note(name, home_versions, home_created)
                continue
            try:
                have = set(list_versions(root))
            except Exception as e:
                breaker.record_failure()
                self._error(name, "list", e)
                out[name] = row
                continue
            for v in home_versions:
                if v in have:
                    continue
                try:
                    self._mirror_one(name, root, v)
                    breaker.record_success()
                    row["mirrored"].append(v)
                except Exception as e:
                    breaker.record_failure()
                    self._error(name, f"mirror v{v}", e)
                    break  # keep versions arriving in order per region
            # retention follows the home root: a version the home writer
            # retired is pruned here manifest-first (invisible, then gone)
            try:
                home_set = set(home_versions)
                for v in sorted(set(list_versions(root)) - home_set):
                    self._prune_one(root, v)
                    row["pruned"].append(v)
            except Exception as e:
                self._error(name, "prune", e)
            row["lag_versions"] = self._note(name, home_versions,
                                             home_created)
            out[name] = row
        return out

    def _mirror_one(self, name: str, root: str, version: int) -> None:
        manifest_bytes = _read_manifest_bytes(self.home_root, version)
        local_src = fetch_version(self.home_root, version, self._staging)

        def _attempt() -> None:
            _mirror_tree(local_src, root, version)
            if self.on_artifact is not None:
                self.on_artifact(name, version)  # the chaos seam
            _write_manifest_bytes(root, version, manifest_bytes)

        self._retry.call(_attempt)
        manifest = read_manifest(root, version)
        with self._lock:
            st = self._state[name]
            st["version"] = max(st["version"], version)
            st["fence_token"] = int(
                manifest.extra.get("fence_token", st["fence_token"]))
            st["replicated"] += 1
        if self._metrics is not None:
            self._metrics["replicated"].labels(name).inc()
            self._metrics["version"].labels(name).set(version)
            self._metrics["fence"].labels(name).set(
                self._state[name]["fence_token"])
        flight.record("region_version_replicated", region=name,
                      version=version,
                      fence_token=manifest.extra.get("fence_token"))

    def _prune_one(self, root: str, version: int) -> None:
        if is_url(root):
            get_store().delete(_manifest_path(root, version))
            get_store().delete_prefix(
                version_location(root, version) + "/")
        else:
            try:
                os.remove(_manifest_path(root, version))
            except FileNotFoundError:
                pass
            shutil.rmtree(version_location(root, version),
                          ignore_errors=True)

    def _error(self, name: str, what: str, e: Exception) -> None:
        with self._lock:
            self._state[name]["errors"] += 1
        if self._metrics is not None:
            self._metrics["errors"].labels(name).inc()
        kind = ("region_replication_open"
                if isinstance(e, CircuitOpenError)
                else "region_replication_error")
        flight.record(kind, region=name, what=what,
                      error=f"{type(e).__name__}: {e}")

    def _note(self, name: str, home_versions: list[int],
              home_created: dict[int, float]) -> int:
        """Refresh one region's lag gauges; returns lag in versions."""
        try:
            have = set(list_versions(self.regions[name]))
        # da:allow[swallowed-exception] a store that cannot list counts every home version as missing — the lag gauges carry the outage, and the mirror path records the error itself
        except Exception:
            have = set()
        missing = [v for v in home_versions if v not in have]
        lag_secs = 0.0
        if missing:
            v0 = missing[0]
            if v0 not in home_created:
                try:
                    home_created[v0] = read_manifest(
                        self.home_root, v0).created_unix
                # da:allow[swallowed-exception] lag-clock fallback: an unreadable home manifest pins this pass's lag at zero seconds; the next pass re-reads it
                except Exception:
                    home_created[v0] = time.time()
            lag_secs = max(0.0, time.time() - home_created[v0])
        with self._lock:
            st = self._state[name]
            st["lag_versions"] = len(missing)
            st["lag_secs"] = round(lag_secs, 3)
        if self._metrics is not None:
            self._metrics["lag_versions"].labels(name).set(len(missing))
            self._metrics["lag_secs"].labels(name).set(lag_secs)
        return len(missing)

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            state = {k: dict(v) for k, v in self._state.items()}
        for name, breaker in self._breakers.items():
            state[name]["breaker"] = breaker.status()["state"]
        return {"home_root": self.home_root, "regions": state}
