"""The region layer's control process: the replicator and the front.

    python -m deepfm_tpu_torch.region \
        --home-root /path/to/publish \
        --regions '[{"name": "use1", "router_url": "http://...:8500",
                     "store_root": "/stores/use1"}, ...]' \
        --port 8400

Runs the async manifest replicator (home root -> every region store,
marker-last) and the front (home-region routing, the staleness drain,
budgeted failover) in one host-only process: no CUDA, no model bytes.
Each region's pool is its own ``deepfm_tpu_torch.serve.pool`` process
tree.  ``--task_type region-front`` (train/loop.py) builds the same
arguments from the ``regions`` config section.  SIGTERM or SIGINT stops
it cleanly (exit 0).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def _build(args):
    from ..obs.metrics import MetricsRegistry
    from .front import start_front
    from .replicator import ManifestReplicator

    regions = args.regions
    if isinstance(regions, str):
        regions = json.loads(regions)
    spec = {entry["name"]: {"router_url": entry["router_url"],
                            "store_root": entry.get("store_root", "")}
            for entry in regions}
    registry = MetricsRegistry()
    replicator = None
    stores = {name: s["store_root"] for name, s in spec.items() if s["store_root"]}
    if args.home_root and stores:
        replicator = ManifestReplicator(args.home_root, stores,
                                        poll_interval_secs=args.replication_poll,
                                        registry=registry)
        replicator.start()
    httpd, base_url, front = start_front(
        spec, host=args.host, port=args.port, home_root=args.home_root,
        max_version_skew=args.max_version_skew,
        readmit_version_skew=args.readmit_version_skew,
        probe_interval_secs=args.probe_interval, eject_after=args.eject_after,
        failover_budget_pct=args.failover_budget_pct, registry=registry)
    return httpd, base_url, front, replicator


def _serve(args) -> None:
    """Build, announce, and block until SIGTERM or SIGINT, then stop the
    front and the replicator."""

    def _terminate(*_):
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _terminate)
    httpd, base_url, front, replicator = _build(args)
    print(f"region front serving on {base_url}", file=sys.stderr, flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        front.close()
        if replicator is not None:
            replicator.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deepfm_tpu_torch.region",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--home-root", default="", help="home publish root the replicator tails")
    ap.add_argument("--regions", required=True,
                    help="JSON list of {name, router_url, store_root}")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--replication-poll", type=float, default=1.0)
    ap.add_argument("--probe-interval", type=float, default=1.0)
    ap.add_argument("--eject-after", type=int, default=2)
    ap.add_argument("--max-version-skew", type=int, default=2)
    ap.add_argument("--readmit-version-skew", type=int, default=0)
    ap.add_argument("--failover-budget-pct", type=float, default=10.0)
    _serve(ap.parse_args(argv))
    return 0


def run_from_config(cfg) -> None:
    """``task_type=region-front``: the same process, its arguments from the
    ``regions`` config section."""
    rc = cfg.regions
    _serve(argparse.Namespace(
        home_root=rc.home_root, regions=list(rc.regions), host=rc.front_host,
        port=rc.front_port, replication_poll=rc.replication_poll_secs,
        probe_interval=rc.probe_interval_secs, eject_after=rc.eject_after,
        max_version_skew=rc.max_version_skew,
        readmit_version_skew=rc.readmit_version_skew,
        failover_budget_pct=rc.failover_budget_pct))


if __name__ == "__main__":
    raise SystemExit(main())
