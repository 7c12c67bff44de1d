"""Run the router-fronted shard-group pool: the port's counterpart of
``python -m deepfm_tpu.serve.pool``.

    python -m deepfm_tpu_torch.serve.pool --servable D --router \
        --groups 2 --group-dp 1 --group-mp 2 --port 8500 \
        [--reload-url PUBLISH_ROOT] [--slo JSON [--autoscale]] \
        [--flywheel-log ROOT] [--device cpu]

The supervisor (this process) never initialises CUDA: it starts one
MEMBER PROCESS per shard-group (each a fresh interpreter running this
module with ``--member-entry``, which loads the row-sharded servable onto
its card, captures its bucket graphs and serves on ``member-port-base +
index``), runs the router front and, with ``--reload-url``, one
group-atomic :class:`~.swap.GroupSwapper` a group; with ``--slo`` group
bounds and ``--autoscale``, the autoscaler.

**Crash handling**: each member runs under ``utils/retry.py
run_with_restarts``: a dead member is started again after an
equal-jitter backoff, and the router keeps it ejected until its
``/readyz`` passes again; the swapper's repair brings it to the group's
version.  Each member prints its kernel runs as one JSON line at exit
(``serve/server.py report_kernel_counts_at_exit``).

All of a member's ``[dp, mp]`` shards sit on its one card; several
members share the card when the machine has one.  A member serves one
tenant: ``--tenants`` raises (ROADMAP A18).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading


def _parse_slo(arg: str):
    """Parse ``--slo``: inline JSON, or ``@path`` to a JSON file, with
    the keys of :class:`~...core.config.SloConfig`.  Unknown keys are an
    error here (operator CLI, not a forward-compatible config file)."""
    import dataclasses

    from ...core.config import SloConfig

    if not arg:
        return None
    text = arg
    if arg.startswith("@"):
        with open(arg[1:]) as f:
            text = f.read()
    d = json.loads(text)
    names = {f.name for f in dataclasses.fields(SloConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise SystemExit(
            f"--slo: unknown key(s) {unknown}; valid: {sorted(names)}"
        )
    return SloConfig(**d)


def _member_argv(args, group: str, index: int, port: int) -> list[str]:
    argv = [
        sys.executable, "-m", "deepfm_tpu_torch.serve.pool", "--member-entry",
        "--servable", args.servable, "--group", group,
        "--member-port", str(port),
        "--group-dp", str(args.group_dp), "--group-mp", str(args.group_mp),
        "--buckets", args.buckets, "--max-wait-ms", str(args.max_wait_ms),
        "--model-name", args.model_name, "--host", args.host,
        "--device", args.device,
    ]
    if args.exchange:
        argv += ["--exchange", args.exchange]
    if args.slo:
        argv += ["--slo", args.slo]
    if args.reload_url:
        argv += ["--reload-url", args.reload_url]
    if args.funnel_top_k:
        argv += ["--funnel-top-k", str(args.funnel_top_k)]
    if args.funnel_return_n:
        argv += ["--funnel-return-n", str(args.funnel_return_n)]
    if args.funnel_retrieval:
        argv += ["--funnel-retrieval", args.funnel_retrieval]
    if args.funnel_oversample:
        argv += ["--funnel-oversample", str(args.funnel_oversample)]
    if args.flight_dump:
        # one timeline file per process: members suffix their group name
        argv += ["--flight-dump", f"{args.flight_dump}.{group}"]
    return argv


def _supervise_member(args, group: str, index: int, port: int,
                      stop: threading.Event) -> None:
    """One member's crash-restart loop: spawn, wait, raise on abnormal
    exit, respawn under the bounded equal-jitter schedule."""
    from ...utils.retry import RetryPolicy, run_with_restarts

    def spawn_and_wait() -> None:
        if stop.is_set():
            return
        proc = subprocess.Popen(_member_argv(args, group, index, port))
        try:
            while proc.poll() is None:
                if stop.wait(0.5):
                    proc.terminate()
                    proc.wait(timeout=30)
                    return
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0 and not stop.is_set():
            raise RuntimeError(
                f"member {group} exited with status {proc.returncode}"
            )

    try:
        run_with_restarts(
            spawn_and_wait,
            max_restarts=args.max_restarts,
            policy=RetryPolicy(
                max_attempts=args.max_restarts + 1,
                base_delay_secs=args.restart_backoff_secs,
                max_delay_secs=8 * args.restart_backoff_secs,
                jitter="equal",
            ),
            on_restart=lambda n, e, d: print(
                f"pool: member {group} died ({e}); respawn {n}/"
                f"{args.max_restarts} in {d:.1f}s", file=sys.stderr,
            ),
        )
    except Exception as e:
        print(f"pool: member {group} restart budget exhausted: {e}",
              file=sys.stderr)


def _run_member(args) -> int:
    from ..server import report_kernel_counts_at_exit
    from .worker import serve_member

    # the supervisor stops members with SIGTERM: the kernel-runs line on
    # the way out
    report_kernel_counts_at_exit(f"member:{args.group}")
    if args.flight_dump:
        from ...obs import flight as obs_flight

        obs_flight.install(args.flight_dump)
        obs_flight.dump_on_signal()
    serve_member(
        args.servable, group=args.group,
        data_parallel=args.group_dp, model_parallel=max(1, args.group_mp),
        device=args.device, model_name=args.model_name, host=args.host,
        port=args.member_port,
        buckets=tuple(int(x) for x in args.buckets.split(",")),
        max_wait_ms=args.max_wait_ms,
        exchange=args.exchange or None,
        source=args.reload_url or None,
        funnel_top_k=args.funnel_top_k,
        funnel_return_n=args.funnel_return_n,
        funnel_retrieval=args.funnel_retrieval,
        funnel_oversample=args.funnel_oversample,
        slo=_parse_slo(args.slo),
    )
    return 0


def _start_autoscaler(args, slo, router, shutdown, state_lock, groups,
                      start_group, stop_group) -> threading.Thread:
    """The elastic shard-group control loop (the execution half of
    serve/control/autoscale.py): every second, fold the router's
    aggregate utilization + worst-group p95 into the AutoScaler; on
    "up", spawn a member, wait out its ``/readyz`` gate, admit it to the
    ring; on "down", stop admitting to the emptiest group, wait its
    in-flight to zero, terminate it.  Host threads over HTTP, outside
    every graph (analysis/trace_audit.py audit_control_plane)."""
    import time

    from ..control.autoscale import AutoScaler

    scaler = AutoScaler(
        min_groups=(slo.min_groups if slo else 1),
        max_groups=(slo.max_groups if slo else 4),
        up_util=(slo.scale_up_util if slo else 0.75),
        down_util=(slo.scale_down_util if slo else 0.25),
        slo_ms=(slo.deadline_ms if slo else 0.0),
        up_window_secs=(slo.scale_up_window_secs if slo else 5.0),
        down_window_secs=(slo.scale_down_window_secs if slo else 30.0),
        cooldown_secs=(slo.cooldown_secs if slo else 10.0),
    )
    largest = max(int(x) for x in args.buckets.split(","))

    def _ready(url: str, timeout_secs: float = 180.0) -> bool:
        import urllib.request

        deadline = time.monotonic() + timeout_secs
        while time.monotonic() < deadline and not shutdown.is_set():
            try:
                with urllib.request.urlopen(url + "/readyz",
                                            timeout=2) as r:
                    if json.load(r).get("ready"):
                        return True
            # refused or reset while the group warms up is the not-ready
            # signal; the deadline bounds the loop
            except Exception:
                pass
            time.sleep(0.5)
        return False

    def _scale_up() -> None:
        with state_lock:
            used = {st["index"] for st in groups.values()}
        index = next(i for i in range(4096) if i not in used)
        name = f"g{index}"
        url = start_group(name, index)
        # stage -> ready -> admit: the new group takes ZERO traffic
        # until its engine precompiled and weights loaded (/readyz)
        if not _ready(url):
            print(f"pool: scale-up {name} never became ready; "
                  f"tearing it back down", file=sys.stderr)
            stop_group(name)
            scaler.note_scaled(time.monotonic())
            return
        router.add_group(name, [url])
        print(f"pool: scaled UP: admitted {name} at {url}",
              file=sys.stderr)
        scaler.note_scaled(time.monotonic())

    def _scale_down() -> None:
        live = router.group_names()
        with state_lock:
            candidates = [g for g in live if g in groups]
        if len(candidates) <= 1:
            return
        # the emptiest group drains fastest (graceful degradation:
        # admitted work always finishes)
        victim = min(candidates, key=router.group_inflight)
        router.remove_group(victim)           # stop admitting
        deadline = time.monotonic() + 60.0
        while (router.group_inflight(victim) > 0
               and time.monotonic() < deadline):
            time.sleep(0.1)                   # wait out in-flight
        stop_group(victim)                    # terminate
        print(f"pool: scaled DOWN: drained and removed {victim}",
              file=sys.stderr)
        scaler.note_scaled(time.monotonic())

    def _loop() -> None:
        while not shutdown.wait(1.0):
            try:
                snap = router.metrics_snapshot()
                gs = snap["groups"]
                n = len(gs) or 1
                # utilization: router-tracked in-flight rows against the
                # pool's one-big-dispatch-per-group capacity proxy
                util = (sum(g["inflight_rows"] for g in gs.values())
                        / (n * largest))
                p95s = [(g.get("latency_ms") or {}).get("p95")
                        for g in gs.values()]
                p95s = [p for p in p95s if p is not None]
                action = scaler.observe(
                    time.monotonic(), groups=n, util=util,
                    p95_ms=max(p95s) if p95s else None,
                )
                if action == "up":
                    _scale_up()
                elif action == "down":
                    _scale_down()
            except Exception as e:
                # the control loop must outlive any one bad sample
                print(f"pool: autoscale loop error: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)

    t = threading.Thread(target=_loop, daemon=True, name="autoscaler")
    t.start()
    return t


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="deepfm-serve-pool", description=__doc__.splitlines()[0].rstrip(":")
    )
    ap.add_argument("--servable", required=True)
    ap.add_argument("--router", action="store_true",
                    help="run the consistent-hashing router front")
    ap.add_argument("--groups", type=int, default=1,
                    help="shard-group count (one member process each)")
    ap.add_argument("--group-dp", type=int, default=1,
                    help="data-parallel degree inside each group's mesh")
    ap.add_argument("--group-mp", type=int, default=0,
                    help="row shards of fm_w/fm_v inside each member, all on its "
                         "card (0 = 1)")
    ap.add_argument("--port", type=int, default=8500,
                    help="router bind port")
    ap.add_argument("--member-port-base", type=int, default=8601)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--model-name", default="deepfm")
    ap.add_argument("--buckets", default="8,32,128,512")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--exchange", default="",
                    help="psum|alltoall (default: the servable's shard_exchange; "
                         "'auto' = psum, the member's shards share one process)")
    ap.add_argument("--device", default="cuda",
                    help="the members' device: cuda (default) or cpu; the "
                         "supervisor and the router never touch CUDA")
    ap.add_argument("--reload-url", default="",
                    help="publish root: each group gets a group-atomic "
                         "swap coordinator polling it")
    ap.add_argument("--reload-interval", type=float, default=2.0)
    ap.add_argument("--tenants", default="",
                    help="multi-tenant fleets are ROADMAP A18: any value raises")
    ap.add_argument("--funnel-top-k", type=int, default=0,
                    help="funnel servables: candidates retrieved per user "
                         "(0 = the servable's funnel.json default)")
    ap.add_argument("--funnel-return-n", type=int, default=0,
                    help="funnel servables: ranked items returned per "
                         "user (0 = the servable's funnel.json default)")
    ap.add_argument("--funnel-retrieval", default="",
                    choices=("", "exact", "int8", "auto"),
                    help="funnel retrieval tier: exact | int8 (quantized "
                         "scoring + exact f32 rescore of the oversampled "
                         "shortlist) | auto; '' = the servable's "
                         "published retrieval section")
    ap.add_argument("--funnel-oversample", type=int, default=0,
                    help="int8 shortlist width multiplier "
                         "(0 = the servable's published value)")
    ap.add_argument("--funnel-pallas", default="",
                    choices=("", "on", "off", "auto"),
                    help="JAX's retrieval-kernel switch: validated; the port "
                         "always runs its own retrieval kernel (B2)")
    ap.add_argument(
        "--slo", default="",
        help="SLO control plane (serve/control/): inline JSON or @file "
             "with SloConfig keys (core/config.py): deadline_ms turns "
             "on deadline-aware admission at every member and arms "
             "router hedging; retry_budget_pct/hedge_budget_pct cap the "
             "retry/hedge token buckets; shed_*_util set the priority "
             "shed ladder; min/max_groups and scale_*_util bound the "
             "autoscaler",
    )
    ap.add_argument(
        "--autoscale", action="store_true",
        help="elastic shard-groups: watch router utilization + SLO "
             "attainment, spawn a group (stage -> /readyz -> admit) on "
             "sustained breach, drain the emptiest on sustained slack "
             "(bounded by --slo min_groups/max_groups; requires "
             "--router)",
    )
    ap.add_argument(
        "--flywheel-log", default="",
        help="data flywheel: arm the router-side impression logger "
             "(flywheel/impressions.py) writing scored impressions into "
             "this local segment-log root; the join reads it against a "
             "click log",
    )
    ap.add_argument("--flywheel-sample", type=float, default=1.0,
                    help="fraction of requests logged, hash-stable per "
                         "impression id (trace id, else routing key)")
    ap.add_argument("--flywheel-roll-bytes", type=int, default=1 << 20,
                    help="impression segment roll: size trigger")
    ap.add_argument("--flywheel-roll-age", type=float, default=10.0,
                    help="impression segment roll: age trigger seconds")
    ap.add_argument("--flywheel-queue", type=int, default=1024,
                    help="bounded impression queue; overflow drops "
                         "(counted), never blocks the serve path")
    ap.add_argument("--flywheel-join-out", default="",
                    help="the join service's output root: /v1/metrics "
                         "then reports its last committed checkpoint "
                         "(lag, pending window) next to the logger")
    ap.add_argument("--retry-limit", type=int, default=2)
    ap.add_argument("--eject-after", type=int, default=2)
    ap.add_argument("--health-interval", type=float, default=1.0)
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--restart-backoff-secs", type=float, default=1.0)
    ap.add_argument(
        "--flight-dump", default="",
        help="arm the flight-recorder termination dump (obs/flight.py): "
             "the supervisor/router writes this JSONL on shutdown or "
             "crash, each member writes <path>.<group> on SIGTERM; the "
             "live rings stay at GET /v1/flight",
    )
    # internal: the re-exec member entry
    ap.add_argument("--member-entry", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--group", default="g0", help=argparse.SUPPRESS)
    ap.add_argument("--member-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.member_entry:
        return _run_member(args)

    # SIGTERM must tear the whole tree down: without a handler the
    # supervisor dies on the signal's default action and the member
    # processes ORPHAN onto init, still serving (observed live) — route
    # it through the same cleanup path as ^C
    import signal

    def _terminate(*_):
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _terminate)

    if args.flight_dump:
        from ...obs import flight as obs_flight

        # SIGTERM raises KeyboardInterrupt (above) and unwinds through
        # the finally below, which dumps — so crash coverage (install's
        # excepthook) plus clean/killed shutdown both leave the timeline
        obs_flight.install(args.flight_dump)

    if args.tenants:
        from . import TENANTS_NOT_PORTED

        raise NotImplementedError(f"--tenants: {TENANTS_NOT_PORTED}")
    slo = _parse_slo(args.slo)
    if args.autoscale and not args.router:
        ap.error("--autoscale requires --router (the router aggregates "
                 "the utilization/SLO signal the scaler watches)")

    # per-group lifecycle state: the autoscaler stops ONE group's member
    # without touching its siblings, so each group owns its stop event,
    # supervisor thread and swap coordinators
    shutdown = threading.Event()
    state_lock = threading.Lock()
    groups: dict[str, dict] = {}

    def _start_swappers(g: str, url: str) -> list:
        if not args.reload_url:
            return []
        from .swap import GroupSwapper

        return [GroupSwapper([url], args.reload_url, group=g,
                             interval_secs=args.reload_interval).start()]

    def _start_group(g: str, index: int) -> str:
        """Spawn one supervised member process for group ``g``; returns
        its base URL (it is NOT ready yet — the member still has to load
        and precompile behind its /readyz gate)."""
        port = args.member_port_base + index
        stop = threading.Event()
        t = threading.Thread(
            target=_supervise_member, args=(args, g, index, port, stop),
            daemon=True, name=f"supervise-{g}",
        )
        t.start()
        url = f"http://{args.host}:{port}"
        with state_lock:
            groups[g] = {"stop": stop, "thread": t, "index": index,
                         "url": url, "swappers": _start_swappers(g, url)}
        return url

    def _stop_group(g: str) -> None:
        """Terminate one group's member process and coordinators (the
        caller already stopped admitting traffic and waited out the
        drain)."""
        with state_lock:
            st = groups.pop(g, None)
        if st is None:
            return
        for s in st["swappers"]:
            s.stop()
        st["stop"].set()
        st["thread"].join(timeout=40)

    for i in range(args.groups):
        _start_group(f"g{i}", i)
    with state_lock:
        urls = {g: [st["url"]] for g, st in groups.items()}
    print(f"pool: {args.groups} shard-group(s) at "
          f"{ {g: u[0] for g, u in urls.items()} }", file=sys.stderr)

    flywheel = None
    try:
        if args.router:
            from .router import Router, make_router_handler
            from ..server import ScoringHTTPServer

            registry = None
            # the SLO control plane (serve/control/): shared retry
            # budget, tail hedging (needs a deadline to define "tail"),
            # and the shadow shed gate — all off without --slo
            retry_budget = hedge = shed_gate = None
            if slo is not None:
                from ..control.admission import LoadShedGate
                from ..control.hedge import HedgeController, TokenBudget

                retry_budget = TokenBudget(slo.retry_budget_pct / 100.0)
                shed_gate = LoadShedGate()
                if slo.deadline_ms > 0:
                    hedge = HedgeController(
                        slo_budget_ms=slo.deadline_ms,
                        after_pct=slo.hedge_after_pct,
                        budget=TokenBudget(slo.hedge_budget_pct / 100.0),
                    )
            if args.flywheel_log:
                from ...flywheel.impressions import ImpressionLogger

                if registry is None:
                    from ...obs.metrics import MetricsRegistry

                    registry = MetricsRegistry()
                flywheel = ImpressionLogger(
                    args.flywheel_log,
                    sample_rate=args.flywheel_sample,
                    queue_depth=args.flywheel_queue,
                    roll_bytes=args.flywheel_roll_bytes,
                    roll_age_secs=args.flywheel_roll_age,
                    join_output_url=args.flywheel_join_out,
                    registry=registry,
                ).start()
            router = Router(
                urls, model_name=args.model_name,
                retry_limit=args.retry_limit,
                eject_after=args.eject_after,
                probe_interval_secs=args.health_interval,
                registry=registry,
                retry_budget=retry_budget, hedge=hedge,
                shed_gate=shed_gate, flywheel=flywheel,
            ).start()
            if args.autoscale:
                _start_autoscaler(args, slo, router, shutdown,
                                  state_lock, groups,
                                  _start_group, _stop_group)
            httpd = ScoringHTTPServer(
                (args.host, args.port), make_router_handler(router)
            )
            print(
                f"pool router: serving {args.model_name} on "
                f"http://{args.host}:{httpd.server_address[1]}"
                f"/v1/models/{args.model_name}:predict",
                file=sys.stderr,
            )
            httpd.serve_forever()
        else:
            threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        shutdown.set()
        if flywheel is not None:
            # drain the queue and publish the tail segment — the last
            # impressions before shutdown still reach the join
            flywheel.stop()
        # stop every group's member + coordinators: signal all first,
        # then join, so teardown is parallel not serial
        with state_lock:
            snapshot = list(groups.items())
        for _g, st in snapshot:
            for s in st["swappers"]:
                s.stop()
            st["stop"].set()
        for _g, st in snapshot:
            st["thread"].join(timeout=40)
        if args.flight_dump:
            from ...obs import flight as obs_flight

            obs_flight.get_recorder().dump(reason="shutdown")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
