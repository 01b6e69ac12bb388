"""Fleet router CLI of the PyTorch port: one front door over N
``raft-serve-torch`` replicas (``python -m raft_stereo_tpu_torch.cli.route``).
The JAX package's router CLI: every flag under the same name and
default.  The router is host code and holds no CUDA context; the card
belongs to the replicas.

    # three replicas on one host (each boots warm from the shared
    # artifact store tools/compile_farm.py populated)
    raft-serve-torch --restore_ckpt ckpt --port 8551 --executable_cache_dir /shared/store ... &
    raft-serve-torch --restore_ckpt ckpt --port 8552 --executable_cache_dir /shared/store ... &
    raft-serve-torch --restore_ckpt ckpt --port 8553 --executable_cache_dir /shared/store ... &

    raft-route-torch --port 8550 \\
        --replica http://127.0.0.1:8551 \\
        --replica http://127.0.0.1:8552 \\
        --replica http://127.0.0.1:8553

    # clients talk to the router exactly like a single replica:
    curl -s -X POST --data-binary @pair.npz \\
        http://127.0.0.1:8550/v1/disparity > disp.npy
    curl -s http://127.0.0.1:8550/fleet | python -m json.tool

Stateless requests balance by measured queue depth; streaming sessions
consistent-hash to one replica (sticky warm-start state); a dead replica
is failed over in one health-poll interval — stateless traffic reroutes
transparently, its sessions fail typed (410 ``session_lost``) and
reseed cold on survivors.  A GRACEFULLY draining replica (SIGTERM /
rolling restart) instead hands its sessions off through the artifact
store — zero 410s, warm first frames on the survivors.

High availability (round 18): run TWO routers over one shared ledger
directory (inside the artifact store) — the standby serves traffic the
whole time and takes over the replicated lost-session/handoff ledger
when the primary dies::

    raft-route-torch --port 8550 --ha_dir /shared/store/fleet --name rt-a ...
    raft-route-torch --port 8560 --ha_dir /shared/store/fleet --name rt-b \\
        --standby --peer http://127.0.0.1:8550 ...

Autoscaling: give the router a replica launch template and bounds, and
it scales the fleet on the aggregate pressure signal (scale-down always
drains — never kills)::

    raft-route-torch ... --autoscale_cmd \\
        "python -m raft_stereo_tpu_torch.cli.serve --restore_ckpt ckpt \\
         --port {port} --executable_cache_dir /shared/store --sessions" \\
        --autoscale_max 6

Canary rollout (round 21): after registering a new model version on the
replicas (``POST /admin/models``), split a deterministic fraction of
stateless traffic onto it — sessions never split — with shadow
mirroring and auto-demotion on sustained regression::

    raft-route-torch ... --canary kitti@v2=0.05 --canary_shadow 0.1

Fleet observability (round 23): sample end-to-end traces across the
router hop, scrape every replica into one federated ``/metrics/fleet``,
and page on SLO error-budget burn with a coordinated flight-recorder
dump::

    raft-route-torch ... --trace_sample_rate 0.1 --slo_ms 250 \\
        --slo_availability 0.999 --flight_recorder_dir /var/log/fleet

    curl -s "http://127.0.0.1:8550/debug/spans?trace=<X-Trace-Id>" \\
        | python -m json.tool     # merged router + replica timeline
    curl -s http://127.0.0.1:8550/metrics/fleet | grep replica=

See docs/architecture.md §Fleet / §Multi-model and the README runbooks
"a replica died", "roll a replica without dropping streams", "the
router died", "roll out a new checkpoint".
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from raft_stereo_tpu_torch.cli import common

log = logging.getLogger(__name__)


def parse_canary(spec):
    """``model@version=FRACTION`` -> ("model@version", fraction)."""
    if spec is None:
        return None
    coord, _, frac = spec.rpartition("=")
    if not coord or not frac:
        raise argparse.ArgumentTypeError(
            f"{spec!r}: expected model@version=FRACTION, e.g. "
            f"kitti@v2=0.05")
    try:
        fraction = float(frac)
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            f"{spec!r}: fraction {frac!r} is not a number") from e
    if not 0.0 <= fraction <= 1.0:
        raise argparse.ArgumentTypeError(
            f"{spec!r}: fraction {fraction} not in [0, 1]")
    return coord, fraction


def build_router(args):
    from raft_stereo_tpu_torch.serving.fleet import FleetRouter, RouterConfig

    replicas = {}
    for i, url in enumerate(args.replica):
        name = f"r{i}"
        if "=" in url.split("//", 1)[0]:    # "name=http://host:port"
            name, url = url.split("=", 1)
        replicas[name] = url
    cfg = RouterConfig(
        health_poll_s=args.health_poll_s,
        health_timeout_s=args.health_timeout_s,
        fail_after=args.fail_after,
        request_timeout_s=args.request_timeout_s,
        route_retries=args.route_retries,
        fleet_brownout=args.fleet_brownout,
        brownout_engage_fraction=args.brownout_engage_fraction,
        brownout_restore_fraction=args.brownout_restore_fraction,
        brownout_max_level=args.brownout_max_level,
        session_lost_cap=args.session_lost_cap,
        ha_dir=args.ha_dir,
        router_name=args.name,
        standby=args.standby,
        lease_ttl_s=args.lease_ttl_s,
        peer_url=args.peer,
        trace_sample_rate=args.trace_sample_rate,
        slo_ms=args.slo_ms,
        slo_availability=args.slo_availability,
        slo_fast_burn=args.slo_fast_burn,
        slo_slow_burn=args.slo_slow_burn,
        federation_poll_s=args.federation_poll_s,
        federation_timeout_s=args.federation_timeout_s,
        federation_stale_s=args.federation_stale_s,
        flight_recorder_dir=args.flight_recorder_dir)
    router = FleetRouter(replicas, cfg)
    canary = parse_canary(args.canary)
    if canary is not None:
        router.rollout.set_canary(canary[0], canary[1],
                                  shadow_fraction=args.canary_shadow)
    return router


def build_autoscaler(args, router):
    """Optional pressure-driven autoscaler over a local-subprocess
    launcher (the k8s seam is the ReplicaLauncher interface)."""
    if not args.autoscale_cmd:
        return None
    from raft_stereo_tpu_torch.serving.fleet import (AutoscaleConfig, Autoscaler,
                                               LocalProcessLauncher,
                                               serve_argv_template)

    launcher = LocalProcessLauncher(
        serve_argv_template(args.autoscale_cmd),
        log_dir=args.autoscale_log_dir)
    cfg = AutoscaleConfig(
        min_replicas=args.autoscale_min,
        max_replicas=args.autoscale_max,
        engage_fraction=args.autoscale_engage_fraction,
        engage_s=args.autoscale_engage_s,
        restore_fraction=args.autoscale_restore_fraction,
        restore_s=args.autoscale_restore_s,
        cooldown_s=args.autoscale_cooldown_s)
    return Autoscaler(router, launcher, cfg)


def run_route(args) -> int:
    from raft_stereo_tpu_torch.serving.fleet import RouterHTTPServer

    router = build_router(args).start()
    autoscaler = build_autoscaler(args, router)
    if autoscaler is not None:
        autoscaler.start()
    server = RouterHTTPServer(router, host=args.host, port=args.port,
                              max_workers=args.http_workers)
    stop = threading.Event()

    def _graceful(signum, frame):
        log.warning("signal %d: stopping the router (replicas keep "
                    "running — they drain on their own SIGTERM)", signum)
        stop.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _graceful)

    status = router.fleet_status()
    log.info("routing on %s over %d replica(s), %d ready, role %s: %s",
             f"http://{args.host}:{args.port}", status["total"],
             status["ready"], status["role"],
             {n: r["url"] for n, r in status["replicas"].items()})
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if autoscaler is not None:
            autoscaler.stop()
            autoscaler.launcher.stop_all()
        router.stop()
        if not stop.is_set():
            server.shutdown()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--replica", action="append", required=True,
                   help="replica base URL (repeatable), e.g. "
                        "http://127.0.0.1:8551 or named "
                        "kitti0=http://10.0.0.5:8551")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8550)
    p.add_argument("--health_poll_s", type=float, default=0.25,
                   help="health-probe cadence per replica; the failover "
                        "detection window is fail_after x this")
    p.add_argument("--health_timeout_s", type=float, default=1.0,
                   help="per-probe transport timeout (a blackholed "
                        "health check counts as a failure after this)")
    p.add_argument("--fail_after", type=int, default=2,
                   help="consecutive failed probes before a replica "
                        "leaves rotation (forwarded-traffic transport "
                        "errors remove it immediately)")
    p.add_argument("--request_timeout_s", type=float, default=600.0,
                   help="forwarded-request timeout (covers first-request "
                        "compiles on replicas without prewarm)")
    p.add_argument("--route_retries", type=int, default=3,
                   help="stateless dispatch attempts across distinct "
                        "replicas before 503 no_replicas_ready "
                        "(sessions never retry: their state is sticky)")
    p.add_argument("--fleet_brownout",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="push a fleet-wide brownout floor to every "
                        "replica's /admin/brownout when the AGGREGATE "
                        "queued fraction sustains past the engage "
                        "watermark — the fleet degrades in lockstep "
                        "instead of flapping per replica")
    p.add_argument("--brownout_engage_fraction", type=float, default=0.75)
    p.add_argument("--brownout_restore_fraction", type=float,
                   default=0.25)
    p.add_argument("--brownout_max_level", type=int, default=2)
    p.add_argument("--session_lost_cap", type=int, default=4096,
                   help="capacity cap on the lost-session/handoff "
                        "ledgers (oldest owed 410s are forgotten past "
                        "this; fleet_lost_ledger_size tracks the size)")
    # HA pair (docs/architecture.md §Fleet, "Router HA").
    p.add_argument("--name", default="router",
                   help="this router's name in the shared lease/ledger")
    p.add_argument("--ha_dir", default=None,
                   help="shared lease + ledger directory for an HA "
                        "router pair (put it inside the artifact "
                        "store, e.g. /shared/store/fleet).  Unset: "
                        "single-router mode")
    p.add_argument("--standby", action="store_true",
                   help="start PASSIVE: serve traffic but hold no "
                        "lease; take over (bump the fencing epoch, "
                        "replay the ledger) when the primary's lease "
                        "goes stale or --peer stops answering")
    p.add_argument("--peer", default=None,
                   help="the primary router's URL (standby only): "
                        "probing it detects a kill -9 faster than "
                        "lease staleness alone")
    p.add_argument("--lease_ttl_s", type=float, default=3.0,
                   help="lease staleness window: the standby takes "
                        "over once the primary has not renewed for "
                        "this long")
    # Canary/shadow rollout (fleet/rollout.py).
    p.add_argument("--canary", default=None,
                   help="arm a canary split at boot: model@version="
                        "FRACTION, e.g. kitti@v2=0.05 routes 5%% of "
                        "stateless default-model traffic to the kitti "
                        "v2 registered model (deterministic body hash; "
                        "sessions never split).  Also drivable live via "
                        "POST /admin/rollout")
    p.add_argument("--canary_shadow", type=float, default=0.0,
                   help="additionally mirror this fraction of BASELINE "
                        "requests to the canary fire-and-forget; the "
                        "answers are EPE-compared and dropped — the "
                        "regression signal for auto-demotion")
    # Autoscaling (fleet/autoscaler.py).
    p.add_argument("--autoscale_cmd", default=None,
                   help="enable pressure-driven autoscaling: a "
                        "raft-serve-torch command template with a {port} "
                        "placeholder (and optional {name}), e.g. "
                        "\"python -m raft_stereo_tpu_torch.cli.serve "
                        "--restore_ckpt ckpt --port {port} "
                        "--executable_cache_dir /shared/store "
                        "--sessions\".  Scale-down always drains "
                        "(session handoff), never kills")
    p.add_argument("--autoscale_min", type=int, default=1)
    p.add_argument("--autoscale_max", type=int, default=4)
    p.add_argument("--autoscale_engage_fraction", type=float,
                   default=0.6,
                   help="composite pressure (max of queued fraction, "
                        "normalized brownout level, deadline-miss "
                        "rate) that must sustain --autoscale_engage_s "
                        "to scale up")
    p.add_argument("--autoscale_engage_s", type=float, default=2.0)
    p.add_argument("--autoscale_restore_fraction", type=float,
                   default=0.15)
    p.add_argument("--autoscale_restore_s", type=float, default=10.0)
    p.add_argument("--autoscale_cooldown_s", type=float, default=5.0)
    p.add_argument("--autoscale_log_dir", default=None,
                   help="directory for launched replicas' logs")
    # Fleet observability (round 23): cross-process tracing, metrics
    # federation, SLO burn-rate alerting.
    p.add_argument("--trace_sample_rate", type=float, default=0.0,
                   help="fraction of routed requests to trace end to "
                        "end: the router opens a route.request span "
                        "tree and propagates a traceparent header so "
                        "the replica's serve.request becomes a child "
                        "of the SAME trace id (merged view: GET "
                        "/debug/spans?trace=<id>).  0 (default) keeps "
                        "forwarding byte-verbatim")
    p.add_argument("--slo_ms", type=float, default=None,
                   help="latency SLO threshold: router-observed "
                        "end-to-end latencies past this count against "
                        "the error budget (fleet_slo_slow_total)")
    p.add_argument("--slo_availability", type=float, default=0.999,
                   help="availability objective in (0,1); the error "
                        "BUDGET is 1 minus this, and burn rate is "
                        "bad-fraction / budget per window "
                        "(fleet_slo_burn_rate{window=5m|1h})")
    p.add_argument("--slo_fast_burn", type=float, default=14.4,
                   help="fast-window (5m) burn-rate page threshold; "
                        "both windows breaching trips the watchdog and "
                        "a coordinated fleet flight-recorder dump")
    p.add_argument("--slo_slow_burn", type=float, default=6.0,
                   help="slow-window (1h) burn-rate page threshold")
    p.add_argument("--federation_poll_s", type=float, default=5.0,
                   help="background scrape cadence for GET "
                        "/metrics/fleet (replica /metrics re-exposed "
                        "with a replica= label; render is cache-only)")
    p.add_argument("--federation_timeout_s", type=float, default=2.0,
                   help="per-replica scrape timeout: a replica dying "
                        "mid-scrape costs the poller one timeout, "
                        "never a client request")
    p.add_argument("--federation_stale_s", type=float, default=60.0,
                   help="age past which a dead replica's last-good "
                        "series vanish from /metrics/fleet (only the "
                        "fleet_federation_up 0 marker remains)")
    p.add_argument("--flight_recorder_dir", default=None,
                   help="enable the router flight recorder; an SLO "
                        "burn-rate page triggers a COORDINATED dump "
                        "(router bundle + every replica's "
                        "/debug/flightrecorder) manifested here under "
                        "one trigger trace id")
    p.add_argument("--http_workers", type=int, default=128,
                   help="router HTTP thread-pool size (bounded pool "
                        "replaces thread-per-connection; sized for the "
                        "10k-session load profile in bench_fleet.py)")
    return p


def main(argv=None):
    common.setup_logging()
    return run_route(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
