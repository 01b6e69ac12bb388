"""Stereo-depth serving CLI of the PyTorch port: a localhost HTTP API over
the batch-N serving engine on the card (serving/engine.py).

    python -m raft_stereo_tpu_torch.cli.serve \\
        --restore_ckpt models/raftstereo-realtime.pth \\
        --port 8551 --max_batch 8 --warmup_shape 375x1242

    # one request: left|right side-by-side PNG in, 16-bit disparity PNG out
    curl -s -X POST --data-binary @pair.png -H 'Content-Type: image/png' \\
        'http://127.0.0.1:8551/v1/disparity?format=png' > disp.png
    curl -s http://127.0.0.1:8551/metrics

    # a streaming session: POST frames in order, DELETE to close
    curl -s -X POST --data-binary @frame0.png -H 'Content-Type: image/png' \\
        'http://127.0.0.1:8551/v1/stream/cam0?format=png' > d0.png
    curl -s -X DELETE http://127.0.0.1:8551/v1/stream/cam0

The JAX package's ``raft-serve``: every flag of its parser under the same
name and default.  ``--xl_mesh`` serves the xl tier over groups of this
process's devices.  ``--sessions`` turns on streaming
sessions (warm start from the previous frame; ``--session_hidden``,
``--session_ctx_cache`` and the other session flags as in JAX).  The
engine is built from a port checkpoint directory or a reference ``.pth``
file, on the card unless
``--device cpu``.  The ``turbo`` tier (int8) fails the int8 drift gate in
both packages (ROADMAP §C7).

SIGTERM/SIGINT drain gracefully: /readyz flips to 503 first, new requests
shed typed while the HTTP server stays up, the live sessions are published
as a handoff blob (with ``--sessions`` and ``--executable_cache_dir``),
queued + in-flight + retry-backoff work finishes via engine.drain(), the
listener lingers up to ``--handoff_linger_s`` for a router to fetch
``/admin/handoff``, and only then does it close and the process exit.  A
second signal force-quits.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
import time

from raft_stereo_tpu_torch.cli import common

log = logging.getLogger(__name__)


def _parse_hw(text: str):
    try:
        h, w = text.lower().split("x")
        return (int(h), int(w))
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            f"{text!r}: expected HxW, e.g. 375x1242") from e


def build_serve_config(args):
    """The ``ServeConfig`` of the flags (raises for a refused one)."""
    from raft_stereo_tpu_torch.serving import ServeConfig, parse_chaos_spec

    tiers = tuple(t.strip() for t in (args.tiers or "").split(",")
                  if t.strip())
    exempt = tuple(t.strip() for t in (args.brownout_exempt or "").split(",")
                   if t.strip())
    return ServeConfig(
        max_batch=args.max_batch,
        batch_sizes=tuple(int(s) for s in args.batch_sizes.split(",")),
        max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        data_parallel=args.data_parallel, iters=args.valid_iters,
        tiers=tiers, default_tier=args.default_tier,
        shape_bucket=args.shape_bucket,
        adaptive_buckets=args.adaptive_buckets,
        max_padding_waste=args.max_padding_waste,
        fetch_dtype=args.fetch_dtype,
        default_deadline_ms=args.deadline_ms,
        trace_sample_rate=args.trace_sample_rate,
        cost_telemetry=args.cost_telemetry,
        device_peak_tflops=args.device_peak_tflops,
        chaos=parse_chaos_spec(args.chaos),
        max_dispatch_attempts=args.max_dispatch_attempts,
        retry_backoff_ms=args.retry_backoff_ms,
        breaker_failures=args.breaker_failures,
        breaker_cooldown_s=args.breaker_cooldown_s,
        brownout=args.brownout,
        brownout_exempt_tiers=exempt,
        confidence=args.confidence,
        confidence_floor=args.confidence_floor,
        quality_drift_threshold=args.quality_drift_threshold,
        quality_drift_reference=args.quality_drift_reference,
        quality_availability=args.quality_availability,
        brownout_spare_below=args.brownout_spare_below,
        cascade=args.cascade,
        cascade_draft=args.cascade_draft,
        cascade_escalate=args.cascade_escalate,
        cascade_threshold=args.cascade_threshold,
        executable_cache_dir=args.executable_cache_dir,
        executable_cache_max_bytes=args.executable_cache_max_bytes,
        executable_cache_read_only=args.executable_cache_read_only,
        sessions=args.sessions,
        session_ttl_s=args.session_ttl_s,
        session_capacity=args.session_capacity,
        scene_cut_threshold=args.scene_cut_threshold,
        session_ctx_cache=args.session_ctx_cache,
        ctx_cache_threshold=args.ctx_cache_threshold,
        session_hidden=args.session_hidden,
        edf_scheduler=args.edf_scheduler,
        edf_max_slack_ms=args.edf_max_slack_ms,
        quant_scales_path=args.quant_scales,
        xl_mesh=args.xl_mesh,
        xl_workers=args.xl_workers,
        xl_threshold_pixels=args.xl_threshold_pixels,
        xl_max_pixels=args.xl_max_pixels,
        xl_batch_sizes=tuple(int(s)
                             for s in args.xl_batch_sizes.split(",")),
        tile_threshold_pixels=args.tile_threshold_pixels,
        tile_rows=args.tile_rows,
        tile_halo=args.tile_halo,
        warmup_shapes=tuple(args.warmup_shape or ()),
        models=tuple(m.strip() for m in (args.models or "").split(",")
                     if m.strip()),
        model_store_dir=args.model_store_dir,
        default_model=args.default_model,
        prewarm_on_init=False)


def build_service(args):
    """The engine of the flags: ``ServeConfig`` first (so a refused flag
    raises before the checkpoint loads), then the checkpoint.
    ``warmup_shapes`` declares the readiness target, and
    ``prewarm_on_init=False`` leaves the warm-up to ``run_serve`` (after
    the event log is wired and the HTTP server is up)."""
    from raft_stereo_tpu_torch.serving import StereoService

    serve_cfg = build_serve_config(args)
    cfg, state = common.load_any_checkpoint(
        args.restore_ckpt, **common.arch_overrides(args))
    return StereoService(cfg, state, serve_cfg, device=args.device)


def build_observability(args, service):
    """Opt-in second observability layer: run-event log, flight recorder,
    and the serving anomaly watchdog, wired into the service's tracer +
    instrument registry.  Returns ``(events, recorder, watchdog)``, any of
    which may be None."""
    from raft_stereo_tpu_torch.telemetry import (AnomalySink, EventLog,
                                                 FlightRecorder,
                                                 ServingWatchdog)

    events = EventLog(args.event_log) if args.event_log else None
    recorder = None
    if args.event_log or args.watchdog or args.trace_sample_rate > 0:
        recorder = FlightRecorder(args.flight_recorder_dir,
                                  tracer=service.tracer,
                                  registry=service.metrics.registry)
        if events is not None:
            events.add_sink(recorder.record_event)
    watchdog = None
    if args.watchdog or events is not None or recorder is not None:
        sink = AnomalySink(events=events, recorder=recorder,
                           counter=service.metrics.anomalies)
        service.attach_anomaly_sink(sink)
        if args.watchdog:
            watchdog = ServingWatchdog(sink, service.metrics,
                                       max_queue=args.max_queue).start()
    if events is not None and service.costs is not None:
        # each program's first build becomes a "compile" run event
        service.costs.events = events
    return events, recorder, watchdog


def run_serve(args) -> int:
    from raft_stereo_tpu_torch.serving.http import StereoHTTPServer

    service = build_service(args)
    events, recorder, watchdog = build_observability(args, service)
    # The HTTP server comes up BEFORE prewarm: /healthz answers and
    # /readyz answers 503 "warming" during the warm-up.
    server = StereoHTTPServer(service, host=args.host, port=args.port,
                              recorder=recorder).start()
    t_warm = time.perf_counter()
    for hw in (args.warmup_shape or ()):
        service.prewarm(hw)
    if args.warmup_shape:
        log.info("prewarm done in %.1fs (%d programs built); /readyz now "
                 "reports ready", time.perf_counter() - t_warm,
                 service.metrics.compiles_cold.value)
    stop = threading.Event()
    forced = threading.Event()

    def _graceful(signum, frame):
        if stop.is_set():
            forced.set()  # second signal: skip the drain, hard-close
            raise KeyboardInterrupt(f"second signal {signum}: force quit")
        log.warning("signal %d: graceful shutdown — /readyz flips to 503, "
                    "new work is refused typed, and %d queued + in-flight "
                    "+ backoff request(s) drain before exit (send again to "
                    "force-quit)", signum, service.queue.depth)
        service.begin_shutdown()
        # Hand the live streams off: the export waits on each session's
        # ordering lock (in-flight frames fold their state in first),
        # publishes the blob into the shared artifact store, and
        # /admin/handoff starts answering the manifest.  On a thread: the
        # signal handler must return so the drain below can progress.
        if (service.sessions is not None
                and service.handoff_store is not None):
            threading.Thread(target=service.publish_handoff, daemon=True,
                             name="session-handoff").start()
        stop.set()

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _graceful)

    log.info("serving on %s (batch sizes %s, queue<=%d, %d device "
             "worker(s), %s buckets, tiers %s, sessions %s, xl %s)",
             server.url,
             service.queue.sizes, service.serve_cfg.max_queue,
             len(service.devices),
             "adaptive" if service.policy.adaptive else "static",
             (f"{sorted(service.tiers)} default={service.default_tier}"
              if service.tiers else "off"),
             (f"on (ttl {service.serve_cfg.session_ttl_s:.0f}s, "
              f"capacity {service.serve_cfg.session_capacity})"
              if service.sessions is not None else "off"),
             (f"{service.serve_cfg.xl_mesh} "
              f"(>{service.serve_cfg.xl_threshold_pixels}px)"
              if service.xl_enabled else "off"))
    try:
        while not stop.is_set() and server._thread.is_alive():
            server._thread.join(timeout=0.5)
    except KeyboardInterrupt:
        pass     # second signal: fall through to the forced path
    finally:
        if watchdog is not None:
            watchdog.stop()
        if forced.is_set():
            log.warning("force quit: dropping %d queued requests",
                        service.queue.depth)
            service.close()
        else:
            drained = service.drain(timeout=args.drain_timeout_s)
            log.info("drain %s; final metrics:\n%s",
                     "complete" if drained else
                     f"timed out after {args.drain_timeout_s:.0f}s",
                     service.metrics.render_text())
            # With a handoff published, keep the listener up until a
            # router fetched the manifest (bounded by --handoff_linger_s):
            # an instant exit would read as a crash to a router polling
            # for it.
            if (service.sessions is not None
                    and service.handoff_store is not None
                    and args.handoff_linger_s > 0):
                t_end = time.monotonic() + args.handoff_linger_s
                while (service.handoff_manifest is None
                       and time.monotonic() < t_end):
                    time.sleep(0.05)
                manifest = service.handoff_manifest
                if manifest is not None and manifest.get("count", 0):
                    fetched = service.wait_handoff_fetched(
                        args.handoff_linger_s)
                    log.info("handoff manifest %s by a router (lingered "
                             "<= %.1fs)",
                             "fetched" if fetched else "NEVER fetched",
                             args.handoff_linger_s)
        # Only now does the listener go away: every drained response has
        # been written.
        server.shutdown()
        if events is not None:
            events.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--restore_ckpt", required=True,
                   help=".pth file or port checkpoint directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8551)
    p.add_argument("--valid_iters", type=int, default=32,
                   help="GRU iterations per request (the depth CAP for "
                        "early-exit tiers)")
    p.add_argument("--tiers", default="interactive,balanced,quality",
                   help="comma list of latency tiers to serve: preset "
                        "names (interactive: exit once the mean "
                        "|Δdisparity| update < 0.05 px, min 2 iters; "
                        "balanced: < 0.01 px, min 3; quality: the fixed-"
                        "depth reference program; turbo: interactive's "
                        "exit knobs on the post-training int8 path — "
                        "quantized encoder weights + int8 correlation "
                        "pyramid, docs/architecture.md §Quantization) "
                        "and/or inline "
                        "'name:threshold_px[:min_iters[:quant]]' specs. "
                        "Each tier compiles its own bucket executables "
                        "(prewarm covers all of them) and requests pick "
                        "one via ?tier= or X-Tier; responses carry "
                        "X-Iters-Used.  Empty string disables tiers "
                        "(every request runs the fixed-depth program)")
    p.add_argument("--default_tier", default=None,
                   help="tier for requests that name none (default: "
                        "quality when configured, else the first tier) — "
                        "the out-of-the-box path stays the reference "
                        "fixed-depth program")
    p.add_argument("--max_batch", type=int, default=8,
                   help="occupancy ceiling per device dispatch")
    p.add_argument("--batch_sizes", default="1,2,4,8",
                   help="comma list of batch sizes compiled per shape "
                        "bucket (capped at max_batch; must include 1). "
                        "The scheduler dispatches the largest size the "
                        "queue depth fills and decomposes remainders — "
                        "the batch axis never carries filler frames")
    p.add_argument("--max_wait_ms", type=float, default=0.0,
                   help="RETIRED: continuous batching dispatches the "
                        "moment a worker is free; accepted and ignored")
    p.add_argument("--max_queue", type=int, default=64,
                   help="admission bound; beyond it requests get 429")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="device workers (each on its own local device)")
    p.add_argument("--shape_bucket", type=int, default=None,
                   help="pad to this static grid instead of /32 (coarser "
                        "buckets batch more shapes together per compile)")
    p.add_argument("--adaptive_buckets", action="store_true",
                   help="waste-driven bucket selection: shapes start at "
                        "the coarsest pad grid and a bucket is refined "
                        "toward /32 once its measured padding waste "
                        "exceeds --max_padding_waste")
    p.add_argument("--max_padding_waste", type=float, default=0.10,
                   help="adaptive-bucket refinement threshold: measured "
                        "waste fraction above which a coarse bucket is "
                        "split to the next finer grid")
    p.add_argument("--warmup_shape", type=_parse_hw, action="append",
                   help="raw HxW whose bucket ladder (all batch sizes) is "
                        "compiled at boot (repeatable), e.g. 375x1242 — "
                        "cold-start compiles move out of the first "
                        "requests' path")
    p.add_argument("--deadline_ms", type=float, default=None,
                   help="default per-request queue deadline (504 past it; "
                        "X-Deadline-Ms header overrides)")
    p.add_argument("--drain_timeout_s", type=float, default=30.0,
                   help="max seconds to finish queued work on SIGTERM")
    p.add_argument("--handoff_linger_s", type=float, default=5.0,
                   help="after a graceful drain published a session "
                        "handoff, keep the listener up to this many "
                        "seconds for a router to fetch /admin/handoff "
                        "(an instant drain must not close the port "
                        "before the router's next health poll); 0 "
                        "disables the linger")
    p.add_argument("--fetch_dtype", default=None,
                   choices=["fp16", "bf16"],
                   help="half-precision device->host disparity fetch "
                        "(halves the down-leg bytes; results stay f32)")
    # Observability layer 2 (telemetry/): all off by default.
    p.add_argument("--trace_sample_rate", type=float, default=0.0,
                   help="fraction of requests whose span tree (admission/"
                        "queue/dispatch/fetch/respond) is recorded and "
                        "served as Chrome trace JSON on GET /debug/spans; "
                        "0 (default) disables tracing")
    p.add_argument("--cost_telemetry", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="route worker compiles through the AOT path so "
                        "GET /debug/compiles lists each bucket "
                        "executable's flops/bytes/memory and the "
                        "serve_mfu gauge is live (telemetry/costs.py); "
                        "--no-cost_telemetry records nothing")
    p.add_argument("--device_peak_tflops", type=float, default=None,
                   help="peak TFLOP/s for the MFU denominator; default: "
                        "auto table keyed by the local device kind")
    p.add_argument("--event_log", default=None,
                   help="append structured JSONL run events (compiles "
                        "with cost summaries, anomalies) to this file")
    p.add_argument("--watchdog", action="store_true",
                   help="run the serving anomaly watchdog: queue "
                        "saturation and deadline-miss-rate detectors that "
                        "write a flight-recorder bundle on trigger")
    p.add_argument("--flight_recorder_dir", default="flightrecorder",
                   help="debug-bundle directory for the flight recorder "
                        "(span ring, /metrics snapshot, stack dump, "
                        "device memory)")
    p.add_argument("--executable_cache_dir", default=None,
                   help="persistent artifact store directory: the CUDA "
                        "kernel libraries nvcc builds are kept here keyed "
                        "by (source hash, flags, toolkit version, arch, "
                        "torch/CUDA/driver/device fingerprint), so a "
                        "restarted server builds no kernel (its CUDA "
                        "graphs are captured again: they cannot be "
                        "serialized).  May be a SHARED artifact store "
                        "(tools/compile_farm.py populates it once; every "
                        "replica boots from it); also holds the session "
                        "handoff's sessions/ namespace")
    p.add_argument("--executable_cache_max_bytes", type=int, default=None,
                   help="bound the artifact store: beyond this many "
                        "bytes the least-recently-used entries are "
                        "evicted (atime LRU) so toolkit / source churn "
                        "ages out instead of growing without bound; the "
                        "serve_persist_cache_bytes gauge tracks the total")
    p.add_argument("--executable_cache_read_only", action="store_true",
                   help="treat the executable cache as a read-only "
                        "shared artifact store: fetch warm executables "
                        "but never write (replicas against a fleet "
                        "store populated by tools/compile_farm.py)")
    # Multi-model registry (serving/models.py).
    p.add_argument("--models", default=None,
                   help="comma-separated registered model specs to load "
                        "at boot from the model store, each "
                        "name[@version] (bare name = latest published "
                        "version); requests pick one via ?model= / "
                        "X-Model, and POST /admin/models hot-swaps "
                        "more at runtime.  Unset: exactly today's "
                        "single-model server, byte-identical")
    p.add_argument("--model_store_dir", default=None,
                   help="model store root (the models/<name>/<version> "
                        "namespace; tools/publish_model.py populates "
                        "it).  Defaults to --executable_cache_dir — "
                        "weights and executables share one artifact "
                        "store")
    p.add_argument("--default_model", default=None,
                   help="registered model name that serves requests "
                        "naming NO model (must be in --models); unset: "
                        "the checkpoint from --restore_ckpt stays the "
                        "default")
    p.add_argument("--max_dispatch_attempts", type=int, default=2,
                   help="dispatch attempts per request before the typed "
                        "RequestPoisoned failure (crashed dispatches "
                        "requeue ahead of fresh work with exponential "
                        "backoff); 1 disables retries")
    p.add_argument("--retry_backoff_ms", type=float, default=20.0,
                   help="base requeue backoff after a crashed dispatch "
                        "(doubles per attempt)")
    p.add_argument("--breaker_failures", type=int, default=3,
                   help="consecutive dispatch failures that quarantine a "
                        "device worker (circuit breaker opens; a "
                        "half-open probe re-admits it after the "
                        "cooldown)")
    p.add_argument("--breaker_cooldown_s", type=float, default=1.0,
                   help="circuit-breaker open -> half-open cooldown")
    p.add_argument("--brownout", action="store_true",
                   help="degrade before shedding: under sustained queue "
                        "saturation / deadline misses, eligible requests "
                        "run one tier-ladder rung cheaper (X-Degraded "
                        "response header; X-No-Degrade opts a request "
                        "out) and restore with hysteresis; needs >= 2 "
                        "tiers")
    p.add_argument("--brownout_exempt", default=None,
                   help="comma list of tiers brownout must never "
                        "degrade (e.g. 'quality' for contractual full-"
                        "quality clients)")
    # Quality observability (round 24; telemetry/quality.py).
    p.add_argument("--confidence", action="store_true",
                   help="serve per-request confidence maps: every "
                        "answer derives a per-pixel confidence from the "
                        "refinement loop's own convergence signals "
                        "(X-Confidence header, ?format=npz/conf_png "
                        "payloads, serve_confidence histograms, the "
                        "quality SLO burn rate, and the PSI drift "
                        "watchdog); off keeps programs, cache keys and "
                        "wire bytes identical to the pre-confidence "
                        "build")
    p.add_argument("--confidence_floor", type=float, default=0.5,
                   help="mean confidence below which a request burns "
                        "quality SLO budget (serve_quality_bad_total)")
    p.add_argument("--quality_drift_threshold", type=float, default=0.25,
                   help="PSI threshold of the confidence drift watchdog "
                        "(0.25 = the classic 'act' band; one typed "
                        "quality_drift anomaly + flight-recorder bundle "
                        "per excursion)")
    p.add_argument("--quality_drift_reference", type=int, default=256,
                   help="requests that freeze the drift watchdog's "
                        "healthy reference distribution")
    p.add_argument("--quality_availability", type=float, default=0.99,
                   help="quality SLO objective: fraction of requests "
                        "that must meet the confidence floor (0.99 = "
                        "1%% low-confidence budget)")
    p.add_argument("--brownout_spare_below", type=float, default=0.0,
                   help="brownout victim selection: spare requests of "
                        "tiers whose rolling mean confidence is below "
                        "this (they already need the expensive "
                        "program); 0 keeps the unconditional ladder; "
                        "needs --confidence")
    p.add_argument("--cascade", action="store_true",
                   help="enable the ?tier=auto confidence-gated "
                        "cascade: requests draft on the cheapest tier "
                        "and re-run on the expensive one only when the "
                        "draft's mean confidence is below "
                        "--cascade_threshold (X-Escalated/X-Draft-Tier "
                        "provenance); needs --confidence and >= 2 tiers")
    p.add_argument("--cascade_draft", default=None,
                   help="cascade draft tier (default: the cheapest "
                        "rung of the cost ladder, e.g. turbo)")
    p.add_argument("--cascade_escalate", default=None,
                   help="cascade escalation tier (default: the most "
                        "expensive rung, e.g. quality)")
    p.add_argument("--cascade_threshold", type=float, default=0.5,
                   help="draft mean confidence below which the cascade "
                        "escalates")
    # Streaming sessions (warm-start video serving; serving/sessions.py).
    p.add_argument("--sessions", action="store_true",
                   help="enable streaming stereo sessions: POST "
                        "/v1/stream/<id> frames warm-start the GRU from "
                        "the session's previous disparity (with an "
                        "early-exit tier the convergence gate then stalls "
                        "in a fraction of the cold iterations); "
                        "DELETE /v1/stream/<id> closes a session")
    p.add_argument("--session_ttl_s", type=float, default=30.0,
                   help="idle seconds before a session expires (its next "
                        "frame gets the typed 410; the client must open "
                        "a fresh session)")
    p.add_argument("--session_capacity", type=int, default=256,
                   help="live-session ceiling; beyond it the least-"
                        "recently-used session is evicted (410 on its "
                        "next frame)")
    p.add_argument("--scene_cut_threshold", type=float, default=40.0,
                   help="scene-cut fallback: a frame whose mean "
                        "|delta-intensity| vs the previous frame exceeds "
                        "this (0..255) cold-starts instead of warm-"
                        "starting from a stale disparity; <= 0 disables "
                        "the check")
    p.add_argument("--session_ctx_cache", action="store_true",
                   help="per-session CONTEXT-feature cache (needs "
                        "--sessions): streams whose inter-frame delta "
                        "stays tiny reuse the session's cnet context "
                        "bundle instead of re-encoding it every frame "
                        "(X-Ctx-Cached response header; invalidated by "
                        "scene cuts and the keyframe guard).  "
                        "Unsupported with shared_backbone "
                        "architectures")
    p.add_argument("--ctx_cache_threshold", type=float, default=2.0,
                   help="mean inter-frame |delta-intensity| (0..255) at "
                        "or below which a warm frame may reuse the "
                        "cached context — the static-scene gate, far "
                        "below the scene-cut threshold by design")
    p.add_argument("--session_hidden", action="store_true",
                   help="hidden-state warm start (needs --sessions): "
                        "carry the multi-level GRU hidden state frame "
                        "to frame alongside the disparity, so warm "
                        "frames resume the GRU's own trajectory — the "
                        "warm-h executable families; lets the "
                        "convergence gate chain stably at tighter "
                        "thresholds than the flow-only warm start")
    p.add_argument("--edf_scheduler", action="store_true",
                   help="deadline-aware EDF pop policy: frames carrying "
                        "a per-frame deadline (X-Deadline-Ms) are "
                        "ordered earliest-deadline-first and an idle "
                        "worker waits a bounded slack to coalesce "
                        "concurrent streams' frames into one batch-N "
                        "dispatch.  Deadline-less requests keep the "
                        "immediate-pop behavior; off = the exact "
                        "continuous-batching scheduler")
    p.add_argument("--edf_max_slack_ms", type=float, default=50.0,
                   help="EDF coalescing bound: never hold a frame more "
                        "than this past its arrival (the nearest "
                        "deadline minus the bucket's measured dispatch "
                        "latency is always the harder bound)")
    # XL tier + tiling fallback (docs/architecture.md §Serving, "XL tier").
    p.add_argument("--xl_mesh", default=None,
                   help="serve an XL tier whose bucket programs run "
                        "context-parallel over a device group, e.g. "
                        "'rows=4' (image-row context parallelism through "
                        "the whole forward) or 'rows=2,corr=2' "
                        "(rows-sharded encoders x disparity-sharded "
                        "correlation volume).  One xl worker owns "
                        "rows*corr devices (allocated after the "
                        "--data_parallel solo workers); requests whose "
                        "padded bucket exceeds --xl_threshold_pixels (or "
                        "that pass ?tier=xl) run ONE sharded dispatch "
                        "instead of one device.  A replica with too few "
                        "devices for the mesh logs a typed skip and "
                        "serves without the tier")
    p.add_argument("--xl_workers", type=int, default=1,
                   help="independent xl device groups (each of "
                        "rows*corr devices)")
    p.add_argument("--xl_threshold_pixels", type=int, default=2_000_000,
                   help="padded-bucket pixel count above which requests "
                        "route to the xl family automatically")
    p.add_argument("--xl_max_pixels", type=int, default=None,
                   help="the mesh's own ceiling: buckets past this fall "
                        "through to halo-overlap tiling (size it from "
                        "the mesh's measured per-device memory); unset = "
                        "the mesh takes everything above the threshold")
    p.add_argument("--xl_batch_sizes", default="1",
                   help="comma list of batch sizes built per xl bucket "
                        "(default 1: megapixel pairs are latency-bound "
                        "and the mesh already uses the devices)")
    p.add_argument("--tile_threshold_pixels", type=int, default=None,
                   help="padded-bucket pixel count above which requests "
                        "that did not take the xl route are answered by "
                        "halo-overlap row tiling through the ordinary "
                        "batcher (tiles of one image batch together; "
                        "responses carry X-Tiles and the measured "
                        "X-Seam-EPE).  Unset: never tile")
    p.add_argument("--tile_rows", type=int, default=512,
                   help="owned rows per tile (each tile adds "
                        "2*--tile_halo context rows)")
    p.add_argument("--tile_halo", type=int, default=64,
                   help="overlap rows on each side of a tile — vertical "
                        "context for the encoders/GRU; the residual "
                        "tile disagreement is measured per request as "
                        "seam EPE (serve_tile_seam_epe)")
    p.add_argument("--quant_scales", default=None,
                   help="checkpoint-adjacent int8 calibration scale file "
                        "(quant/calibrate.py): int8 tiers (e.g. "
                        "'turbo') compile with the calibrated "
                        "percentile-clipped correlation scales instead "
                        "of dynamic in-graph max-abs scales")
    p.add_argument("--chaos", default=None,
                   help="FAULT INJECTION (testing only): comma key=value "
                        "spec, e.g. 'crash=0.1,seed=7' for a 10%% "
                        "injected worker-crash rate; keys crash/oom/"
                        "compile/latency (rates), latency_ms, seed, "
                        "max_faults, devices=0|1, plus the replica-"
                        "level faults die_after=N (kill -9 the process "
                        "at the Nth dispatch), blackhole_after_s "
                        "(healthz stops answering), slow_start_s "
                        "(readiness held closed).  Off when unset — "
                        "the dispatch path is bitwise-unchanged")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card); 'cpu' "
                        "runs the plain versions")
    common.add_arch_overrides(p)
    return p


def main(argv=None):
    common.setup_logging()
    return run_serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
