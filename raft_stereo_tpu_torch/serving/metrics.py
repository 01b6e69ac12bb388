"""Serving observability: the serving instrument set over the SHARED
registry (telemetry/registry.py).

The Counter/Gauge/Histogram/MetricsRegistry implementations live in
``raft_stereo_tpu_torch.telemetry.registry`` (one implementation the
training runtime and the serving engine share); this module re-exports
them.  ``ServingMetrics`` — the serving subsystem's standard instrument
set — lives here.

The JAX package's ``serving/metrics.py``, copied whole: the same
observations render byte-equal Prometheus text in both packages.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from raft_stereo_tpu_torch.telemetry.registry import (  # noqa: F401 — re-exports
    DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry)

__all__ = ["DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "ServingMetrics", "PADDING_WASTE_BUCKETS",
           "SEAM_EPE_BUCKETS"]

# Waste-fraction buckets for serve_padding_waste: fraction of dispatched
# pixels that were padding (0 = every pixel real).  KITTI's /32 pad wastes
# ~2.3% (375x1242 -> 384x1248); a stack-mode pow2 batch fill can waste up
# to ~50%, hence the wide top end.
PADDING_WASTE_BUCKETS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.15, 0.2,
                         0.3, 0.5, 0.75)

# GRU-iteration buckets for infer_gru_iters_used: trip counts, not
# seconds.  Covers the realtime depth (7), the accuracy depth (32), and
# headroom past it.
ITERS_USED_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

# Seam-error buckets for serve_tile_seam_epe: mean |Δdisparity| (px)
# between adjacent tiles' predictions on their overlap rows
# (serving/tiles.py).  Consistent tiles sit at ~0; values past ~1 px mean
# the halo is not carrying enough vertical context for this content.
SEAM_EPE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0)

# Inter-frame delta buckets for serve_session_frame_delta: mean
# |Δintensity| (0..255) between consecutive frames' thumbnails.  Video at
# normal motion sits in the low single digits; a hard scene cut jumps
# past the default 40-unit threshold, hence the wide top end.
FRAME_DELTA_BUCKETS = (0.5, 1, 2, 4, 8, 16, 32, 64, 128, 255)


class ServingMetrics:
    """The serving subsystem's standard instrument set, in one place so the
    batcher / workers / HTTP layer all record into the same names.

    Latency is split into the three legs the product-path profiling
    established as the interesting decomposition (PRODUCT_r03/r04,
    profiling.py): queue wait (admission -> device worker pickup), device
    time (dispatch -> outputs ready), and fetch (device->host transfer of
    the results).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 max_batch: int = 8):
        r = registry or MetricsRegistry()
        self.registry = r
        self.admitted = r.counter(
            "serve_requests_admitted_total", "requests accepted into the queue")
        self.rejected_queue_full = r.counter(
            "serve_requests_rejected_queue_full_total",
            "requests shed because the bounded queue was full")
        self.rejected_draining = r.counter(
            "serve_requests_rejected_draining_total",
            "requests refused while the service was draining")
        self.deadline_missed = r.counter(
            "serve_requests_deadline_missed_total",
            "requests dropped at dispatch because their deadline had passed")
        self.completed = r.counter(
            "serve_requests_completed_total", "requests answered successfully")
        self.failed = r.counter(
            "serve_requests_failed_total", "requests failed with an error")
        self.batches = r.counter(
            "serve_batches_total", "micro-batches dispatched to a device")
        self.queue_depth = r.gauge(
            "serve_queue_depth", "requests waiting in the batcher")
        self.inflight = r.gauge(
            "serve_inflight_requests", "requests on a device worker right now")
        self.batch_occupancy = r.histogram(
            "serve_batch_occupancy", "requests per dispatched micro-batch",
            buckets=tuple(range(1, max(2, max_batch) + 1)))
        self.queue_wait = r.histogram(
            "serve_queue_wait_seconds", "admission -> worker pickup")
        self.device_time = r.histogram(
            "serve_device_seconds",
            "forward dispatch -> outputs ready (advisory behind an async "
            "device tunnel, where readiness reports at dispatch — see "
            "profiling.py; the fetch leg below is always honest)")
        self.fetch_time = r.histogram(
            "serve_fetch_seconds", "device->host transfer of the results")
        self.total_latency = r.histogram(
            "serve_total_latency_seconds", "admission -> response ready")
        self.anomalies = r.counter(
            "serve_anomalies_total",
            "anomalies detected (queue saturation, deadline-miss rate)")
        # Resilience instruments (serving/engine.py supervised recovery +
        # serving/resilience.py): the failure story's audit trail — every
        # crashed dispatch must show up as retries that converge, a
        # poisoned request, or a breaker transition, never as silence.
        self.retries = r.counter(
            "serve_retries_total",
            "requests requeued after a crashed dispatch (each retry hop "
            "counts once)")
        self.worker_restarts = r.counter(
            "serve_worker_restarts_total",
            "device worker threads restarted by the engine supervisor "
            "after a dispatch crash")
        self.poisoned = r.counter(
            "serve_requests_poisoned_total",
            "requests failed with the typed RequestPoisoned after "
            "exhausting their dispatch attempts")
        self.degraded = r.counter(
            "serve_requests_degraded_total",
            "requests answered at a cheaper tier than requested "
            "(brownout degradation)")
        self.brownout_level = r.gauge(
            "serve_brownout_level",
            "current brownout degradation level (0 = off; each level "
            "pushes eligible requests one rung down the tier ladder)")
        self.compiles_cold = r.counter(
            "serve_compiles_cold_total",
            "serving executables built by XLA compilation (cold)")
        self.compiles_warm = r.counter(
            "serve_compiles_warm_total",
            "serving executables restored from the persistent disk "
            "cache (warm — no XLA compile paid)")
        self.persist_cache_bytes = r.gauge(
            "serve_persist_cache_bytes",
            "bytes of serialized executables in the persistent artifact "
            "store (post-GC; 0 without executable_cache_dir)")
        self._circuit_lock = threading.Lock()
        self._circuit_by_device: Dict[int, Gauge] = {}
        self._chaos_lock = threading.Lock()
        self._chaos_by_kind: Dict[str, Counter] = {}
        # Engine dispatch accounting: serve_batches_total counts device
        # dispatches (the "fewer dispatches than requests" batching win is
        # completed/batches), and the per-batch-size family shows which
        # bucket ladder rungs traffic actually exercises.
        self._dispatch_lock = threading.Lock()
        self._dispatch_by_size: Dict[int, Counter] = {}
        self.bucket_refinements = r.counter(
            "serve_bucket_refinements_total",
            "spatial buckets refined to a finer pad grid by the measured "
            "padding-waste feedback loop (adaptive_buckets)")
        # Padding-waste accounting (telemetry/costs.py motivates it): the
        # device runs padded shapes, so wasted pixels are wasted flops in
        # exact proportion — the /32 spatial pad plus stack mode's pow2
        # batch fill.  Complements serve_batch_occupancy (which only sees
        # request counts, not pixel geometry).
        self.padding_waste = r.histogram(
            "serve_padding_waste",
            "per-dispatch fraction of device pixels that were padding "
            "(spatial /32 pad + stack-mode pow2 batch fill)",
            buckets=PADDING_WASTE_BUCKETS)
        self.dispatched_flops = r.counter(
            "serve_dispatched_flops_total",
            "model FLOPs dispatched to the device (compiled-executable "
            "cost x dispatches; 0 without cost telemetry)")
        self.achieved_flops_per_s = r.gauge(
            "serve_achieved_flops_per_s",
            "dispatched FLOP/s over the rolling MFU window (0 without "
            "cost telemetry)")
        self.mfu = r.gauge(
            "serve_mfu",
            "model FLOP utilization: achieved FLOP/s / device peak (0 "
            "without cost telemetry or with an unknown peak)")
        # Streaming-session instruments (serving/sessions.py +
        # engine.submit_session): the warm-start story's audit trail —
        # how many streams are live, how their frames split warm vs cold,
        # and how temporally coherent the traffic actually is (the
        # inter-frame delta the scene-cut fallback gates on).
        self.sessions_active = r.gauge(
            "serve_sessions_active",
            "live streaming sessions holding warm-start state")
        self.sessions_created = r.counter(
            "serve_sessions_created_total", "streaming sessions opened")
        self.sessions_expired = r.counter(
            "serve_sessions_expired_total",
            "streaming sessions expired by the TTL sweep")
        self.sessions_evicted = r.counter(
            "serve_sessions_evicted_total",
            "streaming sessions evicted at LRU capacity")
        self.scene_cuts = r.counter(
            "serve_session_scene_cuts_total",
            "session frames that fell back to a cold start because the "
            "inter-frame delta check failed (scene cut)")
        self.session_reseeds = r.counter(
            "serve_session_reseeds_total",
            "session states dropped by the keyframe guard: a warm frame "
            "ran to the iteration cap without converging, so the next "
            "frame cold-starts (session_reseed_on_cap)")
        self.ctx_cache_hits = r.counter(
            "serve_session_ctx_cache_hits_total",
            "session frames served with the cached context bundle (the "
            "context encoder never ran — session_ctx_cache; the "
            "X-Ctx-Cached response header marks these)")
        self.sessions_exported = r.counter(
            "serve_sessions_exported_total",
            "streaming sessions serialized into a graceful-drain "
            "handoff blob (engine.publish_handoff — these streams move "
            "to a survivor instead of 410ing)")
        self.sessions_adopted = r.counter(
            "serve_sessions_adopted_total",
            "streaming sessions whose state was imported from another "
            "replica's handoff blob at the session's first frame here "
            "(X-Handoff-Artifact; the frame dispatches WARM)")
        # serve_handoff_import_skipped_total{reason=...}: a labeled
        # family (round 19) — "corrupt" entries failed their checksum /
        # parse; "config_mismatch" blobs carried another exec-config
        # fingerprint than this engine compiles (r18 follow-up: the
        # mismatch is TYPED, never a silent cold start).
        self._handoff_skip_lock = threading.Lock()
        self._handoff_skip_by_reason: Dict[str, Counter] = {}
        self.frame_delta = r.histogram(
            "serve_session_frame_delta",
            "mean |delta intensity| (0..255) between consecutive session "
            "frames' thumbnails — the scene-cut gate's input",
            buckets=FRAME_DELTA_BUCKETS)
        self._session_frame_lock = threading.Lock()
        self._session_frames_by_mode: Dict[str, Counter] = {}
        # Per-model request accounting (round 21 multi-model serving).
        # Lazily labeled like every family here: a single-model engine
        # never touches it, so its /metrics stay byte-identical.
        self._model_req_lock = threading.Lock()
        self._model_req_by_coord: Dict[Tuple[str, str], Counter] = {}
        self._bucket_lock = threading.Lock()
        self._bucket_px: Dict[str, Tuple[Counter, Counter]] = {}
        # Adaptive early-exit accounting (serving/engine.py per-tier
        # executables): the per-tier trip-count histogram family
        # infer_gru_iters_used{tier=...} and the iterations-saved counter
        # family — (configured depth - iters_used) summed over every
        # request, i.e. the GRU compute the convergence gate recovered.
        self._iters_lock = threading.Lock()
        self._iters_by_tier: Dict[str, Tuple[Histogram, Counter]] = {}
        # XL tier + tiling instruments (serving/engine.py xl mesh groups,
        # serving/tiles.py): how much big-image traffic runs sharded, how
        # much falls back to tiles, and what the tiles' measured seam
        # disagreement is.  The per-(mesh, bucket) HBM gauge family
        # surfaces the sharding win itself — per-device bytes from the xl
        # executable's memory_analysis, directly comparable to the solo
        # bucket's record in /debug/compiles.
        self.xl_dispatches = r.counter(
            "serve_xl_dispatches_total",
            "device-group dispatches of mesh-sharded xl bucket "
            "executables")
        self.tiled_requests = r.counter(
            "serve_tiled_requests_total",
            "requests answered by halo-overlap tiling (stitched from "
            "multiple bucket dispatches)")
        self.tile_seam_epe = r.histogram(
            "serve_tile_seam_epe",
            "mean |delta disparity| (px) between adjacent tiles' "
            "predictions on their overlap rows — the measured accuracy "
            "cost of tiling (serving/tiles.py)",
            buckets=SEAM_EPE_BUCKETS)
        self._xl_hbm_lock = threading.Lock()
        self._xl_hbm: Dict[Tuple[str, str], Gauge] = {}
        # EDF scheduler accounting (round 19, serving/batcher.py): how
        # often a pop deliberately held open to coalesce concurrent
        # sessions' frames.  The coalescing RESULT reads off the
        # existing serve_requests_completed_total / serve_batches_total
        # ratio (frames per dispatch).
        self.edf_slack_waits = r.counter(
            "serve_edf_slack_waits_total",
            "EDF pops that waited a bounded slack to coalesce "
            "deadline-carrying frames into a larger batch "
            "(edf_scheduler; 0 with the policy off)")
        self.last_batch_unix = r.gauge(
            "serve_last_batch_unix_seconds",
            "wall-clock time the last micro-batch finished (0 until one "
            "does)")
        self._age_lock = threading.Lock()
        self._last_batch_mono: Optional[float] = None

    def xl_hbm_gauge(self, mesh: str, bucket: str) -> Gauge:
        """``serve_xl_hbm_bytes{mesh=,bucket=}``: per-device HBM of one
        compiled xl bucket executable (CompileRecord.hbm_bytes — the
        ROWSGRU_MEMORY scaling claim, measured through the serving path).
        ``mesh`` is the compact spec label (``"rows4"``); the solo
        comparison row uses ``mesh="solo"``."""
        with self._xl_hbm_lock:
            g = self._xl_hbm.get((mesh, bucket))
            if g is None:
                g = self.registry.gauge(
                    "serve_xl_hbm_bytes",
                    "per-device HBM bytes of a compiled xl bucket "
                    "executable (memory_analysis via the compile-cost "
                    "registry; 0 when the analysis degraded)",
                    labels={"mesh": mesh, "bucket": bucket})
                self._xl_hbm[(mesh, bucket)] = g
        return g

    def circuit_gauge(self, device_index: int) -> Gauge:
        """The ``serve_circuit_state{device="N"}`` gauge for one device
        worker: 0 closed, 1 open (quarantined), 2 half-open (probing)."""
        with self._circuit_lock:
            g = self._circuit_by_device.get(device_index)
            if g is None:
                g = self.registry.gauge(
                    "serve_circuit_state",
                    "per-device circuit breaker state (0 closed, 1 open/"
                    "quarantined, 2 half-open/probing)",
                    labels={"device": str(device_index)})
                self._circuit_by_device[device_index] = g
        return g

    def observe_injected_fault(self, kind: str) -> None:
        """Count one injected chaos fault into the per-kind
        ``serve_chaos_injected_total`` family (serving/chaos.py wires
        this as the injector's observe hook)."""
        with self._chaos_lock:
            c = self._chaos_by_kind.get(kind)
            if c is None:
                c = self.registry.counter(
                    "serve_chaos_injected_total",
                    "faults injected by the chaos harness, by kind",
                    labels={"kind": kind})
                self._chaos_by_kind[kind] = c
        c.inc()

    def injected_faults(self, kind: str) -> int:
        with self._chaos_lock:
            c = self._chaos_by_kind.get(kind)
        return 0 if c is None else c.value

    def observe_dispatch(self, batch_size: int) -> None:
        """Record one device dispatch at ``batch_size`` occupancy: the
        batches counter, the occupancy histogram, and the per-size
        ``serve_dispatches_total{batch="N"}`` counter family."""
        self.batches.inc()
        self.batch_occupancy.observe(batch_size)
        with self._dispatch_lock:
            c = self._dispatch_by_size.get(batch_size)
            if c is None:
                c = self.registry.counter(
                    "serve_dispatches_total",
                    "device dispatches by batch-size bucket",
                    labels={"batch": str(batch_size)})
                self._dispatch_by_size[batch_size] = c
        c.inc()

    def observe_iters_used(self, tier: str, iters_used: int,
                           max_iters: int, n_requests: int = 1) -> None:
        """Record one dispatch's GRU trip count: the per-tier histogram
        gets one observation per dispatch, the saved counter accumulates
        (max_iters - iters_used) per REQUEST (the whole batch rode the
        worst member's depth)."""
        with self._iters_lock:
            pair = self._iters_by_tier.get(tier)
            if pair is None:
                labels = {"tier": tier}
                pair = (self.registry.histogram(
                            "infer_gru_iters_used",
                            "GRU iterations actually run per dispatch "
                            "(convergence-gated early exit; fixed-depth "
                            "tiers always report the configured depth)",
                            buckets=ITERS_USED_BUCKETS, labels=labels),
                        self.registry.counter(
                            "serve_gru_iters_saved_total",
                            "GRU iterations the early-exit gate skipped, "
                            "summed over requests (configured depth - "
                            "iters_used)", labels=labels))
                self._iters_by_tier[tier] = pair
        pair[0].observe(iters_used)
        pair[1].inc(max(0, max_iters - iters_used) * max(1, n_requests))

    def iters_used_stats(self, tier: str):
        """(histogram, saved-counter) for one tier, or None before its
        first dispatch — what the smoke/bench harnesses assert on."""
        with self._iters_lock:
            return self._iters_by_tier.get(tier)

    def observe_handoff_skip(self, reason: str, n: int = 1) -> None:
        """Count ``n`` handoff sessions skipped at import into the
        per-reason ``serve_handoff_import_skipped_total{reason=...}``
        family ("corrupt" | "config_mismatch")."""
        if n <= 0:
            return
        with self._handoff_skip_lock:
            c = self._handoff_skip_by_reason.get(reason)
            if c is None:
                c = self.registry.counter(
                    "serve_handoff_import_skipped_total",
                    "handoff sessions skipped at import, by reason "
                    "(corrupt = checksum/parse failure; config_mismatch "
                    "= the blob's exec-config fingerprint differs from "
                    "this engine's) — each degrades that session to a "
                    "cold start, never a crash",
                    labels={"reason": reason})
                self._handoff_skip_by_reason[reason] = c
        c.inc(n)

    def observe_model_request(self, model: str, version: str,
                              n_requests: int = 1) -> None:
        """Count ``n_requests`` completed requests against one registered
        model version (``serve_model_requests_total{model=,version=}``) —
        the canary/shadow rollout's per-version traffic signal.  Only
        NAMED models land here; the implicit constructor model keeps the
        pre-registry metric surface."""
        if n_requests <= 0:
            return
        with self._model_req_lock:
            c = self._model_req_by_coord.get((model, version))
            if c is None:
                c = self.registry.counter(
                    "serve_model_requests_total",
                    "completed requests by registered model version "
                    "(named models only; the implicit model is not "
                    "labeled)",
                    labels={"model": model, "version": version})
                self._model_req_by_coord[(model, version)] = c
        c.inc(n_requests)

    def model_requests(self, model: str, version: str) -> int:
        """Completed-request count for one model version (0 before the
        first) — what model_smoke asserts routing on."""
        with self._model_req_lock:
            c = self._model_req_by_coord.get((model, version))
        return 0 if c is None else c.value

    def handoff_skips(self, reason: str) -> int:
        """Skipped-session count for one reason (0 before the first)."""
        with self._handoff_skip_lock:
            c = self._handoff_skip_by_reason.get(reason)
        return 0 if c is None else c.value

    def observe_session_frame(self, mode: str) -> None:
        """Count one completed session frame into the per-mode
        ``serve_session_frames_total{mode="warm"|"cold"}`` family — the
        warm-vs-cold split the streaming smoke asserts on."""
        with self._session_frame_lock:
            c = self._session_frames_by_mode.get(mode)
            if c is None:
                c = self.registry.counter(
                    "serve_session_frames_total",
                    "streaming session frames served, by warm/cold start",
                    labels={"mode": mode})
                self._session_frames_by_mode[mode] = c
        c.inc()

    def session_frames(self, mode: str) -> int:
        """Completed session frames for one mode (0 before the first)."""
        with self._session_frame_lock:
            c = self._session_frames_by_mode.get(mode)
        return 0 if c is None else c.value

    def dispatches_at(self, batch_size: int) -> int:
        """Dispatch count for one batch-size bucket (0 if never used)."""
        with self._dispatch_lock:
            c = self._dispatch_by_size.get(batch_size)
        return 0 if c is None else c.value

    def observe_padding(self, bucket: Tuple[int, int], real_pixels: int,
                        dispatched_pixels: int) -> None:
        """Record one dispatch's pixel accounting: ``real_pixels`` the sum
        of un-padded image pixels in the batch, ``dispatched_pixels`` what
        the device actually ran (frames x padded H x padded W, including
        stack-mode batch fill).  Feeds the waste histogram and the
        per-bucket real/pad counter family."""
        if dispatched_pixels <= 0:
            return
        waste = max(0, dispatched_pixels - real_pixels)
        self.padding_waste.observe(waste / dispatched_pixels)
        label = f"{bucket[0]}x{bucket[1]}"
        with self._bucket_lock:
            pair = self._bucket_px.get(label)
            if pair is None:
                labels = {"bucket": label}
                pair = (self.registry.counter(
                            "serve_bucket_real_pixels_total",
                            "un-padded image pixels dispatched, by padded-"
                            "shape bucket", labels=labels),
                        self.registry.counter(
                            "serve_bucket_pad_pixels_total",
                            "padding pixels dispatched (pure waste), by "
                            "padded-shape bucket", labels=labels))
                self._bucket_px[label] = pair
        pair[0].inc(real_pixels)
        pair[1].inc(waste)

    def bucket_pixels(self) -> Dict[str, Dict[str, int]]:
        """Per-bucket pixel accounting snapshot: ``{"HxW": {"real_px": n,
        "pad_px": n}}`` — what bench_serve.py publishes next to the MFU
        numbers and what the waste feedback loop acts on."""
        with self._bucket_lock:
            return {label: {"real_px": pair[0].value,
                            "pad_px": pair[1].value}
                    for label, pair in self._bucket_px.items()}

    def note_batch_done(self) -> None:
        """Stamp micro-batch completion — the freshness signal behind
        ``/healthz``'s ``last_batch_age_s`` (a serving twin of the train
        loop's ``last_step_age_s``)."""
        self.last_batch_unix.set(time.time())
        with self._age_lock:
            self._last_batch_mono = time.monotonic()

    def last_batch_age_s(self) -> Optional[float]:
        """Seconds since the last micro-batch finished; None before the
        first one (an idle-from-boot service is not stale, it is idle)."""
        with self._age_lock:
            last = self._last_batch_mono
        return (round(time.monotonic() - last, 3)
                if last is not None else None)

    def render_text(self) -> str:
        return self.registry.render_text()
