"""Training-runtime instruments: step timing, memory, recompiles, GRU
convergence.

A run that silently rebuilds a program every step, stalls on the data
loader, or drifts in step time looks identical to a healthy one until it
is measured by hand.  ``TrainTelemetry`` gives the loop a scrapable
surface:

* per-step wall-time split — data-wait (host loader + prefetch queue),
  device-step (the dispatch leg; advisory behind asynchronous CUDA
  launches), metric-drain (the SUM_FREQ device fetch), checkpoint write;
* host RSS + device live/peak bytes (``profiling.device_memory_stats``),
  refreshed at the drain cadence — a host-side runtime query, not a device
  fetch;
* a recompile detector: the port's program builds (a kernel compiled by
  ``kernels/_build.py``, a CUDA-graph capture; ``profiling.note_build``)
  are counted when they happen inside a step-dispatch window AFTER step 1
  completed (step 1 builds the kernels; a validation between steps
  captures its graphs legitimately; a build inside a later step re-pays
  seconds of compile time), logged with the offending batch shapes, and
  mirrored into the event log;
* optional GRU convergence histograms (``observe_gru_deltas``): per-
  iteration disparity-delta magnitudes from ``TrainConfig.gru_telemetry``,
  so iteration-count choices follow an observed convergence curve instead
  of the paper's fixed 7/32.

EVERY method here is host-only: no ``.item()``, ``.cpu()``, ``float()``
of a device tensor or ``torch.cuda.synchronize()``.  The train loop
guards each call behind ``telemetry is not None``, so the disabled
(default) path is the loop without telemetry, bit for bit;
tests/test_torch_telemetry.py asserts the no-extra-fetch property.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, Iterable, Optional

from raft_stereo_tpu_torch.telemetry.events import EventLog
from raft_stereo_tpu_torch.telemetry.registry import (DEFAULT_LATENCY_BUCKETS,
                                                MetricsRegistry)
from raft_stereo_tpu_torch.telemetry.spans import SpanTracer
from raft_stereo_tpu_torch.telemetry.watchdog import AnomalySink, NonFiniteSentinel

log = logging.getLogger(__name__)

# The cost-registry key the train loop instruments its step under
# (training/train_loop.py) and the drain's MFU computation looks up.
TRAIN_STEP_COST_KEY = "train.step"

# Pixel-scale buckets for GRU disparity-delta magnitudes: sub-milli-px
# (converged) up to tens of px (early iterations at SceneFlow disparities).
GRU_DELTA_BUCKETS = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2,
                     0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0)

# --- process-global build-event dispatch -----------------------------------
# ONE module-level listener on ``profiling.note_build``, registered lazily
# and pointed at the active telemetry instance: tests that create many
# TrainTelemetry objects don't accumulate listeners, and a finished run
# simply detaches.
_dispatch_lock = threading.Lock()
_listener_registered = False
_active_detector: Optional["TrainTelemetry"] = None


def _on_build_event(event: str, duration_secs: float) -> None:
    det = _active_detector
    if det is not None:
        det._on_compile(event, duration_secs)


def _ensure_listener() -> bool:
    global _listener_registered
    with _dispatch_lock:
        if not _listener_registered:
            from raft_stereo_tpu_torch.profiling import add_build_listener
            add_build_listener(_on_build_event)
            _listener_registered = True
        return True


def _set_active_detector(det: Optional["TrainTelemetry"]) -> None:
    global _active_detector
    with _dispatch_lock:
        _active_detector = det


def host_rss_bytes() -> int:
    """Resident-set bytes of this process; 0 where /proc is unavailable."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import resource  # page size without shelling out
        return pages * resource.getpagesize()
    except Exception:
        try:
            import resource
            # ru_maxrss is KiB on Linux — peak, not current, but better
            # than nothing on non-/proc platforms.
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # pragma: no cover - no resource module
            return 0


class TrainTelemetry:
    """The training loop's instrument set + structured-event emitter.

    Construct one per run (``cli/train.py --metrics_port``), hand it to
    ``train(..., telemetry=...)``, and serve ``registry`` through a
    ``telemetry.http.TelemetryHTTPServer``.  ``events`` is an optional
    ``EventLog`` the lifecycle events mirror into.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 events: Optional[EventLog] = None,
                 tracer: Optional[SpanTracer] = None,
                 recorder=None, stall_watchdog=None, costs=None):
        r = registry or MetricsRegistry()
        self.registry = r
        self.events = events
        # Cost registry (telemetry/costs.py).  When set, the train loop
        # records its step's first dispatch (wall time, FLOPs, memory), and
        # the drain turns the recorded FLOPs into train_step_flops /
        # train_mfu below.  None (default) = the plain step.
        self.costs = costs
        # Span tracer (telemetry/spans.py): default sampling 0.0 — every
        # span site below takes the constant-time None exit.
        self.tracer = tracer if tracer is not None else SpanTracer(0.0)
        # Flight recorder + anomaly plumbing (telemetry/flight_recorder.py,
        # telemetry/watchdog.py).  The non-finite sentinel rides the
        # buffered metric drain — the means it inspects are ALREADY host
        # floats, so detection adds zero device fetches.
        self.recorder = recorder
        if recorder is not None and events is not None:
            events.add_sink(recorder.record_event)
        self.stall_watchdog = stall_watchdog
        self.anomaly_sink = AnomalySink(events=events, recorder=recorder)
        self.nonfinite = NonFiniteSentinel(self.anomaly_sink)
        self._trace = None  # the most recent sampled step's Trace
        self.steps = r.counter(
            "train_steps_total", "optimization steps completed this run")
        self.anomalies = r.counter(
            "train_anomalies_total",
            "anomalies detected (non-finite metrics, step stalls)")
        self.anomaly_sink.counter = self.anomalies
        self.recompiles = r.counter(
            "train_recompiles_total",
            "program builds (kernel compiles, CUDA-graph captures) inside "
            "a step AFTER step 1 (step 1 builds the kernels; later ones "
            "re-pay compile time)")
        self.checkpoints = r.counter(
            "train_checkpoints_total", "checkpoints written")
        self.step_gauge = r.gauge(
            "train_step", "current global step (includes restored steps)")
        self.last_step_unix = r.gauge(
            "train_last_step_unix_seconds",
            "wall-clock time the last step completed (0 until step 1)")
        self.images_per_s = r.gauge(
            "train_images_per_s", "throughput over the last drain window")
        self.host_rss = r.gauge(
            "train_host_rss_bytes", "resident-set bytes of the train process")
        self.device_bytes = r.gauge(
            "train_device_bytes_in_use",
            "live bytes on the card (0 on the CPU)")
        self.device_peak_bytes = r.gauge(
            "train_device_peak_bytes",
            "peak bytes on the card (0 on the CPU)")
        self.data_wait = r.histogram(
            "train_data_wait_seconds",
            "host wait for the next uploaded batch (loader + prefetch)")
        self.step_time = r.histogram(
            "train_step_seconds",
            "step dispatch leg (advisory behind asynchronous CUDA launches: "
            "the drain leg absorbs the device-bound tail)")
        self.drain_time = r.histogram(
            "train_metric_drain_seconds",
            "SUM_FREQ metric fetch: the one host<->device sync of the loop")
        self.checkpoint_time = r.histogram(
            "train_checkpoint_seconds", "checkpoint fetch + write",
            buckets=DEFAULT_LATENCY_BUCKETS)
        self.step_flops = r.gauge(
            "train_step_flops",
            "train-step FLOPs (telemetry/flops.py; 0 without cost "
            "telemetry)")
        self.achieved_flops_per_s = r.gauge(
            "train_achieved_flops_per_s",
            "step FLOPs x steps / wall time over the last drain window "
            "(0 without cost telemetry)")
        self.mfu = r.gauge(
            "train_mfu",
            "model FLOP utilization: achieved FLOP/s / device peak (0 "
            "without cost telemetry or with an unknown peak)")
        self.gru_delta = r.histogram(
            "train_gru_delta_px",
            "per-iteration |disparity update| means "
            "(TrainConfig.gru_telemetry; empty when disabled)",
            buckets=GRU_DELTA_BUCKETS)
        # --- Divergence-proof training (training/anomaly.py): every
        # anomaly-policy decision lands in a TYPED counter, so no skip is
        # silent.
        skip_help = ("optimizer updates dropped on device by the anomaly "
                     "policy (TrainConfig.anomaly_policy)")
        self.batches_skipped = {
            "nonfinite": r.counter("train_batches_skipped_total", skip_help,
                                   labels={"reason": "nonfinite"}),
            "spike": r.counter("train_batches_skipped_total", skip_help,
                               labels={"reason": "spike"})}
        self.rewinds = r.counter(
            "train_rewinds_total",
            "checkpoint rewinds after consecutive anomalous steps")
        self.checkpoints_rejected = r.counter(
            "train_checkpoints_rejected_total",
            "checkpoints skipped at restore for failing validation "
            "(torn, or SHA-256 manifest mismatch — bit rot / byte flip)")
        self.loader_retries = r.counter(
            "train_loader_sample_retries_total",
            "samples that raised once and decoded on retry")
        self.loader_quarantined = r.counter(
            "train_loader_samples_quarantined_total",
            "samples quarantined after a failed retry (substituted "
            "deterministically; persisted to the quarantine list)")
        self.loader_respawns = r.counter(
            "train_loader_worker_respawns_total",
            "dead loader worker pools respawned (in-flight batches "
            "resubmitted)")
        self._loader_stats_seen = {"retried": 0, "quarantined": 0,
                                   "worker_respawns": 0}

        self._lock = threading.Lock()
        self._status = "starting"
        self._total = 0
        self._batch_size = 0
        self._last_step_mono: Optional[float] = None
        self._last_drain_mono = time.monotonic()
        self._steps_at_last_drain = 0
        self._shapes: Optional[Dict[str, str]] = None
        self._step = 0
        self._armed = False
        self._in_step = False
        self._step_lock = threading.Lock()

    # ----------------------------------------------------------- lifecycle
    def run_start(self, model_cfg, train_cfg, start_step: int,
                  name: str = "") -> None:
        with self._lock:
            self._status = "running"
            self._step = start_step
            self._total = int(getattr(train_cfg, "num_steps", 0))
            self._batch_size = int(getattr(train_cfg, "batch_size", 0))
            self._steps_at_last_drain = start_step
            self._last_drain_mono = time.monotonic()
        self.step_gauge.set(start_step)
        if self.events is not None:
            from raft_stereo_tpu_torch.telemetry.events import run_metadata
            self.events.emit(
                "run_start", name=name, start_step=start_step,
                run=run_metadata(),
                model_config=_cfg_dict(model_cfg),
                train_config=_cfg_dict(train_cfg))

    def resumed(self, path: str, step: int) -> None:
        if self.events is not None:
            self.events.emit("resume", path=path, step=step)

    def note_batch(self, batch) -> None:
        """Shape/dtype summary of the batch about to step — metadata access
        only; attributes recompiles to the shapes that caused them.  Also
        opens the step-dispatch window the build detector listens in
        (graph captures of a validation between steps are legitimate) and
        holds the step boundary a trace window waits for
        (``step_boundary``)."""
        try:
            self._shapes = {k: f"{tuple(v.shape)}:{v.dtype}"
                            for k, v in batch.items()}
        except Exception:  # pragma: no cover - exotic batch container
            self._shapes = None
        self._step_lock.acquire()
        self._in_step = True

    def observe_step(self, step: int, data_wait_s: float,
                     dispatch_s: float) -> None:
        self._end_step()
        self.steps.inc()
        self.step_gauge.set(step)
        # Per-step trace (telemetry/spans.py), reconstructed RETROACTIVELY
        # from the durations the loop already clocked — sampling a step
        # adds span-object bookkeeping but no extra clock reads or fetches
        # in the loop itself, and sampling 0 (default) skips even that.
        trace = None
        if self.tracer.enabled:
            trace = self.tracer.start_trace()
            if trace is not None:
                t_end = time.perf_counter()
                t_dispatch = t_end - dispatch_s
                t_wait = t_dispatch - data_wait_s
                trace.root = self.tracer.add_span(
                    "train.step", trace, t_wait, t_end, step=step)
                self.tracer.add_span("train.data_wait", trace,
                                     t_wait, t_dispatch)
                self.tracer.add_span("train.dispatch", trace,
                                     t_dispatch, t_end)
        self._trace = trace
        exemplar = trace.trace_id if trace is not None else None
        self.data_wait.observe(data_wait_s, exemplar=exemplar)
        self.step_time.observe(dispatch_s, exemplar=exemplar)
        if self.stall_watchdog is not None:
            self.stall_watchdog.note_step(step)
        now = time.time()
        self.last_step_unix.set(now)
        with self._lock:
            self._step = step
            self._last_step_mono = time.monotonic()
        # Step-0 compilation is expected; arm the detector once the first
        # step of THIS run has been dispatched.
        if not self._armed:
            self._armed = _ensure_listener()
            if self._armed:
                _set_active_detector(self)

    def observe_drain(self, seconds: float, means: Dict[str, float],
                      step: int, window: int) -> None:
        """Called after each SUM_FREQ metric fetch with the window's mean
        scalars; also the refresh point for throughput + memory gauges,
        the attach point for the drain span, and the non-finite sentinel's
        inspection point (``means`` is already host floats — the check
        costs zero device fetches)."""
        trace = self._trace
        if trace is not None:
            t_end = time.perf_counter()
            self.tracer.add_span("train.metric_drain", trace,
                                 t_end - seconds, t_end,
                                 step=step, window=window)
        self.drain_time.observe(
            seconds, exemplar=trace.trace_id if trace is not None else None)
        self.nonfinite.check(means, step)
        now = time.monotonic()
        with self._lock:
            elapsed = now - self._last_drain_mono
            n_steps = step - self._steps_at_last_drain
            self._last_drain_mono = now
            self._steps_at_last_drain = step
            batch = self._batch_size
        step_flops = 0.0
        if self.costs is not None:
            rec = self.costs.get(TRAIN_STEP_COST_KEY)
            if rec is not None and rec.flops:
                step_flops = rec.flops
                self.step_flops.set(step_flops)
        if elapsed > 0 and n_steps > 0:
            self.images_per_s.set(n_steps * max(1, batch) / elapsed)
            if step_flops:
                # MFU over the drain window
                achieved = step_flops * n_steps / elapsed
                self.achieved_flops_per_s.set(achieved)
                if self.costs.peak_flops:
                    self.mfu.set(achieved / self.costs.peak_flops)
        self.host_rss.set(host_rss_bytes())
        try:
            from raft_stereo_tpu_torch.profiling import device_memory_stats
            stats = device_memory_stats()
        except Exception:  # pragma: no cover - backend without stats
            stats = {}
        self.device_bytes.set(stats.get("bytes_in_use", 0))
        self.device_peak_bytes.set(stats.get("peak_bytes_in_use", 0))
        if self.events is not None:
            self.events.emit(
                "step_stats", step=step, window=window,
                means={k: float(v) for k, v in means.items()},
                images_per_s=self.images_per_s.value,
                data_wait_ms_p50=self.data_wait.percentile(50) * 1e3,
                step_ms_p50=self.step_time.percentile(50) * 1e3,
                host_rss_bytes=int(self.host_rss.value),
                device_bytes_in_use=int(self.device_bytes.value),
                step_flops=step_flops,
                mfu=self.mfu.value)

    def observe_gru_deltas(self, deltas: Iterable[float]) -> None:
        """Per-iteration mean |disparity update| magnitudes (px), already on
        host — the drained ``gru_delta_px`` metric vector."""
        for d in deltas:
            self.gru_delta.observe(float(d))

    # ------------------------------------------- anomaly-policy mirrors
    def observe_anomaly_skip(self, step: int, kind: str) -> None:
        """One on-device-dropped update, as drained by the loop (kind is
        ``nonfinite`` or ``spike``)."""
        counter = self.batches_skipped.get(kind)
        if counter is not None:
            counter.inc()
        if self.events is not None:
            self.events.emit("skip_batch", step=step, reason=kind)

    def observe_rewind(self, from_step: int, to_step: int,
                       checkpoint: str) -> None:
        """A checkpoint rewind: anomaly event (+ flight-recorder bundle
        when wired) plus the typed counter."""
        self.rewinds.inc()
        self.anomaly_sink.fire("training_rewind", from_step=from_step,
                               to_step=to_step, checkpoint=checkpoint)

    def observe_checkpoint_rejected(self, path: str, reason: str) -> None:
        self.checkpoints_rejected.inc()
        if self.events is not None:
            self.events.emit("checkpoint_rejected", path=path,
                             reason=reason)

    def observe_loader_stats(self, stats: Dict[str, int]) -> None:
        """Mirror the loader's cumulative fault counters (StereoLoader
        .stats) into the registry; called at the drain cadence, deltas
        computed here so the loader stays telemetry-free."""
        mapping = (("retried", self.loader_retries),
                   ("quarantined", self.loader_quarantined),
                   ("worker_respawns", self.loader_respawns))
        for key, counter in mapping:
            now = int(stats.get(key, 0))
            delta = now - self._loader_stats_seen[key]
            if delta > 0:
                counter.inc(delta)
            self._loader_stats_seen[key] = now

    def observe_checkpoint(self, seconds: float, path: str,
                           step: int) -> None:
        self.checkpoints.inc()
        trace = self._trace
        if trace is not None:
            t_end = time.perf_counter()
            self.tracer.add_span("train.checkpoint", trace,
                                 t_end - seconds, t_end,
                                 step=step, path=path)
        self.checkpoint_time.observe(seconds)
        if self.events is not None:
            self.events.emit("checkpoint", step=step, path=path,
                             seconds=seconds)

    def observe_validation(self, results: Dict[str, float],
                           step: int) -> None:
        if self.events is not None:
            self.events.emit("validation", step=step,
                             results={k: float(v)
                                      for k, v in results.items()})

    def stop_requested(self, signum: int) -> None:
        with self._lock:
            self._status = "stopping"
        if self.events is not None:
            self.events.emit("stop_requested", signal=int(signum),
                             step=self._step)

    def run_end(self, status: str, step: int) -> None:
        with self._lock:
            self._status = status
        self.step_gauge.set(step)
        self._end_step()
        if self._armed:
            _set_active_detector(None)
            self._armed = False
        if self.stall_watchdog is not None:
            self.stall_watchdog.stop()  # a finished run must not page
        if self.events is not None:
            self.events.emit("run_end", status=status, step=step)

    def _end_step(self) -> None:
        if self._in_step:
            self._in_step = False
            self._step_lock.release()

    @contextlib.contextmanager
    def step_boundary(self):
        """Held while a trace window opens (telemetry/trace.py): waits for
        the step in flight to end and keeps the next one from starting."""
        with self._step_lock:
            yield

    def enable_stall_watchdog(self, **kw) -> "object":
        """Create + start a ``StepStallWatchdog`` wired into this run's
        anomaly sink (cli/train.py calls this when the watchdog flag is
        on); ``observe_step`` feeds it heartbeats, ``run_end`` stops it."""
        from raft_stereo_tpu_torch.telemetry.watchdog import StepStallWatchdog
        self.stall_watchdog = StepStallWatchdog(self.anomaly_sink,
                                                **kw).start()
        return self.stall_watchdog

    # ------------------------------------------------------------- scrapes
    def healthz(self) -> Dict[str, object]:
        """The heartbeat ``GET /healthz`` serves: run status, step progress,
        and the age of the last completed step."""
        with self._lock:
            last = self._last_step_mono
            out: Dict[str, object] = {
                "status": self._status,
                "step": self._step,
                "total_steps": self._total,
            }
        out["last_step_age_s"] = (round(time.monotonic() - last, 3)
                                  if last is not None else None)
        out["recompiles"] = self.recompiles.value
        out["anomalies"] = self.anomalies.value
        return out

    # ------------------------------------------------- compile-event sink
    def _on_compile(self, event: str, duration_secs: float) -> None:
        if not self._in_step:
            return
        self.recompiles.inc()
        shapes = self._shapes
        log.warning(
            "program build %s inside step %d after step 1 (%.2fs): batch "
            "shapes %s — it re-pays compile time every occurrence", event,
            self._step, duration_secs, shapes)
        if self.events is not None:
            self.events.emit("compile", step=self._step, name=event,
                             duration_s=duration_secs, batch_shapes=shapes)


def _cfg_dict(cfg) -> Dict[str, object]:
    to_dict = getattr(cfg, "to_dict", None)
    return to_dict() if to_dict is not None else dict(vars(cfg))
