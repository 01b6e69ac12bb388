"""Anomaly watchdogs: detect the failure modes that page an operator and
capture the evidence at the moment they happen.

Each detector does the same three things on trigger: emit a versioned
``anomaly`` run event (the machine-readable alert), write a flight-recorder
debug bundle (the post-mortem evidence — telemetry/flight_recorder.py), and
log a warning (the human alert).  Detectors are deliberately cheap and
host-side only:

* ``NonFiniteSentinel`` — rides the train loop's EXISTING buffered metric
  fetch: ``check(means)`` inspects the already-host-side drained scalars
  for NaN/Inf, so detection costs zero extra device fetches and the
  telemetry-off device-fetch count of the train loop is untouched.
  RAFT-Stereo's sequence loss sums over GRU iterations, so one non-finite
  iteration poisons the whole step — catching it at the drain window is as
  early as host-side detection can be without adding a sync.
* ``StepStallWatchdog`` — a daemon thread that alarms when no step has
  completed within ``factor ×`` the rolling median inter-step interval
  (medians tolerate the checkpoint/validation spikes a mean would not).
  Self-calibrating: compile time is excluded because the clock only starts
  at the first observed step, and the threshold floor covers tiny models.
* ``ServingWatchdog`` — a daemon thread over the serving instrument set:
  queue saturation (depth ≥ ``saturation`` of ``max_queue`` sustained for
  ``sustain_s``) and deadline-miss rate (misses/admissions over the poll
  window above ``miss_rate``).

Every detector re-arms only after the condition clears, so a persistent
anomaly produces one event + one bundle, not a firehose.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from typing import Dict, Iterable, Optional

log = logging.getLogger(__name__)

# Version of the anomaly event payload (distinct from the event-log
# schema_version: the log schema carries any event kind; this versions the
# anomaly record's own fields so downstream alerting can migrate).
ANOMALY_VERSION = 1


class AnomalySink:
    """Shared trigger plumbing: anomaly event + flight-recorder bundle +
    log line.  ``events`` is an ``EventLog`` (or None), ``recorder`` a
    ``FlightRecorder`` (or None) — each detector fires whatever is wired."""

    def __init__(self, events=None, recorder=None, counter=None):
        self.events = events
        self.recorder = recorder
        self.counter = counter       # optional registry Counter to bump
        self._lock = threading.Lock()
        self.anomalies = 0

    def fire(self, kind: str, **detail) -> Dict[str, object]:
        with self._lock:
            self.anomalies += 1
        if self.counter is not None:
            self.counter.inc()
        log.warning("anomaly detected: %s %s", kind, detail)
        bundle = None
        if self.recorder is not None:
            bundle = self.recorder.dump(kind, detail=detail)
        rec: Dict[str, object] = {}
        if self.events is not None:
            rec = self.events.emit("anomaly", anomaly_version=ANOMALY_VERSION,
                                   kind=kind, bundle=bundle, **detail)
        return rec


class NonFiniteSentinel:
    """Non-finite loss/grad-metric detector over already-fetched scalars.

    The train loop drains its buffered device metrics every SUM_FREQ steps
    (training/train_loop.py ``drain_metrics``); ``check`` runs on that
    host-side dict — never on device arrays — so the sentinel adds no
    fetches and no syncs.  Re-arms when a later window is finite again
    (a recovered run can alarm again if it re-diverges).
    """

    def __init__(self, sink: AnomalySink):
        self.sink = sink
        self._tripped = False

    def check(self, means: Dict[str, float], step: int) -> bool:
        """Returns True when this call fired an anomaly."""
        bad = {k: repr(float(v)) for k, v in means.items()
               if not math.isfinite(v)}
        if not bad:
            self._tripped = False
            return False
        if self._tripped:
            return False
        self._tripped = True
        self.sink.fire("non_finite_metric", step=step, metrics=bad)
        return True


class StepStallWatchdog:
    """No-step-completed-recently detector with a self-calibrating bound.

    ``note_step()`` is the train loop's heartbeat (TrainTelemetry calls it
    from ``observe_step``).  The poll thread alarms when the time since the
    last heartbeat exceeds ``max(min_stall_s, factor × rolling median
    inter-step interval)``; before the first interval exists there is no
    baseline and the watchdog stays silent (startup compilation can
    legitimately take minutes).
    """

    def __init__(self, sink: AnomalySink, factor: float = 10.0,
                 min_stall_s: float = 5.0, poll_s: float = 1.0,
                 window: int = 64):
        self.sink = sink
        self.factor = factor
        self.min_stall_s = min_stall_s
        self.poll_s = poll_s
        self._intervals: "collections.deque[float]" = collections.deque(
            maxlen=window)
        self._lock = threading.Lock()
        self._last_step_mono: Optional[float] = None
        self._last_step = 0
        self._tripped = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def note_step(self, step: int) -> None:
        now = time.monotonic()
        with self._lock:
            if self._last_step_mono is not None:
                self._intervals.append(now - self._last_step_mono)
            self._last_step_mono = now
            self._last_step = step
            self._tripped = False      # progress re-arms the alarm

    def threshold_s(self) -> Optional[float]:
        """Current stall bound; None while there is no baseline yet."""
        with self._lock:
            if not self._intervals:
                return None
            med = sorted(self._intervals)[len(self._intervals) // 2]
        return max(self.min_stall_s, self.factor * med)

    def check(self) -> bool:
        """One poll; returns True when it fired.  Public for tests."""
        bound = self.threshold_s()
        with self._lock:
            last = self._last_step_mono
            step = self._last_step
            tripped = self._tripped
        if bound is None or last is None or tripped:
            return False
        age = time.monotonic() - last
        if age <= bound:
            return False
        with self._lock:
            self._tripped = True
        self.sink.fire("step_stall", step=step, stalled_s=round(age, 3),
                       threshold_s=round(bound, 3),
                       median_step_s=round(bound / self.factor, 4))
        return True

    def start(self) -> "StepStallWatchdog":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="step-stall-watchdog")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:  # pragma: no cover - detector must not die
                log.exception("step-stall watchdog poll failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class ServingWatchdog:
    """Queue-saturation and deadline-miss-rate detectors over the serving
    instrument set (serving/metrics.py).

    Saturation: queue depth ≥ ``saturation × max_queue`` on every poll for
    ``sustain_s`` (a burst that clears within the window is the batcher
    doing its job, not an anomaly).  Miss rate: deadline misses per
    admitted request over the trailing poll window above ``miss_rate``,
    with at least ``min_events`` admissions so an idle service cannot
    divide by noise.
    """

    def __init__(self, sink: AnomalySink, metrics, max_queue: int,
                 saturation: float = 0.9, sustain_s: float = 2.0,
                 miss_rate: float = 0.5, min_events: int = 8,
                 poll_s: float = 0.5):
        self.sink = sink
        self.metrics = metrics
        self.max_queue = max(1, max_queue)
        self.saturation = saturation
        self.sustain_s = sustain_s
        self.miss_rate = miss_rate
        self.min_events = min_events
        self.poll_s = poll_s
        self._saturated_since: Optional[float] = None
        self._sat_tripped = False
        self._miss_tripped = False
        self._prev_admitted = 0
        self._prev_missed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check(self) -> Iterable[str]:
        """One poll; returns the kinds fired (tests call this directly)."""
        fired = []
        now = time.monotonic()
        depth = self.metrics.queue_depth.value
        if depth >= self.saturation * self.max_queue:
            if self._saturated_since is None:
                self._saturated_since = now
            elif (not self._sat_tripped
                  and now - self._saturated_since >= self.sustain_s):
                self._sat_tripped = True
                self.sink.fire(
                    "queue_saturation", queue_depth=int(depth),
                    max_queue=self.max_queue,
                    saturated_s=round(now - self._saturated_since, 3))
                fired.append("queue_saturation")
        else:
            self._saturated_since = None
            self._sat_tripped = False

        admitted, missed = (self.metrics.admitted.value,
                            self.metrics.deadline_missed.value)
        d_adm = admitted - self._prev_admitted
        d_miss = missed - self._prev_missed
        self._prev_admitted, self._prev_missed = admitted, missed
        if d_adm >= self.min_events:
            rate = d_miss / d_adm
            if rate >= self.miss_rate and not self._miss_tripped:
                self._miss_tripped = True
                self.sink.fire("deadline_miss_rate",
                               missed=int(d_miss), admitted=int(d_adm),
                               rate=round(rate, 4))
                fired.append("deadline_miss_rate")
            elif rate < self.miss_rate:
                self._miss_tripped = False
        return fired

    def start(self) -> "ServingWatchdog":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-watchdog")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:  # pragma: no cover - detector must not die
                log.exception("serving watchdog poll failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
