"""Quality observability: online confidence telemetry and drift detection.

The span tracer and telemetry/slo.py give the fleet latency and
availability observability (traces, federation, SLO burn rates); this
module is the QUALITY half.  The model's
``return_confidence`` variant (models/raft_stereo.py) turns the refinement
loop's own convergence signals into a per-pixel confidence map, and the
serving engine reports each answered request's mean confidence here:

* ``QualityTracker`` — per-(tier, model) confidence histograms with trace
  exemplars (``serve_confidence{tier=,model=}``), per-tier rolling means
  (the brownout victim-selection signal and the cascade's own telemetry),
  and good/bad quality totals against a confidence floor — the counters a
  ``BurnRateTracker`` (telemetry/slo.py, ``dimension="quality"``) turns
  into the quality error-budget burn rate.
* ``QualityDriftWatchdog`` — a PSI (population-stability-index) detector
  over the confidence distribution: the first ``reference_size``
  observations freeze a reference histogram (the "known healthy" shape),
  every later observation lands in a rolling recent window, and when the
  two distributions diverge past ``threshold`` the watchdog fires ONE
  typed ``quality_drift`` anomaly through the shared ``AnomalySink``
  (versioned event + flight-recorder bundle, telemetry/watchdog.py
  semantics), latched until the PSI recovers below half the threshold.
  PSI ~0.1 is the classic "monitor" band and ~0.25 the "act" band; the
  default threshold 0.25 pages only on a real shift, e.g. a perturbed or
  stale checkpoint answering live traffic (scripts/quality_smoke.py
  proves exactly that injection).

Everything here is host-side and O(1) per request; with
``ServeConfig.confidence`` off the engine never constructs a tracker and
no series exist — the metrics exposition stays byte-identical.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

# Confidence-histogram bucket edges: confidence lives in (0, 1], and the
# interesting resolution is near the escalation/floor band — uniform 0.1
# steps read directly as deciles of the distribution.
CONFIDENCE_BUCKETS: Tuple[float, ...] = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

# PSI bin edges over [0, 1] (11 bins): finer than the exposition buckets
# so a shift WITHIN a decile still moves the index.
_PSI_BINS = 11
_PSI_EPS = 1e-4   # Laplace smoothing: empty bins must not blow up the log


class QualityDriftWatchdog:
    """PSI detector over the online confidence distribution.

    ``observe(confidence)`` is O(1): the first ``reference_size`` values
    accumulate the frozen reference histogram; later values ride a
    bounded recent window.  ``check()`` (called by ``observe`` every
    ``check_every`` observations once both sides have enough mass, or
    directly by tests) computes PSI(recent ‖ reference) and fires the
    latched ``quality_drift`` anomaly when it crosses ``threshold``.
    Re-arms when the index falls below ``threshold / 2``."""

    def __init__(self, sink=None, threshold: float = 0.25,
                 reference_size: int = 256, window: int = 128,
                 min_window: int = 32, check_every: int = 8,
                 label: str = "default"):
        if threshold <= 0:
            raise ValueError(f"threshold={threshold} must be > 0")
        self.sink = sink
        self.threshold = float(threshold)
        self.reference_size = int(reference_size)
        self.min_window = int(min_window)
        self.check_every = int(max(1, check_every))
        self.label = label
        self._lock = threading.Lock()
        self._reference = [0] * _PSI_BINS
        self._reference_n = 0
        self._recent: "collections.deque[int]" = collections.deque(
            maxlen=int(window))
        self._since_check = 0
        self._tripped = False
        self.fired: List[Dict[str, object]] = []

    @staticmethod
    def _bin(v: float) -> int:
        v = min(1.0, max(0.0, float(v)))
        return min(_PSI_BINS - 1, int(v * _PSI_BINS))

    def observe(self, confidence: float) -> Optional[Dict[str, object]]:
        """Feed one per-request mean confidence; returns the fired
        anomaly record when this observation tripped the detector."""
        with self._lock:
            b = self._bin(confidence)
            if self._reference_n < self.reference_size:
                self._reference[b] += 1
                self._reference_n += 1
                return None
            self._recent.append(b)
            self._since_check += 1
            if (self._since_check < self.check_every
                    or len(self._recent) < self.min_window):
                return None
            self._since_check = 0
        return self.check()

    def psi(self) -> Optional[float]:
        """Current PSI(recent ‖ reference); None while either side is
        still filling."""
        with self._lock:
            if (self._reference_n < min(self.reference_size,
                                        self.min_window)
                    or len(self._recent) < self.min_window):
                return None
            ref_n = self._reference_n
            ref = list(self._reference)
            rec = [0] * _PSI_BINS
            for b in self._recent:
                rec[b] += 1
            rec_n = len(self._recent)
        index = 0.0
        for i in range(_PSI_BINS):
            p = rec[i] / rec_n + _PSI_EPS
            q = ref[i] / ref_n + _PSI_EPS
            index += (p - q) * math.log(p / q)
        return index

    def check(self) -> Optional[Dict[str, object]]:
        """One evaluation; returns the fired record or None."""
        index = self.psi()
        if index is None:
            return None
        if index < self.threshold:
            if self._tripped and index < self.threshold / 2:
                self._tripped = False
                log.info("confidence drift recovered (PSI %.3f); quality "
                         "watchdog re-armed", index)
            return None
        if self._tripped:
            return None
        self._tripped = True
        detail = {
            "psi": round(index, 4),
            "threshold": self.threshold,
            "label": self.label,
            "reference_n": self._reference_n,
            "recent_n": len(self._recent),
            "recent_mean_bin": (sum(self._recent) / len(self._recent)
                                / _PSI_BINS if self._recent else None),
        }
        if self.sink is not None:
            self.sink.fire("quality_drift", **detail)
        self.fired.append(detail)
        log.warning("confidence distribution drifted: PSI %.3f >= %.3f "
                    "(%s)", index, self.threshold, self.label)
        return detail

    def status(self) -> Dict[str, object]:
        with self._lock:
            ref_n, rec_n = self._reference_n, len(self._recent)
            tripped = self._tripped
        return {"psi": self.psi(), "threshold": self.threshold,
                "reference_n": ref_n, "recent_n": rec_n,
                "tripped": tripped}


class QualityTracker:
    """Per-request confidence telemetry for the serving engine.

    ``observe(tier, model, confidence, exemplar=)`` is the one call the
    dispatch path makes per answered request:

    * lands in the ``serve_confidence{tier=,model=}`` histogram family
      (trace-ID exemplars ride like the latency histograms'),
    * bumps ``serve_quality_good_total`` / ``serve_quality_bad_total``
      against ``floor`` (the SLO numerators a quality
      ``BurnRateTracker`` samples),
    * updates the per-tier rolling mean (``mean_confidence`` — the
      brownout victim-selection signal), and
    * feeds the drift watchdog.
    """

    def __init__(self, registry=None, sink=None, floor: float = 0.5,
                 drift_threshold: float = 0.25,
                 drift_reference_size: int = 256,
                 drift_window: int = 128,
                 rolling_window: int = 64,
                 slo=None, slo_every: int = 8):
        if not 0.0 <= floor <= 1.0:
            raise ValueError(f"floor={floor} must be in [0, 1]")
        self.registry = registry
        self.floor = float(floor)
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, str], object] = {}
        self._rolling: Dict[str, "collections.deque[float]"] = {}
        self._rolling_window = int(rolling_window)
        # Optional quality-dimension BurnRateTracker (telemetry/slo.py,
        # dimension="quality"): sampled with the cumulative good/bad
        # totals every ``slo_every`` observations — frequent enough to
        # keep the fast window honest, cheap enough for the dispatch
        # path.
        self.slo = slo
        self.slo_every = int(max(1, slo_every))
        self._slo_count = 0
        self.good = (registry.counter(
            "serve_quality_good_total",
            "Requests whose mean confidence met the quality floor")
            if registry is not None else None)
        self.bad = (registry.counter(
            "serve_quality_bad_total",
            "Requests whose mean confidence fell below the quality floor")
            if registry is not None else None)
        self.drift = QualityDriftWatchdog(
            sink=sink, threshold=drift_threshold,
            reference_size=drift_reference_size, window=drift_window)

    def _hist(self, tier: str, model: str):
        key = (tier, model)
        with self._lock:
            h = self._hists.get(key)
            if h is None and self.registry is not None:
                h = self.registry.histogram(
                    "serve_confidence",
                    "Per-request mean confidence (0..1] from the "
                    "refinement loop's convergence signals",
                    buckets=CONFIDENCE_BUCKETS,
                    labels={"tier": tier, "model": model})
                self._hists[key] = h
        return h

    def observe(self, tier: Optional[str], model: Optional[str],
                confidence: float,
                exemplar: Optional[str] = None) -> None:
        tier_label = tier or "default"
        model_label = model or "default"
        confidence = float(confidence)
        h = self._hist(tier_label, model_label)
        if h is not None:
            h.observe(confidence, exemplar=exemplar)
        if confidence >= self.floor:
            if self.good is not None:
                self.good.inc()
        elif self.bad is not None:
            self.bad.inc()
        with self._lock:
            roll = self._rolling.get(tier_label)
            if roll is None:
                roll = collections.deque(maxlen=self._rolling_window)
                self._rolling[tier_label] = roll
            roll.append(confidence)
            slo_due = False
            if self.slo is not None:
                self._slo_count += 1
                slo_due = self._slo_count % self.slo_every == 0
        if slo_due:
            good, bad = self.totals()
            self.slo.sample(good, bad)
        self.drift.observe(confidence)

    def mean_confidence(self, tier: Optional[str] = None
                        ) -> Optional[float]:
        """Rolling mean confidence of recent requests at ``tier`` (all
        tiers pooled when None); None before any observation."""
        with self._lock:
            if tier is not None:
                roll = self._rolling.get(tier or "default")
                vals = list(roll) if roll else []
            else:
                vals = [v for roll in self._rolling.values()
                        for v in roll]
        if not vals:
            return None
        return sum(vals) / len(vals)

    def totals(self) -> Tuple[int, int]:
        """Cumulative (good, bad) quality totals — what a quality
        ``BurnRateTracker.sample`` consumes."""
        good = self.good.value if self.good is not None else 0
        bad = self.bad.value if self.bad is not None else 0
        return good, bad

    def status(self) -> Dict[str, object]:
        with self._lock:
            tiers = {t: (sum(r) / len(r) if r else None)
                     for t, r in self._rolling.items()}
        good, bad = self.totals()
        out = {"floor": self.floor, "good": good, "bad": bad,
               "mean_confidence": tiers, "drift": self.drift.status()}
        if self.slo is not None:
            out["slo"] = self.slo.status()
        return out
