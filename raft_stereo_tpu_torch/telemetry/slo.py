"""SLO burn-rate tracking: turn raw good/bad totals into the multi-window
burn-rate signal alerting actually pages on.

A service-level objective is a budget: availability 0.999 allows 0.1% of
requests to fail (or miss their latency bound) over the compliance
period.  The *burn rate* is how fast that budget is being spent — the
bad-request fraction over a trailing window divided by the budget
fraction.  Burn rate 1.0 spends exactly the budget; 14.4 over a 5-minute
window is the classic "2% of a 30-day budget in one hour" page.  Multi-
window evaluation (a fast window AND a slow one both burning) is what
keeps a two-second blip from paging while a sustained brownout still
does — the standard SRE-workbook shape.

``BurnRateTracker`` is deliberately source-agnostic: feed it cumulative
``(good, bad)`` totals from anywhere (the fleet router samples replica
``admitted``/``deadline_missed`` sums plus its own typed route errors)
and it maintains one gauge per window (``fleet_slo_burn_rate{window=…}``).
Totals may regress when a replica restarts — deltas clamp at zero, so a
restart never manufactures negative traffic.

``SloWatchdog`` is the detector half (telemetry/watchdog.py shape): when
the fast window burns past ``fast_burn`` AND the slow window past
``slow_burn``, it fires one versioned anomaly event through the shared
``AnomalySink`` and invokes ``dump_fn`` — the fleet router wires that to
its coordinated fleet flight-recorder dump, so the page arrives with the
evidence already collected from every replica.  Re-arms only after both
windows drop below half their thresholds (hysteresis, not flapping).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

# (label, window seconds): the SRE-workbook fast/slow pair.  The fast
# window catches cliffs, the slow one sustained degradation; the watchdog
# requires both so a blip cannot page.
DEFAULT_WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("5m", 300.0), ("1h", 3600.0))


class BurnRateTracker:
    """Windowed burn rates over cumulative good/bad totals.

    ``sample(good_total, bad_total)`` appends one snapshot and recomputes
    every window's burn rate from the oldest snapshot still inside it —
    O(windows) per sample, memory bounded by the slowest window at the
    sampling cadence.  ``availability`` is the objective (0.999 → 0.1%
    error budget); ``latency_ms`` is advisory metadata recorded in
    ``status()`` (the CALLER decides which requests count as bad — the
    router counts deadline misses, typed route errors, and forwards
    slower than its ``--slo_ms``).
    """

    def __init__(self, availability: float = 0.999,
                 latency_ms: Optional[float] = None,
                 windows: Sequence[Tuple[str, float]] = DEFAULT_WINDOWS,
                 registry=None,
                 gauge_name: str = "fleet_slo_burn_rate",
                 clock: Callable[[], float] = time.monotonic,
                 dimension: Optional[str] = None):
        if not 0.0 < availability < 1.0:
            raise ValueError(f"availability={availability} must be in "
                             f"(0, 1) — 1.0 leaves no error budget to "
                             f"burn")
        if not windows:
            raise ValueError("need at least one burn-rate window")
        self.availability = float(availability)
        self.latency_ms = latency_ms
        # SLO dimension this tracker burns against: None (the
        # availability/latency accounting — gauge labels unchanged,
        # byte-for-byte) or a named dimension like "quality" (the
        # confidence-floor budget; telemetry/quality.py feeds its
        # good/bad totals).  Joins the gauge labels and the status
        # payload so one registry can carry several budgets side by
        # side.
        self.dimension = dimension
        self.windows: Tuple[Tuple[str, float], ...] = tuple(
            (str(label), float(seconds)) for label, seconds in windows)
        self.budget = 1.0 - self.availability
        self._clock = clock
        self._lock = threading.Lock()
        horizon = max(seconds for _, seconds in self.windows)
        self._horizon = horizon
        # (t, good_total, bad_total) snapshots, oldest first.
        self._samples: "collections.deque[Tuple[float, float, float]]" = (
            collections.deque())
        self._burns: Dict[str, float] = {label: 0.0
                                         for label, _ in self.windows}
        self._gauges = {}
        if registry is not None:
            for label, _seconds in self.windows:
                labels = {"window": label}
                if dimension is not None:
                    labels["dimension"] = dimension
                self._gauges[label] = registry.gauge(
                    gauge_name,
                    "SLO error-budget burn rate over a trailing window "
                    "(1.0 = spending exactly the budget)",
                    labels=labels)

    def sample(self, good_total: float, bad_total: float
               ) -> Dict[str, float]:
        """Record one cumulative snapshot; returns {window: burn_rate}."""
        now = self._clock()
        with self._lock:
            self._samples.append((now, float(good_total),
                                  float(bad_total)))
            # Keep one sample OLDER than the horizon so the slowest
            # window always has a baseline to difference against.
            while (len(self._samples) >= 2
                   and now - self._samples[1][0] > self._horizon):
                self._samples.popleft()
            burns: Dict[str, float] = {}
            for label, seconds in self.windows:
                base = self._samples[0]
                for snap in self._samples:
                    if now - snap[0] <= seconds:
                        break
                    base = snap
                d_good = max(0.0, good_total - base[1])
                d_bad = max(0.0, bad_total - base[2])
                total = d_good + d_bad
                bad_fraction = (d_bad / total) if total > 0 else 0.0
                burns[label] = bad_fraction / self.budget
            self._burns = burns
        for label, burn in burns.items():
            gauge = self._gauges.get(label)
            if gauge is not None:
                gauge.set(burn)
        return burns

    def burn_rates(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._burns)

    def status(self) -> Dict[str, object]:
        with self._lock:
            out = {
                "availability_objective": self.availability,
                "latency_objective_ms": self.latency_ms,
                "error_budget": self.budget,
                "windows": {label: seconds
                            for label, seconds in self.windows},
                "burn_rates": dict(self._burns),
                "samples": len(self._samples),
            }
            if self.dimension is not None:
                out["dimension"] = self.dimension
            return out


class SloWatchdog:
    """Multi-window burn-rate detector over a ``BurnRateTracker``.

    ``check(burns)`` runs after every tracker sample (the router's health
    loop drives it; tests call it directly).  Trips when the FAST window
    burns past ``fast_burn`` and the SLOW window past ``slow_burn``
    simultaneously — the two-window AND that separates a cliff from a
    blip.  On trip: one ``slo_burn`` anomaly through the sink (versioned
    event + local recorder bundle, telemetry/watchdog.py semantics) and
    one ``dump_fn(trigger_trace_id, detail)`` call — the coordinated
    fleet-dump hook.  Re-arms only once BOTH windows fall below half
    their thresholds."""

    def __init__(self, tracker: BurnRateTracker, sink,
                 fast_burn: float = 14.4, slow_burn: float = 6.0,
                 dump_fn: Optional[Callable[[str, Dict], object]] = None,
                 id_fn: Optional[Callable[[], str]] = None):
        windows = [label for label, _ in tracker.windows]
        if len(windows) < 2:
            raise ValueError("SloWatchdog needs a (fast, slow) window "
                             "pair; give the tracker at least two")
        self.tracker = tracker
        self.sink = sink
        self.fast_window, self.slow_window = windows[0], windows[-1]
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.dump_fn = dump_fn
        if id_fn is None:
            from raft_stereo_tpu_torch.telemetry.spans import _new_id
            id_fn = _new_id
        self._id_fn = id_fn
        self._tripped = False
        self.fired: List[Dict[str, object]] = []

    def check(self, burns: Optional[Dict[str, float]] = None
              ) -> Optional[Dict[str, object]]:
        """One evaluation; returns the fired record or None."""
        if burns is None:
            burns = self.tracker.burn_rates()
        fast = burns.get(self.fast_window, 0.0)
        slow = burns.get(self.slow_window, 0.0)
        breaching = fast >= self.fast_burn and slow >= self.slow_burn
        if not breaching:
            if (self._tripped and fast < self.fast_burn / 2
                    and slow < self.slow_burn / 2):
                self._tripped = False
                log.info("SLO burn recovered (fast %.2f, slow %.2f); "
                         "watchdog re-armed", fast, slow)
            return None
        if self._tripped:
            return None
        self._tripped = True
        trigger_trace_id = self._id_fn()
        detail = {
            "trigger_trace_id": trigger_trace_id,
            "burn_rates": {k: round(v, 3) for k, v in burns.items()},
            "fast_window": self.fast_window, "fast_burn": fast,
            "slow_window": self.slow_window, "slow_burn": slow,
            "availability_objective": self.tracker.availability,
            "latency_objective_ms": self.tracker.latency_ms,
        }
        if self.tracker.dimension is not None:
            detail["dimension"] = self.tracker.dimension
        if self.sink is not None:
            self.sink.fire("slo_burn", **detail)
        if self.dump_fn is not None:
            try:
                detail["fleet_dump"] = self.dump_fn(trigger_trace_id,
                                                    dict(detail))
            except Exception:  # pragma: no cover — detector must not die
                log.exception("coordinated fleet dump failed")
        self.fired.append(detail)
        return detail
