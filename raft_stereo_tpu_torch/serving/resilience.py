"""Failure containment policies for the serving engine: per-device
circuit breakers and brownout degradation.

Both are deliberately dumb, testable state machines over signals the
engine already measures — no new probes, no model awareness:

* ``CircuitBreaker`` — one per device worker.  K consecutive dispatch
  failures open the circuit (the worker stops taking work: a device that
  fails every dispatch must not keep eating the queue through the retry
  path); after a cooldown the breaker goes half-open and admits ONE
  probe batch; a probe success closes it, a probe failure reopens it
  with the cooldown restarted.  Modeled on the classic pattern (Nygard,
  *Release It!*), with the half-open probe giving a flapping device a
  bounded, automatic way back in.
* ``BrownoutController`` — the load-shedding step BEFORE shedding.  The
  round-12 tier ladder (interactive/balanced/quality) prices the same
  request at three GRU depths, so sustained overload has a cheaper
  answer than a 503: degrade eligible requests one rung down the ladder
  and keep answering.  Engage/restore use the same signals as the
  ServingWatchdog's alarms (queue saturation, deadline-miss rate) with
  hysteresis — engaging needs sustained pressure, restoring needs a
  longer sustained calm at a LOWER watermark, so the controller cannot
  flap at the boundary.

The JAX package's ``serving/resilience.py``, copied whole.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

# serve_circuit_state gauge values (docs/architecture.md §Resilience).
CIRCUIT_CLOSED, CIRCUIT_OPEN, CIRCUIT_HALF_OPEN = 0, 1, 2
_STATE_NAMES = {CIRCUIT_CLOSED: "closed", CIRCUIT_OPEN: "open",
                CIRCUIT_HALF_OPEN: "half_open"}


def circuit_state_name(state: int) -> str:
    return _STATE_NAMES.get(state, str(state))


class CircuitBreaker:
    """Per-device dispatch gate: closed -> (K consecutive failures) ->
    open -> (cooldown) -> half-open -> one probe -> closed | open.

    ``on_state(old, new, consecutive_failures)`` fires on every
    transition (the engine wires the ``serve_circuit_state`` gauge and
    the anomaly events there).  Thread-safe; the worker loop calls
    ``until_allowed`` before popping and ``record_success`` /
    ``record_failure`` after each dispatch.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_state: Optional[Callable[[int, int, int], None]] = None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold={failure_threshold} must be >= 1")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s={cooldown_s} must be > 0")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._on_state = on_state
        self._lock = threading.Lock()
        self._state = CIRCUIT_CLOSED
        self._failures = 0          # consecutive
        self._opened_at: Optional[float] = None
        self._probe_out = False     # half-open: one probe in flight

    # ------------------------------------------------------------- state
    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def _transition(self, new: int) -> None:
        """Caller holds the lock."""
        old, self._state = self._state, new
        if old != new and self._on_state is not None:
            # Fire outside the lock would be nicer, but the callbacks are
            # a gauge.set + an event emit — reentry into the breaker is
            # the only real hazard and none of the wired callbacks do it.
            self._on_state(old, new, self._failures)

    def until_allowed(self) -> float:
        """0.0 when the worker may take a batch now, else seconds until
        the next transition is due.  In half-open, only the single probe
        dispatch is admitted; a second caller waits for its verdict."""
        with self._lock:
            if self._state == CIRCUIT_CLOSED:
                return 0.0
            now = self._clock()
            if self._state == CIRCUIT_OPEN:
                remaining = self._opened_at + self.cooldown_s - now
                if remaining > 0:
                    return remaining
                self._transition(CIRCUIT_HALF_OPEN)
                self._probe_out = False
            # half-open: admit exactly one probe at a time
            if self._probe_out:
                return self.cooldown_s / 4
            self._probe_out = True
            return 0.0

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_out = False
            if self._state != CIRCUIT_CLOSED:
                self._transition(CIRCUIT_CLOSED)

    def record_failure(self) -> bool:
        """Returns True when this failure OPENED the circuit."""
        with self._lock:
            self._failures += 1
            self._probe_out = False
            if self._state == CIRCUIT_HALF_OPEN:
                # failed probe: straight back to open, cooldown restarts
                self._opened_at = self._clock()
                self._transition(CIRCUIT_OPEN)
                return True
            if (self._state == CIRCUIT_CLOSED
                    and self._failures >= self.failure_threshold):
                self._opened_at = self._clock()
                self._transition(CIRCUIT_OPEN)
                return True
        return False


class BrownoutController:
    """Tier-ladder degradation under sustained overload, with hysteresis.

    ``ladder`` orders tier names cheapest-first (the engine derives it
    from the configured tiers by early-exit threshold: highest threshold
    = earliest exit = cheapest; fixed-depth tiers are the most
    expensive).  ``level`` is how many rungs every eligible request is
    pushed down: 0 = off, 1 = quality->balanced / balanced->interactive,
    up to ``len(ladder) - 1`` where everything runs the cheapest tier.

    Engage: queue depth >= ``engage_fraction`` of ``max_queue`` on every
    poll for ``engage_s``, OR deadline-miss rate over the poll window
    >= ``miss_rate`` (with ``min_events`` admissions).  Each sustained
    engage window raises the level one rung.  Restore: depth below
    ``restore_fraction`` AND no miss-rate signal for ``restore_s`` —
    longer than ``engage_s`` and at a lower watermark, so a queue
    hovering at the threshold cannot flap the level.
    """

    def __init__(self, metrics, max_queue: int, ladder: Sequence[str],
                 engage_fraction: float = 0.75, engage_s: float = 0.5,
                 restore_fraction: float = 0.25, restore_s: float = 2.0,
                 miss_rate: float = 0.5, min_events: int = 8,
                 poll_s: float = 0.1,
                 clock: Callable[[], float] = time.monotonic,
                 gauge=None, sink=None):
        if not 0 < restore_fraction <= engage_fraction <= 1:
            raise ValueError(
                f"need 0 < restore_fraction ({restore_fraction}) <= "
                f"engage_fraction ({engage_fraction}) <= 1")
        self.metrics = metrics
        self.max_queue = max(1, max_queue)
        self.ladder: Tuple[str, ...] = tuple(ladder)
        self.engage_fraction = engage_fraction
        self.engage_s = engage_s
        self.restore_fraction = restore_fraction
        self.restore_s = restore_s
        self.miss_rate = miss_rate
        self.min_events = min_events
        self.poll_s = poll_s
        self._clock = clock
        self._gauge = gauge
        self._sink = sink
        self._lock = threading.Lock()
        self._level = 0
        self._floor = 0     # fleet-wide minimum (set_floor; round 16)
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._prev_admitted = 0
        self._prev_missed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- degrade
    @property
    def level(self) -> int:
        """The EFFECTIVE degradation level: the local pressure state
        machine's rung, or the fleet-wide floor if that is higher (the
        router pushes the floor so every replica steps down together;
        local pressure can still degrade further on top)."""
        with self._lock:
            return max(self._level, self._floor)

    @property
    def floor(self) -> int:
        with self._lock:
            return self._floor

    def set_floor(self, level: int) -> int:
        """Set the fleet-wide minimum level (``POST /admin/brownout`` ->
        engine.set_brownout_floor).  Clamped to the ladder; returns the
        effective level.  The local controller keeps polling its own
        signals — the floor only prevents it from RESTORING below the
        fleet's verdict."""
        level = max(0, min(int(level), self.max_level))
        with self._lock:
            old_eff = max(self._level, self._floor)
            self._floor = level
            eff = max(self._level, self._floor)
            if self._gauge is not None:
                self._gauge.set(eff)
        if eff != old_eff:
            log.warning("brownout floor set to %d (effective level "
                        "%d -> %d, fleet-pushed)", level, old_eff, eff)
            if self._sink is not None:
                self._sink.fire("brownout_engaged" if eff > old_eff
                                else "brownout_restored",
                                level=eff, previous_level=old_eff,
                                reason="fleet_floor", floor=level,
                                ladder=list(self.ladder))
        return eff

    @property
    def max_level(self) -> int:
        return max(0, len(self.ladder) - 1)

    # Mean request confidence BELOW which a request is spared from
    # degradation (round 24 quality observability): brownout exists to
    # shed compute from requests that can afford it, and a
    # low-confidence stream is exactly the one that cannot — pushing it
    # down the ladder converts a latency problem into a quality
    # incident.  The engine feeds the requester's recent rolling mean
    # confidence (telemetry/quality.QualityTracker) when available.
    spare_below: float = 0.0

    def degrade(self, tier: Optional[str],
                confidence: Optional[float] = None) -> Optional[str]:
        """The tier a request actually runs at the current level: its
        requested tier pushed ``level`` rungs toward the cheap end of the
        ladder.  Tiers off the ladder (and None) pass through.

        ``confidence`` is the principled victim-selection signal: when
        given and below ``spare_below``, the request passes through
        undegraded — recent answers at its tier were already
        low-confidence, so it NEEDS the expensive program.  None (the
        default, and always when confidence telemetry is off) keeps the
        round-13 ladder behavior byte-for-byte."""
        lvl = self.level
        if lvl == 0 or tier is None or tier not in self.ladder:
            return tier
        if confidence is not None and confidence < self.spare_below:
            return tier
        idx = self.ladder.index(tier)
        return self.ladder[max(0, idx - lvl)]

    # ------------------------------------------------------------- poll
    def _set_level(self, new: int, reason: str, **detail) -> None:
        """Caller holds the lock."""
        old, self._level = self._level, new
        if self._gauge is not None:
            self._gauge.set(max(new, self._floor))
        log.warning("brownout level %d -> %d (%s)", old, new, reason)
        if self._sink is not None:
            self._sink.fire("brownout_engaged" if new > old
                            else "brownout_restored",
                            level=new, previous_level=old, reason=reason,
                            ladder=list(self.ladder), **detail)

    def check(self) -> int:
        """One poll; returns the (possibly changed) level.  Public for
        tests — the poll thread calls exactly this."""
        now = self._clock()
        depth = self.metrics.queue_depth.value
        admitted = self.metrics.admitted.value
        missed = self.metrics.deadline_missed.value
        d_adm = admitted - self._prev_admitted
        d_miss = missed - self._prev_missed
        self._prev_admitted, self._prev_missed = admitted, missed
        missing = (d_adm >= self.min_events
                   and d_miss / d_adm >= self.miss_rate)
        saturated = depth >= self.engage_fraction * self.max_queue
        calm = (depth <= self.restore_fraction * self.max_queue
                and not missing)

        with self._lock:
            if saturated or missing:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                elif (now - self._pressure_since >= self.engage_s
                        and self._level < self.max_level):
                    self._set_level(
                        self._level + 1,
                        "deadline_miss_rate" if missing
                        else "queue_saturation",
                        queue_depth=int(depth), max_queue=self.max_queue,
                        missed=int(d_miss), admitted=int(d_adm))
                    self._pressure_since = now  # next rung needs its own
                    #                             sustained window
            elif calm:
                self._pressure_since = None
                if self._level > 0:
                    if self._calm_since is None:
                        self._calm_since = now
                    elif now - self._calm_since >= self.restore_s:
                        self._set_level(self._level - 1, "load_restored",
                                        queue_depth=int(depth))
                        self._calm_since = now
                else:
                    self._calm_since = None
            else:
                # between the watermarks: hold level, reset both timers —
                # this band is the hysteresis.
                self._pressure_since = None
                self._calm_since = None
            return self._level

    def start(self) -> "BrownoutController":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="brownout-controller")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:  # pragma: no cover - controller must not die
                log.exception("brownout poll failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def cost_ladder(tiers) -> List[str]:
    """Tier names cheapest-first for the brownout ladder: higher
    early-exit threshold = earlier exit = cheaper; fixed-depth tiers
    (threshold <= 0) are the most expensive; at equal exit knobs an
    int8 tier is cheaper than the full-precision one (it moves a
    fraction of the bytes per iteration — the round-15 "turbo" tier
    sits below "interactive" as the ladder's bottom rung).  Ties keep
    configuration order.  ``tiers`` is a sequence of
    ``config.RequestTier``."""
    order = sorted(
        enumerate(tiers),
        key=lambda it: (it[1].exit_threshold_px <= 0,
                        -it[1].exit_threshold_px
                        if it[1].exit_threshold_px > 0 else 0,
                        getattr(it[1], "quant", "off") == "off",
                        it[0]))
    return [t.name for _, t in order]
