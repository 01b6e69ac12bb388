"""Canary/shadow rollout policy — the router-level half of multi-model
serving (round 21; serving/models.py is the replica-level half).

A new model version never meets live traffic all at once.  The operator
registers it on the replicas (``POST /admin/models``), then arms a
**canary** here: a configurable fraction of STATELESS requests is routed
to the canary version by tagging them ``X-Model`` before forwarding —
the replicas' registry does the actual weight selection, the router only
decides WHICH requests carry the tag.  Two invariants the split keeps:

* **Deterministic assignment.**  The canary decision is a pure hash of
  the request body (salted SHA-256 against a threshold), not a coin
  flip: the same request replays onto the same arm, a router restart
  (or the HA standby) makes identical decisions, and tests can pin the
  split exactly.
* **Sessions never split.**  Only stateless ``/v1/disparity`` traffic
  participates.  A streaming session pins the model its first frame
  resolved (serving/sessions.py) and the router's sticky path never
  consults this policy — no stream ever receives frames from two
  versions (the acceptance invariant).

**Shadow mirroring** is the read-only sibling: a sampled fraction of
baseline requests is ALSO forwarded to the canary version
fire-and-forget — the shadow answer is compared against the primary's
(mean end-point-error between the two disparity maps), recorded into
the regression window, and dropped, never returned to the client.
Shadow EPE is the strongest regression signal: it measures the canary
against the incumbent on identical live inputs.  When both arms serve
with confidence telemetry (round 24, ``--confidence``) the compare also
diffs the two answers' ``X-Confidence`` headers — a canary that matches
the incumbent's disparity but is systematically LESS SURE of it is an
early regression the EPE diff cannot see.

**Auto-demotion** closes the loop with the brownout hysteresis shape
(serving/resilience.py): a regression signal — canary transport/HTTP
error rate or mean shadow EPE divergence over the rolling window —
sustained for ``demote_after_s`` drops the canary fraction to ZERO,
emits the typed ``canary_demoted`` event, and bumps
``fleet_canary_demotions_total``.  Demotion is one-way: re-arming is an
operator decision (``POST /admin/rollout``), never automatic, so a
flapping canary cannot oscillate back into traffic.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from raft_stereo_tpu_torch.serving.models import parse_model_spec
from raft_stereo_tpu_torch.telemetry.registry import MetricsRegistry

log = logging.getLogger(__name__)


def _hash_fraction(salt: bytes, key: bytes) -> float:
    """Deterministic uniform draw in [0, 1): the salted SHA-256 of the
    request key, top 8 bytes.  Pure — same (salt, key) always lands on
    the same side of any threshold."""
    digest = hashlib.sha256(salt + key).digest()
    return int.from_bytes(digest[:8], "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """Regression/demotion knobs (cli/route.py maps flags here)."""

    # Rolling evidence window (shadow compares + canary outcomes each
    # keep this many recent samples).
    window: int = 64
    # Samples required before the regression verdict may fire at all —
    # one unlucky compare must never demote.
    min_samples: int = 8
    # Mean shadow EPE divergence (px) between canary and primary
    # answers on identical inputs above which the canary is regressing.
    epe_threshold: float = 1.0
    # Canary error-rate (transport + HTTP >= 500) above which the
    # canary is regressing even without shadow evidence.
    error_threshold: float = 0.5
    # Mean confidence DROP (primary minus canary, from the replicas'
    # X-Confidence headers on identical inputs) above which the canary
    # is regressing — the round-24 quality signal: a canary that
    # answers with the same EPE but systematically less confidence is
    # drifting toward the failure the drift watchdog pages on.  Only
    # fed when BOTH arms serve with confidence telemetry; same
    # window/min_samples/dwell hysteresis as the EPE verdict.
    confidence_threshold: float = 0.2
    # The hysteresis dwell: the regression verdict must hold
    # continuously this long before demotion fires (brownout pattern —
    # a single bad window never flips the fleet).
    demote_after_s: float = 2.0

    def __post_init__(self):
        if not 0 < self.window <= 65536:
            raise ValueError(f"window={self.window} out of range")
        if self.min_samples < 1:
            raise ValueError(f"min_samples={self.min_samples} must be >= 1")
        if self.epe_threshold <= 0:
            raise ValueError(
                f"epe_threshold={self.epe_threshold} must be > 0")
        if not 0 < self.error_threshold <= 1:
            raise ValueError(
                f"error_threshold={self.error_threshold} not in (0, 1]")
        if not 0 < self.confidence_threshold <= 1:
            raise ValueError(
                f"confidence_threshold={self.confidence_threshold} "
                f"not in (0, 1]")
        if self.demote_after_s < 0:
            raise ValueError(
                f"demote_after_s={self.demote_after_s} must be >= 0")


class RolloutPolicy:
    """One canary arm at a time, with deterministic traffic splitting,
    shadow-compare bookkeeping, and hysteresis auto-demotion.  All state
    under one lock; every decision method is cheap and pure given the
    armed state (the I/O — forwarding, mirroring — is the router's)."""

    _CANARY_SALT = b"raft-canary:"
    _SHADOW_SALT = b"raft-shadow:"

    def __init__(self, cfg: RolloutConfig = RolloutConfig(),
                 registry: Optional[MetricsRegistry] = None,
                 clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        # Armed canary: (name, version) + fractions; None = no rollout.
        self._model: Optional[Tuple[str, str]] = None
        self._fraction = 0.0
        self._shadow_fraction = 0.0
        self._demoted = False
        self._demoted_reason: Optional[str] = None
        self._bad_since: Optional[float] = None
        # Rolling evidence.
        self._epe_window: Deque[float] = deque(maxlen=cfg.window)
        self._outcome_window: Deque[bool] = deque(maxlen=cfg.window)
        self._conf_window: Deque[float] = deque(maxlen=cfg.window)
        self._transitions = []
        r = registry or MetricsRegistry()
        self.registry = r
        self.canary_requests = r.counter(
            "fleet_canary_requests_total",
            "stateless requests the rollout policy split onto the "
            "canary model version")
        self.shadow_requests = r.counter(
            "fleet_shadow_requests_total",
            "baseline requests mirrored fire-and-forget to the canary "
            "version (answers compared and dropped, never returned)")
        self.shadow_compares = r.counter(
            "fleet_shadow_compares_total",
            "shadow answers successfully compared against their "
            "primary (mean-EPE divergence recorded)")
        self.demotions = r.counter(
            "fleet_canary_demotions_total",
            "canary arms auto-demoted to 0% after a sustained "
            "regression verdict (typed canary_demoted event)")
        self.fraction_gauge = r.gauge(
            "fleet_canary_fraction",
            "current canary traffic fraction (0 when disarmed or "
            "demoted)")
        self.shadow_epe_gauge = r.gauge(
            "fleet_shadow_epe_mean",
            "mean |EPE| divergence between canary and primary answers "
            "over the rolling shadow-compare window")
        self.shadow_confidence_gauge = r.gauge(
            "fleet_shadow_confidence_delta_mean",
            "mean confidence drop (primary minus canary, X-Confidence "
            "headers) over the rolling shadow-compare window")

    # ------------------------------------------------------------- arming
    def set_canary(self, spec: str, fraction: float,
                   shadow_fraction: float = 0.0) -> Dict[str, object]:
        """Arm (or re-arm) the canary: ``spec`` is ``name@version`` —
        the version is REQUIRED here; an operator rolling out "whatever
        latest resolves to" would make the demotion record ambiguous.
        Re-arming clears a previous demotion and its evidence windows
        (the operator looked; the new arm starts clean)."""
        name, version = parse_model_spec(spec)
        if version is None:
            raise ValueError(
                f"canary spec {spec!r} needs an explicit version "
                f"(name@version): demotion records must name the exact "
                f"weights they demoted")
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction={fraction} not in [0, 1]")
        if not 0.0 <= shadow_fraction <= 1.0:
            raise ValueError(
                f"shadow_fraction={shadow_fraction} not in [0, 1]")
        with self._lock:
            self._model = (name, version)
            self._fraction = float(fraction)
            self._shadow_fraction = float(shadow_fraction)
            self._demoted = False
            self._demoted_reason = None
            self._bad_since = None
            self._epe_window.clear()
            self._outcome_window.clear()
            self._conf_window.clear()
            self._note_event_locked("canary_armed", fraction=fraction,
                                    shadow_fraction=shadow_fraction)
            self.fraction_gauge.set(fraction)
        log.info("canary armed: %s@%s at %.1f%% traffic (%.1f%% shadow)",
                 name, version, fraction * 100, shadow_fraction * 100)
        return self.status()

    def clear_canary(self) -> Dict[str, object]:
        """Disarm: no traffic splits, no mirroring, windows dropped."""
        with self._lock:
            self._model = None
            self._fraction = self._shadow_fraction = 0.0
            self._demoted = False
            self._demoted_reason = None
            self._bad_since = None
            self._epe_window.clear()
            self._outcome_window.clear()
            self._conf_window.clear()
            self._note_event_locked("canary_cleared")
            self.fraction_gauge.set(0)
        return self.status()

    def _note_event_locked(self, event: str, **fields) -> None:
        entry = {"t": self._clock(), "event": event}
        if self._model is not None:
            entry["model"] = f"{self._model[0]}@{self._model[1]}"
        entry.update(fields)
        self._transitions.append(entry)
        if len(self._transitions) > 50:
            self._transitions = self._transitions[-50:]

    # ---------------------------------------------------------- decisions
    @property
    def active(self) -> bool:
        with self._lock:
            return (self._model is not None and not self._demoted
                    and (self._fraction > 0 or self._shadow_fraction > 0))

    def canary_model(self) -> Optional[Tuple[str, str]]:
        with self._lock:
            return self._model

    def assign(self, request_key: bytes) -> Optional[str]:
        """The split decision for one stateless request that named NO
        model itself: the canary model NAME to tag it with (the replica
        registry resolves the weights), or None for the baseline arm.
        Deterministic in ``request_key`` (the request body)."""
        with self._lock:
            if (self._model is None or self._demoted
                    or self._fraction <= 0):
                return None
            if _hash_fraction(self._CANARY_SALT,
                              request_key) >= self._fraction:
                return None
            self.canary_requests.inc()
            return self._model[0]

    def wants_shadow(self, request_key: bytes) -> bool:
        """Whether this BASELINE request should also be mirrored to the
        canary (fire-and-forget).  Independent salt from ``assign`` so
        the shadow sample is uncorrelated with the canary split."""
        with self._lock:
            if (self._model is None or self._demoted
                    or self._shadow_fraction <= 0):
                return False
            if _hash_fraction(self._SHADOW_SALT,
                              request_key) >= self._shadow_fraction:
                return False
            self.shadow_requests.inc()
            return True

    # ----------------------------------------------------------- evidence
    def note_canary_result(self, ok: bool) -> None:
        """One canary-arm request finished: ``ok`` is transport success
        AND status < 500 (4xx is the CLIENT's fault on either arm)."""
        with self._lock:
            self._outcome_window.append(bool(ok))
        self.poll()

    def note_shadow_epe(self, epe: float) -> None:
        """One shadow pair compared: ``epe`` is the mean end-point-error
        divergence (px) between the canary and primary disparity maps
        on the SAME input."""
        with self._lock:
            self._epe_window.append(float(epe))
            self.shadow_compares.inc()
            vals = list(self._epe_window)
            self.shadow_epe_gauge.set(sum(vals) / len(vals))
        self.poll()

    def note_shadow_confidence(self, delta: float) -> None:
        """One shadow pair's confidence compared: ``delta`` is the
        primary's mean confidence minus the canary's on the SAME input
        (positive = the canary is LESS sure of its answer).  Fed by the
        router only when both arms answered with ``X-Confidence``."""
        with self._lock:
            self._conf_window.append(float(delta))
            vals = list(self._conf_window)
            self.shadow_confidence_gauge.set(sum(vals) / len(vals))
        self.poll()

    def _regression_locked(self) -> Optional[str]:
        """The current regression verdict, or None: which signal says
        the canary is worse than the incumbent."""
        if len(self._epe_window) >= self.cfg.min_samples:
            mean_epe = sum(self._epe_window) / len(self._epe_window)
            if mean_epe > self.cfg.epe_threshold:
                return (f"shadow_epe mean {mean_epe:.3f}px > "
                        f"{self.cfg.epe_threshold}px over "
                        f"{len(self._epe_window)} compares")
        if len(self._outcome_window) >= self.cfg.min_samples:
            errs = sum(1 for ok in self._outcome_window if not ok)
            rate = errs / len(self._outcome_window)
            if rate > self.cfg.error_threshold:
                return (f"canary error rate {rate:.2f} > "
                        f"{self.cfg.error_threshold} over "
                        f"{len(self._outcome_window)} requests")
        if len(self._conf_window) >= self.cfg.min_samples:
            mean_drop = sum(self._conf_window) / len(self._conf_window)
            if mean_drop > self.cfg.confidence_threshold:
                return (f"shadow confidence drop {mean_drop:.3f} > "
                        f"{self.cfg.confidence_threshold} over "
                        f"{len(self._conf_window)} compares")
        return None

    def poll(self) -> bool:
        """One hysteresis evaluation (called after every evidence note
        and from the router's health loop).  Returns True when THIS call
        demoted the canary."""
        now = self._clock()
        with self._lock:
            if self._model is None or self._demoted:
                return False
            reason = self._regression_locked()
            if reason is None:
                self._bad_since = None
                return False
            if self._bad_since is None:
                self._bad_since = now
            if now - self._bad_since < self.cfg.demote_after_s:
                return False
            # Sustained regression: demote to 0%, one-way.
            self._demoted = True
            self._demoted_reason = reason
            self._fraction = 0.0
            self._shadow_fraction = 0.0
            self.demotions.inc()
            self.fraction_gauge.set(0)
            self._note_event_locked("canary_demoted", reason=reason)
            name, version = self._model
        log.warning("canary %s@%s DEMOTED to 0%%: %s", name, version,
                    reason)
        return True

    # ------------------------------------------------------------- status
    def status(self) -> Dict[str, object]:
        with self._lock:
            vals = list(self._epe_window)
            confs = list(self._conf_window)
            return {
                "model": (f"{self._model[0]}@{self._model[1]}"
                          if self._model else None),
                "fraction": self._fraction,
                "shadow_fraction": self._shadow_fraction,
                "demoted": self._demoted,
                "demoted_reason": self._demoted_reason,
                "canary_requests": self.canary_requests.value,
                "shadow_requests": self.shadow_requests.value,
                "shadow_compares": self.shadow_compares.value,
                "shadow_epe_mean": (round(sum(vals) / len(vals), 4)
                                    if vals else None),
                "shadow_confidence_delta_mean": (
                    round(sum(confs) / len(confs), 4) if confs
                    else None),
                "canary_errors": sum(
                    1 for ok in self._outcome_window if not ok),
                "demotions": self.demotions.value,
                "transitions": list(self._transitions[-20:]),
            }
