"""Typed anomaly policy of the training loop: skip, rewind, give up (the
JAX package's ``training/anomaly.py``).

* **Skip**: the step (training/step.py ``anomaly_train_step``) decides on
  the card whether an update is poisoned (a non-finite loss or gradient
  norm, or a loss above ``spike_factor`` times the loss EWMA) and keeps
  every leaf of the old state through ``torch.where``.  The decision
  never syncs the host: the skip flags ride the metrics to the buffered
  drain.
* **Rewind**: ``AnomalyTracker``, fed the drained per-step metrics,
  counts consecutive skips; ``rewind_after`` of them in a row restore the
  newest checkpoint that passes the finite-state probe and reshuffle the
  rest of the epoch (``StereoLoader.add_salt``).
* **Give up**: with ``max_rewinds`` spent, or no checkpoint to rewind
  to, the loop raises ``TrainingDiverged``.

Everything here is host bookkeeping over already-fetched floats; with the
policy off (the default) the step and the loop take their plain paths.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

# Metric keys the anomaly-mode step adds to its metrics dict (device-side
# 0/1 flags; the tracker and telemetry read them after the buffered drain).
SKIP_KEY = "skipped"
SKIP_NONFINITE_KEY = "skip_nonfinite"
SKIP_SPIKE_KEY = "skip_spike"
ANOMALY_METRIC_KEYS = (SKIP_KEY, SKIP_NONFINITE_KEY, SKIP_SPIKE_KEY)


class TrainingDiverged(RuntimeError):
    """Typed terminal divergence: the anomaly policy ran out of moves
    (no valid checkpoint to rewind to, or ``max_rewinds`` exhausted).
    Carries the step so an operator/runbook can resume by hand from an
    older checkpoint with different hyperparameters."""

    def __init__(self, step: int, reason: str):
        super().__init__(f"training diverged at step {step}: {reason}")
        self.step = step
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class AnomalyPolicy:
    """The typed policy knobs (``TrainConfig.anomaly_*``).

    ``spike_factor`` — a finite loss above ``spike_factor × EWMA(loss)``
    is dropped too (0 disables the spike gate; non-finite is always
    dropped).  The EWMA lives ON DEVICE, threaded through the step like
    the train state, so the gate costs no host sync; ``ewma_beta`` is its
    decay.  ``rewind_after`` — this many CONSECUTIVE dropped steps
    trigger a checkpoint rewind (0 = never rewind, skip-only).
    ``max_rewinds`` — rewinds allowed before the run fails typed
    (``TrainingDiverged``)."""

    spike_factor: float = 0.0
    ewma_beta: float = 0.98
    rewind_after: int = 3
    max_rewinds: int = 2

    def __post_init__(self):
        if self.spike_factor < 0:
            raise ValueError(f"spike_factor={self.spike_factor} must be "
                             f">= 0 (0 disables the spike gate)")
        if not 0.0 < self.ewma_beta < 1.0:
            raise ValueError(f"ewma_beta={self.ewma_beta} must be in (0, 1)")
        if self.rewind_after < 0:
            raise ValueError(f"rewind_after={self.rewind_after} must be "
                             f">= 0 (0 = skip-only)")
        if self.max_rewinds < 0:
            raise ValueError(f"max_rewinds={self.max_rewinds} must be >= 0")

    @classmethod
    def from_train_config(cls, train_cfg) -> Optional["AnomalyPolicy"]:
        """None when ``TrainConfig.anomaly_policy`` is off — the loop and
        step take the exact pre-policy path then."""
        if not getattr(train_cfg, "anomaly_policy", False):
            return None
        return cls(
            spike_factor=getattr(train_cfg, "anomaly_spike_factor", 0.0),
            ewma_beta=getattr(train_cfg, "anomaly_ewma_beta", 0.98),
            rewind_after=getattr(train_cfg, "anomaly_rewind_after", 3),
            max_rewinds=getattr(train_cfg, "anomaly_max_rewinds", 2))


class AnomalyTracker:
    """Host-side anomaly bookkeeping over drained per-step metrics.

    ``observe(step, metrics)`` is called once per DRAINED step (the loop
    feeds it each fetched metrics dict, oldest first); it returns the
    anomaly kind (``"nonfinite"`` / ``"spike"``) when that step's update
    was dropped on device, else None.  ``should_rewind()`` goes True at
    ``rewind_after`` consecutive drops.  The whole history round-trips
    through the checkpoint runtime blob (``history()`` /
    ``load_history``) so a resumed run keeps its rewind budget —
    a crash-loop cannot reset the give-up counter.
    """

    def __init__(self, policy: AnomalyPolicy):
        self.policy = policy
        self.skipped_nonfinite = 0
        self.skipped_spike = 0
        self.consecutive = 0
        self.rewinds = 0
        # (step, kind) of recent anomalies — bounded, for the runtime
        # blob / post-mortem, not for decisions.
        self.recent: List[Dict[str, object]] = []
        self._recent_cap = 64

    def observe(self, step: int, metrics: Dict[str, float]) -> Optional[str]:
        skipped = float(metrics.get(SKIP_KEY, 0.0))
        if skipped < 0.5:
            self.consecutive = 0
            return None
        if float(metrics.get(SKIP_NONFINITE_KEY, 0.0)) >= 0.5:
            kind = "nonfinite"
            self.skipped_nonfinite += 1
        else:
            kind = "spike"
            self.skipped_spike += 1
        self.consecutive += 1
        self.recent.append({"step": int(step), "kind": kind})
        del self.recent[:-self._recent_cap]
        return kind

    @property
    def skipped_total(self) -> int:
        return self.skipped_nonfinite + self.skipped_spike

    def should_rewind(self) -> bool:
        return (self.policy.rewind_after > 0
                and self.consecutive >= self.policy.rewind_after)

    def rewind_budget_left(self) -> bool:
        return self.rewinds < self.policy.max_rewinds

    def note_rewind(self, step: int, to_step: int, checkpoint: str) -> None:
        self.rewinds += 1
        self.consecutive = 0
        self.recent.append({"step": int(step), "kind": "rewind",
                            "to_step": int(to_step),
                            "checkpoint": checkpoint})
        del self.recent[:-self._recent_cap]

    # -------------------------------------------------- checkpoint blob
    def history(self) -> Dict[str, object]:
        return {"skipped_nonfinite": self.skipped_nonfinite,
                "skipped_spike": self.skipped_spike,
                "consecutive": self.consecutive,
                "rewinds": self.rewinds,
                "recent": list(self.recent)}

    def load_history(self, h: Optional[Dict[str, object]]) -> None:
        if not h:
            return
        self.skipped_nonfinite = int(h.get("skipped_nonfinite", 0))
        self.skipped_spike = int(h.get("skipped_spike", 0))
        self.consecutive = int(h.get("consecutive", 0))
        self.rewinds = int(h.get("rewinds", 0))
        self.recent = list(h.get("recent", []))
