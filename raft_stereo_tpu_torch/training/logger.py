"""Training metrics logger: running-mean console prints and TensorBoard
(the JAX package's ``training/logger.py``; reference:
train_stereo.py:82-129).

Running means flushed every ``SUM_FREQ = 100`` steps to the console and a
``SummaryWriter``, per-step ``live_loss``/``learning_rate`` scalars,
``write_dict`` for validation results.  TensorBoard is optional: without
it the logger prints to the console only.
"""

from __future__ import annotations

import logging
from typing import Dict

log = logging.getLogger(__name__)

SUM_FREQ = 100


class Logger:
    def __init__(self, log_dir: str = "runs", total_steps: int = 0,
                 enable_tensorboard: bool = True):
        self.total_steps = total_steps
        self.running: Dict[str, float] = {}
        self.running_count = 0  # pushes since the last flush
        self._last_lr = 0.0
        self.writer = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(log_dir=log_dir)
            except ImportError:
                log.warning("tensorboard unavailable; console logging only")

    def _flush(self, lr: float):
        # Divide by the ACTUAL accumulated count, not SUM_FREQ: the
        # ``% SUM_FREQ == SUM_FREQ - 1`` flush condition means the first
        # window holds only SUM_FREQ-1 pushes (and the final partial drain
        # at close() fewer still) — a constant divisor deflated those means.
        n = self.running_count
        if not n:
            return
        means = {k: v / n for k, v in self.running.items()}
        msg = ", ".join(f"{k} {v:.4f}" for k, v in sorted(means.items()))
        log.info("step %d, lr %.7f: %s", self.total_steps, lr, msg)
        if self.writer is not None:
            for k, v in means.items():
                self.writer.add_scalar(k, v, self.total_steps)
        self.running = {}
        self.running_count = 0

    def push(self, metrics: Dict[str, float], lr: float = 0.0):
        """Accumulate one step's metrics; flush every SUM_FREQ steps."""
        self.total_steps += 1
        self.running_count += 1
        self._last_lr = lr
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.writer is not None:
            self.writer.add_scalar("live_loss", float(metrics.get("loss", 0)),
                                   self.total_steps)
            self.writer.add_scalar("learning_rate", lr, self.total_steps)
        if self.total_steps % SUM_FREQ == SUM_FREQ - 1:
            self._flush(lr)

    def write_dict(self, results: Dict[str, float]):
        """Log validation results (reference: train_stereo.py:121-126)."""
        log.info("validation @ step %d: %s", self.total_steps, results)
        if self.writer is not None:
            for k, v in results.items():
                self.writer.add_scalar(k, float(v), self.total_steps)

    def close(self):
        # Drain a partial window first so a run that stops between flush
        # boundaries (preemption, crash, short test run) keeps its tail.
        if self.running_count:
            self._flush(getattr(self, "_last_lr", 0.0))
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    def __enter__(self) -> "Logger":
        return self

    def __exit__(self, *exc) -> None:
        """Context manager: the TensorBoard writer closes on every exit
        path (train_loop.py wraps the whole loop in ``with Logger(...)``)."""
        self.close()
