"""Optimizer, schedule and gradient clip (reference: train_stereo.py:72-79),
as the JAX package's ``make_optimizer`` chain builds them.

AdamW (betas 0.9/0.999) over the model's parameters, which are exactly the
JAX ``params`` collection (conv weights and biases, norm scales and
biases; frozen-BN statistics are buffers), with the one-cycle linear
schedule through ``LambdaLR``.  Gradients are clipped to a global norm
before the update with optax's ``clip_by_global_norm``:
``g * max_norm / max(|g|, max_norm)``, the norm taken in fp32 over all
gradients.  ``torch.nn.utils.clip_grad_norm_`` is not that function (it
adds 1e-6 to the norm).
"""

from __future__ import annotations

import warnings
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import TrainConfig


def one_cycle_lr(peak_lr: float, total_steps: int, pct_start: float = 0.01,
                 div_factor: float = 25.0, final_div_factor: float = 1e4
                 ) -> Callable[[int], float]:
    """Piecewise-linear one-cycle schedule (torch ``OneCycleLR`` with a
    linear anneal), computed in fp32 as the JAX function computes it."""
    initial = peak_lr / div_factor
    final = initial / final_div_factor
    if pct_start * total_steps < 2.0:
        warnings.warn(
            f"one_cycle_lr: pct_start*total_steps = {pct_start * total_steps:.1f}"
            " < 2 leaves no real warmup phase — LR jumps to peak after one"
            " step and torch OneCycleLR equivalence does not hold (fine for"
            " smoke tests, not for real training)", stacklevel=2)
    peak_step = max(float(pct_start * total_steps) - 1.0, 1.0)
    last_step = float(total_steps - 1)
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        up = f32(initial) + f32(peak_lr - initial) * (s / f32(peak_step))
        frac = (s - f32(peak_step)) / f32(max(last_step - peak_step, 1.0))
        down = f32(peak_lr) + f32(final - peak_lr) * np.clip(
            frac, f32(0.0), f32(1.0))
        return float(up if s < f32(peak_step) else down)

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig
                   ) -> Tuple[torch.optim.AdamW,
                              torch.optim.lr_scheduler.LambdaLR]:
    """AdamW with the one-cycle schedule over ``num_steps + 100`` steps,
    as the reference schedules it (the final LR is never reached).  The
    optimizer's base LR is 1, so the scheduler's factor IS the LR."""
    schedule = one_cycle_lr(cfg.lr, cfg.num_steps + 100)
    opt = torch.optim.AdamW(list(params), lr=1.0, betas=(0.9, 0.999),
                            eps=cfg.epsilon, weight_decay=cfg.wdecay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter],
                         max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by ``max_norm / max(norm, max_norm)``;
    returns the fp32 global norm before the clip, on the device (no host
    sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    factor = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, factor.to(grads[0].dtype))
    return norm
