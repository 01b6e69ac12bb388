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
from typing import Callable, Iterable, Optional, Tuple

import torch

from raft_stereo_tpu_torch.config import TrainConfig


BETAS = (0.9, 0.999)


def one_cycle_lr_tensor(peak_lr: float, total_steps: int,
                        pct_start: float = 0.01, div_factor: float = 25.0,
                        final_div_factor: float = 1e4
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Piecewise-linear one-cycle schedule (torch ``OneCycleLR`` with a
    linear anneal) of a count tensor: an fp32 0-d tensor on the count's
    device, computed in fp32 as the JAX function computes it, so the
    anomaly policy reads its LR from the device count with no host sync.
    The divisors are fp32 tensors: CUDA divides by a Python scalar as a
    product with its reciprocal, which rounds differently."""
    initial = peak_lr / div_factor
    final = initial / final_div_factor
    peak_step = max(float(pct_start * total_steps) - 1.0, 1.0)
    last_step = float(total_steps - 1)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        s = count.to(torch.float32)
        up = initial + (peak_lr - initial) * (
            s / torch.full_like(s, peak_step))
        frac = (s - peak_step) / torch.full_like(
            s, max(last_step - peak_step, 1.0))
        down = peak_lr + (final - peak_lr) * torch.clamp(frac, 0.0, 1.0)
        return torch.where(s < peak_step, up, down)

    return schedule


def one_cycle_lr(peak_lr: float, total_steps: int, pct_start: float = 0.01,
                 div_factor: float = 25.0, final_div_factor: float = 1e4
                 ) -> Callable[[int], float]:
    """``one_cycle_lr_tensor`` of a host step, as a Python float: the
    schedule of the host ``LambdaLR`` and of the logged LR."""
    if pct_start * total_steps < 2.0:
        warnings.warn(
            f"one_cycle_lr: pct_start*total_steps = {pct_start * total_steps:.1f}"
            " < 2 leaves no real warmup phase — LR jumps to peak after one"
            " step and torch OneCycleLR equivalence does not hold (fine for"
            " smoke tests, not for real training)", stacklevel=2)
    tensor_schedule = one_cycle_lr_tensor(peak_lr, total_steps, pct_start,
                                          div_factor, final_div_factor)
    return lambda step: float(tensor_schedule(torch.tensor(step)))


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                   anomaly: bool = False
                   ) -> Tuple[torch.optim.AdamW,
                              Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """AdamW with the one-cycle schedule over ``num_steps + 100`` steps,
    as the reference schedules it (the final LR is never reached).  The
    optimizer's base LR is 1, so the scheduler's factor IS the LR.

    ``anomaly``: the anomaly policy's AdamW, whose LR is an fp32 0-d
    tensor on the parameters' device that the step sets from the device
    count (``one_cycle_lr_tensor``); on the card it is ``capturable``, so
    its per-parameter ``step`` lives there too and no update reads the
    host.  There is no host scheduler then."""
    params = list(params)
    if anomaly:
        device = params[0].device
        return torch.optim.AdamW(
            params, lr=torch.zeros((), dtype=torch.float32, device=device),
            betas=BETAS, eps=cfg.epsilon, weight_decay=cfg.wdecay,
            capturable=device.type == "cuda"), None
    opt = torch.optim.AdamW(params, lr=1.0, betas=BETAS, eps=cfg.epsilon,
                            weight_decay=cfg.wdecay)
    return opt, make_scheduler(opt, cfg)


def make_scheduler(opt: torch.optim.AdamW, cfg: TrainConfig, count: int = 0
                   ) -> torch.optim.lr_scheduler.LambdaLR:
    """The host one-cycle ``LambdaLR`` over ``opt``, standing at
    ``count`` applied updates (the LR of the next update is
    ``schedule(count)``).  At a count above 0 the groups need the
    ``initial_lr`` the first scheduler over ``opt`` set."""
    return torch.optim.lr_scheduler.LambdaLR(
        opt, one_cycle_lr(cfg.lr, cfg.num_steps + 100), last_epoch=count - 1)


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
