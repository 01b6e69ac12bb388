"""One optimisation step (reference: train_stereo.py:159-181; the JAX
package's ``training/step.py``).

Forward over all GRU iterations in train mode, sequence loss, backward,
global-norm clip, AdamW with the one-cycle schedule.  There is no loss
scaling: bf16 has fp32's exponent range.  The metrics stay on the device
(0-d tensors), so a step never waits for the card.  The forward, the
backward and the update are named ``raft::train_forward``,
``raft::train_backward`` and ``raft::clip_and_update`` in a
``torch.profiler`` trace (tools/torch_profile.py ``--train``).

``anomaly_train_step`` wraps the same forward and backward in the
anomaly policy's gate (training/anomaly.py), decided on the device: a
non-finite loss or gradient norm, or a loss above ``spike_factor`` times
the loss EWMA, keeps every leaf of the old state (parameters, AdamW
moments, the update count that drives the schedule, the EWMA).  The
update is computed out of place and merged leaf by leaf with
``torch.where``, which selects and never mixes: a NaN in the discarded
branch cannot leak, as a 0/1 multiply or ``lerp`` would let it.  The
update is torch's AdamW, ``capturable`` on the card, with the learning
rate a device tensor set from the device count, so nothing reaches the
host before the buffered drain.

Under data parallelism (``TrainState.ddp``, a ``DistributedDataParallel``
over the model; training/train_loop.py) each process steps on its slice
of the global batch and the step computes what one process would on the
whole batch: the loss divides by the global batch's count of counted
pixels (one all-reduce before the forward), each process backpropagates
its share times the world size, so DDP's gradient mean is the global
loss's gradient, and the loss and metrics are summed over the processes
(one all-reduce after the backward).  The photometric jitter draws the
global batch's factors and takes this process's rows.  Every process thus
clips, gates and updates on the same numbers.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from raft_stereo_tpu_torch.config import TrainConfig
from raft_stereo_tpu_torch.data.device_jitter import (JitterParams,
                                                      apply_photometric,
                                                      draw_factors,
                                                      local_rows,
                                                      params_for_datasets)
from raft_stereo_tpu_torch.training.anomaly import (SKIP_KEY,
                                                    SKIP_NONFINITE_KEY,
                                                    SKIP_SPIKE_KEY,
                                                    AnomalyPolicy)
from raft_stereo_tpu_torch.training.loss import loss_mask, sequence_loss
from raft_stereo_tpu_torch.training.optimizer import (clip_by_global_norm_,
                                                      one_cycle_lr_tensor)
from raft_stereo_tpu_torch.training.state import TrainState


def _to_device(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device, non_blocking=True)


def _forward_backward(state: TrainState, batch: Mapping[str, object],
                      iters: int, loss_gamma: float, max_flow: float,
                      gru_telemetry: bool,
                      jitter: Optional[JitterParams], jitter_seed: int,
                      jitter_step) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """Forward, loss and backward; the gradients are left in ``.grad``.
    Under ``state.ddp`` the returned loss and metrics are the global
    batch's (module docstring)."""
    model = state.model
    device = next(model.parameters()).device
    world, rank = ((state.ddp.process_group.size(),
                    state.ddp.process_group.rank())
                   if state.ddp is not None else (1, 0))
    img1 = _to_device(batch["image1"], device)
    img2 = _to_device(batch["image2"], device)
    if jitter is not None:
        if not isinstance(jitter_step, torch.Tensor):
            jitter_step = torch.full((), jitter_step, dtype=torch.int64,
                                     device=device)
        factors = draw_factors(jitter_seed, jitter_step,
                               img1.shape[0] * world, jitter)
        img1, img2 = apply_photometric(img1, img2,
                                       local_rows(factors, rank, world))
    flow_gt = _to_device(batch["flow"], device).float()
    valid = _to_device(batch["valid"], device).float()
    denom = None
    if world > 1:
        denom = loss_mask(flow_gt, valid, max_flow).sum()
        torch.distributed.all_reduce(denom, group=state.ddp.process_group)
        denom = denom.clamp_min(1.0)
    state.optimizer.zero_grad(set_to_none=True)
    with record_function("raft::train_forward"):
        net = model if state.ddp is None else state.ddp
        preds = net(img1, img2, iters=iters, test_mode=False)
        loss, metrics = sequence_loss(preds, flow_gt, valid,
                                      loss_gamma=loss_gamma,
                                      max_flow=max_flow, denom=denom)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if gru_telemetry and iters > 1:
        p = preds.detach()
        metrics["gru_delta_px"] = (p[1:] - p[:-1]).abs().mean(dim=(1, 2, 3))
    with record_function("raft::train_backward"):
        (loss * world if world > 1 else loss).backward()
    loss = loss.detach()
    if world > 1:
        loss, metrics = _global_sums(loss, metrics, world,
                                     state.ddp.process_group)
    return loss, metrics


def _global_sums(loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
                 world: int, group) -> Tuple[torch.Tensor,
                                             Dict[str, torch.Tensor]]:
    """The loss and metrics of the global batch, in one all-reduce: the
    processes' loss and metric sums (each over the global count), and the
    mean of their per-iteration ``gru_delta_px`` (each a mean over an
    equal share of the batch)."""
    keys = [k for k in metrics if k != "gru_delta_px"]
    parts = [loss.reshape(1)] + [metrics[k].reshape(1) for k in keys]
    if "gru_delta_px" in metrics:
        parts.append(metrics["gru_delta_px"] / world)
    flat = torch.cat([p.float() for p in parts])
    torch.distributed.all_reduce(flat, group=group)
    out = dict(zip(keys, flat[1:1 + len(keys)].unbind()))
    if "gru_delta_px" in metrics:
        out["gru_delta_px"] = flat[1 + len(keys):]
    return flat[0], out


def train_step(state: TrainState, batch: Mapping[str, object], *,
               iters: int, loss_gamma: float, max_flow: float,
               gru_telemetry: bool = False,
               jitter: Optional[JitterParams] = None, jitter_seed: int = 0
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step on ``batch``, updating ``state`` in place.

    ``batch`` is the loader's dict: image1/image2 (B,H,W,3) uint8 or
    float 0..255, flow (B,H,W) x-flow in fp32 or fp16, valid (B,H,W) in
    {0,1} of any dtype; numpy arrays or tensors.  Flow and valid are cast
    to fp32 on the device.  ``jitter`` applies the on-device photometric
    augmentation with factors from ``(jitter_seed, state.step)``.
    Returns the state and the metrics ``loss``, ``grad_norm`` (before the
    clip), ``epe``, ``1px``, ``3px``, ``5px``, and ``gru_delta_px`` (mean
    |disparity update| per iteration, (iters-1,)) when ``gru_telemetry``
    is set."""
    loss, metrics = _forward_backward(state, batch, iters, loss_gamma,
                                      max_flow, gru_telemetry, jitter,
                                      jitter_seed, state.step)
    with record_function("raft::clip_and_update"):
        grad_norm = clip_by_global_norm_(state.model.parameters(),
                                         state.train_cfg.clip_grad_norm)
        state.optimizer.step()
        state.scheduler.step()
    state.step += 1
    metrics.update(loss=loss, grad_norm=grad_norm)
    return state, metrics


@torch.no_grad()
def _gated_adamw_(state: TrainState, skip: torch.Tensor) -> None:
    """One step of the state's torch AdamW at ``one_cycle_lr(count)``,
    each leaf (parameter, ``exp_avg``, ``exp_avg_sq``, AdamW's ``step``)
    and the count kept where the 0-d bool ``skip`` is set.  The old
    leaves are copied before the step and merged back after it with
    ``torch.where``; a leaf AdamW has not made yet (the first step) was
    zero."""
    cfg = state.train_cfg
    opt = state.optimizer
    for group in opt.param_groups:
        group["lr"].copy_(
            one_cycle_lr_tensor(cfg.lr, cfg.num_steps + 100)(state.count))
    old = [(p, p.clone(), {k: v.clone() for k, v in opt.state[p].items()})
           for group in opt.param_groups for p in group["params"]
           if p.grad is not None]
    opt.step()
    for p, p_old, st_old in old:
        p.copy_(torch.where(skip, p_old, p))
        for k, v in opt.state[p].items():
            v.copy_(torch.where(skip, st_old[k] if k in st_old
                                else torch.zeros_like(v), v))
    state.count.copy_(torch.where(skip, state.count, state.count + 1))


def anomaly_train_step(state: TrainState, batch: Mapping[str, object],
                       loss_ewma: torch.Tensor, *, iters: int,
                       loss_gamma: float, max_flow: float,
                       policy: AnomalyPolicy,
                       gru_telemetry: bool = False,
                       jitter: Optional[JitterParams] = None,
                       jitter_seed: int = 0):
    """``train_step`` behind the anomaly gate, for a state made with
    ``create_train_state(..., anomaly=True)``.  ``loss_ewma`` is an fp32
    0-d tensor on the device (0 = no baseline yet; the first finite loss
    seeds it).  Returns ``(state, metrics, new_ewma)``; the metrics gain
    the 0/1 fp32 flags ``skipped``, ``skip_nonfinite`` and
    ``skip_spike``.  ``state.step`` (the loop's step) advances either
    way; ``state.count`` only with an applied update, and the jitter
    folds in the count, as the JAX step folds in its ``state.step``."""
    loss, metrics = _forward_backward(state, batch, iters, loss_gamma,
                                      max_flow, gru_telemetry, jitter,
                                      jitter_seed, state.count)
    with record_function("raft::clip_and_update"):
        grad_norm = clip_by_global_norm_(state.model.parameters(),
                                         state.train_cfg.clip_grad_norm)
        nonfinite = ~(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if policy.spike_factor > 0:
            spike = (~nonfinite & (loss_ewma > 0)
                     & (loss > loss_ewma * policy.spike_factor))
        else:
            spike = torch.zeros_like(nonfinite)
        skip = nonfinite | spike
        _gated_adamw_(state, skip)
    beta = policy.ewma_beta
    updated = torch.where(loss_ewma > 0,
                          beta * loss_ewma + (1.0 - beta) * loss, loss)
    new_ewma = torch.where(skip, loss_ewma, updated)
    state.step += 1
    metrics.update(loss=loss, grad_norm=grad_norm,
                   **{SKIP_KEY: skip.float(),
                      SKIP_NONFINITE_KEY: nonfinite.float(),
                      SKIP_SPIKE_KEY: spike.float()})
    return state, metrics, new_ewma


def make_train_step(train_cfg: TrainConfig,
                    anomaly: Optional[AnomalyPolicy] = None):
    """The step of ``train_cfg``: ``step(state, batch) -> (state,
    metrics)``, or with an ``AnomalyPolicy`` ``step(state, batch,
    loss_ewma) -> (state, metrics, loss_ewma)``.  With
    ``device_photometric`` the step jitters the images on the device."""
    jitter = None
    if train_cfg.device_photometric:
        jitter = params_for_datasets(train_cfg.train_datasets,
                                     saturation_range=train_cfg.saturation_range,
                                     img_gamma=train_cfg.img_gamma)
    common = dict(iters=train_cfg.train_iters,
                  loss_gamma=train_cfg.loss_gamma,
                  max_flow=train_cfg.max_flow,
                  gru_telemetry=train_cfg.gru_telemetry,
                  jitter=jitter, jitter_seed=train_cfg.seed)
    if anomaly is not None:
        return functools.partial(anomaly_train_step, policy=anomaly,
                                 **common)
    return functools.partial(train_step, **common)
