"""One optimisation step (reference: train_stereo.py:159-181; the JAX
package's ``training/step.py`` ``train_step``).

Forward over all GRU iterations in train mode, sequence loss, backward,
global-norm clip, AdamW with the one-cycle schedule.  There is no loss
scaling: bf16 has fp32's exponent range.  The metrics stay on the device
(0-d tensors), so a step never waits for the card.  The forward, the
backward and the update are named ``raft::train_forward``,
``raft::train_backward`` and ``raft::clip_and_update`` in a
``torch.profiler`` trace (tools/torch_profile.py ``--train``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from raft_stereo_tpu_torch.training.loss import sequence_loss
from raft_stereo_tpu_torch.training.optimizer import clip_by_global_norm_
from raft_stereo_tpu_torch.training.state import TrainState


def _to_device(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device, non_blocking=True)


def train_step(state: TrainState, batch: Mapping[str, object], *,
               iters: int, loss_gamma: float, max_flow: float,
               gru_telemetry: bool = False
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step on ``batch``, updating ``state`` in place.

    ``batch`` is the JAX loader's dict: image1/image2 (B,H,W,3) uint8 or
    float 0..255, flow (B,H,W) x-flow in fp32 or fp16, valid (B,H,W) in
    {0,1} of any dtype; numpy arrays or tensors.  Flow and valid are cast
    to fp32 on the device.  Returns the state and the metrics ``loss``,
    ``grad_norm`` (before the clip), ``epe``, ``1px``, ``3px``, ``5px``,
    and ``gru_delta_px`` (mean |disparity update| per iteration, (iters-1,))
    when ``gru_telemetry`` is set."""
    model = state.model
    device = next(model.parameters()).device
    img1 = _to_device(batch["image1"], device)
    img2 = _to_device(batch["image2"], device)
    flow_gt = _to_device(batch["flow"], device).float()
    valid = _to_device(batch["valid"], device).float()
    state.optimizer.zero_grad(set_to_none=True)
    with record_function("raft::train_forward"):
        preds = model(img1, img2, iters=iters, test_mode=False)
        loss, metrics = sequence_loss(preds, flow_gt, valid,
                                      loss_gamma=loss_gamma,
                                      max_flow=max_flow)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if gru_telemetry and iters > 1:
        p = preds.detach()
        metrics["gru_delta_px"] = (p[1:] - p[:-1]).abs().mean(dim=(1, 2, 3))
    with record_function("raft::train_backward"):
        loss.backward()
    with record_function("raft::clip_and_update"):
        grad_norm = clip_by_global_norm_(model.parameters(),
                                         state.train_cfg.clip_grad_norm)
        state.optimizer.step()
        state.scheduler.step()
    state.step += 1
    metrics.update(loss=loss.detach(), grad_norm=grad_norm)
    return state, metrics
