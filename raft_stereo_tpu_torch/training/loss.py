"""Sequence loss over per-iteration predictions (reference:
train_stereo.py:35-69), the JAX package's formula and metrics.

The model emits a stacked (iters, B, H, W) x-flow; the y component is zero
by the epipolar projection, so L1 and EPE are absolute errors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, loss_gamma: float = 0.9,
                  max_flow: float = 700.0,
                  denom: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Exponentially weighted L1 over all iteration outputs.

    Args:
      flow_preds: (iters, B, H, W) per-iteration x-flow, fp32.
      flow_gt: (B, H, W) ground-truth x-flow (= -disparity), fp32.
      valid: (B, H, W) validity; a pixel counts where it is >= 0.5.
      loss_gamma: base decay, renormalized so the schedule does not
        depend on the iteration count (reference: train_stereo.py:52-54).
      max_flow: pixels with |flow| >= max_flow are excluded.
      denom: the count of counted pixels to divide by (at least 1), by
        default this batch's.  A data-parallel process passes the global
        batch's (training/step.py), so the sums of every process's
        loss and metrics are the global batch's.

    Returns the scalar loss and the metrics ``epe``, ``1px``, ``3px``,
    ``5px`` of the final prediction, all 0-d fp32 tensors on the device."""
    n = flow_preds.shape[0]
    gamma_adj = loss_gamma ** (15.0 / max(n - 1, 1))
    maskf = loss_mask(flow_gt, valid, max_flow)
    if denom is None:
        denom = maskf.sum().clamp_min(1.0)
    abs_err = (flow_preds - flow_gt[None]).abs()
    per_iter = (abs_err * maskf[None]).sum(dim=(1, 2, 3)) / denom
    weights = torch.tensor(gamma_adj, dtype=torch.float32,
                           device=flow_preds.device) ** torch.arange(
        n - 1, -1, -1, dtype=torch.float32, device=flow_preds.device)
    loss = (weights * per_iter).sum()
    epe = abs_err[-1]
    metrics = {
        "epe": (epe * maskf).sum() / denom,
        "1px": ((epe < 1).float() * maskf).sum() / denom,
        "3px": ((epe < 3).float() * maskf).sum() / denom,
        "5px": ((epe < 5).float() * maskf).sum() / denom,
    }
    return loss, metrics


def loss_mask(flow_gt: torch.Tensor, valid: torch.Tensor,
              max_flow: float) -> torch.Tensor:
    """The fp32 mask of the pixels the loss and the metrics count."""
    return ((valid >= 0.5) & (flow_gt.abs() < max_flow)).float()
