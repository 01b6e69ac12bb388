"""Bilinear resize with ``align_corners=True`` semantics (NCHW)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize NCHW ``x`` to spatial size ``out_hw``."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[-2:]) == (oh, ow):
        return x
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=True)


def interp_like(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Resize ``x`` to ``dest``'s spatial size."""
    return resize_bilinear_align_corners(x, dest.shape[-2:])
