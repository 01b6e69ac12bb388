"""Convex (mask-weighted) flow upsampling.

Softmax over a 9-way mask per output subpixel, combining the 3x3
neighbourhood of the coarse flow, whose values are scaled by the factor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int) -> torch.Tensor:
    """Upsample an NCHW (B,C,H,W) flow to (B,C,H*f,W*f).

    ``mask`` is (B, 9*f*f, H, W) raw logits with channel
    ``c = k*f*f + iy*f + ix``: k the 3x3 tap in ``F.unfold`` order,
    (iy, ix) the subpixel."""
    b, c, h, w = flow.shape
    f = factor
    m = torch.softmax(mask.view(b, 1, 9, f, f, h, w), dim=2)
    taps = F.unfold(f * flow, [3, 3], padding=1).view(b, c, 9, 1, 1, h, w)
    up = torch.sum(m * taps, dim=2)                       # (B,C,f,f,H,W)
    up = up.permute(0, 1, 4, 2, 5, 3)                     # (B,C,H,f,W,f)
    return up.reshape(b, c, h * f, w * f)
