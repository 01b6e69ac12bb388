"""1-D linear sampling along the last axis.

Linear interpolation with zeros outside ``[0, W-1]`` and pixel-coordinate
(align-corners) semantics: the plain version of the correlation lookup.
"""

from __future__ import annotations

import torch


def linear_sampler_1d(vol: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linearly sample ``vol`` along its last axis at positions ``x``.

    Args:
      vol: (..., W) values.
      x:   (..., K) sample positions in pixels; leading dims equal
           ``vol``'s leading dims.

    Returns:
      (..., K) samples, zero for taps outside ``[0, W-1]``.
    """
    w = vol.shape[-1]
    x0 = torch.floor(x)
    frac = (x - x0).to(vol.dtype)
    x0i = x0.to(torch.int64)

    def tap(idx):
        valid = (idx >= 0) & (idx <= w - 1)
        v = torch.gather(vol, -1, idx.clamp(0, w - 1))
        return torch.where(valid, v, torch.zeros_like(v))

    return tap(x0i) * (1.0 - frac) + tap(x0i + 1) * frac
