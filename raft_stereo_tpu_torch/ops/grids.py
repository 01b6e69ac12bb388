"""Coordinate grids.

Stereo disparity is 1-D, so the port, like the JAX package, carries only
the x channel of the reference's 2-channel coordinate grid.
"""

from __future__ import annotations

import torch


def coords_grid_x(batch: int, ht: int, wd: int, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """x-coordinate grid of shape (batch, ht, wd)."""
    x = torch.arange(wd, device=device, dtype=dtype)
    return x.view(1, 1, wd).expand(batch, ht, wd)
