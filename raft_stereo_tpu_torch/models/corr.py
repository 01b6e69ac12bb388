"""1-D (epipolar) all-pairs correlation: volume, pyramid and lookup.

    corr_fn = make_corr_fn(config, fmap1, fmap2)   # NCHW feature maps
    feats   = corr_fn(coords_x)                    # (B,H,W1) x-positions
    # feats: (B, H, W1, corr_levels * (2*radius+1)), level-major

Backends of this slice:
* ``reg``       — the all-pairs volume as a batched fp32 matmul, a W2
                  average-pooled pyramid, and the plain window lookup.
* ``reg_fused`` — the same volume and pyramid; the lookup goes through
                  kernels/corr_lookup.py (the CUDA kernel on a CUDA tensor).
``alt`` is rejected by the config (ROADMAP §D1).
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.kernels.corr_lookup import (lookup_pyramid_fused,
                                                       lookup_pyramid_xla)

__all__ = ["build_corr_volume", "pool_axis", "build_corr_pyramid",
           "lookup_pyramid_xla", "make_corr_fn"]

CorrFn = Callable[[torch.Tensor], torch.Tensor]


def build_corr_volume(fmap1: torch.Tensor,
                      fmap2: torch.Tensor) -> torch.Tensor:
    """(B,D,H,W1), (B,D,H,W2) -> (B,H,W1,W2) dot products / sqrt(D).

    One (W1, D) x (D, W2) matmul per image row.  Full fp32 needs
    ``torch.backends.cuda.matmul.allow_tf32 = False`` on the card, which
    the entry points set."""
    d = fmap1.shape[1]
    f1 = fmap1.permute(0, 2, 3, 1)   # (B,H,W1,D)
    f2 = fmap2.permute(0, 2, 1, 3)   # (B,H,D,W2)
    return torch.matmul(f1, f2) / math.sqrt(d)


def pool_axis(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """2-wide stride-2 mean along ``axis``, floor semantics."""
    x = x.movedim(axis, -1)
    w2 = (x.shape[-1] // 2) * 2
    return (0.5 * (x[..., 0:w2:2] + x[..., 1:w2:2])).movedim(-1, axis)


def build_corr_pyramid(corr: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Exactly ``num_levels`` levels; level i has W2 // 2^i bins."""
    pyramid = [corr]
    for _ in range(num_levels - 1):
        pyramid.append(pool_axis(pyramid[-1]).contiguous())
    return pyramid


def make_corr_fn(cfg: RaftStereoConfig, fmap1: torch.Tensor,
                 fmap2: torch.Tensor) -> CorrFn:
    if cfg.corr_backend not in ("reg", "reg_fused"):
        raise NotImplementedError(
            f"corr_backend={cfg.corr_backend!r} (ROADMAP.md §D1)")
    # The volume is built in fp32 for every backend of this slice;
    # ``corr_fp32`` matters only under mixed precision (ROADMAP.md §D1).
    pyramid = build_corr_pyramid(
        build_corr_volume(fmap1.float(), fmap2.float()), cfg.corr_levels)
    lookup = (lookup_pyramid_fused if cfg.corr_backend == "reg_fused"
              else lookup_pyramid_xla)

    def corr_fn(coords: torch.Tensor) -> torch.Tensor:
        return lookup(pyramid, coords, cfg.corr_radius)

    return corr_fn
