"""1-D (epipolar) all-pairs correlation: volume, pyramid and lookup.

    corr_fn = make_corr_fn(config, fmap1, fmap2)   # NCHW feature maps
    feats   = corr_fn(coords_x)                    # (B,H,W1) x-positions
    # feats: (B, H, W1, corr_levels * (2*radius+1)), level-major

Backends:
* ``reg``       — the all-pairs volume as a batched fp32 matmul, a W2
                  average-pooled pyramid, and the plain window lookup; fp32
                  throughout.
* ``reg_fused`` — the same fp32 volume, stored (and pooled) in the feature
                  dtype; the lookup goes through kernels/corr_lookup.py (the
                  CUDA kernel on a CUDA tensor).
* ``alt``       — no volume: the right features are W-pooled in their own
                  dtype and every lookup goes through kernels/corr_alt.py
                  (the CUDA kernel on a CUDA tensor).
``corr_fp32`` upcasts both feature maps to fp32 before any backend, as the
JAX package does, so even the dtype-keeping backends run fp32.
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.kernels.corr_alt import alt_lookup_fused
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


def _make_corr_fn_alt(cfg: RaftStereoConfig, fmap1: torch.Tensor,
                      fmap2: torch.Tensor) -> CorrFn:
    f1 = fmap1.permute(0, 2, 3, 1).contiguous()      # (B,H,W1,D)
    pyramid = [fmap2.permute(0, 2, 3, 1).contiguous()]
    for _ in range(cfg.corr_levels - 1):
        pyramid.append(pool_axis(pyramid[-1], axis=2).contiguous())

    def corr_fn(coords: torch.Tensor) -> torch.Tensor:
        return alt_lookup_fused(f1, pyramid, coords, cfg.corr_radius)

    return corr_fn


def make_corr_fn(cfg: RaftStereoConfig, fmap1: torch.Tensor,
                 fmap2: torch.Tensor) -> CorrFn:
    if cfg.corr_fp32:
        fmap1, fmap2 = fmap1.float(), fmap2.float()
    if cfg.corr_backend == "alt":
        return _make_corr_fn_alt(cfg, fmap1, fmap2)
    volume = build_corr_volume(fmap1.float(), fmap2.float())
    if cfg.corr_backend == "reg_fused":
        volume, lookup = volume.to(fmap1.dtype), lookup_pyramid_fused
    else:
        lookup = lookup_pyramid_xla
    pyramid = build_corr_pyramid(volume, cfg.corr_levels)

    def corr_fn(coords: torch.Tensor) -> torch.Tensor:
        return lookup(pyramid, coords, cfg.corr_radius)

    return corr_fn
