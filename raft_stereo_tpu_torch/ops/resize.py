"""Bilinear resize with ``align_corners=True`` semantics (NCHW).

As in the JAX package, the resize is two small interpolation matrices
applied as matmuls, one per axis, and the matrices are cast to the
activation dtype: in bf16 their weights are rounded to bf16 and each pass
rounds its output to bf16 (the products are summed in fp32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(src: int, dst: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """(dst, src) align-corners bilinear interpolation matrix, its weights
    rounded to ``dtype``, as fp32 on ``device``: built once per shape, so
    the GRU loop never copies it from the host.  Built outside inference
    mode, so a matrix first made by an inference call can also serve a
    training forward."""
    m = np.zeros((dst, src), dtype=np.float32)
    if dst == 1:
        m[0, 0] = 1.0
    else:
        pos = np.arange(dst) * ((src - 1) / (dst - 1))
        lo = np.clip(np.floor(pos).astype(np.int64), 0, src - 1)
        hi = np.clip(lo + 1, 0, src - 1)
        frac = (pos - lo).astype(np.float32)
        m[np.arange(dst), lo] += 1.0 - frac
        m[np.arange(dst), hi] += frac
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(dtype).float().to(device)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize NCHW ``x`` to spatial size ``out_hw``."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    dtype = x.dtype
    if h != oh:
        my = _interp_matrix(h, oh, x.device, dtype)
        x = torch.einsum("bchw,oh->bcow", x.float(), my).to(dtype)
    if w != ow:
        mx = _interp_matrix(w, ow, x.device, dtype)
        x = torch.einsum("bchw,ow->bcho", x.float(), mx).to(dtype)
    return x


def interp_like(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Resize ``x`` to ``dest``'s spatial size."""
    return resize_bilinear_align_corners(x, dest.shape[-2:])


def upsample_flow_bilinear(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """x``factor`` bilinear upsample of NCHW ``flow``, its values scaled
    by ``factor``."""
    h, w = flow.shape[-2:]
    return factor * resize_bilinear_align_corners(flow, (factor * h,
                                                         factor * w))
