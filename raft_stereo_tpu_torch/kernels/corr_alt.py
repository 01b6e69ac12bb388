"""No-volume ("alt") window correlation: CUDA kernel and its plain version.

``alt_lookup_fused(fmap1, fmap2_pyramid, coords, radius)`` keeps the JAX
package's signature (NHWC features): for every level l of the W-pooled
right-feature pyramid and every tap k it returns the linearly sampled
correlation row ``f1 . f2_l^T / sqrt(D)`` at ``coords / 2^l + k - radius``,
level-major, without ever building the volume.  On CUDA tensors it
launches ``csrc/corr_alt.cu`` once for all levels; on CPU tensors it runs
the plain version ``alt_lookup_xla``.  Features are fp32 or bf16 (one dtype
for all of them); dots accumulate in fp32 and the output is rounded once
to the feature dtype, as the TPU kernel does.  One level at scale 1/2^l
(the TPU's per-level route) is a call with that level alone and
``coords / 2^l``.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence

import torch

from raft_stereo_tpu_torch.kernels import _build
from raft_stereo_tpu_torch.kernels.corr_lookup import window_coords
from raft_stereo_tpu_torch.ops.sampler import linear_sampler_1d

MAX_LEVELS = 8   # kMaxLevels in csrc/corr_alt.cu
MAX_RADIUS = 8   # kMaxRadius
# D is a whole number of 16-byte vectors, at most 64 of them per pixel
# (kMaxVecPerLane lanes-worth): elements per vector by dtype.
_VEC = {torch.float32: 4, torch.bfloat16: 8}
_ENTRIES = {torch.float32: "raft_corr_alt_f32",
            torch.bfloat16: "raft_corr_alt_bf16"}


def alt_lookup_xla(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                   coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version: per level the fp32 volume of the features as given,
    times 1/sqrt(D), sampled linearly; rounded once to the feature dtype."""
    inv_sqrt_d = 1.0 / math.sqrt(fmap1.shape[-1])
    f1 = fmap1.float()
    outs = []
    for i, f2 in enumerate(fmap2_pyramid):
        vol = torch.matmul(f1, f2.float().transpose(-1, -2)) * inv_sqrt_d
        outs.append(linear_sampler_1d(vol, window_coords(coords, i, radius)))
    return torch.cat(outs, dim=-1).to(fmap1.dtype)


def _lib(dtype: torch.dtype):
    fn = getattr(_build.load("corr_alt"), _ENTRIES[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def alt_lookup_fused(fmap1: torch.Tensor, fmap2_pyramid: List[torch.Tensor],
                     coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Window correlation at every level of the right-feature pyramid.

    Args:
      fmap1: (B,H,W1,D) left features, fp32 or bf16.
      fmap2_pyramid: (B,H,W2_l,D) right features per level, fmap1's dtype.
      coords: (B,H,W1) fp32 centers at level 0.

    Returns (B,H,W1,L*(2r+1)) in fmap1's dtype.  Counts its kernel
    launches in ``alt_lookup_fused.launches``."""
    if coords.device.type == "cpu":
        return alt_lookup_xla(fmap1, fmap2_pyramid, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    levels = len(fmap2_pyramid)
    b, h, w1, d = fmap1.shape
    dtype = fmap1.dtype
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{levels} levels; the kernel takes 1..{MAX_LEVELS}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius}; the kernel takes 0..{MAX_RADIUS}")
    if dtype not in _ENTRIES or coords.dtype != torch.float32:
        raise TypeError(f"the alt kernel takes float32 or bfloat16 features "
                        f"and float32 coords, got {dtype} and {coords.dtype}")
    vec = _VEC[dtype]
    if d % vec or not vec <= d <= 64 * vec:
        raise ValueError(f"D={d}: the alt kernel takes {dtype} features of "
                         f"a multiple of {vec} channels, at most {64 * vec}")
    if tuple(coords.shape) != (b, h, w1):
        raise ValueError(f"coords shape {tuple(coords.shape)} does not match "
                         f"fmap1 {tuple(fmap1.shape)}")
    for f2 in (fmap1, *fmap2_pyramid):
        if f2.dtype != dtype:
            raise TypeError(f"features mix {dtype} and {f2.dtype}")
        if f2.device != coords.device:
            raise ValueError("features and coords must share one device")
        if f2.dim() != 4 or (f2.shape[0], f2.shape[1], f2.shape[3]) != (
                b, h, d):
            raise ValueError(f"level shape {tuple(f2.shape)} does not match "
                             f"fmap1 {tuple(fmap1.shape)}")
    f1 = fmap1.contiguous()
    f2s = [f2.contiguous() for f2 in fmap2_pyramid]
    coords = coords.contiguous()
    for t in (f1, *f2s):
        if t.data_ptr() % 16:
            raise ValueError("the alt kernel reads features as 16-byte "
                             "vectors: their storage must be 16-byte aligned")
    k = 2 * radius + 1
    out = torch.empty((b, h, w1, levels * k), device=coords.device,
                      dtype=dtype)
    ptrs = (ctypes.c_void_p * levels)(*[t.data_ptr() for t in f2s])
    w2s = (ctypes.c_int * levels)(*[t.shape[2] for t in f2s])
    with torch.cuda.device(coords.device):
        err = _lib(dtype)(f1.data_ptr(), ptrs, w2s, levels, coords.data_ptr(),
                          out.data_ptr(), b * h * w1, w1, d, radius,
                          1.0 / math.sqrt(d),
                          torch.cuda.current_stream().cuda_stream)
    _build.check(err, "corr_alt")
    alt_lookup_fused.launches += 1
    return out


alt_lookup_fused.launches = 0
