"""Correlation-pyramid window lookup: CUDA kernel and its plain version.

``lookup_pyramid_fused`` samples every pyramid level in ONE launch of the
kernel in ``csrc/corr_lookup.cu`` when its tensors lie on a CUDA device,
and runs the plain PyTorch version ``lookup_pyramid_xla`` when they lie
on the CPU.  There is no fallback from one to the other: a CUDA tensor
the kernel does not take raises.  Volumes are fp32, or bf16 under mixed
precision; both versions sample in fp32 and round once to that dtype.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from raft_stereo_tpu_torch.kernels import _build
from raft_stereo_tpu_torch.ops.sampler import linear_sampler_1d

MAX_LEVELS = 8  # kMaxLevels in csrc/corr_lookup.cu


def window_coords(coords: torch.Tensor, level: int,
                  radius: int) -> torch.Tensor:
    """(B,H,W1) centers -> (B,H,W1,2r+1) tap positions at ``level``."""
    dx = torch.arange(-radius, radius + 1, device=coords.device,
                      dtype=coords.dtype)
    return coords[..., None] / (2 ** level) + dx


def lookup_pyramid_xla(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """Plain version: linear window lookup at every level, level-major, in
    fp32 and rounded once to the levels' dtype (the kernel's rounding)."""
    outs = [linear_sampler_1d(vol.float(), window_coords(coords, i, radius))
            for i, vol in enumerate(pyramid)]
    return torch.cat(outs, dim=-1).to(pyramid[0].dtype)


_ENTRIES = {torch.float32: "raft_corr_lookup",
            torch.bfloat16: "raft_corr_lookup_bf16"}


def _lib(dtype: torch.dtype):
    fn = getattr(_build.load("corr_lookup"), _ENTRIES[dtype])
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lookup_pyramid_fused(pyramid: List[torch.Tensor], coords: torch.Tensor,
                         radius: int) -> torch.Tensor:
    """Window lookup at every level of ``pyramid``, concat level-major.

    Args:
      pyramid: (B,H,W1,W2_i) volumes, all fp32 or all bf16.
      coords:  (B,H,W1) fp32 centers at level 0.

    Returns (B,H,W1,L*(2r+1)) in the volumes' dtype, computed in fp32.
    Counts its kernel launches in ``lookup_pyramid_fused.launches``."""
    if coords.device.type == "cpu":
        return lookup_pyramid_xla(pyramid, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    levels = len(pyramid)
    b, h, w1 = coords.shape
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{levels} levels; the kernel takes 1..{MAX_LEVELS}")
    dtype = pyramid[0].dtype
    if dtype not in _ENTRIES or coords.dtype != torch.float32:
        raise TypeError(f"the lookup kernel takes float32 or bfloat16 "
                        f"volumes and float32 coords, got {dtype} and "
                        f"{coords.dtype}")
    for v in pyramid:
        if v.dtype != dtype:
            raise TypeError(f"pyramid levels mix {dtype} and {v.dtype}")
        if v.device != coords.device:
            raise ValueError("pyramid and coords must share one device")
    for v in pyramid:
        if tuple(v.shape[:3]) != (b, h, w1):
            raise ValueError(f"level shape {tuple(v.shape)} does not match "
                             f"coords {tuple(coords.shape)}")
    vols = [v.contiguous() for v in pyramid]
    coords = coords.contiguous()
    k = 2 * radius + 1
    out = torch.empty((b, h, w1, levels * k), device=coords.device,
                      dtype=dtype)
    ptrs = (ctypes.c_void_p * levels)(*[v.data_ptr() for v in vols])
    w2s = (ctypes.c_int * levels)(*[v.shape[-1] for v in vols])
    with torch.cuda.device(coords.device):
        err = _lib(dtype)(ptrs, w2s, levels, coords.data_ptr(),
                          out.data_ptr(), b * h * w1, radius,
                          torch.cuda.current_stream().cuda_stream)
    _build.check(err, "corr_lookup")
    lookup_pyramid_fused.launches += 1
    return out


lookup_pyramid_fused.launches = 0
