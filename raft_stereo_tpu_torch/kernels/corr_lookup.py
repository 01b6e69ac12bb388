"""Correlation-pyramid window lookup: CUDA kernels and their plain versions.

``lookup_pyramid_fused`` samples every pyramid level in ONE launch of the
kernel in ``csrc/corr_lookup.cu`` when its tensors lie on a CUDA device,
and runs the plain PyTorch version ``lookup_pyramid_xla`` when they lie
on the CPU.  There is no fallback from one to the other: a CUDA tensor
the kernels do not take raises.  Volumes are fp32, or bf16 under mixed
precision; both versions sample in fp32 and round once to that dtype.

``lookup_pyramid_fused_q`` is the quantized tier's lookup over a 1-byte
pyramid (int8 or float8_e4m3fn codes, ``check_q_dtype``): the same kernel
upcasts each bin on load and writes fp32, the raw samples of the codes;
the caller multiplies each level's taps by its scale.  It is forward
only, like the JAX package's: the quantized tier is inference only.

The lookup is differentiable in the volumes (``_LookupPyramid``, an
``autograd.Function``): its backward is ``lookup_pyramid_bwd_fused``, the
transpose of the forward in one launch of the backward kernel for all
levels on CUDA tensors, and the plain ``lookup_pyramid_bwd_xla`` on CPU
tensors.  The centers get no gradient, as in the JAX package (RAFT
detaches them before every lookup).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from raft_stereo_tpu_torch.kernels import _build
from raft_stereo_tpu_torch.ops.sampler import linear_sampler_1d

MAX_LEVELS = 8  # kMaxLevels in csrc/corr_lookup.cu
MAX_RADIUS = 8  # kMaxRadius


def window_coords(coords: torch.Tensor, level: int,
                  radius: int) -> torch.Tensor:
    """(B,H,W1) centers -> (B,H,W1,2r+1) tap positions at ``level``."""
    dx = torch.arange(-radius, radius + 1, device=coords.device,
                      dtype=coords.dtype)
    return coords[..., None] / (2 ** level) + dx


def lookup_pyramid_xla(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int, out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Plain version: linear window lookup at every level, level-major, in
    fp32 and rounded once to ``out_dtype``, by default the levels' dtype
    (the kernel's rounding)."""
    outs = [linear_sampler_1d(vol.float(), window_coords(coords, i, radius))
            for i, vol in enumerate(pyramid)]
    return torch.cat(outs, dim=-1).to(out_dtype or pyramid[0].dtype)


def lookup_pyramid_bwd_xla(g: torch.Tensor, coords: torch.Tensor,
                           w2s: Sequence[int], radius: int,
                           dtype: torch.dtype) -> List[torch.Tensor]:
    """Plain version of the backward: for every level, tap k adds
    (1-t)*g_k to bin x0 and t*g_k to bin x0+1 of the pixel's row
    (``scatter_add_`` in fp32), bins outside [0, W2-1] dropped; rounded
    once to ``dtype``.  Returns the (B,H,W1,W2_l) volume gradients."""
    k = 2 * radius + 1
    g = g.float()
    out = []
    for i, w2 in enumerate(w2s):
        x = window_coords(coords, i, radius)
        x0 = torch.floor(x)
        t = x - x0
        gl = g[..., i * k:(i + 1) * k]
        # a spare last bin takes the taps that fall outside, with weight 0
        dv = torch.zeros(g.shape[:-1] + (w2 + 1,), dtype=torch.float32,
                         device=g.device)
        for idx, w in ((x0, (1.0 - t) * gl), (x0 + 1.0, t * gl)):
            inside = (idx >= 0) & (idx <= w2 - 1)
            pos = torch.where(inside, idx, torch.full_like(idx, w2))
            dv.scatter_add_(-1, pos.to(torch.int64),
                            torch.where(inside, w, torch.zeros_like(w)))
        out.append(dv[..., :w2].to(dtype))
    return out


_ENTRIES = {torch.float32: "raft_corr_lookup",
            torch.bfloat16: "raft_corr_lookup_bf16"}
# The quantized grids and their entries (out fp32).
Q_DTYPES = (torch.int8, torch.float8_e4m3fn)
_Q_ENTRIES = {torch.int8: "raft_corr_lookup_q_int8",
              torch.float8_e4m3fn: "raft_corr_lookup_q_fp8"}
_BWD_ENTRIES = {torch.float32: "raft_corr_lookup_bwd",
                torch.bfloat16: "raft_corr_lookup_bwd_bf16"}


_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _lib(entry: str):
    return _build.entry("corr_lookup", entry, _ARGTYPES)


def _check_coords(coords: torch.Tensor, dtype: torch.dtype) -> None:
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    if dtype not in _ENTRIES or coords.dtype != torch.float32:
        raise TypeError(f"the lookup kernels take float32 or bfloat16 "
                        f"volumes and float32 coords, got {dtype} and "
                        f"{coords.dtype}")


def _launch_fwd(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int, entry: str, out_dtype: torch.dtype
                ) -> torch.Tensor:
    levels = len(pyramid)
    b, h, w1 = coords.shape
    vols = [v.contiguous() for v in pyramid]
    coords = coords.contiguous()
    k = 2 * radius + 1
    out = torch.empty((b, h, w1, levels * k), device=coords.device,
                      dtype=out_dtype)
    ptrs = (ctypes.c_void_p * levels)(*[v.data_ptr() for v in vols])
    w2s = (ctypes.c_int * levels)(*[v.shape[-1] for v in vols])
    with torch.cuda.device(coords.device):
        err = _lib(entry)(
            ptrs, w2s, levels, coords.data_ptr(), out.data_ptr(),
            b * h * w1, radius, torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    return out


def _check_levels(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                  radius: int) -> None:
    """Raise on levels and radii the kernels do not take (CUDA tensors)."""
    levels = len(pyramid)
    b, h, w1 = coords.shape
    if not 1 <= levels <= MAX_LEVELS or not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{levels} levels, radius {radius}: the kernel "
                         f"takes 1..{MAX_LEVELS} levels and radius "
                         f"0..{MAX_RADIUS}")
    for v in pyramid:
        if v.dtype != pyramid[0].dtype:
            raise TypeError(f"pyramid levels mix {pyramid[0].dtype} and "
                            f"{v.dtype}")
        if v.device != coords.device:
            raise ValueError("pyramid and coords must share one device")
        if tuple(v.shape[:3]) != (b, h, w1):
            raise ValueError(f"level shape {tuple(v.shape)} does not "
                             f"match coords {tuple(coords.shape)}")


class _LookupPyramid(torch.autograd.Function):
    """The lookup, differentiable in the volumes: saves the centers only
    (the backward needs the volumes' widths and dtype, not their values)."""

    @staticmethod
    def forward(ctx, coords, radius, *pyramid):
        ctx.radius = radius
        ctx.w2s = [v.shape[-1] for v in pyramid]
        ctx.dtype = pyramid[0].dtype
        ctx.save_for_backward(coords)
        if coords.device.type == "cpu":
            return lookup_pyramid_xla(pyramid, coords, radius)
        out = _launch_fwd(pyramid, coords, radius,
                          _ENTRIES[pyramid[0].dtype], pyramid[0].dtype)
        lookup_pyramid_fused.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        coords, = ctx.saved_tensors
        dvols = lookup_pyramid_bwd_fused(g, coords, ctx.w2s, ctx.radius,
                                         ctx.dtype)
        return (None, None, *dvols)


def lookup_pyramid_fused(pyramid: List[torch.Tensor], coords: torch.Tensor,
                         radius: int) -> torch.Tensor:
    """Window lookup at every level of ``pyramid``, concat level-major.

    Args:
      pyramid: (B,H,W1,W2_i) volumes, all fp32 or all bf16.
      coords:  (B,H,W1) fp32 centers at level 0.

    Returns (B,H,W1,L*(2r+1)) in the volumes' dtype, computed in fp32,
    differentiable in the volumes.  Counts its kernel launches in
    ``lookup_pyramid_fused.launches``."""
    if coords.device.type != "cpu":
        _check_levels(pyramid, coords, radius)
        _check_coords(coords, pyramid[0].dtype)
    return _LookupPyramid.apply(coords, radius, *pyramid)


lookup_pyramid_fused.launches = 0


def check_q_dtype(pyramid: Sequence[torch.Tensor],
                  q_dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The grid of one quantized call: ``q_dtype`` (None: level 0's
    dtype) must be int8 or float8_e4m3fn and every level must carry it.
    Returns it.  The port reads fp8 on every device (torch has
    float8_e4m3fn on the CPU, Hopper reads it natively), so there is no
    capability gate."""
    q_dtype = q_dtype if q_dtype is not None else pyramid[0].dtype
    if q_dtype not in Q_DTYPES:
        raise ValueError(f"q_dtype={q_dtype} not a supported quantized "
                         f"grid {Q_DTYPES}")
    bad = [str(v.dtype) for v in pyramid if v.dtype != q_dtype]
    if bad:
        raise ValueError(f"q-entry levels must all be {q_dtype}; got {bad}")
    return q_dtype


def lookup_pyramid_fused_q(pyramid: List[torch.Tensor], coords: torch.Tensor,
                           radius: int, out_dtype: torch.dtype,
                           q_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Window lookup over a quantized pyramid (int8 or float8_e4m3fn codes),
    all levels in one launch of the lookup kernel on CUDA tensors, the
    plain ``lookup_pyramid_xla`` on CPU tensors.

    Returns the (B,H,W1,L*(2r+1)) raw samples of the codes in
    ``out_dtype`` (fp32 on the card, the kernel's output): the caller
    applies the per-level scales.  Forward only: a level that requires
    grad raises.  Counts its kernel launches in
    ``lookup_pyramid_fused_q.launches``."""
    q_dtype = check_q_dtype(pyramid, q_dtype)
    if any(v.requires_grad for v in pyramid):
        raise ValueError("the quantized lookup is forward only: detach the "
                         "pyramid")
    if coords.device.type == "cpu":
        return lookup_pyramid_xla(pyramid, coords, radius, out_dtype)
    _check_levels(pyramid, coords, radius)
    if coords.device.type != "cuda" or coords.dtype != torch.float32:
        raise TypeError(f"the lookup kernel takes float32 CUDA coords, got "
                        f"{coords.dtype} on {coords.device}")
    if out_dtype != torch.float32:
        raise TypeError(f"the quantized lookup kernel writes float32, not "
                        f"{out_dtype}")
    out = _launch_fwd(pyramid, coords, radius, _Q_ENTRIES[q_dtype],
                      torch.float32)
    lookup_pyramid_fused_q.launches += 1
    return out


lookup_pyramid_fused_q.launches = 0


def lookup_pyramid_bwd_fused(g: torch.Tensor, coords: torch.Tensor,
                             w2s: Sequence[int], radius: int,
                             dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """Gradients of the lookup's volumes from its output gradient ``g``
    (B,H,W1,L*(2r+1)), in ``dtype`` (the volumes' dtype, which ``g``
    shares).  One launch of the backward kernel on CUDA tensors, the plain
    ``lookup_pyramid_bwd_xla`` on CPU tensors.  Counts its kernel launches
    in ``lookup_pyramid_bwd_fused.launches``."""
    if g.device.type == "cpu":
        return tuple(lookup_pyramid_bwd_xla(g, coords, w2s, radius, dtype))
    _check_coords(coords, dtype)
    levels = len(w2s)
    b, h, w1 = coords.shape
    if not 1 <= levels <= MAX_LEVELS or not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{levels} levels, radius {radius}: the backward "
                         f"kernel takes 1..{MAX_LEVELS} levels and radius "
                         f"0..{MAX_RADIUS}")
    k = 2 * radius + 1
    if g.dtype != dtype or tuple(g.shape) != (b, h, w1, levels * k):
        raise TypeError(f"gradient {g.dtype} {tuple(g.shape)}, expected "
                        f"{dtype} {(b, h, w1, levels * k)}")
    g = g.contiguous()
    coords = coords.contiguous()
    dvols = [torch.empty((b, h, w1, w2), device=g.device, dtype=dtype)
             for w2 in w2s]
    ptrs = (ctypes.c_void_p * levels)(*[v.data_ptr() for v in dvols])
    widths = (ctypes.c_int * levels)(*w2s)
    with torch.cuda.device(g.device):
        err = _lib(_BWD_ENTRIES[dtype])(
            ptrs, widths, levels, coords.data_ptr(), g.data_ptr(),
            b * h * w1, radius, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "corr_lookup_bwd")
    lookup_pyramid_bwd_fused.launches += 1
    return tuple(dvols)


lookup_pyramid_bwd_fused.launches = 0
