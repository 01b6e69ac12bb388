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

``alt_lookup_fused_q`` is kernel #9 of the quantized tier: the same
lookup over int8 or float8_e4m3fn feature codes (``check_q_dtype``), fp32
output, the raw correlation of the codes times 1/sqrt(D); the caller
multiplies each level's taps by the combined scale ``s1 * s2_l``.  It is
forward only.

The lookup is differentiable in the features (``_AltLookup``, an
``autograd.Function``): its backward is ``alt_lookup_bwd_fused``, one
launch of the backward kernel for all levels on CUDA tensors and the
plain ``alt_lookup_bwd_xla`` on CPU tensors.  The centers get no
gradient, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from raft_stereo_tpu_torch.kernels import _build
from raft_stereo_tpu_torch.kernels.corr_lookup import (
    check_q_dtype, lookup_pyramid_bwd_xla, window_coords)
from raft_stereo_tpu_torch.ops.sampler import linear_sampler_1d

MAX_LEVELS = 8   # kMaxLevels in csrc/corr_alt.cu
MAX_RADIUS = 8   # kMaxRadius
# D is a whole number of 16-byte vectors, at most 64 of them per pixel
# (kMaxVecPerLane lanes-worth): elements per vector by dtype.
_VEC = {torch.float32: 4, torch.bfloat16: 8, torch.int8: 16,
        torch.float8_e4m3fn: 16}
_ENTRIES = {torch.float32: "raft_corr_alt_f32",
            torch.bfloat16: "raft_corr_alt_bf16"}
_Q_ENTRIES = {torch.int8: "raft_corr_alt_q_int8",
              torch.float8_e4m3fn: "raft_corr_alt_q_fp8"}
_BWD_ENTRIES = {torch.float32: "raft_corr_alt_bwd_f32",
                torch.bfloat16: "raft_corr_alt_bwd_bf16"}
# Shared memory a block may use (csrc/corr_alt.cu kMaxSmem), and the
# backward's widest pixel tile (kBwdMaxTile: a bucket entry packs the pixel
# in 11 bits) and channel chunk (kBwdMaxChunk).
MAX_BWD_SMEM = 232448
MAX_BWD_TILE = 2048
MAX_BWD_CHUNK = 64
# The forward (csrc/corr_alt.cu corr_alt_fwd_kernel): shared memory that
# leaves two blocks on an SM (233,472 bytes less 1 KB per block, halved),
# its pixel tile, the band rows a pass should take at least before D is
# chunked (fewer passes beat whole D: at the realtime shape fp32 is faster
# as two chunks with 160 rows than D whole with 64, PERF.md §6), and the
# bytes of a feature as staged (fp8 codes land as bf16).
MAX_FWD_SMEM = 115712
FWD_TILE = 32
FWD_MIN_SEG = 160
_FWD_ITEM = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1,
             torch.float8_e4m3fn: 2}


def alt_lookup_xla(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                   coords: torch.Tensor, radius: int,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: per level the fp32 volume of the features as given,
    times 1/sqrt(D), sampled linearly; rounded once to ``out_dtype``, by
    default the feature dtype."""
    inv_sqrt_d = 1.0 / math.sqrt(fmap1.shape[-1])
    f1 = fmap1.float()
    outs = []
    for i, f2 in enumerate(fmap2_pyramid):
        vol = torch.matmul(f1, f2.float().transpose(-1, -2)) * inv_sqrt_d
        outs.append(linear_sampler_1d(vol, window_coords(coords, i, radius)))
    return torch.cat(outs, dim=-1).to(out_dtype or fmap1.dtype)


def alt_lookup_bwd_xla(fmap1: torch.Tensor,
                       fmap2_pyramid: Sequence[torch.Tensor],
                       coords: torch.Tensor, g: torch.Tensor, radius: int
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain version of the backward: per level the dense fp32 window
    weights dv (B,H,W1,W2_l) from the lookup backward's plain scatter,
    then ``df1 = sum_l (dv_l @ f2_l) * s`` and ``df2_l = (dv_l^T @ f1) * s``
    with ``torch.matmul`` in fp32, rounded once to the feature dtype.
    Returns ``(df1, [df2_l])``."""
    dtype = fmap1.dtype
    inv_sqrt_d = 1.0 / math.sqrt(fmap1.shape[-1])
    f1 = fmap1.float()
    dvs = lookup_pyramid_bwd_xla(g, coords,
                                 [f2.shape[2] for f2 in fmap2_pyramid],
                                 radius, torch.float32)
    df1 = torch.zeros_like(f1)
    df2 = []
    for dv, f2 in zip(dvs, fmap2_pyramid):
        df1 = df1 + torch.matmul(dv, f2.float()) * inv_sqrt_d
        df2.append((torch.matmul(dv.transpose(-1, -2), f1)
                    * inv_sqrt_d).to(dtype))
    return df1.to(dtype), df2


_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                 ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib(entry: str):
    return _build.entry("corr_alt", entry, _ARGTYPES)


def _bwd_lib(entry: str):
    return _build.entry("corr_alt", entry, _BWD_ARGTYPES)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def bwd_smem_bytes(bins: int, levels: int, radius: int, tile: int,
                   chunk: int, itemsize: int, w1: int) -> int:
    """Shared bytes of one block of the CUDA-core backward (csrc/corr_alt.cu
    ``BwdSmem``): the row's f2 chunk of every level in the feature dtype,
    an f1 tile widened to fp32, df2's fp32 partials when the row takes more
    than one tile, the tile's window weights (stride 2R+5), starts and bin
    counts, the bucket ends per window start, the bucket entries and the
    task counter."""
    keys = bins + levels * (2 * radius + 3)
    return (_align16(bins * chunk * itemsize) + _align16(tile * chunk * 4)
            + (_align16(bins * chunk * 4) if tile < w1 else 0)
            + _align16(levels * tile * (2 * radius + 5) * 4)
            + 2 * _align16(levels * tile * 4) + _align16(keys * 4)
            + _align16(levels * tile * 4) + 16)


def tc_smem_bytes(w2s: Sequence[int], radius: int, w1: int,
                  chunk: int) -> int:
    """Shared bytes of one block of the bf16 tensor-core backward
    (csrc/corr_alt.cu ``TcSmem``): every level's f2 chunk padded to 16 bins
    and the row's f1 padded to 16 pixels, rows of chunk + 8 bf16, then the
    window weights, starts and bin counts, and the task counter."""
    stride = (chunk + 8) * 2
    krows = sum(-(-w2 // 16) * 16 for w2 in w2s)
    levels = len(w2s)
    return (_align16(krows * stride) + _align16(-(-w1 // 16) * 16 * stride)
            + _align16(levels * w1 * (2 * radius + 5) * 4)
            + 2 * _align16(levels * w1 * 4) + 16)


def plan_bwd(w1: int, w2s: Sequence[int], radius: int, d: int,
             itemsize: int) -> Tuple[int, int, bool]:
    """(channel chunk, pixel tile, tensor cores) of one backward launch.

    A block takes one image row and up to 64 channels (eight lanes cover a
    row of them).  bf16 features take the tensor-core kernel where the
    whole row fits one block: at the realtime training shape (W1 90, W2
    90/45/22/11, D 256) 1,280 blocks of ~63 KB.  Otherwise (fp32, or a row
    too wide) the CUDA-core kernel: the whole row one tile where it fits,
    else the chunk halves down to one 16-byte vector of the features, then
    the row is cut into tiles of 1024 down to 32 pixels.  Raises where
    nothing fits (the row's f2 chunk of every level must)."""
    vec = 16 // itemsize
    bins, levels = sum(w2s), len(w2s)
    if itemsize == 2 and w1 <= MAX_BWD_TILE:
        chunk = min(d, MAX_BWD_CHUNK)
        if tc_smem_bytes(w2s, radius, w1, chunk) <= MAX_BWD_SMEM:
            return chunk, w1, True
    chunks, c = [], min(d, MAX_BWD_CHUNK)
    while c >= vec:
        chunks.append(c)
        c //= 2
    tiles = [t for t in (w1, 1024, 512, 256, 128, 64, 32)
             if t <= min(w1, MAX_BWD_TILE)]
    for tile in dict.fromkeys(tiles):
        for chunk in chunks:
            if bwd_smem_bytes(bins, levels, radius, tile, chunk, itemsize,
                              w1) <= MAX_BWD_SMEM:
                return chunk, tile, False
    least = bwd_smem_bytes(bins, levels, radius, 32, vec, itemsize, w1)
    raise ValueError(f"W2 levels {list(w2s)}, radius {radius}: the alt "
                     f"backward keeps a row's f2 of every level in shared "
                     f"memory, {least} bytes at the smallest plan > "
                     f"{MAX_BWD_SMEM}")


def fwd_smem_bytes(levels: int, radius: int, tile: int, chunk: int,
                   item: int, seg: int, out_item: int) -> int:
    """Shared bytes of one block of the forward (csrc/corr_alt.cu
    ``FwdSmem``): the tile's f1 chunk in 16-pixel blocks and ``seg`` band
    rows, each row the chunk padded to 32 bytes plus 16; the window dots
    (stride 2R+5), centers, starts and bin counts; the band table; each
    band row's level and bin; the staged outputs with up to 16 bytes of
    lead."""
    row = -(-chunk * item // 32) * 32 + 16
    pl = levels * tile
    return (-(-tile // 16) * 16 * row + seg * (row + 4)
            + _align16(pl * (2 * radius + 5) * 4) + 3 * _align16(pl * 4)
            + 64 * 4 + _align16(tile * levels * (2 * radius + 1) * out_item
                                + 16))


def plan_fwd(w2s: Sequence[int], radius: int, d: int,
             dtype: torch.dtype) -> Tuple[int, int, int]:
    """(pixel tile, channel chunk, band rows per pass) of one forward launch.

    A block takes ``FWD_TILE`` pixels of one image row and stages their f1
    and, per pass, ``seg`` rows of the band of f2 bins their windows reach,
    in at most ``MAX_FWD_SMEM`` bytes (two blocks per SM).  The centers are not known here, so the band is
    sized for the worst case, every bin of every level, and a block whose
    band is wider takes it in passes of ``seg`` rows.  D is taken whole
    where at least ``FWD_MIN_SEG`` rows (or the whole worst band) fit,
    else in 2, 4, ... chunks of whole 16-byte vectors.  At the realtime
    shapes (W2 156/78/39/19 or 90/45/22/11, D 256): bf16 and fp8 D whole
    with 160 rows, int8 with the whole band, fp32 in two chunks of 128
    with 160 rows.  Raises where not even one vector of D with 16 rows
    fits."""
    vec, item = _VEC[dtype], _FWD_ITEM[dtype]
    out_item = 2 if dtype == torch.bfloat16 else 4
    levels = len(w2s)
    band = -(-sum(w2s) // 16) * 16
    parts = 1
    while True:
        chunk = -(-d // (vec * parts)) * vec
        row = -(-chunk * item // 32) * 32 + 16
        fixed = fwd_smem_bytes(levels, radius, FWD_TILE, chunk, item, 0,
                               out_item)
        seg = min(band, (MAX_FWD_SMEM - fixed) // (row + 4) // 16 * 16)
        if seg >= min(band, FWD_MIN_SEG) and seg >= 16:
            return FWD_TILE, chunk, seg
        if chunk == vec:
            raise ValueError(f"{levels} levels, radius {radius}, D={d} "
                             f"{dtype}: the alt forward's smallest plan "
                             f"exceeds {MAX_FWD_SMEM} bytes of shared "
                             f"memory")
        parts *= 2


def _check(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
           coords: torch.Tensor, radius: int, entries=_ENTRIES) -> None:
    """Raise on what the kernels of ``entries`` do not take (CUDA
    tensors)."""
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    levels = len(fmap2_pyramid)
    b, h, w1, d = fmap1.shape
    dtype = fmap1.dtype
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{levels} levels; the kernel takes 1..{MAX_LEVELS}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius}; the kernel takes 0..{MAX_RADIUS}")
    if dtype not in entries or coords.dtype != torch.float32:
        raise TypeError(f"the alt kernel takes {tuple(entries)} features "
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


def _launch_fwd(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                coords: torch.Tensor, radius: int, entry: str,
                out_dtype: torch.dtype) -> torch.Tensor:
    levels = len(fmap2_pyramid)
    b, h, w1, d = fmap1.shape
    f1 = fmap1.contiguous()
    f2s = [f2.contiguous() for f2 in fmap2_pyramid]
    coords = coords.contiguous()
    for t in (f1, *f2s):
        if t.data_ptr() % 16:
            raise ValueError("the alt kernel reads features as 16-byte "
                             "vectors: their storage must be 16-byte aligned")
    k = 2 * radius + 1
    out = torch.empty((b, h, w1, levels * k), device=coords.device,
                      dtype=out_dtype)
    widths = [t.shape[2] for t in f2s]
    tile, chunk, seg = plan_fwd(widths, radius, d, f1.dtype)
    ptrs = (ctypes.c_void_p * levels)(*[t.data_ptr() for t in f2s])
    w2s = (ctypes.c_int * levels)(*widths)
    with torch.cuda.device(coords.device):
        err = _lib(entry)(
            f1.data_ptr(), ptrs, w2s, levels, coords.data_ptr(),
            out.data_ptr(), b * h * w1, w1, d, radius, 1.0 / math.sqrt(d),
            tile, chunk, seg, torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    return out


class _AltLookup(torch.autograd.Function):
    """The no-volume lookup, differentiable in the features."""

    @staticmethod
    def forward(ctx, coords, radius, fmap1, *fmap2_pyramid):
        ctx.radius = radius
        ctx.save_for_backward(coords, fmap1, *fmap2_pyramid)
        if coords.device.type == "cpu":
            return alt_lookup_xla(fmap1, fmap2_pyramid, coords, radius)
        out = _launch_fwd(fmap1, fmap2_pyramid, coords, radius,
                          _ENTRIES[fmap1.dtype], fmap1.dtype)
        alt_lookup_fused.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        coords, fmap1, *fmap2_pyramid = ctx.saved_tensors
        df1, df2 = alt_lookup_bwd_fused(fmap1, fmap2_pyramid, coords, g,
                                        ctx.radius)
        return (None, None, df1, *df2)


def alt_lookup_fused(fmap1: torch.Tensor, fmap2_pyramid: List[torch.Tensor],
                     coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Window correlation at every level of the right-feature pyramid.

    Args:
      fmap1: (B,H,W1,D) left features, fp32 or bf16.
      fmap2_pyramid: (B,H,W2_l,D) right features per level, fmap1's dtype.
      coords: (B,H,W1) fp32 centers at level 0.

    Returns (B,H,W1,L*(2r+1)) in fmap1's dtype, differentiable in the
    features.  Counts its kernel launches in ``alt_lookup_fused.launches``."""
    if coords.device.type != "cpu":
        _check(fmap1, fmap2_pyramid, coords, radius)
    return _AltLookup.apply(coords, radius, fmap1, *fmap2_pyramid)


alt_lookup_fused.launches = 0


def alt_lookup_fused_q(fmap1_q: torch.Tensor,
                       fmap2_pyramid_q: List[torch.Tensor],
                       coords: torch.Tensor, radius: int,
                       out_dtype: torch.dtype,
                       q_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Window correlation over quantized features (int8 or float8_e4m3fn
    codes, one grid for all of them): one launch of kernel #9 for all
    levels on CUDA tensors, the plain ``alt_lookup_xla`` on CPU tensors.

    Returns the (B,H,W1,L*(2r+1)) raw correlations of the codes times
    1/sqrt(D), in ``out_dtype`` (fp32 on the card, the kernel's output);
    the caller multiplies level l's taps by ``s1 * s2_l``.  Forward only:
    a feature map that requires grad raises.  One level at scale 1/2^l is
    a call with that level alone and ``coords / 2^l``.  Counts its kernel
    launches in ``alt_lookup_fused_q.launches``."""
    check_q_dtype([fmap1_q, *fmap2_pyramid_q], q_dtype)
    if any(t.requires_grad for t in (fmap1_q, *fmap2_pyramid_q)):
        raise ValueError("the quantized alt lookup is forward only: detach "
                         "the features")
    if coords.device.type == "cpu":
        return alt_lookup_xla(fmap1_q, fmap2_pyramid_q, coords, radius,
                              out_dtype)
    _check(fmap1_q, fmap2_pyramid_q, coords, radius, _Q_ENTRIES)
    if out_dtype != torch.float32:
        raise TypeError(f"the quantized alt kernel writes float32, not "
                        f"{out_dtype}")
    out = _launch_fwd(fmap1_q, fmap2_pyramid_q, coords, radius,
                      _Q_ENTRIES[fmap1_q.dtype], torch.float32)
    alt_lookup_fused_q.launches += 1
    return out


alt_lookup_fused_q.launches = 0


def alt_lookup_bwd_fused(fmap1: torch.Tensor,
                         fmap2_pyramid: Sequence[torch.Tensor],
                         coords: torch.Tensor, g: torch.Tensor, radius: int
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Feature gradients ``(df1, [df2_l])`` of the lookup from its output
    gradient ``g`` (B,H,W1,L*(2r+1)), in the feature dtype.  One launch of
    the backward kernel for all levels on CUDA tensors, the plain
    ``alt_lookup_bwd_xla`` on CPU tensors.  Counts its kernel launches in
    ``alt_lookup_bwd_fused.launches``."""
    if g.device.type == "cpu":
        return alt_lookup_bwd_xla(fmap1, fmap2_pyramid, coords, g, radius)
    _check(fmap1, fmap2_pyramid, coords, radius)
    levels = len(fmap2_pyramid)
    b, h, w1, d = fmap1.shape
    dtype = fmap1.dtype
    k = 2 * radius + 1
    if g.dtype != dtype or tuple(g.shape) != (b, h, w1, levels * k):
        raise TypeError(f"gradient {g.dtype} {tuple(g.shape)}, expected "
                        f"{dtype} {(b, h, w1, levels * k)}")
    w2s = [f2.shape[2] for f2 in fmap2_pyramid]
    chunk, tile, tensor_cores = plan_bwd(w1, w2s, radius, d,
                                         fmap1.element_size())
    f1 = fmap1.contiguous()
    f2s = [f2.contiguous() for f2 in fmap2_pyramid]
    for t in (f1, *f2s):
        if t.data_ptr() % 16:
            raise ValueError("the alt backward reads the features as "
                             "16-byte vectors: their storage must be "
                             "16-byte aligned")
    g = g.contiguous()
    coords = coords.contiguous()
    df1 = torch.empty_like(f1)
    df2 = [torch.empty_like(f2) for f2 in f2s]
    ptrs = (ctypes.c_void_p * levels)(*[t.data_ptr() for t in f2s])
    dptrs = (ctypes.c_void_p * levels)(*[t.data_ptr() for t in df2])
    widths = (ctypes.c_int * levels)(*w2s)
    with torch.cuda.device(g.device):
        err = _bwd_lib(_BWD_ENTRIES[dtype])(
            f1.data_ptr(), ptrs, dptrs, widths, levels, coords.data_ptr(),
            g.data_ptr(), df1.data_ptr(), b * h, w1, d, radius,
            1.0 / math.sqrt(d), chunk, tile, int(tensor_cores),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "corr_alt_bwd")
    alt_lookup_bwd_fused.launches += 1
    return df1, df2


alt_lookup_bwd_fused.launches = 0
