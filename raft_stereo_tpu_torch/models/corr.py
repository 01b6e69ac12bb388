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
``corr_w2_shards > 1`` builds the ``reg``/``reg_fused`` volume sharded over
the disparity axis of the active mesh's corr devices
(parallel/corr_sharded.py, under ``corr_sharding(mesh)``).

The quantized tier (``quant`` "int8" or "int8_mxu" with ``quant_corr``)
stores the correlation in one byte, int8 or, with ``quant_corr_fp8``,
float8_e4m3fn, detached (inference only):
* ``reg``/``reg_fused`` quantize the fp32 pyramid per level (calibrated
  ``quant_corr_scales``, int8-referenced, else dynamic in fp32); ``reg``
  dequantizes the levels and samples them (the plain reference),
  ``reg_fused`` samples the codes with ``lookup_pyramid_fused_q`` and
  scales the taps after;
* ``alt`` quantizes the features per tensor with dynamic scales in their
  own dtype (``x / s`` in bf16 under mixed precision) and runs kernel #9
  (``alt_lookup_fused_q``), scaling level l's taps by ``s1 * s2_l``
  (a bf16 product under mixed precision, then cast to fp32).
Both round the scaled fp32 output once to the compute dtype.  The
quantization runs under the profiler range ``raft::quantize_corr``, each
lookup with its scaling under ``raft::corr_lookup_q``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Tuple

import torch
from torch.profiler import record_function

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.kernels.corr_alt import (alt_lookup_fused,
                                                    alt_lookup_fused_q)
from raft_stereo_tpu_torch.kernels.corr_lookup import (lookup_pyramid_fused,
                                                       lookup_pyramid_fused_q,
                                                       lookup_pyramid_xla)
from raft_stereo_tpu_torch.quant.core import (FP8_DTYPE, FP8_QMAX,
                                              dynamic_scale, quantize_fp8,
                                              quantize_symmetric)

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


# ------------------------------------------------------- quantized tier
def corr_quant_enabled(cfg: RaftStereoConfig) -> bool:
    """Whether this config stores the correlation in one byte."""
    return cfg.quant in ("int8", "int8_mxu") and cfg.quant_corr


def corr_q_dtype(cfg: RaftStereoConfig) -> torch.dtype:
    """float8_e4m3fn with ``quant_corr_fp8``, else int8.  Every device of
    the port reads fp8, so there is no capability fallback."""
    return FP8_DTYPE if cfg.quant_corr_fp8 else torch.int8


def _quantize(x: torch.Tensor, scale: torch.Tensor,
              q_dtype: torch.dtype) -> torch.Tensor:
    if q_dtype == torch.int8:
        return quantize_symmetric(x, scale)
    return quantize_fp8(x, scale, q_dtype)


@functools.lru_cache(maxsize=64)
def _static_scale(value: float, device: torch.device) -> torch.Tensor:
    """A calibrated scale as an fp32 0-dim tensor on ``device``, made once:
    a forward captured into a CUDA graph may not copy from the host.
    Made outside inference mode, like the resize matrices."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=torch.float32, device=device)


def quantize_pyramid(pyramid: List[torch.Tensor], cfg: RaftStereoConfig
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-level symmetric quantization of the fp32 pyramid on the
    ``corr_q_dtype`` grid: ``(codes, fp32 scales)``.  Calibrated
    ``quant_corr_scales`` are absmax/127, so the fp8 grid rescales them
    by 127/448; without them each level's scale is its dynamic max-abs
    scale.  The levels are detached first."""
    q_dtype = corr_q_dtype(cfg)
    qmax = 127.0 if q_dtype == torch.int8 else FP8_QMAX
    pyramid = [v.detach() for v in pyramid]
    if cfg.quant_corr_scales is not None:
        scales = [_static_scale(s * (127.0 / qmax), v.device)
                  for s, v in zip(cfg.quant_corr_scales, pyramid)]
    else:
        scales = [dynamic_scale(v, qmax=qmax) for v in pyramid]
    return ([_quantize(v, s, q_dtype) for v, s in zip(pyramid, scales)],
            scales)


def _tap_scale_vector(scales: List[torch.Tensor], radius: int
                      ) -> torch.Tensor:
    """Level l's scale, cast to fp32, repeated over its 2r+1 taps: the
    dequantization of a level-major lookup of codes (sampling is
    linear)."""
    return torch.stack([s.float() for s in scales]).repeat_interleave(
        2 * radius + 1)


def _dequantize_levels(pyramid_q: List[torch.Tensor],
                       scales: List[torch.Tensor], dtype: torch.dtype
                       ) -> List[torch.Tensor]:
    """``codes * scale`` in fp32, cast to ``dtype``."""
    return [(q.float() * s).to(dtype) for q, s in zip(pyramid_q, scales)]


def _make_corr_fn_alt_q(cfg: RaftStereoConfig, f1: torch.Tensor,
                        pyramid: List[torch.Tensor]) -> CorrFn:
    """The no-volume lookup over quantized features: per-tensor dynamic
    scales in the features' dtype, kernel #9, scaled taps."""
    q_dtype = corr_q_dtype(cfg)
    qmax = 127.0 if q_dtype == torch.int8 else FP8_QMAX
    with record_function("raft::quantize_corr"):
        f1 = f1.detach()
        s1 = dynamic_scale(f1, qmax=qmax)
        f1_q = _quantize(f1, s1, q_dtype)
        f2_qs, s2s = [], []
        for f2 in pyramid:
            f2 = f2.detach()
            s2 = dynamic_scale(f2, qmax=qmax)
            f2_qs.append(_quantize(f2, s2, q_dtype))
            s2s.append(s2)
        scale_vec = _tap_scale_vector([s1 * s2 for s2 in s2s],
                                      cfg.corr_radius)
    compute_dtype = f1.dtype

    def corr_fn(coords: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), record_function("raft::corr_lookup_q"):
            raw = alt_lookup_fused_q(f1_q, f2_qs, coords, cfg.corr_radius,
                                     out_dtype=torch.float32,
                                     q_dtype=q_dtype)
            return (raw * scale_vec).to(compute_dtype)

    corr_fn.codes = [f1_q, *f2_qs]
    return corr_fn


def _make_corr_fn_alt(cfg: RaftStereoConfig, fmap1: torch.Tensor,
                      fmap2: torch.Tensor) -> CorrFn:
    f1 = fmap1.permute(0, 2, 3, 1).contiguous()      # (B,H,W1,D)
    pyramid = [fmap2.permute(0, 2, 3, 1).contiguous()]
    for _ in range(cfg.corr_levels - 1):
        pyramid.append(pool_axis(pyramid[-1], axis=2).contiguous())
    if corr_quant_enabled(cfg):
        return _make_corr_fn_alt_q(cfg, f1, pyramid)

    def corr_fn(coords: torch.Tensor) -> torch.Tensor:
        return alt_lookup_fused(f1, pyramid, coords, cfg.corr_radius)

    return corr_fn


def _make_corr_fn_q(cfg: RaftStereoConfig, fmap1: torch.Tensor,
                    fmap2: torch.Tensor) -> CorrFn:
    """``reg``/``reg_fused`` over the 1-byte pyramid of the fp32 volume."""
    with torch.no_grad():
        pyramid = build_corr_pyramid(
            build_corr_volume(fmap1.float(), fmap2.float()), cfg.corr_levels)
        with record_function("raft::quantize_corr"):
            pyramid_q, scales = quantize_pyramid(pyramid, cfg)
    radius = cfg.corr_radius
    if cfg.corr_backend == "reg":
        levels = _dequantize_levels(pyramid_q, scales, torch.float32)

        def corr_fn(coords: torch.Tensor) -> torch.Tensor:
            return lookup_pyramid_xla(levels, coords, radius)
    else:
        scale_vec = _tap_scale_vector(scales, radius)
        q_dtype = corr_q_dtype(cfg)
        compute_dtype = fmap1.dtype

        def corr_fn(coords: torch.Tensor) -> torch.Tensor:
            with torch.no_grad(), record_function("raft::corr_lookup_q"):
                raw = lookup_pyramid_fused_q(pyramid_q, coords, radius,
                                             out_dtype=torch.float32,
                                             q_dtype=q_dtype)
                return (raw * scale_vec).to(compute_dtype)

    corr_fn.codes = pyramid_q
    return corr_fn


def make_corr_fn(cfg: RaftStereoConfig, fmap1: torch.Tensor,
                 fmap2: torch.Tensor) -> CorrFn:
    """The lookup of ``cfg.corr_backend`` over (B,D,H,W) features.  A
    quantized config's function carries its codes as ``corr_fn.codes``
    (the features or the pyramid levels)."""
    if cfg.corr_fp32:
        fmap1, fmap2 = fmap1.float(), fmap2.float()
    if cfg.corr_w2_shards > 1:
        # the disparity-axis-sharded volume over the active mesh's corr
        # devices (parallel/corr_sharded.py); ``alt`` builds no volume
        # and is refused by the config
        from raft_stereo_tpu_torch.parallel.corr_sharded import (
            active_corr_mesh, make_corr_fn_w2_sharded)
        mesh = active_corr_mesh()
        if mesh is None:
            raise RuntimeError(
                f"corr_w2_shards={cfg.corr_w2_shards} needs an active mesh: "
                "run the model under parallel.corr_sharded.corr_sharding(mesh)")
        return make_corr_fn_w2_sharded(cfg, fmap1, fmap2, mesh)
    if cfg.corr_backend == "alt":
        return _make_corr_fn_alt(cfg, fmap1, fmap2)
    if corr_quant_enabled(cfg):
        return _make_corr_fn_q(cfg, fmap1, fmap2)
    volume = build_corr_volume(fmap1.float(), fmap2.float())
    if cfg.corr_backend == "reg_fused":
        volume, lookup = volume.to(fmap1.dtype), lookup_pyramid_fused
    else:
        lookup = lookup_pyramid_xla
    pyramid = build_corr_pyramid(volume, cfg.corr_levels)

    def corr_fn(coords: torch.Tensor) -> torch.Tensor:
        return lookup(pyramid, coords, cfg.corr_radius)

    return corr_fn
