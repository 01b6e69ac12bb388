"""Post-training int8 quantization of the inference tier.

The port's own copy of the JAX package's ``quant/core.py``, on the port's
state dict (OIHW conv weights) instead of a Flax variables tree:

* **Weights**, per output channel, symmetric: ``scale = absmax_c / 127``
  (1 for an all-zero channel), ``q = clip(rint(w / scale), -127, 127)``,
  in host numpy exactly as the JAX package computes them.  A conv's
  ``<path>.weight`` becomes ``<path>.q8`` (int8, OIHW), ``<path>.qscale``
  (fp32, [O]) and, with a calibrated input scale, ``<path>.ascale`` (fp32
  scalar): the JAX pack ``{q8, qscale[, ascale]}`` with the kernel's
  layout moved.
* **Scope**: the encoders only (``fnet``, ``cnet``, ``conv2_res``,
  ``conv2_out`` and the per-level ``context_zqr_conv*``), which run once
  per pair; the GRU update block runs every iteration and stays in the
  compute dtype.
* **Activations** (correlation features and pyramid, and the int8 conv
  inputs): per tensor, ``clip(round(x / s), -127, 127)`` with ``x / s``
  in x's dtype, or ``clip(x / s, -448, 448)`` cast to float8_e4m3fn.

``quant == "off"`` never calls anything here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

QUANT_MODES = ("off", "int8", "int8_mxu")

# float8_e4m3fn's largest finite magnitude (1.75 * 2^8): the fp8 analogue
# of int8's 127 for symmetric scales.
FP8_QMAX = 448.0
FP8_DTYPE = torch.float8_e4m3fn

# Top-level modules whose convs quantize; ``context_zqr_conv*`` by prefix.
_ENCODER_MODULES = ("fnet", "cnet", "conv2_res", "conv2_out")
_ENCODER_PREFIXES = ("context_zqr_conv",)
PACK_KEYS = ("q8", "qscale", "ascale")


def in_encoder_scope(path: str) -> bool:
    """Whether a dotted module path or state-dict key lies in the
    quantized encoder scope."""
    top = path.split(".")[0]
    return top in _ENCODER_MODULES or top.startswith(_ENCODER_PREFIXES)


def quantize_array(w: np.ndarray, axis: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel symmetric int8 quantization of one conv weight:
    ``(q int8, scale fp32)``, ``scale`` with kept dims, one value per
    index of ``axis`` (the output channel: 0 in OIHW)."""
    w = np.asarray(w, dtype=np.float32)
    absmax = np.max(np.abs(w), axis=tuple(
        a for a in range(w.ndim) if a != axis % w.ndim), keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_array(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in fp32, ``scale`` one value per output channel
    (OIHW)."""
    return q.float() * scale.float().reshape(-1, *([1] * (q.dim() - 1)))


def quantize_state_dict(state: Mapping[str, torch.Tensor],
                        act_scales: Optional[Mapping[str, float]] = None
                        ) -> Dict[str, torch.Tensor]:
    """The int8 inference state dict: every encoder conv weight replaced
    by its pack; every other entry (biases, norms, the update block)
    passes through.  ``act_scales`` maps "/"-joined module paths
    (``"fnet/trunk/conv1"``, the keys of ``quant.calibrate
    .conv_input_scales``) to calibrated scales of the conv's input; a
    matching pack gains ``ascale``."""
    act_scales = act_scales or {}
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        path, _, name = key.rpartition(".")
        if name == "weight" and value.dim() == 4 and in_encoder_scope(key):
            q, scale = quantize_array(value.detach().cpu().float().numpy())
            out[f"{path}.q8"] = torch.from_numpy(q)
            out[f"{path}.qscale"] = torch.from_numpy(scale.reshape(-1))
            ascale = act_scales.get(path.replace(".", "/"))
            if ascale is not None:
                out[f"{path}.ascale"] = torch.tensor(np.float32(ascale))
        else:
            out[key] = value
    return out


def dequantize_state_dict(state: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """Every pack back to its fp32 ``weight`` (``ascale`` dropped)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        path, _, name = key.rpartition(".")
        if name == "q8":
            out[f"{path}.weight"] = dequantize_array(
                value, state[f"{path}.qscale"])
        elif name not in ("qscale", "ascale"):
            out[key] = value
    return out


def is_quantized(state: Mapping[str, torch.Tensor]) -> bool:
    """True when the state dict holds at least one pack."""
    return any(k.endswith(".q8") for k in state)


def quantized_param_bytes(state: Mapping[str, torch.Tensor]
                          ) -> Dict[str, int]:
    """``{"int8": n, "fp32": n, "scales": n}``: bytes of the packs' codes,
    of every float leaf outside the packs, and of the packs' scales."""
    acc = {"int8": 0, "fp32": 0, "scales": 0}
    for key, value in state.items():
        nbytes = value.numel() * value.element_size()
        name = key.rpartition(".")[2]
        if name == "q8":
            acc["int8"] += nbytes
        elif name in ("qscale", "ascale"):
            acc["scales"] += nbytes
        elif value.is_floating_point():
            acc["fp32"] += nbytes
    return acc


def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8; ``x / scale`` in the
    dtype both share (bf16 under mixed precision), rounding half to
    even."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dynamic_scale(x: torch.Tensor, eps: float = 1e-12,
                  qmax: float = 127.0) -> torch.Tensor:
    """Per-tensor symmetric scale ``max(max|x|, eps) / qmax`` as a 0-dim
    tensor in x's dtype; ``qmax`` is 127 for int8, ``FP8_QMAX`` for
    float8_e4m3fn."""
    return torch.clamp_min(x.abs().amax(), eps) / qmax


def quantize_fp8(x: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = FP8_DTYPE) -> torch.Tensor:
    """``clip(x / scale, -448, 448)`` cast to fp8 (round to nearest even);
    the clip keeps the cast away from fp8's missing infinities."""
    return torch.clamp(x / scale, -FP8_QMAX, FP8_QMAX).to(dtype)


def clipped_scale(absmax_percentile: float) -> float:
    """A calibrated percentile-clipped range to its int8 scale."""
    return max(float(absmax_percentile), 1e-12) / 127.0
