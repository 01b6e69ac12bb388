"""int8 x int8 -> int32 convolution: the ``int8_mxu`` encoder convs.

The port's counterpart of the JAX package's ``quant/matmul.py``:

    y = conv_i8(q(x), q8) * (ascale * qscale) + bias

* ``ascale`` is the pack's calibrated input scale, or else the dynamic
  per-tensor ``max|x| / 127`` in x's dtype, cast to fp32; ``q(x)`` divides
  ``x`` cast to fp32 by it.
* The int32 accumulator is exact: the widest encoder conv reduces
  K = 3*3*128 = 1152 products, |acc| <= 1152 * 127^2 ~ 1.9e7 << 2^31.
  So the card and the CPU give bit-equal accumulators on equal codes.
* The rescale happens once, after accumulation, in fp32, and the result
  is rounded once to the conv's dtype (unlike the bf16 ``Conv2d``, which
  rounds the conv and then its bias add).

``int8_conv_int32`` on a CUDA tensor is an im2col of the int8 codes
(strided views of the zero-padded input, copied once) and one
``torch._int_mm`` (cuBLASLt's int8 GEMM with int32 accumulation): the
JAX package computes this conv with ``lax.conv_general_dilated`` outside
any Pallas kernel, so a library GEMM takes its place.  cuBLASLt wants more
than 16 rows and K and N multiples of 8: K is padded with zero columns
(cnet's 7x7 conv1 has K = 147) and M with zero rows.  On a CPU tensor the
plain version runs the same integer arithmetic as an fp64 convolution,
exact for these sums.

The steps run under the profiler ranges ``raft::quantize_activation``,
``raft::int8_conv`` and ``raft::int8_rescale`` (tools/torch_profile.py
--quant reads them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from raft_stereo_tpu_torch.quant.core import dynamic_scale, quantize_symmetric

_MIN_ROWS = 32  # cuBLASLt's int8 GEMM takes more than 16 rows


def quantize_activation(x: torch.Tensor,
                        ascale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One activation tensor to ``(int8 codes, fp32 scale)``: the
    calibrated ``ascale`` when given, else the dynamic per-tensor scale in
    x's dtype, cast to fp32."""
    if ascale is None:
        ascale = dynamic_scale(x)
    ascale = ascale.float()
    return quantize_symmetric(x.float(), ascale), ascale


def _im2col(x_q: torch.Tensor, kh: int, kw: int, stride: int,
            padding: int) -> Tuple[torch.Tensor, int, int]:
    """(N,C,H,W) int8 -> ((N*Ho*Wo, C*kh*kw) int8, Ho, Wo), columns in
    the (C, kh, kw) order of an OIHW weight row."""
    n, c = x_q.shape[:2]
    xp = F.pad(x_q, (padding,) * 4) if padding else x_q
    cols = xp.unfold(2, kh, stride).unfold(3, kw, stride)  # N,C,Ho,Wo,kh,kw
    ho, wo = cols.shape[2], cols.shape[3]
    return (cols.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, c * kh * kw),
            ho, wo)


def int8_conv_int32(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                    padding: int) -> torch.Tensor:
    """int8 (N,C,H,W) codes x int8 (O,C,kh,kw) codes -> (N,O,Ho,Wo) int32,
    zero padding ``padding`` on every side (exact: 0 quantizes to 0).
    Counts its GEMM launches in ``int8_conv_int32.launches``."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8 conv takes int8 codes, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    if x_q.device.type == "cpu":
        return F.conv2d(x_q.double(), w_q.double(), stride=stride,
                        padding=padding).to(torch.int32)
    if x_q.device.type != "cuda" or w_q.device != x_q.device:
        raise ValueError(f"unsupported devices {x_q.device}, {w_q.device}")
    o, _, kh, kw = w_q.shape
    if o % 8:
        raise ValueError(f"{o} output channels: the int8 GEMM takes a "
                         f"multiple of 8")
    cols, ho, wo = _im2col(x_q, kh, kw, stride, padding)
    m, k = cols.shape
    kp = -(-k // 8) * 8
    mp = max(m, _MIN_ROWS)
    if kp != k or mp != m:
        cols = F.pad(cols, (0, kp - k, 0, mp - m))
    w2 = w_q.reshape(o, k)
    if kp != k:
        w2 = F.pad(w2, (0, kp - k))
    acc = torch._int_mm(cols, w2.contiguous().t())
    int8_conv_int32.launches += 1
    n = x_q.shape[0]
    return acc[:m].reshape(n, ho, wo, o).permute(0, 3, 1, 2)


int8_conv_int32.launches = 0


def quantized_conv_apply(x: torch.Tensor, q8: torch.Tensor,
                         qscale: torch.Tensor,
                         ascale: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], stride: int,
                         padding: int, out_dtype: torch.dtype
                         ) -> torch.Tensor:
    """The quantized conv: quantize the input, int8 conv with int32
    accumulation, per-output-channel rescale in fp32 after accumulation,
    bias add in fp32, one rounding to ``out_dtype``."""
    with record_function("raft::quantize_activation"):
        x_q, a = quantize_activation(x, ascale)
    with record_function("raft::int8_conv"):
        acc = int8_conv_int32(x_q, q8, stride, padding)
    with record_function("raft::int8_rescale"):
        y = acc.float() * (a * qscale.float())[:, None, None]
        if bias is not None:
            y = y + bias.float()[:, None, None]
        return y.to(out_dtype)
