"""Feature and context encoders (NCHW).

Module names follow the Flax paths of the JAX package (``trunk.conv1``,
``layer1_0.norm3``, ``outputs08_0_conv``, ...) so the weight bridge is a
rename.  Convolutions pad symmetrically by ``k//2``, as torch's
``padding=k//2`` and the JAX package's explicit padding tuples do, and
compute in their input's dtype (bf16 under mixed precision), as Flax's
``nn.Conv(dtype=...)`` does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from raft_stereo_tpu_torch.models.norm import make_norm
from raft_stereo_tpu_torch.quant.core import dequantize_array
from raft_stereo_tpu_torch.quant.matmul import quantized_conv_apply


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: weight and bias are cast to it,
    and the bias is added to the rounded conv output, as ``nn.Conv`` adds
    it in the JAX package (in bf16 the two round separately).  The casts
    are no-ops once ``RAFTStereo.cast_weights_`` has cast the parameters,
    as an inference runner does once.

    ``quantize_(mode)`` replaces the weight by an int8 pack (buffers
    ``q8`` OIHW, ``qscale`` [O], and ``ascale`` when the loaded state dict
    carries one), and the conv routes on what it holds, as the JAX
    package's ``QuantConv`` does: under "int8" it dequantizes the pack in
    fp32 on every call and runs the path above, so int8 is what resides
    on the device; under "int8_mxu" it runs ``quantized_conv_apply``
    (int8 x int8 -> int32, rescaled in fp32, rounded once)."""

    quant = "off"

    def quantize_(self, mode: str) -> "Conv2d":
        """Hold an int8 pack in place of the weight (values come from a
        quantized state dict)."""
        if mode not in ("int8", "int8_mxu"):
            raise ValueError(f"quant mode {mode!r}")
        shape = self.weight.shape
        del self.weight
        self.register_buffer("q8", torch.zeros(shape, dtype=torch.int8))
        self.register_buffer("qscale", torch.ones(shape[0]))
        self.register_buffer("ascale", None)
        self.quant = mode
        return self

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # ``ascale`` is optional in a pack: take it when the state has one.
        if (self.quant != "off" and self.ascale is None
                and prefix + "ascale" in state_dict):
            self.ascale = torch.zeros((), device=self.qscale.device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "int8_mxu":
            return quantized_conv_apply(
                x, self.q8, self.qscale, self.ascale, self.bias,
                self.stride[0], self.padding[0], out_dtype=x.dtype)
        if self.quant == "int8":
            with record_function("raft::dequantize_weights"):
                weight = dequantize_array(self.q8, self.qscale)
        else:
            weight = self.weight
        y = self._conv_forward(x, weight.to(x.dtype), None)
        return y + self.bias.to(x.dtype)[:, None, None]


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         cls: type = Conv2d) -> Conv2d:
    """Conv (``cls``, a ``Conv2d``) with kaiming-normal(fan_out) weights
    and zero bias."""
    c = cls(cin, cout, kernel, stride=stride, padding=kernel // 2)
    nn.init.kaiming_normal_(c.weight, mode="fan_out", nonlinearity="relu")
    nn.init.zeros_(c.bias)
    return c


class ResidualBlock(nn.Module):
    """Two 3x3 convs + norm + skip."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.norm1 = make_norm(norm_fn, planes)
        self.conv2 = conv(planes, planes, 3, 1)
        self.norm2 = make_norm(norm_fn, planes)
        self.has_downsample = not (stride == 1 and in_planes == planes)
        if self.has_downsample:
            self.downsample_conv = conv(in_planes, planes, 1, stride)
            self.norm3 = make_norm(norm_fn, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.has_downsample:
            x = self.norm3(self.downsample_conv(x))
        return F.relu(x + y)


class Trunk(nn.Module):
    """Stem + 3 residual stages (64 -> 96 -> 128) at 1/2^downsample res."""

    def __init__(self, norm_fn: str, downsample: int):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 1 + (downsample > 2))
        self.norm1 = make_norm(norm_fn, 64)
        in_planes = 64
        for i, (dim, stride) in enumerate(
                [(64, 1), (96, 1 + (downsample > 1)),
                 (128, 1 + (downsample > 0))], start=1):
            self.add_module(f"layer{i}_0",
                            ResidualBlock(in_planes, dim, norm_fn, stride))
            self.add_module(f"layer{i}_1",
                            ResidualBlock(dim, dim, norm_fn, 1))
            in_planes = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        for i in (1, 2, 3):
            x = getattr(self, f"layer{i}_0")(x)
            x = getattr(self, f"layer{i}_1")(x)
        return x


class BasicEncoder(nn.Module):
    """fnet: trunk + 1x1 projection."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance",
                 downsample: int = 3):
        super().__init__()
        self.trunk = Trunk(norm_fn, downsample)
        self.conv2 = conv(128, output_dim, 1)

    def forward(self, x: torch.Tensor,
                trunk_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        # ``trunk_out``: the trunk's output computed by another executor
        # on the same parameters (models/banded.py)
        if trunk_out is None:
            trunk_out = self.trunk(x)
        return self.conv2(trunk_out)


class MultiBasicEncoder(nn.Module):
    """cnet: trunk + two extra stride-2 stages + per-level output heads.

    ``output_dims`` holds one FINE -> COARSE channel tuple per head.
    Returns ``(levels, v)``: ``levels[l]`` the list over heads of features
    at 1/2^(downsample+l) resolution, for ``num_layers`` levels, and ``v``
    the trunk output of the whole batch.  With ``dual_inp`` the batch holds
    both images and the heads see only its first half (the left images):
    the shared backbone, whose ``v`` feeds the feature head."""

    def __init__(self, output_dims: Sequence[Tuple[int, ...]],
                 norm_fn: str = "batch", downsample: int = 3,
                 num_layers: int = 3, dual_inp: bool = False):
        super().__init__()
        self.output_dims = [tuple(d) for d in output_dims]
        self.num_layers = num_layers
        self.dual_inp = dual_inp
        self.trunk = Trunk(norm_fn, downsample)
        for h, dims in enumerate(self.output_dims):
            self.add_module(f"outputs08_{h}_res",
                            ResidualBlock(128, 128, norm_fn, 1))
            self.add_module(f"outputs08_{h}_conv", conv(128, dims[0], 3))
        if num_layers >= 2:
            self.layer4_0 = ResidualBlock(128, 128, norm_fn, 2)
            self.layer4_1 = ResidualBlock(128, 128, norm_fn, 1)
            for h, dims in enumerate(self.output_dims):
                self.add_module(f"outputs16_{h}_res",
                                ResidualBlock(128, 128, norm_fn, 1))
                self.add_module(f"outputs16_{h}_conv",
                                conv(128, dims[1], 3))
        if num_layers >= 3:
            self.layer5_0 = ResidualBlock(128, 128, norm_fn, 2)
            self.layer5_1 = ResidualBlock(128, 128, norm_fn, 1)
            for h, dims in enumerate(self.output_dims):
                self.add_module(f"outputs32_{h}_conv",
                                conv(128, dims[2], 3))

    def _heads(self, tag: str, x: torch.Tensor, res: bool) -> List:
        outs = []
        for h in range(len(self.output_dims)):
            y = getattr(self, f"outputs{tag}_{h}_res")(x) if res else x
            outs.append(getattr(self, f"outputs{tag}_{h}_conv")(y))
        return outs

    def forward(self, x: torch.Tensor,
                trunk_out: Optional[torch.Tensor] = None
                ) -> Tuple[List[List[torch.Tensor]], torch.Tensor]:
        # ``trunk_out``: as in ``BasicEncoder.forward``
        x = v = self.trunk(x) if trunk_out is None else trunk_out
        if self.dual_inp:
            x = x[:x.shape[0] // 2]
        levels = [self._heads("08", x, True)]
        if self.num_layers >= 2:
            x = self.layer4_1(self.layer4_0(x))
            levels.append(self._heads("16", x, True))
        if self.num_layers >= 3:
            x = self.layer5_1(self.layer5_0(x))
            levels.append(self._heads("32", x, False))
        return levels, v
