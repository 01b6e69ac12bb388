"""Normalization layers with the reference's semantics (NCHW).

* ``batch``    — ``FrozenBatchNorm``: always normalized with the stored
  statistics; ``scale``/``bias`` are parameters, ``mean``/``var`` buffers.
* ``instance`` — per-sample, per-channel over (H, W), biased variance,
  eps 1e-5, no affine; statistics in fp32 (fp64 for fp64 activations).
* ``group``    — ``GroupNorm(planes // 8)``, eps 1e-5, affine.
* ``none``     — identity.

Parameter and buffer names are the Flax leaf names of the JAX package,
so the weight bridge (io/jax_weights.py) maps them by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the norms take their statistics and coefficients in:
    fp32, or fp64 for fp64 activations."""
    return torch.promote_types(x.dtype, torch.float32)


class FrozenBatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # inv and shift in fp32 (fp64 for fp64 activations), then cast to
        # the activation dtype.
        dt = stats_dtype(x)
        scale = self.scale.to(dt)
        std = torch.sqrt(self.var.to(dt) + self.eps)
        inv = (scale / std).to(x.dtype)
        shift = (self.bias.to(dt) - self.mean.to(dt) * scale / std
                 ).to(x.dtype)
        return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


class InstanceNorm(nn.Module):
    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(stats_dtype(x))
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups = max(channels // 8, 1)
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.groups, self.scale, self.bias, self.eps)


def make_norm(norm_fn: str, channels: int) -> nn.Module:
    if norm_fn == "batch":
        return FrozenBatchNorm(channels)
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "group":
        return GroupNorm(channels)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm_fn {norm_fn!r}")
