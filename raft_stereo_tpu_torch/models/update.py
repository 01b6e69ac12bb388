"""Recurrent update block (NCHW).

Level 0 is the FINEST resolution (1/2^n_downsample); the reference's
gru08/gru16/gru32 are levels 0/1/2.  The context biases (cz, cr, cq) are
computed once per forward by the model and passed in per level.  Every
op runs in the activations' dtype (bf16 under mixed precision).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.kernels.gru_fused import gru_gates_fused
from raft_stereo_tpu_torch.models.extractor import conv
from raft_stereo_tpu_torch.models.remat import GateConv2d
from raft_stereo_tpu_torch.ops.pooling import pool2x
from raft_stereo_tpu_torch.ops.resize import interp_like


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 output_dim: int = 2):
        super().__init__()
        self.conv1 = conv(input_dim, hidden_dim, 3)
        self.conv2 = conv(hidden_dim, output_dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """ConvGRU with precomputed context biases.

    ``convzr`` is one conv producing z|r.  With ``fused`` "auto" or "on"
    the gate pre-activations come from kernels/gru_fused.py (the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor) and only
    the sigmoid/tanh/blend tail runs here; "off" runs the plain convs.
    Either way the pre-activations come from dispatcher operators that a
    checkpoint policy can keep (``remat_save`` "gru_gates",
    models/remat.py)."""

    def __init__(self, hidden_dim: int, input_dim: int, fused: str = "off"):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.fused = fused
        self.convzr = conv(hidden_dim + input_dim, 2 * hidden_dim, 3,
                           cls=GateConv2d)
        self.convq = conv(hidden_dim + input_dim, hidden_dim, 3,
                          cls=GateConv2d)

    def forward(self, h: torch.Tensor, context: Sequence[torch.Tensor],
                *x_list: torch.Tensor) -> torch.Tensor:
        cz, cr, cq = context
        x = torch.cat(x_list, dim=1)
        hd = self.hidden_dim
        if self.fused != "off":
            zr, qpre = gru_gates_fused(
                _nhwc(h), _nhwc(x), _nhwc(cr), _hwio(self.convzr.weight),
                self.convzr.bias, _hwio(self.convq.weight), self.convq.bias)
            z = torch.sigmoid(_nchw(zr)[:, :hd] + cz)
            q = torch.tanh(_nchw(qpre) + cq)
            return (1 - z) * h + z * q
        zr = self.convzr(torch.cat([h, x], dim=1))
        z = torch.sigmoid(zr[:, :hd] + cz)
        r = torch.sigmoid(zr[:, hd:] + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """Correlation + flow -> 126 motion channels, plus the 2 flow channels."""

    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = conv(corr_channels, 64, 1)
        self.convc2 = conv(64, 64, 3)
        self.convf1 = conv(2, 64, 7)
        self.convf2 = conv(64, 64, 3)
        self.conv = conv(128, 128 - 2, 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicMultiUpdateBlock(nn.Module):
    """Up to 3 cross-coupled ConvGRUs + flow and mask heads."""

    def __init__(self, cfg: RaftStereoConfig):
        super().__init__()
        self.n = n = cfg.n_gru_layers
        hd = cfg.hidden_dims
        fused = cfg.fused_gru
        self.encoder = BasicMotionEncoder(cfg.corr_channels)
        self.gru08 = ConvGRU(hd[0], 128 + (hd[1] if n > 1 else 0), fused)
        if n >= 2:
            self.gru16 = ConvGRU(hd[1], hd[0] + (hd[2] if n > 2 else 0),
                                 fused)
        if n == 3:
            self.gru32 = ConvGRU(hd[2], hd[1], fused)
        self.flow_head = FlowHead(hd[0], 256, 2)
        self.mask_conv1 = conv(hd[0], 256, 3)
        self.mask_conv2 = conv(256, cfg.mask_channels, 1)

    def forward(self, net: Sequence[torch.Tensor],
                context: Sequence[Tuple[torch.Tensor, ...]],
                corr: Optional[torch.Tensor] = None,
                flow: Optional[torch.Tensor] = None,
                iter_fine: bool = True, iter_mid: bool = True,
                iter_coarse: bool = True, update: bool = True,
                motion: Optional[torch.Tensor] = None,
                interp_fn: Optional[Callable[[torch.Tensor, torch.Tensor],
                                             torch.Tensor]] = None):
        """One update, coarse to fine (gru32 -> gru16 -> gru08), of the
        levels whose flag is set; ``iter_fine`` needs ``corr`` and
        ``flow``, or the motion encoder's output ``motion`` computed
        before (``remat_save`` "motion_features").  Returns (net, mask,
        delta_flow), or only net when ``update`` is False (the slow-fast
        schedule's coarse-only steps).

        ``interp_fn(x, dest)`` replaces the cross-resolution upsampling
        ``interp_like``: the align-corners grid depends on the GLOBAL
        heights, so the row-sharded GRU loop (parallel/rows_gru.py)
        passes its window-restricted matrices; None is ``interp_like``."""
        n = self.n
        net = list(net)
        interp = interp_fn or interp_like
        if iter_coarse and n == 3:
            net[2] = self.gru32(net[2], context[2], pool2x(net[1]))
        if iter_mid and n >= 2:
            extra = [interp(net[2], net[1])] if n > 2 else []
            net[1] = self.gru16(net[1], context[1], pool2x(net[0]), *extra)
        if iter_fine:
            if motion is None:
                motion = self.encoder(flow, corr)
            extra = [interp(net[1], net[0])] if n > 1 else []
            net[0] = self.gru08(net[0], context[0], motion, *extra)
        if not update:
            return net
        delta_flow = self.flow_head(net[0])
        # mask scaled by 0.25 to balance gradients, as in the reference
        mask = 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net[0])))
        return net, mask, delta_flow
