"""RAFT-Stereo at fixed depth, test and train mode (NCHW inside).

One forward: normalize both images; run cnet (frozen BN) on the left image
and fnet (instance norm) on both as one batch (one image at a time once
H*W reaches ``sequential_fnet_threshold``, as the JAX model does), or, with
``shared_backbone``, the cnet trunk on both images and the feature head
(``conv2_res``, ``conv2_out``) on its output; build the per-level GRU
context biases; build the correlation (volume and pyramid, or the pooled
right features of ``alt``); run ``iters`` refinement iterations (lookup ->
slow-fast coarse-only GRU steps when set -> motion encoder -> ConvGRUs ->
flow and mask heads -> x-only disparity update); convex-upsample once.

Train mode (``test_mode=False``) returns the full-resolution x-flow of
every iteration, (iters, B, H, W), as the JAX model does: each iteration
starts from a detached disparity and convex-upsamples inside the
iteration.  With ``remat_gru`` the iteration after the lookup runs under
``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes it;
the lookup runs outside the checkpointed region and its output is saved,
as the JAX ``remat_save=("corr_lookup",)`` policy saves it
(``remat_save=()`` puts the lookup inside and recomputes it too).

Under ``mixed_precision`` the images are cast to bf16 after normalization
and the network runs in bf16, at the JAX package's cast points: the
lookup output and the flow input of each iteration are cast to bf16, the
disparity stays fp32 (``delta`` is upcast before it is added), and the
final mask is upcast for the upsampling.  Parameters stay fp32 in the
state dict; ``cast_weights_`` casts the convs of a copy once.

With ``quant`` "int8" or "int8_mxu" every conv of the encoder scope
(``fnet``, ``cnet``, ``conv2_res``, ``conv2_out``, ``context_zqr_conv*``)
holds an int8 pack in place of its weight (``Conv2d.quantize_``): the
model loads a quantized state dict (``quant.core.quantize_state_dict``)
and runs in test mode only.

Disparity is carried as a single x-channel field; the zero y-channel is
built only for the motion encoder's 2-channel flow input.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.models.corr import make_corr_fn
from raft_stereo_tpu_torch.models.extractor import (BasicEncoder, Conv2d,
                                                    MultiBasicEncoder,
                                                    ResidualBlock, conv)
from raft_stereo_tpu_torch.models.update import (BasicMultiUpdateBlock,
                                                 ConvGRU)
from raft_stereo_tpu_torch.ops.grids import coords_grid_x
from raft_stereo_tpu_torch.quant.core import in_encoder_scope
from raft_stereo_tpu_torch.ops.upsample import convex_upsample


# The JAX model's sequential-fnet gate (raft_stereo_tpu/models/
# raft_stereo.py): fnet runs the two images one at a time once H*W reaches
# this share of the device's memory over the batched path's measured extra
# bytes per pixel.  Without a device memory size (the CPU) the JAX package
# assumes 16 GiB.
_STEM_EXTRA_BYTES_PER_PIXEL = 1180
_SEQ_FNET_MEMORY_FRACTION = 0.10
_CPU_MEMORY_BYTES = 16 * 2 ** 30


def sequential_fnet_threshold(cfg: RaftStereoConfig,
                              device: torch.device) -> int:
    """Pixel count from which fnet runs the two images one at a time:
    ``cfg.sequential_fnet_pixels`` where set, else 0.10 x memory / 1180 B
    per pixel, memory being the card's own total memory on a CUDA device
    (about 7.2 M pixels on an 80 GB card) and the JAX package's 16 GiB
    fallback elsewhere (1,455,921 pixels).  In fp32 and bf16 the two
    routes are one function (instance norm is per image); under
    ``quant="int8_mxu"`` with dynamic scales each route takes its own
    scales (one per image against one per pair), so the port takes the
    JAX model's route."""
    if cfg.sequential_fnet_pixels is not None:
        return cfg.sequential_fnet_pixels
    memory = (torch.cuda.get_device_properties(device).total_memory
              if device.type == "cuda" else _CPU_MEMORY_BYTES)
    return int(_SEQ_FNET_MEMORY_FRACTION * memory
               / _STEM_EXTRA_BYTES_PER_PIXEL)


class RAFTStereo(nn.Module):
    def __init__(self, config: RaftStereoConfig):
        super().__init__()
        cfg = self.config = config
        self.cnet = MultiBasicEncoder(
            output_dims=(cfg.hidden_dims, cfg.context_dims),
            norm_fn=cfg.context_norm, downsample=cfg.n_downsample,
            num_layers=cfg.n_gru_layers, dual_inp=cfg.shared_backbone)
        self.update_block = BasicMultiUpdateBlock(cfg)
        for l in range(cfg.n_gru_layers):
            self.add_module(f"context_zqr_conv{l}",
                            conv(cfg.context_dims[l], cfg.hidden_dims[l] * 3,
                                 3))
        if cfg.shared_backbone:
            self.conv2_res = ResidualBlock(128, 128, "instance", 1)
            self.conv2_out = conv(128, cfg.fnet_dim, 3)
        else:
            self.fnet = BasicEncoder(output_dim=cfg.fnet_dim,
                                     norm_fn=cfg.fnet_norm,
                                     downsample=cfg.n_downsample)
        if cfg.quant != "off":
            for name, m in self.named_modules():
                if isinstance(m, Conv2d) and in_encoder_scope(name):
                    m.quantize_(cfg.quant)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.mixed_precision else torch.float32

    def cast_weights_(self) -> "RAFTStereo":
        """Cast every conv's weight and bias to the compute dtype, in place.
        The ConvGRU gate biases stay fp32, as the gate kernel takes them;
        norm parameters stay fp32, and so do quantized convs (pack and
        bias).  For the model an inference runner holds, so the convs do
        not cast their parameters on every call."""
        keep = {id(p) for m in self.modules() if isinstance(m, ConvGRU)
                for p in (m.convzr.bias, m.convq.bias)}
        for m in self.modules():
            if isinstance(m, Conv2d) and m.quant == "off":
                for p in (m.weight, m.bias):
                    if id(p) not in keep:
                        p.data = p.data.to(self.compute_dtype)
        return self

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = True, return_confidence: bool = False,
                hidden_init=None, return_hidden: bool = False,
                ctx_init=None, return_ctx: bool = False):
        """Disparity of a rectified pair.

        Args:
          image1, image2: (B, H, W, 3) images in 0..255.
          iters: GRU refinement iterations.
          flow_init: optional (B, H/f, W/f) initial x-flow.
          test_mode: True for inference, False for training.
          return_confidence, hidden_init, return_hidden, ctx_init,
          return_ctx: not ported yet (ROADMAP.md §D3); setting any raises.

        Returns, in test mode, ``(flow_low, flow_up)``: the (B, H/f, W/f)
        x-flow at feature resolution and its convex-upsampled (B, H, W)
        counterpart (x-flow = -disparity); in train mode the (iters, B, H,
        W) upsampled x-flow of every iteration."""
        if (return_confidence or return_hidden or return_ctx
                or hidden_init is not None or ctx_init is not None):
            raise NotImplementedError(
                "confidence maps and hidden/ctx state carry are not ported "
                "yet (ROADMAP.md §D3)")
        cfg = self.config
        if cfg.quant != "off" and not test_mode:
            raise ValueError(f"quant={cfg.quant!r} is an inference tier: "
                             f"the model runs in test mode only")
        dtype = self.compute_dtype
        img1 = (2 * (image1.float() / 255.0) - 1.0).to(dtype).permute(
            0, 3, 1, 2)
        img2 = (2 * (image2.float() / 255.0) - 1.0).to(dtype).permute(
            0, 3, 1, 2)

        if cfg.shared_backbone:
            levels, v = self.cnet(torch.cat([img1, img2]))
            fmap1, fmap2 = torch.chunk(self.conv2_out(self.conv2_res(v)), 2)
        else:
            levels, _ = self.cnet(img1)
            if (image1.shape[1] * image1.shape[2]
                    >= sequential_fnet_threshold(cfg, img1.device)):
                fmap1, fmap2 = self.fnet(img1), self.fnet(img2)
            else:
                fmap1, fmap2 = torch.chunk(
                    self.fnet(torch.cat([img1, img2])), 2)

        # levels[l] = [hidden_head, context_head], fine -> coarse
        net = [torch.tanh(lv[0]) for lv in levels]
        context = [
            tuple(torch.chunk(
                getattr(self, f"context_zqr_conv{l}")(F.relu(lv[1])), 3,
                dim=1))
            for l, lv in enumerate(levels)]

        b, _, h8, w8 = net[0].shape
        disp = torch.zeros((b, h8, w8), device=img1.device)
        if flow_init is not None:
            disp = disp + flow_init
        corr_fn = make_corr_fn(cfg, fmap1, fmap2)
        grid_x = coords_grid_x(b, h8, w8, device=img1.device)

        def lookup(disp):
            return corr_fn(grid_x + disp).to(dtype).permute(0, 3, 1, 2)

        def update(net, disp, corr):
            """One iteration after the lookup: (net, disp, mask)."""
            n = cfg.n_gru_layers
            flow2 = torch.stack([disp, torch.zeros_like(disp)],
                                dim=1).to(dtype)
            if n == 3 and cfg.slow_fast_gru:
                net = self.update_block(net, context, iter_fine=False,
                                        iter_mid=False, update=False)
            if n >= 2 and cfg.slow_fast_gru:
                net = self.update_block(net, context, iter_fine=False,
                                        iter_coarse=(n == 3), update=False)
            net, mask, delta = self.update_block(
                net, context, corr, flow2, iter_mid=(n >= 2),
                iter_coarse=(n == 3))
            # epipolar projection: only the x component updates
            return net, disp + delta[:, 0].float(), mask

        if test_mode:
            mask = None
            for _ in range(iters):
                net, disp, mask = update(net, disp, lookup(disp))
            if mask is None:
                mask = torch.zeros((b, cfg.mask_channels, h8, w8),
                                   device=img1.device, dtype=dtype)
            return disp, self._upsample(disp, mask)

        save_lookup = "corr_lookup" in cfg.remat_save

        def train_iteration(disp, corr, *net):
            # named in profiler traces, where the remat recompute shows as
            # this range inside the backward
            with record_function("raft::gru_iteration"):
                if corr is None:
                    corr = lookup(disp)
                net, disp, mask = update(list(net), disp, corr)
                return (*net, disp, self._upsample(disp, mask))

        flow_ups = []
        for _ in range(iters):
            disp = disp.detach()
            corr = lookup(disp) if save_lookup else None
            if cfg.remat_gru and torch.is_grad_enabled():
                *net, disp, flow_up = checkpoint(
                    train_iteration, disp, corr, *net, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                *net, disp, flow_up = train_iteration(disp, corr, *net)
            flow_ups.append(flow_up)
        return torch.stack(flow_ups)

    def _upsample(self, disp: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
        """Convex-upsample a (B,h,w) disparity to full resolution."""
        return convex_upsample(disp[:, None], mask.float(),
                               self.config.downsample_factor)[:, 0]
