"""RAFT-Stereo, test and train mode (NCHW inside).

One forward: normalize both images; run cnet (frozen BN) on the left image
and fnet (instance norm) on both as one batch (one image at a time once
H*W reaches ``sequential_fnet_threshold``, as the JAX model does), or, with
``shared_backbone``, the cnet trunk on both images and the feature head
(``conv2_res``, ``conv2_out``) on its output; build the per-level GRU
context biases; build the correlation (volume and pyramid, or the pooled
right features of ``alt``); run the refinement iterations (lookup ->
slow-fast coarse-only GRU steps when set -> motion encoder -> ConvGRUs ->
flow and mask heads -> x-only disparity update); convex-upsample once.
``begin`` is everything before the loop and hands out one iteration as
``step``, so the inference runner can capture the loop's parts apart.
With ``banded_encoder`` each encoder's trunk streams its full-resolution
segment in bands (models/banded.py) and fnet runs one image at a time.

Test mode runs ``iters`` iterations, or, with ``exit_threshold_px > 0``,
the JAX model's convergence-gated loop (``ExitLoop``); it can also
return a confidence map and carry the GRU state between frames
(``hidden_init``/``return_hidden``, ``ctx_init``/``return_ctx``).

Train mode (``test_mode=False``) returns the full-resolution x-flow of
every iteration, (iters, B, H, W), as the JAX model does: each iteration
starts from a detached disparity and convex-upsamples inside the
iteration.  With ``remat_gru`` the iteration after the lookup runs under
``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes it;
the lookup runs outside the checkpointed region and its output is saved,
as the JAX ``remat_save=("corr_lookup",)`` policy saves it
(``remat_save=()`` puts the lookup inside and recomputes it too);
``"gru_gates"`` and ``"motion_features"`` keep the gate pre-activations
and the motion encoder's output as well (models/remat.py).

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

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.kernels.graph_loop import exit_continues, f32
from raft_stereo_tpu_torch.models import remat
from raft_stereo_tpu_torch.models.corr import make_corr_fn
from raft_stereo_tpu_torch.models.extractor import (BasicEncoder, Conv2d,
                                                    MultiBasicEncoder,
                                                    ResidualBlock, conv)
from raft_stereo_tpu_torch.models.update import (BasicMultiUpdateBlock,
                                                 ConvGRU)
from raft_stereo_tpu_torch.ops.grids import coords_grid_x
from raft_stereo_tpu_torch.quant.core import in_encoder_scope
from raft_stereo_tpu_torch.ops.upsample import convex_upsample
from raft_stereo_tpu_torch.profiling import annotate


# The JAX model's sequential-fnet gate (raft_stereo_tpu/models/
# raft_stereo.py): fnet runs the two images one at a time once H*W reaches
# this share of the device's memory over the batched path's measured extra
# bytes per pixel.  Without a device memory size (the CPU) the JAX package
# assumes 16 GiB.
_STEM_EXTRA_BYTES_PER_PIXEL = 1180
_SEQ_FNET_MEMORY_FRACTION = 0.10
_CPU_MEMORY_BYTES = 16 * 2 ** 30

# The JAX model's confidence map: the per-pixel convergence score (final
# |delta disparity| plus half its EWMA, px at feature resolution) maps to
# exp(-score / CONFIDENCE_SCALE_PX); the EWMA keeps CONFIDENCE_EWMA_DECAY
# of the history each iteration.
CONFIDENCE_SCALE_PX = 0.25
CONFIDENCE_EWMA_DECAY = 0.8


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
    return int(_SEQ_FNET_MEMORY_FRACTION * device_memory_bytes(device)
               / _STEM_EXTRA_BYTES_PER_PIXEL)


def device_memory_bytes(device: torch.device) -> int:
    """The card's total memory on a CUDA device; the JAX package's 16 GiB
    assumption elsewhere."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return _CPU_MEMORY_BYTES


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
          iters: GRU refinement iterations; the depth cap under early exit.
          flow_init: optional (B, H/f, W/f) initial x-flow (warm start).
          test_mode: True for inference, False for training.
          return_confidence: test mode only; also return ``(conf_low,
            conf_up)``, the (B, H/f, W/f) per-pixel confidence in (0, 1]
            and its convex-upsampled (B, H, W) counterpart
            (``_confidence_maps``).
          hidden_init: test mode only; the per-level GRU hidden states an
            earlier frame's ``return_hidden`` gave ((B, C_l, h_l, w_l),
            the port's NCHW layout): the loop resumes from them, the
            context biases still come from this frame.
          return_hidden: test mode only; also return the final per-level
            hidden states.
          ctx_init: test mode only; an earlier frame's ``return_ctx``
            bundle ``(net_list, context)``: the initial hidden states and
            the per-level (cz, cr, cq) biases, NCHW.  cnet and the
            context convs do not run.  Refused with ``shared_backbone``.
          return_ctx: test mode only; also return this frame's bundle,
            taken before the loop.

        With ``config.exit_threshold_px > 0`` the test-mode loop is the
        JAX model's convergence-gated loop (``exit_bounds``): it stops
        once the worst batch member's mean |delta disparity| of an
        iteration falls below the threshold, within ``exit_min_iters``
        and ``min(iters, exit_max_iters)`` iterations, and the result
        gains ``iters_used`` (an int).  Each iteration's delta comes to
        the host (``exit_continues``); ``eval/runner.py`` replays the same
        iterations in a CUDA graph.  At threshold 0 the fixed-depth loop
        runs the same operations as it did before early exit existed.

        Returns, in test mode, ``(flow_low, flow_up[, iters_used][,
        confidence][, hidden][, ctx])``: the (B, H/f, W/f) x-flow at
        feature resolution and its convex-upsampled (B, H, W) counterpart
        (x-flow = -disparity), then the tails whose flag is set, in the
        JAX model's order; in train mode the (iters, B, H, W) upsampled
        x-flow of every iteration."""
        cfg = self.config
        if (ctx_init is not None or return_ctx) and not test_mode:
            raise ValueError("ctx_init/return_ctx are test-mode only (the "
                             "streaming ctx cache is an inference feature)")
        if (hidden_init is not None or return_hidden) and not test_mode:
            raise ValueError("hidden_init/return_hidden are test-mode only "
                             "(hidden-state warm start is an inference "
                             "feature)")
        if return_confidence and not test_mode:
            raise ValueError("return_confidence is test-mode only (the "
                             "confidence map is an inference product)")
        if cfg.quant != "off" and not test_mode:
            raise ValueError(f"quant={cfg.quant!r} is an inference tier: "
                             f"the model runs in test mode only")
        if cfg.rows_gru:
            if hidden_init is not None or return_hidden:
                raise ValueError("hidden_init/return_hidden are unsupported "
                                 "with rows_gru (the sharded loop executor "
                                 "owns its own state layout)")
            if return_confidence:
                raise ValueError("return_confidence is unsupported with "
                                 "rows_gru (the sharded loop executor owns "
                                 "its own state layout)")
            if ctx_init is not None or return_ctx:
                raise ValueError("ctx_init/return_ctx are unsupported with "
                                 "rows_gru (the sharded loop executor owns "
                                 "its own context layout)")
            return self._rows_gru_forward(image1, image2, iters, flow_init,
                                          test_mode)
        step, net, disp, ctx_out = self.begin(
            image1, image2, flow_init, hidden_init, ctx_init, return_ctx)

        if not test_mode:
            return self._train_loop(step, net, disp, iters)

        def tail(net_fin):
            return (((tuple(net_fin),) if return_hidden else ())
                    + ((ctx_out,) if return_ctx else ()))

        if cfg.exit_threshold_px > 0:
            return self._exit_loop(step, net, disp, iters,
                                   return_confidence, tail)
        if return_confidence:
            dmag = ewma = torch.zeros_like(disp)
            mask = self.mask0(disp)
            for _ in range(iters):
                net, new_disp, mask = step(net, disp)
                dmag, ewma = self.trajectory(new_disp, disp, ewma)
                disp = new_disp
            return ((disp, self._upsample(disp, mask),
                     self._confidence_maps(dmag, ewma, mask, 1.0))
                    + tail(net))
        mask = None
        for _ in range(iters):
            net, disp, mask = step(net, disp)
        if mask is None:
            mask = self.mask0(disp)
        return (disp, self._upsample(disp, mask)) + tail(net)

    def begin(self, image1: torch.Tensor, image2: torch.Tensor,
              flow_init: Optional[torch.Tensor] = None, hidden_init=None,
              ctx_init=None, return_ctx: bool = False):
        """Everything before the refinement loop: returns ``(step, net,
        disp, ctx_out)``, where ``step(net, disp) -> (net, disp, mask)`` is
        one iteration (lookup -> slow-fast coarse steps -> motion encoder
        -> ConvGRUs -> heads -> x-only update) over this pair's context
        and correlation, ``net`` and ``disp`` the loop's initial state and
        ``ctx_out`` the ``return_ctx`` bundle (None unless asked)."""
        cfg = self.config
        dtype = self.compute_dtype
        net, context, disp, ctx_out, fmap1, fmap2 = self._start(
            image1, image2, flow_init, hidden_init, ctx_init, return_ctx)
        b, _, h8, w8 = net[0].shape
        with annotate("corr_pyramid"):
            corr_fn = make_corr_fn(cfg, fmap1, fmap2)
        grid_x = coords_grid_x(b, h8, w8, device=disp.device)

        def lookup(disp):
            return corr_fn(grid_x + disp).to(dtype).permute(0, 3, 1, 2)

        def flow2(disp):
            """The motion encoder's 2-channel flow input (y zero)."""
            return torch.stack([disp, torch.zeros_like(disp)],
                               dim=1).to(dtype)

        def update(net, disp, corr, motion=None):
            """One iteration after the lookup (and the motion encoder,
            where ``motion`` is given): (net, disp, mask)."""
            n = cfg.n_gru_layers
            if n == 3 and cfg.slow_fast_gru:
                net = self.update_block(net, context, iter_fine=False,
                                        iter_mid=False, update=False)
            if n >= 2 and cfg.slow_fast_gru:
                net = self.update_block(net, context, iter_fine=False,
                                        iter_coarse=(n == 3), update=False)
            flow = None if motion is not None else flow2(disp)
            net, mask, delta = self.update_block(
                net, context, corr, flow, iter_mid=(n >= 2),
                iter_coarse=(n == 3), motion=motion)
            # epipolar projection: only the x component updates
            return net, disp + delta[:, 0].float(), mask

        def step(net, disp, corr=None, motion=None):
            with annotate("gru_iter"):
                if motion is None and corr is None:
                    corr = lookup(disp)
                return update(list(net), disp, corr, motion)

        def motion_features(disp, corr):
            """The motion encoder's output for this iteration's lookup."""
            return self.update_block.encoder(flow2(disp), corr)

        step.lookup = lookup
        step.motion = motion_features
        return step, net, disp, ctx_out


    def _start(self, image1: torch.Tensor, image2: torch.Tensor,
               flow_init=None, hidden_init=None, ctx_init=None,
               return_ctx: bool = False):
        """The encoders and the loop's initial state: ``(net, context,
        disp, ctx_out, fmap1, fmap2)``."""
        cfg = self.config
        if ctx_init is not None and cfg.shared_backbone:
            raise ValueError(
                "ctx_init is unsupported with shared_backbone: fnet is "
                "computed from the cnet trunk there, so the context "
                "encoder cannot be skipped")
        dtype = self.compute_dtype
        img1, img2 = self.normalize(image1), self.normalize(image2)
        levels, fmap1, fmap2 = self.encode(img1, img2,
                                           context=ctx_init is None)

        if ctx_init is not None:
            net = [n.to(dtype) for n in ctx_init[0]]
            context = [tuple(c.to(dtype) for c in cs) for cs in ctx_init[1]]
        else:
            # levels[l] = [hidden_head, context_head], fine -> coarse
            net = [torch.tanh(lv[0]) for lv in levels]
            context = [
                tuple(torch.chunk(
                    getattr(self, f"context_zqr_conv{l}")(F.relu(lv[1])), 3,
                    dim=1))
                for l, lv in enumerate(levels)]
        # taken before the loop: a frame that reuses it starts where a
        # cold frame would
        ctx_out = ((tuple(net), tuple(tuple(c) for c in context))
                   if return_ctx else None)
        if hidden_init is not None:
            if len(hidden_init) != len(net):
                raise ValueError(
                    f"hidden_init carries {len(hidden_init)} levels, model "
                    f"has {len(net)} GRU levels")
            net = [h.to(dtype) for h in hidden_init]

        b, _, h8, w8 = net[0].shape
        disp = torch.zeros((b, h8, w8), device=img1.device)
        if flow_init is not None:
            disp = disp + flow_init
        return net, context, disp, ctx_out, fmap1, fmap2

    def _rows_gru_forward(self, image1, image2, iters, flow_init,
                          test_mode):
        """The forward with the whole refinement loop row-sharded over
        the active mesh's rows devices (parallel/rows_gru.py); the
        encoders' trunks already ran row-sharded on the same devices
        (``encode``)."""
        from raft_stereo_tpu_torch.parallel.rows_gru import \
            rows_sharded_gru_loop
        mesh, axis = self._rows_mesh()
        net, context, disp, _, fmap1, fmap2 = self._start(
            image1, image2, flow_init)
        out = rows_sharded_gru_loop(
            self.config, self.compute_dtype, self.update_block, fmap1,
            fmap2, net, context, disp, iters, test_mode, mesh, axis)
        return out if not test_mode else tuple(out)

    def _rows_mesh(self):
        """The active ``(mesh, axis)`` of ``rows_shards``, checked."""
        from raft_stereo_tpu_torch.parallel.rows_sharded import \
            active_rows_mesh
        cfg = self.config
        active = active_rows_mesh()
        if active is None:
            raise RuntimeError(
                f"rows_shards={cfg.rows_shards} needs an active mesh: run "
                "the model under parallel.rows_sharded.rows_sharding(mesh)")
        mesh, axis = active
        n = len(mesh.axis_devices(axis))
        if n != cfg.rows_shards:
            raise ValueError(
                f"rows_shards={cfg.rows_shards} != mesh axis {axis!r} size "
                f"{n}")
        return mesh, axis

    def normalize(self, image: torch.Tensor) -> torch.Tensor:
        """A (B, H, W, 3) 0..255 image as the encoders take it: -1..1,
        NCHW, in the compute dtype."""
        return (2 * (image.float() / 255.0) - 1.0).to(
            self.compute_dtype).permute(0, 3, 1, 2)

    def encode(self, img1: torch.Tensor, img2: torch.Tensor,
               context: bool = True):
        """The encoders on a normalized pair: ``(levels, fmap1, fmap2)``,
        cnet's per-level heads (None without ``context``; the shared
        backbone always runs cnet) and the two feature maps."""
        cfg = self.config
        # ``banded_encoder``: each encoder's trunk streams its
        # full-resolution segment in bands (models/banded.py), through the
        # encoders' ``trunk_out`` hook on the same parameters
        # ``rows_shards`` > 1: the trunks' full-resolution segment runs
        # with its rows split over the active mesh's rows devices
        # (parallel/rows_sharded.py), on the same parameters
        trunk = (self._banded_trunk() if cfg.banded_encoder
                 else self._rows_trunk() if cfg.rows_shards > 1 else None)

        def run(encoder, x, norm_fn):
            return encoder(x, trunk_out=None if trunk is None
                           else trunk(encoder.trunk, x, norm_fn))

        # the JAX model's phase names (profiling.annotate): profiler
        # traces and NVTX timelines break out the same phases
        levels = None
        if cfg.shared_backbone:
            with annotate("cnet"):
                levels, v = run(self.cnet, torch.cat([img1, img2]),
                                cfg.context_norm)
            with annotate("fnet"):
                fmap1, fmap2 = torch.chunk(
                    self.conv2_out(self.conv2_res(v)), 2)
            return levels, fmap1, fmap2
        if context:
            with annotate("cnet"):
                levels, _ = run(self.cnet, img1, cfg.context_norm)
        with annotate("fnet"):
            # banded: one image at a time, as the JAX model scans fnet
            if trunk is not None or (
                    img1.shape[2] * img1.shape[3]
                    >= sequential_fnet_threshold(cfg, img1.device)):
                return (levels, run(self.fnet, img1, cfg.fnet_norm),
                        run(self.fnet, img2, cfg.fnet_norm))
            fmap1, fmap2 = torch.chunk(self.fnet(torch.cat([img1, img2])), 2)
        return levels, fmap1, fmap2

    def _banded_trunk(self):
        """The banded trunk executor ``(trunk, x, norm_fn) -> trunk
        output`` at ``config.band_rows``, after the JAX model's check that
        every encoder it runs has a supported norm."""
        cfg = self.config
        from raft_stereo_tpu_torch.models.banded import banded_trunk_apply
        self._check_trunk_norms()
        return lambda trunk, x, norm_fn: banded_trunk_apply(
            trunk, x, norm_fn, band=cfg.band_rows)

    def _rows_trunk(self):
        """The row-sharded trunk executor over the active mesh's rows
        devices, after the same norm check as the banded one."""
        from raft_stereo_tpu_torch.parallel.rows_sharded import \
            rows_sharded_trunk_apply
        self._check_trunk_norms()
        mesh, axis = self._rows_mesh()
        return lambda trunk, x, norm_fn: rows_sharded_trunk_apply(
            trunk, x, norm_fn, mesh, axis)

    def _check_trunk_norms(self) -> None:
        """The JAX model's check that every encoder a trunk executor
        runs has a supported norm."""
        from raft_stereo_tpu_torch.models.banded import banded_supported
        cfg = self.config
        for norm in (cfg.context_norm,
                     *((cfg.fnet_norm,) if not cfg.shared_backbone else ())):
            if not banded_supported(norm, cfg.n_downsample):
                raise ValueError(
                    f"banded_encoder/rows_shards: norm {norm!r} with "
                    f"n_downsample={cfg.n_downsample} is unsupported")

    def exit_bounds(self, iters: int):
        """``(limit, min_iters, threshold)`` of the early-exit loop at the
        depth cap ``iters``, the JAX model's: ``limit = min(iters,
        exit_max_iters)``, ``min_iters = max(1, min(exit_min_iters,
        limit))``, the threshold rounded to fp32."""
        cfg = self.config
        limit = (iters if cfg.exit_max_iters is None
                 else min(iters, cfg.exit_max_iters))
        return (limit, max(1, min(cfg.exit_min_iters, limit)),
                f32(cfg.exit_threshold_px))

    def mask0(self, disp: torch.Tensor) -> torch.Tensor:
        """The upsampling mask before the first iteration (zeros)."""
        b, h8, w8 = disp.shape
        return torch.zeros((b, self.config.mask_channels, h8, w8),
                           device=disp.device, dtype=self.compute_dtype)

    @staticmethod
    def trajectory(new_disp: torch.Tensor, disp: torch.Tensor,
                   ewma: torch.Tensor):
        """One iteration's per-pixel |delta disparity| (fp32) and the
        updated EWMA of it (``CONFIDENCE_EWMA_DECAY``)."""
        dmag = (new_disp - disp).abs()
        return dmag, (CONFIDENCE_EWMA_DECAY * ewma
                      + (1.0 - CONFIDENCE_EWMA_DECAY) * dmag)

    @staticmethod
    def batch_delta(dmag: torch.Tensor) -> torch.Tensor:
        """The exit test's quantity: the per-image mean |delta| (fp32),
        worst over the batch, a 0-d tensor."""
        return dmag.mean(dim=(1, 2)).amax()

    def _exit_loop(self, step, net, disp, iters, return_confidence, tail):
        """The convergence-gated test-mode loop, eagerly (``ExitLoop``)."""
        loop = ExitLoop(self, iters, return_confidence)
        carry = loop.start(step, net, disp)
        loop.iterate(carry)
        out = loop.finish(carry)
        return (out[0], out[1], int(out[2])) + out[3:] + tail(carry["net"])

    def _train_loop(self, step, net, disp, iters):
        """Every iteration's upsampled flow; under ``remat_gru`` each
        iteration after its lookup (and its motion encoder, where kept) is
        checkpointed with the policy of ``remat_save`` (models/remat.py)."""
        cfg = self.config
        save_motion = "motion_features" in cfg.remat_save
        save_lookup = "corr_lookup" in cfg.remat_save or save_motion
        policy = remat.context_fn(cfg.remat_save)

        def train_iteration(disp, corr, motion, *net):
            # named in profiler traces, where the remat recompute shows as
            # this range inside the backward
            with record_function("raft::gru_iteration"):
                net, disp, mask = step(net, disp, corr, motion)
                return (*net, disp, self._upsample(disp, mask))

        flow_ups = []
        for _ in range(iters):
            disp = disp.detach()
            corr = step.lookup(disp) if save_lookup else None
            motion = step.motion(disp, corr) if save_motion else None
            if cfg.remat_gru and torch.is_grad_enabled():
                kwargs = {} if policy is None else {"context_fn": policy}
                *net, disp, flow_up = checkpoint(
                    train_iteration, disp, corr, motion, *net,
                    use_reentrant=False, preserve_rng_state=False, **kwargs)
            else:
                *net, disp, flow_up = train_iteration(disp, corr, motion,
                                                      *net)
            flow_ups.append(flow_up)
        return torch.stack(flow_ups)

    def _upsample(self, disp: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
        """Convex-upsample a (B,h,w) disparity to full resolution."""
        with annotate("upsample"):
            return convex_upsample(disp[:, None], mask.float(),
                                   self.config.downsample_factor)[:, 0]

    def _confidence_maps(self, dmag: torch.Tensor, ewma: torch.Tensor,
                         mask: torch.Tensor, depth_frac):
        """The ``return_confidence`` element, ``(conf_low, conf_up)``: the
        per-pixel score ``dmag + ewma / 2`` (px at feature resolution),
        scaled by ``(1 + depth_frac) / 2`` (the share of the depth cap the
        loop spent: 1 at fixed depth, ``iters_used / limit`` under early
        exit), maps to ``exp(-score / CONFIDENCE_SCALE_PX)``; the full
        resolution map is the convex upsampling of it with the final
        mask, clipped to [0, 1]."""
        with annotate("confidence"):
            score = (dmag + 0.5 * ewma).float()
            conf_low = torch.exp(-score * (0.5 + 0.5 * depth_frac)
                                 / CONFIDENCE_SCALE_PX)
            return conf_low, self._upsample(conf_low, mask).clamp(0.0, 1.0)


class ExitLoop:
    """The JAX model's convergence-gated test-mode loop over a carry of
    tensors that each iteration updates in place, in three parts:
    ``start`` (the carry: the state, the upsampling mask, the count ``it``
    and the last ``delta``, and with ``return_confidence`` the per-pixel
    |delta| and its EWMA), ``body`` (one iteration and its delta, the
    worst member's mean |delta disparity|) and ``finish`` ((flow_low,
    flow_up, it[, (conf_low, conf_up)])).  ``iterate`` runs the loop
    eagerly, reading each delta on the host (``exit_continues``); the
    inference runner captures the same three parts as CUDA graphs and
    counts with ``it`` on the card, so its graphs give this loop's result
    bit for bit."""

    def __init__(self, model: RAFTStereo, iters: int,
                 return_confidence: bool = False):
        self.model = model
        self.limit, self.min_iters, self.threshold = model.exit_bounds(
            iters)
        self.conf = return_confidence

    def continues(self, it: int, delta: float) -> bool:
        return exit_continues(it, delta, self.min_iters, self.limit,
                              self.threshold)

    def start(self, step, net, disp: torch.Tensor) -> dict:
        carry = {"step": step, "net": [n.clone() for n in net],
                 "disp": disp.clone(), "mask": self.model.mask0(disp),
                 "it": torch.zeros((), dtype=torch.int32,
                                   device=disp.device),
                 "delta": torch.full((), math.inf, device=disp.device)}
        if self.conf:
            carry["dmag"] = torch.zeros_like(disp)
            carry["ewma"] = torch.zeros_like(disp)
        return carry

    def body(self, carry: dict) -> None:
        """One iteration; every new value is computed before any is
        written back."""
        net, disp, mask = carry["step"](carry["net"], carry["disp"])
        if self.conf:
            dmag, ewma = self.model.trajectory(disp, carry["disp"],
                                               carry["ewma"])
            carry["dmag"].copy_(dmag)
            carry["ewma"].copy_(ewma)
        else:
            dmag = (disp - carry["disp"]).abs()
        carry["delta"].copy_(self.model.batch_delta(dmag))
        for dst, src in zip(carry["net"], net):
            dst.copy_(src)
        carry["disp"].copy_(disp)
        carry["mask"].copy_(mask)

    def iterate(self, carry: dict) -> None:
        it, delta = 0, math.inf
        while self.continues(it, delta):
            self.body(carry)
            carry["it"] += 1
            it, delta = it + 1, float(carry["delta"])

    def finish(self, carry: dict):
        disp, mask = carry["disp"], carry["mask"]
        out = (disp, self.model._upsample(disp, mask), carry["it"])
        if self.conf:
            frac = carry["it"].float() / self.limit
            out += (self.model._confidence_maps(carry["dmag"],
                                                carry["ewma"], mask, frac),)
        return out
