"""Inference runner: host pad -> one program per padded shape -> unpad.

``InferenceRunner`` runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit device it raises.

As the JAX runner keeps one jitted executable per (padded shape, batch),
this one keeps one program per (padded shape, batch) in an LRU cache of
``max_cached_shapes`` entries.  On the card the program is a captured CUDA
graph of ``make_forward``'s closure (``GraphForward``): the first call at
a new key runs the closure once eagerly on the runner's side stream (the
warm-up settles everything that must not first happen inside a capture:
the gate kernel's weight packs, each kernel's one-time
``cudaFuncSetAttribute``, cuBLASLt's workspace, the cached interpolation
matrices and correlation scales), captures it, and replays it; later calls
copy the padded images into the graph's static inputs, replay, and copy
the output to the host.  Every graph of a runner allocates from one
memory pool: safe because a runner replays one graph at a time on one
stream and copies its output to the host before the next replay.  On the
CPU the program is the plain closure, under the same keys.  A replay runs
no Python, so the kernel wrappers' launch counters move only during the
warm-up and the capture; each graph keeps the counts its capture saw (one
forward's launches), and the runner counts captures and replays.

The runner's
entry sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False: the fp32 model is full fp32.
The JAX package asks for HIGHEST precision only in the correlation
volume's einsum, the align-corners resize and its fp32 kernels; its convs
ask for none (single bf16 passes on a TPU, full fp32 on the CPU).  The
port keeps every fp32 conv in full fp32 until a measurement on the card
decides whether TF32 holds the card-vs-CPU tolerances.
The runner always runs a model of its ``effective_config``: it builds one
from the given weights (a model passed in only lends its state dict), on
the device, with the convs cast once to the compute dtype.

``quant`` ("int8" or "int8_mxu"; None keeps the config's own) runs the
quantized inference tier, in the JAX runner's order: ``config.quant`` is
overridden, then ``effective_inference_config`` applies, then the fp32
state dict is quantized here, once (``quant.core.quantize_state_dict``,
with the calibrated conv input scales ``quant_act_scales`` baked into the
packs).  A state dict that is already quantized is used as it is.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops.padding import InputPadder
from raft_stereo_tpu_torch.quant.core import is_quantized, quantize_state_dict

log = logging.getLogger(__name__)

# GRU depth from which bf16 correlation drifts on trained weights, so
# inference at or past it turns ``corr_fp32`` on (as the JAX package does).
DEEP_ITERS_FP32_CORR = 16


def effective_inference_config(config: RaftStereoConfig, iters: int,
                               corr_fp32_auto: bool = True
                               ) -> RaftStereoConfig:
    """The config an inference path runs: deep-iteration bf16 correlation
    gets ``corr_fp32`` switched on."""
    if (corr_fp32_auto and iters >= DEEP_ITERS_FP32_CORR
            and config.mixed_precision and not config.corr_fp32):
        log.warning("iters=%d >= %d with bf16 correlation: enabling "
                    "corr_fp32 for this runner", iters, DEEP_ITERS_FP32_CORR)
        return dataclasses.replace(config, corr_fp32=True)
    return config


def full_fp32() -> None:
    """No TF32 in matmuls or cuDNN convs: the fp32 path is full fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters on the inference path."""
    from raft_stereo_tpu_torch.kernels.corr_alt import (alt_lookup_fused,
                                                        alt_lookup_fused_q)
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_fused, lookup_pyramid_fused_q)
    from raft_stereo_tpu_torch.kernels.gru_fused import gru_gates_fused
    from raft_stereo_tpu_torch.quant.matmul import int8_conv_int32
    return {"lookup": lookup_pyramid_fused.launches,
            "lookup_q": lookup_pyramid_fused_q.launches,
            "alt": alt_lookup_fused.launches,
            "alt_q": alt_lookup_fused_q.launches,
            "gates": gru_gates_fused.launches,
            "gemm": int8_conv_int32.launches}


FETCH_DTYPES = {None: None, "fp16": torch.float16, "bf16": torch.bfloat16}


def make_forward(model: RAFTStereo, iters: int,
                 fetch_dtype: Optional[torch.dtype] = None):
    """The inference program the runner caches per (padded shape, batch):
    ``forward(images1, images2)`` takes (N, Hp, Wp, 3) uint8 (or float)
    images on the model's device and returns the (N, Hp, Wp) x-flow, cast
    to ``fetch_dtype`` on the device (before the copy to the host) when
    one is given.  The model casts the images to fp32 itself."""

    def forward(images1: torch.Tensor, images2: torch.Tensor
                ) -> torch.Tensor:
        _, flow_up = model(images1, images2, iters=iters, test_mode=True)
        return flow_up if fetch_dtype is None else flow_up.to(fetch_dtype)

    return forward


def _to_host(flow: torch.Tensor) -> np.ndarray:
    """A host tensor of the fetch dtype -> a new fp32 array."""
    return flow.float().numpy().copy()


class PlainForward:
    """The CPU entry of the runner's cache: the closure itself."""

    def __init__(self, forward):
        self.forward = forward

    def __call__(self, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return _to_host(self.forward(torch.from_numpy(p1),
                                         torch.from_numpy(p2)))


class GraphForward:
    """One captured CUDA graph of ``forward`` at one (N, Hp, Wp) input
    shape, with its static inputs and output on the card and pinned host
    buffers for the copies.

    ``capture(p1, p2)`` (once) runs ``forward`` eagerly on ``stream``
    outside capture, captures it on ``stream`` into ``pool``, replays it
    and returns the replay's result; ``launches`` holds the wrapper
    launch counts seen during the capture.  ``__call__(p1, p2)`` copies
    the inputs in, replays, and returns the output as a new fp32 array.
    """

    def __init__(self, forward, shape: Tuple[int, int, int, int],
                 dtype: np.dtype, device: torch.device,
                 stream: torch.cuda.Stream, pool):
        self.forward = forward
        self.stream = stream
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()
        self.dtype = np.dtype(dtype)
        tdtype = torch.from_numpy(np.empty(0, self.dtype)).dtype
        self.images1 = torch.empty(shape, dtype=tdtype, device=device)
        self.images2 = torch.empty_like(self.images1)
        self.host1 = torch.empty(shape, dtype=tdtype, pin_memory=True)
        self.host2 = torch.empty_like(self.host1, pin_memory=True)
        self.output: Optional[torch.Tensor] = None
        self.host_out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0

    def _upload(self, p1: np.ndarray, p2: np.ndarray) -> None:
        if p1.dtype != self.dtype or p2.dtype != self.dtype:
            raise ValueError(f"images of {p1.dtype} and {p2.dtype} into a "
                             f"graph captured for {self.dtype}")
        self.host1.numpy()[...] = p1
        self.host2.numpy()[...] = p2
        self.images1.copy_(self.host1, non_blocking=True)
        self.images2.copy_(self.host2, non_blocking=True)

    def _fetch(self) -> np.ndarray:
        self.host_out.copy_(self.output, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return _to_host(self.host_out)

    def capture(self, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        self._upload(p1, p2)
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.inference_mode():
            with torch.cuda.stream(self.stream):
                self.forward(self.images1, self.images2)   # warm-up
            before = launch_counts()
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  stream=self.stream):
                self.output = self.forward(self.images1, self.images2)
            after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        # a normal (not inference) tensor: it is written on every call
        self.host_out = torch.empty(self.output.shape,
                                    dtype=self.output.dtype,
                                    pin_memory=True)
        self.capture_s = time.perf_counter() - t0
        self.graph.replay()
        return self._fetch()

    def __call__(self, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
        self._upload(p1, p2)
        self.graph.replay()
        return self._fetch()


class InferenceRunner:
    """``runner(image1, image2)`` -> ``(flow (H, W), seconds)``.

    Inputs are (H, W, 3) uint8 (or float) numpy images, uploaded in the
    caller's dtype as the JAX runner does; padding to ``divis_by``, the
    test-mode forward and exact unpadding happen inside.  ``shape_bucket`` (a multiple of
    ``divis_by``, e.g. 64) pads to a coarser grid, so nearby image shapes
    share one cache entry; ``max_cached_shapes`` bounds the cache, LRU.
    ``fetch_dtype`` ("fp16", "bf16" or None) casts the flow on the device
    before the copy to the host; results are fp32 either way.
    ``corr_fp32_auto`` (default on) turns ``corr_fp32`` on for bf16
    correlation at ``iters >= DEEP_ITERS_FP32_CORR``
    (``effective_inference_config``); pass False to run raw bf16
    correlation at any depth.  ``quant`` and ``quant_act_scales`` run the
    quantized tier (module docstring).  ``captures`` and ``replays`` count
    the graphs captured and replayed (both stay 0 on the CPU).
    """

    def __init__(self, config: RaftStereoConfig,
                 state_dict_or_model: Union[Mapping[str, torch.Tensor],
                                            RAFTStereo],
                 iters: int = 32, divis_by: int = 32,
                 device: Optional[Union[str, torch.device]] = None,
                 shape_bucket: Optional[int] = None,
                 max_cached_shapes: int = 16,
                 corr_fp32_auto: bool = True,
                 fetch_dtype: Optional[str] = None,
                 quant: Optional[str] = None,
                 quant_act_scales: Optional[Mapping[str, float]] = None):
        if shape_bucket is not None and shape_bucket % divis_by:
            raise ValueError(f"shape_bucket={shape_bucket} must be a "
                             f"multiple of the model's /{divis_by} "
                             f"divisibility requirement")
        if max_cached_shapes < 1:
            raise ValueError(
                f"max_cached_shapes={max_cached_shapes} must be >= 1")
        if fetch_dtype not in FETCH_DTYPES:
            raise ValueError(f"fetch_dtype={fetch_dtype!r}: use 'fp16', "
                             f"'bf16', or None (full fp32 fetch)")
        self.device = resolve_device(device)
        full_fp32()
        self.config = config
        if quant is not None:
            config = dataclasses.replace(config, quant=quant)
        self.effective_config = effective_inference_config(
            config, iters, corr_fp32_auto)
        self._quant_act_scales = quant_act_scales
        state = (state_dict_or_model.state_dict()
                 if isinstance(state_dict_or_model, RAFTStereo)
                 else state_dict_or_model)
        model = RAFTStereo(self.effective_config)
        model.load_state_dict(self._prepare(state), strict=True)
        self.model = model.to(self.device).eval().cast_weights_()
        self.iters = iters
        self.divis_by = shape_bucket or divis_by
        self.max_cached_shapes = max_cached_shapes
        self.fetch_dtype = FETCH_DTYPES[fetch_dtype]
        self._compiled: Dict[Tuple[Tuple[int, int], int],
                             Union[PlainForward, GraphForward]] = {}
        self._forward = make_forward(self.model, iters, self.fetch_dtype)
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        self.captures = 0
        self.replays = 0

    def _prepare(self, state: Mapping[str, torch.Tensor]
                 ) -> Mapping[str, torch.Tensor]:
        """Quantize an fp32 state dict once where the config asks."""
        if self.effective_config.quant != "off" and not is_quantized(state):
            return quantize_state_dict(state,
                                       act_scales=self._quant_act_scales)
        return state

    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """New weights of the same config, copied into the model in place.
        Every cached program is dropped: a graph holds the gate kernel's
        weight packs of the old weights, so the next call at each shape
        captures again."""
        with torch.no_grad():
            self.model.load_state_dict(self._prepare(state), strict=True)
        self._compiled.clear()

    def _forward_for(self, padded_hw: Tuple[int, int], batch: int = 1,
                     dtype: np.dtype = np.uint8):
        """The cache entry for one (padded shape, batch), LRU: distinct
        raw shapes that pad to one grid share it (KITTI's 375x1242,
        370x1224 and 376x1241 all pad to 384x1248)."""
        key = (tuple(padded_hw), batch)
        if key in self._compiled:
            self._compiled[key] = self._compiled.pop(key)  # LRU refresh
            return self._compiled[key]
        while len(self._compiled) >= self.max_cached_shapes:
            evicted = next(iter(self._compiled))
            del self._compiled[evicted]
            log.info("graph cache full (max_cached_shapes=%d): evicting "
                     "padded shape %s batch %d; its next use captures "
                     "again", self.max_cached_shapes, evicted[0],
                     evicted[1])
        if self.device.type == "cuda":
            if self._pool is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            entry = GraphForward(self._forward,
                                 (batch,) + tuple(padded_hw) + (3,),
                                 dtype, self.device, self._stream,
                                 self._pool)
        else:
            entry = PlainForward(self._forward)
        self._compiled[key] = entry
        return entry

    def _run(self, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
        """(N, Hp, Wp, 3) padded images -> (N, Hp, Wp) fp32 flow."""
        entry = self._forward_for(p1.shape[1:3], p1.shape[0], p1.dtype)
        if isinstance(entry, GraphForward):
            if entry.output is None:
                self.captures += 1
                self.replays += 1
                return entry.capture(p1, p2)
            self.replays += 1
        return entry(p1, p2)

    def __call__(self, image1: np.ndarray, image2: np.ndarray
                 ) -> Tuple[np.ndarray, float]:
        """Returns ``(flow, seconds)``: flow is the (H, W) x-flow
        (= -disparity); seconds run from the host pad to the end of the
        device->host copy of the result.  A first call at a new padded
        shape includes the capture; the KITTI validator's warm-up discard
        absorbs it, as the reference's absorbs cuDNN autotuning."""
        if image1.ndim != 3 or image1.shape != image2.shape:
            raise ValueError(f"expected two (H, W, 3) images of one shape, "
                             f"got {image1.shape} and {image2.shape}")
        flows, seconds = self.run_batch([image1], [image2])
        return flows[0], seconds

    def run_batch(self, images1, images2) -> Tuple[np.ndarray, float]:
        """N same-shape pairs in one program: one upload, one replay, one
        fetch.  Returns ``(flows (N, H, W), seconds)``."""
        if len(images1) != len(images2) or not len(images1):
            raise ValueError(f"run_batch takes two equal, non-empty lists; "
                             f"got {len(images1)} and {len(images2)}")
        shape = np.asarray(images1[0]).shape
        if any(np.asarray(im).shape != shape
               for im in (*images1, *images2)):
            raise ValueError("run_batch requires same-shape pairs; pad "
                             "upstream or use per-image calls for mixed "
                             "shapes")
        t0 = time.perf_counter()
        padder = InputPadder((1, 3) + shape[:2], divis_by=self.divis_by)
        l, r, t, b = padder.pads
        spec = ((0, 0), (t, b), (l, r), (0, 0))
        p1 = np.pad(np.stack(images1), spec, mode="edge")
        p2 = np.pad(np.stack(images2), spec, mode="edge")
        flows = padder.unpad(self._run(p1, p2))
        return np.ascontiguousarray(flows), time.perf_counter() - t0

    def disparity(self, image1: np.ndarray, image2: np.ndarray) -> np.ndarray:
        """Positive disparity map (-flow)."""
        flow, _ = self(image1, image2)
        return -flow
