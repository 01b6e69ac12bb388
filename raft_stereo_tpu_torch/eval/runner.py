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

Under early exit (``exit_threshold_px > 0``) the loop's depth depends on
the data, and a CUDA graph has a fixed launch sequence.  The program is
then ``ExitStages`` (prologue, one iteration, epilogue), and on the card
``WhileForward`` captures its three parts after a warm-up of the eager
loop over them and joins them into one graph whose loop is a CUDA WHILE
node with its predicate on the card (``kernels/graph_loop.py``).  It
gives the eager loop's result and trip count bit for bit.

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

``cost_registry`` (a ``telemetry.CompileRegistry``) records one entry per
program built for the (padded shape, batch) cache, under the JAX runner's
key ``eval.forward(<H>x<W>,b<N>)``: on the card the capture (its
wall time, the allocator's peak around it), on the CPU the first call
(degraded: no allocator reading), each with the forward's FLOPs
(telemetry/flops.py, at the depth cap under early exit); the cache's
evictions and size feed its instruments.  Every capture runs under
``profiling.graph_capture``, so no profiler window is open during one.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from raft_stereo_tpu_torch import profiling
from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.kernels.graph_loop import (WhileGraph,
                                                      exit_predicate)
from raft_stereo_tpu_torch.models.raft_stereo import ExitLoop, RAFTStereo
from raft_stereo_tpu_torch.ops.padding import InputPadder
from raft_stereo_tpu_torch.quant.core import is_quantized, quantize_state_dict
from raft_stereo_tpu_torch.telemetry.flops import forward_flops

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
    return {"exit": exit_predicate.launches,
            "lookup": lookup_pyramid_fused.launches,
            "lookup_q": lookup_pyramid_fused_q.launches,
            "alt": alt_lookup_fused.launches,
            "alt_q": alt_lookup_fused_q.launches,
            "gates": gru_gates_fused.launches,
            "gemm": int8_conv_int32.launches}


FETCH_DTYPES = {None: None, "fp16": torch.float16, "bf16": torch.bfloat16}

def early_exit_enabled(config: RaftStereoConfig) -> bool:
    """Whether ``make_forward`` programs of this config return the extra
    ``iters_used`` (the convergence-gated loop)."""
    return config.exit_threshold_px > 0


def _split_extra(extra, warm_start: bool, hidden_init: bool,
                 ctx: Optional[str]):
    """``(flow_init, hidden, ctx_init)`` from a streaming program's inputs
    after the images, in the JAX order ``[flow_init][, hidden][, ctx]``."""
    extra = list(extra)
    flow_init = extra.pop(0).float() if warm_start else None
    hidden = extra.pop(0) if hidden_init else None
    ctx_init = extra.pop(0) if ctx == "reuse" else None
    return flow_init, hidden, ctx_init


def make_forward(model: RAFTStereo, iters: int,
                 fetch_dtype: Optional[torch.dtype] = None,
                 warm_start: bool = False, return_state: bool = False,
                 ctx: Optional[str] = None, hidden_init: bool = False,
                 return_hidden: bool = False,
                 return_confidence: bool = False):
    """The inference program the runner caches, as the JAX package's
    ``make_forward``: ``forward(images1, images2, *extra)`` takes (N, Hp,
    Wp, 3) uint8 (or float) images on the model's device and runs the
    test-mode forward; the flow is cast to ``fetch_dtype`` on the device
    when one is given.  The model casts the images to fp32 itself.

    The base program returns the (N, Hp, Wp) x-flow alone, or ``(flow_up,
    iters_used)`` under early exit (``early_exit_enabled``; ``iters_used``
    a 0-d int32 tensor; the program is then an ``ExitStages``), and with
    ``return_confidence`` ``(flow_up[, iters_used], (conf_low,
    conf_up))``.  The streaming variants (any of
    ``warm_start``, ``return_state``, ``ctx`` "save"/"reuse",
    ``hidden_init``, ``return_hidden``) return ``(flow_up, flow_low[,
    iters_used][, confidence][, hidden][, ctx])``, ``flow_low`` the padded
    (N, Hp/f, Wp/f) fp32 x-flow whatever the fetch dtype (the next frame's
    ``flow_init``), and take ``[flow_init][, hidden][, ctx]`` after the
    images: ``warm_start`` seeds the loop from ``flow_init``,
    ``hidden_init`` resumes the GRU from a hidden tree (per level, NCHW),
    ``ctx="reuse"`` skips the context encoder for a ``ctx="save"`` bundle.
    """
    if ctx not in (None, "save", "reuse"):
        raise ValueError(f"ctx={ctx!r}: use None, 'save', or 'reuse'")
    stream = (warm_start or return_state or ctx is not None or hidden_init
              or return_hidden)
    if early_exit_enabled(model.config):
        return ExitStages(model, iters, fetch_dtype, (warm_start,
                          hidden_init, ctx), stream, return_hidden,
                          return_confidence)

    def forward(images1: torch.Tensor, images2: torch.Tensor, *extra):
        flow_init, hidden, ctx_init = _split_extra(extra, warm_start,
                                                   hidden_init, ctx)
        kwargs = {}
        if stream:
            kwargs = dict(flow_init=flow_init, hidden_init=hidden,
                          ctx_init=ctx_init, return_ctx=ctx == "save",
                          return_hidden=return_hidden)
        if return_confidence:
            kwargs["return_confidence"] = True
        out = model(images1, images2, iters=iters, test_mode=True,
                    **kwargs)
        return _outputs(out, fetch_dtype, stream)

    return forward


def _outputs(out, fetch_dtype, stream: bool):
    """The model's test-mode tuple -> the program's outputs."""
    flow_up = out[1] if fetch_dtype is None else out[1].to(fetch_dtype)
    if stream:
        return (flow_up, out[0].float()) + tuple(out[2:])
    return flow_up if len(out) == 2 else (flow_up,) + tuple(out[2:])


class ExitStages:
    """The early-exit program ``make_forward`` builds, in the three parts
    ``WhileForward`` captures: ``prologue`` (everything before the loop,
    then ``ExitLoop.start``), ``loop.body`` (one iteration written back
    into the carry, with its delta) and ``epilogue``
    (``ExitLoop.finish`` and the outputs).  They are the model's own eager
    loop (``models/raft_stereo.ExitLoop``), so a graph of them gives its
    result bit for bit.  Calling it runs the loop eagerly: the program on
    the CPU, and the warm-up before a capture.  ``flags`` are
    ``(warm_start, hidden_init, ctx)``, the inputs after the images."""

    def __init__(self, model: RAFTStereo, iters: int,
                 fetch_dtype: Optional[torch.dtype], flags: Tuple,
                 stream: bool, return_hidden: bool,
                 return_confidence: bool):
        self.model = model
        self.loop = ExitLoop(model, iters, return_confidence)
        self.fetch_dtype = fetch_dtype
        self.flags = flags
        self.stream = stream
        self.return_hidden = return_hidden
        self.return_ctx = flags[2] == "save"

    def prologue(self, images1: torch.Tensor, images2: torch.Tensor,
                 *extra) -> Dict:
        flow_init, hidden, ctx_init = _split_extra(extra, *self.flags)
        step, net, disp, ctx_out = self.model.begin(
            images1, images2, flow_init, hidden, ctx_init, self.return_ctx)
        carry = self.loop.start(step, net, disp)
        carry["ctx"] = ctx_out
        return carry

    def epilogue(self, carry: Dict):
        out = self.loop.finish(carry)
        if self.return_hidden:
            out += (tuple(carry["net"]),)
        if self.return_ctx:
            out += (carry["ctx"],)
        return _outputs(out, self.fetch_dtype, self.stream)

    def __call__(self, *inputs):
        carry = self.prologue(*inputs)
        self.loop.iterate(carry)
        return self.epilogue(carry)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor -> a new array; half-precision flows become fp32."""
    if t.dtype in (torch.float16, torch.bfloat16):
        t = t.float()
    return t.numpy().copy()


class PlainForward:
    """The CPU entry of the runner's cache: the closure itself.  Takes the
    program's inputs as flat numpy arrays (``spec`` their structure, as
    ``tree_flatten`` gives it) and returns its outputs likewise."""

    def __init__(self, forward, spec):
        self.forward = forward
        self.spec = spec

    def __call__(self, *arrays: np.ndarray) -> List[np.ndarray]:
        with torch.inference_mode():
            args = tree_unflatten([torch.from_numpy(a) for a in arrays],
                                  self.spec)
            flat, _ = tree_flatten(self.forward(*args))
        return [_to_numpy(t) for t in flat]


class _Graphed:
    """What the card's entries share: static device inputs with pinned host
    staging, the captured outputs with pinned host copies, the launch
    counts of the capture, and its seconds.  ``capture(*arrays)`` runs once
    and returns the first result; ``__call__(*arrays)`` replays."""

    def __init__(self, arrays: Sequence[np.ndarray], spec,
                 device: torch.device, stream: torch.cuda.Stream, pool):
        self.stream = stream
        self.pool = pool
        self.specs = [(a.shape, a.dtype) for a in arrays]
        self.inputs = [torch.empty(a.shape, device=device,
                                   dtype=torch.from_numpy(a[:0]).dtype)
                       for a in arrays]
        self.args = tree_unflatten(self.inputs, spec)
        self.host_in = [torch.empty_like(t, device="cpu", pin_memory=True)
                        for t in self.inputs]
        self.outputs: Optional[List[torch.Tensor]] = None
        self.host_out: List[torch.Tensor] = []
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0

    def _upload(self, arrays: Sequence[np.ndarray]) -> None:
        specs = [(a.shape, a.dtype) for a in arrays]
        if specs != self.specs:
            raise ValueError(f"inputs {specs} into a graph captured for "
                             f"{self.specs}")
        for a, host, dev in zip(arrays, self.host_in, self.inputs):
            host.numpy()[...] = a
            dev.copy_(host, non_blocking=True)

    def _set_outputs(self, out) -> None:
        self.outputs, _ = tree_flatten(out)
        # normal (not inference) tensors: they are written on every call
        with torch.inference_mode(False):
            self.host_out = [torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                             for t in self.outputs]

    def _fetch(self) -> List[np.ndarray]:
        for host, dev in zip(self.host_out, self.outputs):
            host.copy_(dev, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return [_to_numpy(t) for t in self.host_out]

    def _graph(self, fn, *args, keep: bool = False):
        """Capture ``fn(*args)`` on the runner's stream into its pool."""
        g = torch.cuda.CUDAGraph(keep_graph=True) if keep \
            else torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
            out = fn(*args)
        return g, out

    def capture(self, *arrays: np.ndarray) -> List[np.ndarray]:
        t0 = time.perf_counter()
        self._upload(arrays)
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.inference_mode():
            with torch.cuda.stream(self.stream):
                self._warm_up()
            with profiling.graph_capture():
                self.launches = self._capture()
        self.capture_s = time.perf_counter() - t0
        torch.cuda.current_stream().wait_stream(self.stream)
        return self(*arrays, uploaded=True)

    def __call__(self, *arrays: np.ndarray,
                 uploaded: bool = False) -> List[np.ndarray]:
        if not uploaded:
            self._upload(arrays)
        self._replay()
        return self._fetch()

    def timed_call(self, *arrays: np.ndarray
                   ) -> Tuple[List[np.ndarray], float]:
        """A replay that also says when the card finished it: upload,
        replay, synchronize, fetch.  Returns ``(outputs, t_ready)``, the
        ``time.monotonic()`` of the synchronization before the fetch."""
        self._upload(arrays)
        self._replay()
        torch.cuda.current_stream().synchronize()
        t_ready = time.monotonic()
        return self._fetch(), t_ready


class GraphForward(_Graphed):
    """One captured CUDA graph of ``forward`` at one set of input shapes:
    the fixed-depth program (and any program without a data-dependent
    loop).  ``launches`` holds one forward's wrapper launch counts."""

    def __init__(self, forward, *args):
        super().__init__(*args)
        self.forward = forward
        self.graph = None

    def _warm_up(self) -> None:
        self.forward(*self.args)

    def _capture(self) -> Dict[str, int]:
        before = launch_counts()
        self.graph, out = self._graph(self.forward, *self.args)
        after = launch_counts()
        self._set_outputs(out)
        return {k: after[k] - before[k] for k in after}

    def _replay(self) -> None:
        self.graph.replay()


class WhileForward(_Graphed):
    """An early-exit entry: one graph per pair, prologue -> WHILE(iteration)
    -> epilogue (``kernels/graph_loop.WhileGraph``), captured from
    ``stages`` (``ExitStages``) after a warm-up of the eager loop over
    them.  The iteration ends in ``exit_predicate``, which counts it and
    sets the loop's condition on the card, so a replay is one graph
    launch and no host synchronisation until the fetch.  ``launches``
    holds the prologue's and epilogue's counts, ``body_launches`` one
    iteration's; a pair launches ``launches + iters_used *
    body_launches``."""

    def __init__(self, stages: ExitStages, *args):
        super().__init__(*args)
        self.stages = stages
        self.body_launches: Dict[str, int] = {}

    def _warm_up(self) -> None:
        self.stages(*self.args)

    def _capture(self) -> Dict[str, int]:
        self.graph_loop = WhileGraph()
        stages, loop = self.stages, self.stages.loop

        def body(carry):
            loop.body(carry)
            exit_predicate(self.graph_loop.handle, carry["it"],
                           carry["delta"], loop.min_iters, loop.limit,
                           loop.threshold)

        def counted(fn, *args):
            before = launch_counts()
            g, out = self._graph(fn, *args, keep=True)
            after = launch_counts()
            return g, out, {k: after[k] - before[k] for k in after}

        gp, carry, lp = counted(stages.prologue, *self.args)
        gb, _, self.body_launches = counted(body, carry)
        ge, out, le = counted(stages.epilogue, carry)
        self.carry = carry
        self._set_outputs(out)
        self.graph_loop.build(gp, gb, ge)
        return {k: lp[k] + le[k] for k in lp}

    def pair_launches(self, iters_used: int) -> Dict[str, int]:
        return {k: self.launches[k] + iters_used * self.body_launches[k]
                for k in self.launches}

    def _replay(self) -> None:
        self.graph_loop.launch(torch.cuda.current_stream())


class ProgramCache:
    """The programs one owner keeps on one device: LRU caches of at most
    ``limit`` entries each (``lru()`` opens one), whose graphs share one
    side stream and one memory pool.  ``add`` evicts the cache's oldest
    entries past the limit (``on_evict(cache, key)`` after each), then
    wraps ``forward``: a ``WhileForward`` (early exit) or ``GraphForward``
    on the card, a ``PlainForward`` on the CPU.  A pool whose graphs are
    all gone cannot be shared again, so a build into empty caches takes a
    new one."""

    def __init__(self, device: torch.device, limit: int, on_evict=None):
        self.device = device
        self.limit = limit
        self.on_evict = on_evict
        self.caches: List[Dict[Tuple, object]] = []
        self.stream: Optional[torch.cuda.Stream] = None
        self.pool = None

    def lru(self) -> Dict[Tuple, object]:
        cache: Dict[Tuple, object] = {}
        self.caches.append(cache)
        return cache

    @staticmethod
    def get(cache: Dict[Tuple, object], key: Tuple):
        """The entry at ``key``, refreshed as the newest, or None."""
        if key not in cache:
            return None
        cache[key] = cache.pop(key)
        return cache[key]

    def add(self, cache: Dict[Tuple, object], key: Tuple, forward, arrays,
            spec, early_exit: bool):
        while len(cache) >= self.limit:
            evicted = next(iter(cache))
            del cache[evicted]
            log.info("graph cache full (max_cached_shapes=%d): evicting "
                     "%s; its next use captures again", self.limit, evicted)
            if self.on_evict is not None:
                self.on_evict(cache, evicted)
        if self.device.type == "cuda":
            if self.pool is None or not any(self.caches):
                self.stream = self.stream or torch.cuda.Stream(self.device)
                self.pool = torch.cuda.graph_pool_handle()
            entry = (WhileForward if early_exit else GraphForward)(
                forward, arrays, spec, self.device, self.stream, self.pool)
        else:
            entry = PlainForward(forward, spec)
        cache[key] = entry
        return entry


@dataclasses.dataclass
class StreamFrame:
    """One frame of a warm-started sequence (``InferenceRunner.run_stream``).

    ``flow`` is the unpadded (H, W) x-flow; ``flow_low`` the PADDED
    low-resolution x-flow to feed back as the next frame's
    ``prev_flow_low`` (consecutive frames share the padded grid, so the
    state round-trips without resampling)."""

    flow: np.ndarray             # (H, W) float32 x-flow (= -disparity)
    flow_low: np.ndarray         # (Hp/f, Wp/f) float32 padded low-res state
    seconds: float               # same clock as __call__ (to the fetch)
    iters_used: Optional[int]    # GRU trip count (None without early exit)
    warm: bool                   # True when prev_flow_low seeded the GRU
    # final per-level GRU hidden states, (C_l, h_l, w_l) host arrays (the
    # port's NCHW layout, batch axis stripped): the next frame's
    # ``prev_hidden``; None unless asked for (``carry_hidden``)
    hidden: Optional[Tuple[np.ndarray, ...]] = None

    @property
    def disparity(self) -> np.ndarray:
        return -self.flow


class InferenceRunner:
    """``runner(image1, image2)`` -> ``(flow (H, W), seconds)``.

    Inputs are (H, W, 3) uint8 (or float) numpy images, uploaded in the
    caller's dtype as the JAX runner does; padding to ``divis_by``, the
    test-mode forward and exact unpadding happen inside.  ``shape_bucket``
    (a multiple of ``divis_by``, e.g. 64) pads to a coarser grid, so
    nearby image shapes share one cache entry; ``max_cached_shapes``
    bounds the cache, LRU.  ``fetch_dtype`` ("fp16", "bf16" or None)
    casts the flow on the device before the copy to the host; results are
    fp32 either way.  ``corr_fp32_auto`` (default on) turns ``corr_fp32``
    on for bf16 correlation at ``iters >= DEEP_ITERS_FP32_CORR``
    (``effective_inference_config``); pass False to run raw bf16
    correlation at any depth.  ``quant`` and ``quant_act_scales`` run the
    quantized tier (module docstring).  ``captures`` and ``replays`` count
    the graphs captured and replayed (both stay 0 on the CPU).

    ``exit_threshold_px`` / ``exit_min_iters`` (None: the config's own)
    turn on the early exit: ``iters`` becomes the depth cap and each call
    records its trip count (``last_iters_used``, ``iters_used_mean``,
    ``reset_iters_used``).  On the card the loop runs in one graph whose
    loop is a CUDA WHILE node (``WhileForward``), with the eager loop's
    result bit for bit.  ``run_stream`` chains the frames of
    a sequence (warm start, optionally the GRU's hidden state) over its
    own LRU of stream programs.  Threshold 0 keeps the fixed-depth
    program as it was.
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
                 exit_threshold_px: Optional[float] = None,
                 exit_min_iters: Optional[int] = None,
                 quant: Optional[str] = None,
                 quant_act_scales: Optional[Mapping[str, float]] = None,
                 cost_registry=None):
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
        if (exit_threshold_px is not None or exit_min_iters is not None
                or quant is not None):
            config = dataclasses.replace(
                config,
                exit_threshold_px=(config.exit_threshold_px
                                   if exit_threshold_px is None
                                   else exit_threshold_px),
                exit_min_iters=(config.exit_min_iters
                                if exit_min_iters is None
                                else exit_min_iters),
                quant=config.quant if quant is None else quant)
        self.effective_config = effective_inference_config(
            config, iters, corr_fp32_auto)
        self.early_exit = early_exit_enabled(self.effective_config)
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
        # one program per (padded shape, batch); the streaming programs
        # (state in and out) in their own LRU, as in the JAX runner
        self._programs = ProgramCache(self.device, max_cached_shapes,
                                      on_evict=self._evicted)
        self._compiled = self._programs.lru()
        self._stream_compiled = self._programs.lru()
        self.captures = 0
        self.replays = 0
        self.cost_registry = cost_registry
        self.last_iters_used: Optional[int] = None
        self._iters_used_sum = 0
        self._iters_used_calls = 0

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
        self._stream_compiled.clear()

    def _exit_key(self) -> Tuple:
        """The early-exit knobs a program was built for (empty at fixed
        depth, so those keys stay the JAX runner's)."""
        if not self.early_exit:
            return ()
        c = self.effective_config
        return ((c.exit_threshold_px, c.exit_min_iters, c.exit_max_iters),)

    def _entry(self, cache: Dict, key: Tuple, args, **flags):
        """``(entry, flat inputs)``: the LRU entry of ``cache`` at ``key``,
        built on a miss from the ``make_forward`` program of ``flags``,
        and the program's inputs ``args`` (a tuple of arrays and tuples of
        arrays) flattened."""
        arrays, spec = tree_flatten(tuple(args))
        entry = self._programs.get(cache, key)
        if entry is not None:
            return entry, arrays
        forward = make_forward(self.model, self.iters, self.fetch_dtype,
                               **flags)
        entry = self._programs.add(cache, key, forward, arrays, spec,
                                   self.early_exit)
        if cache is self._compiled and self.cost_registry is not None:
            entry.cost_key = self._cost_key(*key[:2])
            self.cost_registry.note_runner_cache_size(len(cache))
        return entry, arrays

    def _evicted(self, cache: Dict, key: Tuple) -> None:
        if cache is self._compiled and self.cost_registry is not None:
            self.cost_registry.note_runner_eviction(self._cost_key(*key[:2]),
                                                    len(cache))

    def _cost_key(self, padded_hw: Tuple[int, int], batch: int) -> str:
        """The cost registry's label of one (padded shape, batch) program,
        the JAX runner's."""
        return f"eval.forward({padded_hw[0]}x{padded_hw[1]},b{batch})"

    def compiled_cost(self, padded_hw: Tuple[int, int], batch: int = 1):
        """The cost record of a built (padded shape, batch) program, or
        None (no registry, or not built yet)."""
        if self.cost_registry is None:
            return None
        return self.cost_registry.get(self._cost_key(padded_hw, batch))

    def _forward_for(self, padded_hw: Tuple[int, int], batch: int = 1,
                     args=()):
        """The cache entry for one (padded shape, batch), LRU, and its
        flat inputs: distinct raw shapes that pad to one grid share it
        (KITTI's 375x1242, 370x1224 and 376x1241 all pad to 384x1248)."""
        key = (tuple(padded_hw), batch) + self._exit_key()
        return self._entry(self._compiled, key, args)

    def _run(self, entry, arrays) -> List[np.ndarray]:
        """One call of a cache entry: capture on its first call (recorded
        as its build where the entry carries a cost key)."""
        call = entry
        if isinstance(entry, _Graphed):
            self.replays += 1
            if entry.outputs is None:
                self.captures += 1
                call = entry.capture
        key = getattr(entry, "cost_key", None)
        if key is None:
            return call(*arrays)
        del entry.cost_key
        batch, hw = arrays[0].shape[0], arrays[0].shape[1:3]
        iters = (self.model.exit_bounds(self.iters)[0] if self.early_exit
                 else self.iters)
        return self.cost_registry.measure(
            call, *arrays, key=key, site="eval",
            flops=forward_flops(self.effective_config, hw, batch, iters),
            device=self.device)

    # ---------------------------------------------- iters-used accounting
    def _note_iters_used(self, iters_used) -> int:
        used = int(iters_used)
        self.last_iters_used = used
        self._iters_used_sum += used
        self._iters_used_calls += 1
        return used

    def iters_used_mean(self) -> Optional[float]:
        """Mean GRU trip count over the calls since the last reset; None
        without early exit (the fixed path always runs ``iters``)."""
        if not self._iters_used_calls:
            return None
        return self._iters_used_sum / self._iters_used_calls

    def reset_iters_used(self) -> None:
        self.last_iters_used = None
        self._iters_used_sum = 0
        self._iters_used_calls = 0

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

    def _pad(self, images1, images2):
        shape = np.asarray(images1[0]).shape
        padder = InputPadder((1, 3) + shape[:2], divis_by=self.divis_by)
        l, r, t, b = padder.pads
        spec = ((0, 0), (t, b), (l, r), (0, 0))
        return (padder, np.pad(np.stack(images1), spec, mode="edge"),
                np.pad(np.stack(images2), spec, mode="edge"))

    def run_batch(self, images1, images2) -> Tuple[np.ndarray, float]:
        """N same-shape pairs in one program: one upload, one replay, one
        fetch.  Returns ``(flows (N, H, W), seconds)``; under early exit
        the batch runs to its worst member's depth."""
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
        padder, p1, p2 = self._pad(images1, images2)
        entry, arrays = self._forward_for(p1.shape[1:3], p1.shape[0],
                                          (p1, p2))
        out = self._run(entry, arrays)
        if self.early_exit:
            self._note_iters_used(out[1])
        flows = padder.unpad(out[0])
        return np.ascontiguousarray(flows), time.perf_counter() - t0

    # ------------------------------------------------------------ streaming
    def run_stream(self, image1: np.ndarray, image2: np.ndarray,
                   prev_flow_low: Optional[np.ndarray] = None,
                   prev_hidden: Optional[Sequence[np.ndarray]] = None,
                   carry_hidden: bool = False) -> StreamFrame:
        """One frame of a temporally ordered sequence: like ``__call__``,
        but the GRU warm-starts from ``prev_flow_low`` (the previous
        frame's ``StreamFrame.flow_low``) and the frame carries the state
        forward.  ``prev_flow_low=None`` (frame 0, or after a scene cut)
        runs the cold zero init.  A ``prev_flow_low`` whose shape is not
        this frame's padded low-resolution grid raises (the stream changed
        resolution).  ``carry_hidden`` returns the final GRU hidden states
        (``StreamFrame.hidden``); passing them back as ``prev_hidden``,
        with ``prev_flow_low``, resumes the GRU's own trajectory."""
        if image1.ndim != 3 or image1.shape != image2.shape:
            raise ValueError(f"expected two (H, W, 3) images of one shape, "
                             f"got {image1.shape} and {image2.shape}")
        t0 = time.perf_counter()
        padder, p1, p2 = self._pad([image1], [image2])
        f = self.effective_config.downsample_factor
        low_hw = (p1.shape[1] // f, p1.shape[2] // f)
        warm = prev_flow_low is not None
        if prev_hidden is not None and not warm:
            raise ValueError("prev_hidden needs prev_flow_low: the hidden "
                             "state is meaningless without the disparity "
                             "it evolved against")
        if warm and tuple(prev_flow_low.shape) != low_hw:
            raise ValueError(
                f"prev_flow_low shape {prev_flow_low.shape} does not match "
                f"this frame's padded low-res grid {low_hw} — the stream "
                f"changed resolution; restart with prev_flow_low=None")
        hidden_in = prev_hidden is not None
        hidden_out = carry_hidden or hidden_in
        args = [p1, p2]
        if warm:
            args.append(np.ascontiguousarray(prev_flow_low,
                                             dtype=np.float32)[None])
        if hidden_in:
            args.append(tuple(np.ascontiguousarray(h)[None]
                              for h in prev_hidden))
        key = ((tuple(p1.shape[1:3]), warm, hidden_in, hidden_out)
               + self._exit_key())
        entry, arrays = self._entry(
            self._stream_compiled, key, args, warm_start=warm,
            return_state=True, hidden_init=hidden_in,
            return_hidden=hidden_out)
        out = self._run(entry, arrays)
        pos = 2
        iters_used = None
        if self.early_exit:
            iters_used = self._note_iters_used(out[2])
            pos = 3
        hidden = (tuple(h[0] for h in out[pos:])
                  if hidden_out else None)
        flow = padder.unpad(out[0])[0]
        return StreamFrame(flow=np.ascontiguousarray(flow),
                           flow_low=np.ascontiguousarray(out[1][0],
                                                         dtype=np.float32),
                           seconds=time.perf_counter() - t0,
                           iters_used=iters_used, warm=warm, hidden=hidden)

    def disparity(self, image1: np.ndarray, image2: np.ndarray) -> np.ndarray:
        """Positive disparity map (-flow)."""
        flow, _ = self(image1, image2)
        return -flow
