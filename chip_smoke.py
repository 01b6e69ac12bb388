#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (raft_stereo_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero without them,
and imports nothing of JAX or of the JAX package.  Phases, each of which
fails the run when it fails:

1. print the card (name, power limit) and versions; build every CUDA
   kernel from csrc/, one nvcc per source, all started together; print
   each gate-kernel instantiation's registers, spills and shared memory,
   and read the gate library's SASS (``cuobjdump -sass``): every gate
   kernel must contain tensor-core instructions (HGMMA);
2. the pyramid-lookup kernel against its plain version at the main-path
   shapes (96 rows, W1 312, W2 312/156/78/39, radius 4), all four levels
   in one call and each level alone at scale 1/2^i;
3. the ConvGRU gate kernel in fp32 (3xTF32) against its plain version at
   every fp32 gate GEMM of the driven paths (gru08, gru16 and gru32 of a
   384x1248 input, and one training gru08 call at batch 8) and at the odd
   and narrow shapes of the card tests; at the GEMM rows also against an
   fp64 convolution: the kernel's error may be at most 4x the plain fp32
   version's, plus 1e-6 (a single TF32 pass lands ~100x above);
4. timings of both kernels at those shapes: the kernel, its plain
   version, one PyTorch library yardstick the port never calls, and the
   bound from bytes or operations (the gates: 3xTF32 on the tensor cores,
   the CUDA-core figure beside it); every row from CUDA-graph replays (the
   kernels' device time; the replay floor of a one-element kernel is
   printed; the short lookups also as 20 calls per replay with the
   flushes subtracted) and, kernel and library, from single calls, with
   the share of the bound and the factor against the library call (the
   gates also TFLOP/s and each launch's tile and blocks per SM); whether
   the fp32 lookup is slower than ``F.grid_sample`` by graph replay; the
   lookup wrapper's host microseconds per call, with its C entry bound
   once and rebound on every call;
5. the main path: ``InferenceRunner`` on the default config at full
   width with seeded random weights, on a 375x1242 pair (padded to
   384x1248) at 32 iterations; checks the output and that the lookup ran
   32 times and the gate kernel 96 times; prints seconds per pair;
6. the same seeded model on the card and on the CPU (plain versions) at
   128x256 and 2 iterations, compared against a stated tolerance;
7. the kernels of the realtime preset against their plain versions at its
   shapes: the alt correlation in bf16 and fp32 (48 rows, W1 156, levels
   156/78/39/19, D 256; all levels in one call and each level alone at
   scale 1/2^l), the bf16 gates at gru08 (1,48,156, Cin 384) and gru16
   (1,24,78, Cin 256), at the training gru08 calls (8,80,180 and the
   realtime step's 8,40,90) and at the card tests' odd shapes, and the
   bf16 pyramid lookup at the shapes of phase 2;
8. timings of those kernels as in phase 4; the alt rows also on a
   coherent center field (``coherent_centers``: a smooth disparity field
   in [0, 24] px at 1/8 resolution, what the model's lookups see) beside
   the random centers, each field by one-call graph replay and as 20
   calls per replay with the flushes subtracted (every alt bound lies
   below the replay floor), with ``plan_fwd``'s tile, channel chunk and
   band rows; and the bf16 alt kernel at the realtime training step's
   shape (8x40 rows, W1 90, W2 90/45/22/11, D 256) on both fields;
9. the realtime path: ``InferenceRunner`` on ``RaftStereoConfig.realtime()``
   with seeded random weights on the 375x1242 pair at 7 iterations (7 alt
   launches, 21 bf16 gate calls, no pyramid lookup; seconds per pair and
   peak memory), then at 16 iterations, where the runner turns
   ``corr_fp32`` on (16 alt launches in fp32);
10. the realtime preset on the card and on the CPU at 128x256 and 2
   iterations, held to 3x the card's own spread between bf16 and fp32
   correlation on the same input;
11. the backward kernels against their plain versions at the training
   shapes: the lookup backward in fp32 (640 rows, W1 180, levels
   180/90/45/22, and each level alone at 1/2^l), the alt backward in bf16
   and fp32 (320 rows, W1 90, levels 90/45/22/11, D 256, and an odd
   shape), and the gate Function's gradients against autograd through
   its plain twin at gru08 (8, 80, 180, Cin 384); two launches of the
   lookup backward bitwise equal;
12. timings of the backward kernels as in phase 4, the yardstick being
   the autograd backward of the ``F.grid_sample`` formulations (captured
   on the stream of their forwards), the alt backward's plan (channel
   chunk, pixel tile, tensor or CUDA cores), and beside the lookup
   backward a ``torch.zeros`` of its dV bytes, the write floor;
13. the default training step: ``train()`` with ``RaftStereoConfig()``
   fp32 and ``TrainConfig()`` (batch 8, 320x720, 22 iterations) on a
   seeded synthetic loader, one warm-up step and 3 timed steps; checks
   22 lookups, 22 lookup backwards and 132 gate calls per step (66
   forward, 66 in the remat recompute), finite loss and grad_norm, and
   that the parameters moved; prints seconds per step and peak memory;
14. the realtime training step the same way: 22 alt lookups, 22 alt
   backwards and 132 gate calls per step, all bf16, and no pyramid
   lookup;
15. one step on the card and on the CPU at 64x128 and 2 iterations, of
   the default config and of the realtime architecture in fp32 (which
   drives the fp32 alt backward): loss and grad_norm within stated
   tolerances, every gradient leaf within 3x the card's own spread on
   the same step (cuDNN vs native convolutions, the gate kernel vs plain
   gate convolutions, the weights moved by one fp32 ulp);
16. the quantized tier's kernels against their plain versions: the
   lookup over int8 and fp8 levels at phase 2's shapes (all levels and
   each alone), kernel #9 over int8 and fp8 features at phase 7's shapes
   (all levels, each alone, and an odd shape), each scaled output against
   the dequantize-then-sample reference, with the scale vector left out as
   a check that must fail; the int8 GEMM conv (the realtime cnet's 7x7/2
   conv1, conv2_out's 3x3 128->256) bit-equal to the exact CPU conv;
17. timings of the two 1-byte kernels as in phase 4, #9 also on the
   coherent field and as 20 calls per replay, as in phase 8;
18. the realtime ``int8_mxu`` path: ``InferenceRunner(..., quant=
   "int8_mxu")`` on the 375x1242 pair at 7 iterations (7 int8 #9
   launches, 21 bf16 gate calls, no pyramid lookup, one int8 GEMM per
   encoder conv; seconds per pair and the call's own peak memory, beside
   the unquantized bf16 path measured the same way), again with
   ``quant_act_scales`` from ``calibrate()`` on the pair, and with
   ``quant_corr_fp8`` (7 fp8 #9 launches);
19. the default ``int8`` path at 32 iterations (32 int8 #1 launches, 96
   gate calls; beside the unquantized fp32 path), again with ``quant_corr_scales`` from ``calibrate()``,
   and with ``quant_corr_fp8`` (32 fp8 #1 launches);
20. card vs CPU at 128x256 and 2 iterations for the four variants
   (realtime int8_mxu and default int8, int8 and fp8 correlation), held
   to 3x the card's own spread with every weight moved by one fp32 ulp,
   with the share of correlation codes that flipped.

The line before the last is a JSON object ``{"kernels": [...]}`` (times
by graph replay; a redesigned row names its design under ``design``); the
last is ``{"ok": true, "device": {...}}``.  The fp32 path is full fp32:
TF32 is switched off for matmuls and cuDNN convs.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
RADIUS = 4
LEVELS = 4
ROWS, W1 = 96, 312                      # 1/4 of the 384x1248 padded pair
CH = 128
# The gate GEMMs of the driven paths, (name, B, H, W, Ch, Cx, calls per
# iteration of the timed path): the default path's three levels at 1/4,
# 1/8, 1/16 of 384x1248 and one training gru08 call (TrainConfig: batch
# 8, 320x720 at 1/4); the realtime preset's levels (gru16 twice per
# iteration) and training gru08 calls in bf16.
GATE_ROWS_FP32 = (("default gru08", 1, 96, 312, CH, 256, 1),
                  ("default gru16", 1, 48, 156, CH, 256, 1),
                  ("default gru32", 1, 24, 78, CH, 128, 1),
                  ("training gru08", 8, 80, 180, CH, 256, 0))
GATE_ROWS_BF16 = (("realtime gru08", 1, 48, 156, CH, 256, 1),
                  ("realtime gru16", 1, 24, 78, CH, 128, 2),
                  ("training gru08", 8, 80, 180, CH, 256, 0),
                  ("realtime training gru08", 8, 40, 90, CH, 256, 0))
# The odd and narrow gate shapes of tests/test_torch_cuda.py, (name, B, H,
# W, Ch, Cx), the TINY configs' hidden_dims=(32, 32, 32) among them.
GATE_ODD = (("odd", 2, 17, 35, 32, 160), ("odd", 2, 9, 20, 128, 256),
            ("odd", 2, 24, 78, 128, 128), ("odd", 2, 17, 35, 128, 256),
            ("TINY gru08", 2, 16, 32, 32, 160),
            ("TINY gru16", 2, 8, 16, 32, 64), ("TINY gru32", 2, 4, 8, 32, 32))
LOOKUP_ATOL = 1e-5
GATES_ATOL = 1e-4       # sums over up to 9*384 = 3456 fp32 products
# fp32 gates against an fp64 convolution: the kernel's error at most
# GATES_FP64_FACTOR x the plain fp32 version's + GATES_FP64_ATOL (room for
# the tensor cores' own accumulation order).
GATES_FP64_FACTOR, GATES_FP64_ATOL = 4.0, 1e-6
CARD_VS_CPU_ATOL = 1e-2  # two iterations of random weights; see phase 6
MAIN_HW = (375, 1242)
PADDED_HW = (384, 1248)
MAIN_ITERS = 32
# Realtime preset: 1/8 of the 384x1248 padded pair, fnet_dim 256.
RT_ROWS, RT_W1, RT_D = 48, 156, 256
RT_ITERS = 7
RT_DEEP_ITERS = 16      # the runner's corr_fp32 threshold
COHERENT_MAX_DISP = 24.0  # px at 1/8 resolution (phases 8 and 17)
ALT_ATOL = 1e-5         # fp32: dots of 256 products in another order
BF16_ULPS = 1           # bf16 alt and lookup: one ulp + BF16_ATOL
BF16_GATES_ULPS = 2     # bf16 gates: two ulps + BF16_GATES_ATOL (r*h)
BF16_ATOL = 1e-5
BF16_GATES_ATOL = 1e-3  # a flip of r*h moves qpre by a weight x its ulp
RT_SPREAD_FACTOR = 3.0  # phase 10
# Training (phases 11-15): TrainConfig()'s batch and crop; feature maps at
# 1/4 (default) and 1/8 (realtime).
TRAIN_B, TRAIN_HW, TRAIN_ITERS = 8, (320, 720), 22
TIMED_STEPS = 3
LOOKUP_BWD_ATOL = 1e-6   # the same taps and products, at most 2 per bin
ALT_BWD_RTOL = 1e-5      # fp32: of each gradient's scale (sum order)
ALT_BWD_BF16_RTOL = 1e-5  # bf16: one ulp + this share of the scale
GATES_BWD_RTOL = 1e-5    # the Function's VJP is the twin's autograd
# Phase 15, card vs CPU after one step: loss and grad_norm relative, and
# each gradient leaf over max(its scale, 1e-3 of the largest gradient),
# held to STEP_SPREAD_FACTOR x the card's own spread on the same step,
# and never below STEP_LEAF_RTOL (4x the JAX package's own spread in the
# CPU tests).  The spread is the largest of: cuDNN's convolutions vs
# native ones; the gate kernel vs the plain gate convolutions
# (fused_gru="off"); and every weight moved by one fp32 ulp.  The fnet
# gradients pass through instance norm's backward, whose cancellation
# amplifies rounding: card vs CPU measured 3.6e-2 on fnet trunk weights of
# the default step, where the first two spreads, which leave the
# instance-norm reductions as they are, gave 9.0e-3.
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_LEAF_RTOL = 1e-4, 1e-3, 3e-2
STEP_SPREAD_FACTOR = 3.0
# Phases 16-20, the quantized tier.  Kernel vs plain, of the output's
# scale: #1 over 1-byte levels does the plain version's fp32 arithmetic
# (up to FMA contraction); #9 over int8 sums exact integer dots, over fp8
# inexact products in another order.  Card vs CPU: 3x the card's own
# spread when every weight moves by one fp32 ulp (codes flip where the
# card and the CPU round the encoders differently).
LOOKUP_Q_RTOL = 1e-6
ALT_Q_RTOL = {"int8": 1e-6, "fp8": 1e-5}
# The scaled output against the dequantized reference (fp32 products of
# scaled values in another order); leaving the scale vector out moves the
# output by the inverse of the scale, ~1e2-1e3.
SCALED_RTOL = 1e-5
Q_SPREAD_FACTOR = 3.0
# Published peaks of the H100 SXM (NVIDIA data sheet, 700 W): memory
# bytes/s, fp32 FLOP/s on the CUDA cores, and on the tensor cores dense
# TF32 and bf16 FLOP/s and dense int8/fp8 operations/s.
MEM_RATE = 3.35e12
FP32_RATE = 67e12
TF32_RATE = 495e12
BF16_RATE = 989e12
INT8_RATE = 1979e12


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, flush, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each after a
    write of a buffer larger than L2 so that the call finds L2 cold."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def window_bins(coords, w2s) -> int:
    """Distinct bins inside [0, W2_l - 1] that the windows of these
    centers touch, summed over pixels and levels."""
    total = 0
    for i, w2 in enumerate(w2s):
        c = coords.double() / 2 ** i
        lo = torch.floor(c - RADIUS).clamp(0, w2 - 1)
        hi = (torch.floor(c + RADIUS) + 1).clamp(0, w2 - 1)
        inside = (torch.floor(c + RADIUS) + 1 >= 0) & (
            torch.floor(c - RADIUS) <= w2 - 1)
        total += int(torch.where(inside, hi - lo + 1, 0).sum())
    return total


def coherent_centers(gen, b: int, rows: int, w1: int) -> torch.Tensor:
    """(b, rows, w1) centers c = x - d of a seeded smooth disparity field d
    in [0, COHERENT_MAX_DISP] px: a uniform grid with a node every 8
    pixels, upsampled bilinearly (so d stays in range).  At 1/8 resolution
    that is 0-192 px at full resolution, KITTI's range: what the model's
    lookups see, where the random centers of phase 7 are its worst case."""
    coarse = torch.rand((b, 1, rows // 8 + 2, w1 // 8 + 2),
                        generator=gen) * COHERENT_MAX_DISP
    d = F.interpolate(coarse, size=(rows, w1), mode="bilinear",
                      align_corners=True)[:, 0]
    return torch.arange(w1, dtype=torch.float32) - d


def lookup_bytes(coords, w2s, itemsize: int = 4) -> int:
    """Bytes the lookup must move for these centers: each distinct volume
    bin a window touches (read once), the centers, and the output."""
    k = len(w2s) * (2 * RADIUS + 1)
    return (window_bins(coords, w2s) * itemsize + coords.numel() * 4
            + coords.numel() * k * itemsize)


def bf16_ulp_error(got, want, ulps: int, atol: float):
    """(max |got - want|, whether every value is within ``ulps`` bf16
    ulps of ``want`` plus ``atol``)."""
    want = want.float()
    _, exp = torch.frexp(want.abs().clamp_min(torch.finfo(torch.float32).tiny))
    bound = ulps * torch.ldexp(torch.ones_like(want), exp - 8) + atol
    err = (got.float() - want).abs()
    return float(err.max()), bool((err <= bound).all())


def alt_library(f1, pyramid, coords):
    """The reference's PyTorch formulation of the no-volume correlation
    (PytorchAlternateCorrBlock1D): ``F.grid_sample`` of each pooled level
    of the right features at the window positions, then the dot with the
    left features, in fp32 (the reference runs it in fp32).  Each row is
    its own 1-row image, so the vertical coordinate is exact."""
    b, h, w1, d = f1.shape
    rows = b * h
    taps = torch.arange(-RADIUS, RADIUS + 1, device=f1.device,
                        dtype=torch.float32)
    f1t = f1.float().reshape(rows, w1, d).permute(0, 2, 1)[..., None]
    outs = []
    for i, f2 in enumerate(pyramid):
        w2 = f2.shape[2]
        x = coords.reshape(rows, w1, 1) / 2 ** i + taps
        gx = (2 * x / (w2 - 1) - 1).reshape(rows, 1, -1)
        grid = torch.stack([gx, torch.zeros_like(gx)], dim=-1)
        src = f2.float().reshape(rows, w2, d).permute(0, 2, 1)[:, :, None]
        s = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True).reshape(rows, d, w1, -1)
        outs.append((s * f1t).sum(1) / math.sqrt(d))
    return torch.cat(outs, dim=-1).reshape(b, h, w1, -1)


def max_rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def leaf_errs(got, want):
    """Gradient-leaf differences, largest first: (error, name), each over
    max(the leaf's scale, 1e-3 of the largest gradient).  The floor keeps
    conv biases in front of instance norm, whose gradient is rounding
    noise, from dividing by it."""
    scale = max(float(g.abs().max()) for g in want.values())
    return sorted(((float((got[n] - g).abs().max())
                    / max(float(g.abs().max()), 1e-3 * scale), n)
                   for n, g in want.items()), reverse=True)


def graph_ms(fn, flush, reps: int = 20, stream=None) -> float:
    """Median device time of ``fn`` replayed from a CUDA graph, each replay
    after a write of a buffer larger than L2: the time of its kernels
    without the host's launch overhead (``time_ms`` includes it, and where
    the host takes longer than the kernels it times the host).  ``stream``
    is the capture stream: an autograd backward runs its kernels on the
    stream of its forward, so a backward is captured on the stream its
    forward ran on."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_each_ms(fn, flush, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn`` without the replay's own floor:
    a graph of ``calls`` x (flush, ``fn``) against a graph of ``calls``
    flushes alone, replayed in turns; the median difference over ``reps``
    pairs of replays, per call.  Each call still finds L2 cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    both, flushes = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(both):
        for _ in range(calls):
            flush.zero_()
            fn()
    with torch.cuda.graph(flushes):
        for _ in range(calls):
            flush.zero_()

    def replay_ms(graph):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return statistics.median(replay_ms(both) - replay_ms(flushes)
                             for _ in range(reps)) / calls


def timed(kernel, plain, library, flush, lib_stream=None) -> dict:
    """A kernel, its plain version and its library call, each by CUDA-graph
    replay (``ms``, ``plain``, ``lib``: device time), the kernel and the
    library also as single calls (``single``, ``lib_single``: the host's
    launch work counts where it is slower than the device)."""
    return {"ms": graph_ms(kernel, flush), "single": time_ms(kernel, flush),
            "plain": graph_ms(plain, flush),
            "lib": graph_ms(library, flush, stream=lib_stream),
            "lib_single": time_ms(library, flush)}


def describe(t: dict, library: str, bound: float, by: str) -> str:
    """One log line's timing: graph replay, single call, bound and share."""
    return (f"kernel {t['ms']:.4f} ms by graph replay (single call "
            f"{t['single']:.4f}), plain {t['plain']:.4f}, {library} "
            f"{t['lib']:.4f} (single call {t['lib_single']:.4f}; "
            f"{t['lib'] / t['ms']:.2f}x the kernel), bound {bound:.5f} ms "
            f"({by}): {bound / t['ms']:.1%} of the bound")


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` (its launches queue on the
    device; the device is synchronised outside the timed loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def gate_args(gen, dev, shape, dtype):
    """Seeded gate inputs for (B, H, W, Ch, Cx): h = tanh(normal), x and cr
    normal, weights at He scale in ``dtype``, fp32 biases."""
    b, h, w, ch, cx = shape
    cin = ch + cx
    ws = (2 / (9 * cin)) ** 0.5

    def rnd(*shp, scale=1.0, dt=dtype):
        return (scale * torch.randn(shp, generator=gen)).to(dev, dt)

    return (torch.tanh(rnd(b, h, w, ch)), rnd(b, h, w, cx), rnd(b, h, w, ch),
            rnd(3, 3, cin, 2 * ch, scale=ws),
            rnd(2 * ch, scale=0.1, dt=torch.float32),
            rnd(3, 3, cin, ch, scale=ws), rnd(ch, scale=0.1, dt=torch.float32))


def gates_fp64(h, x, cr, wzr, bzr, wq, bq):
    """The gate function in fp64 (cuDNN's fp64 convolutions): the yardstick
    both the fp32 kernel and its plain fp32 version are held against."""
    def conv(inp, k):
        return F.conv2d(inp.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)

    ch = h.shape[-1]
    h, x, cr = h.double(), x.double(), cr.double()
    zr = conv(torch.cat([h, x], -1), wzr.double()) + bzr.double()
    r = torch.sigmoid(zr[..., ch:] + cr)
    return zr, conv(torch.cat([r * h, x], -1), wq.double()) + bq.double()


def gates_library(args):
    """One PyTorch call computing the gate function, the port never calls
    it: two ``F.conv2d`` (cuDNN) and the sigmoid coupling, NCHW, in the
    activations' dtype."""
    h, x, cr, wzr, bzr, wq, bq = args
    dt, ch = h.dtype, h.shape[-1]
    hh, xx, cc = (a.permute(0, 3, 1, 2).contiguous() for a in (h, x, cr))
    wz, wqq = (w.permute(3, 2, 0, 1).contiguous() for w in (wzr, wq))
    bz, bqq = bzr.to(dt), bq.to(dt)

    def call():
        zr = F.conv2d(torch.cat([hh, xx], 1), wz, bz, padding=1)
        r = torch.sigmoid(zr[:, ch:] + cc)
        return zr, F.conv2d(torch.cat([r * hh, xx], 1), wqq, bqq, padding=1)

    return call


_GATE_KERNEL = re.compile(r"gates_conv_kernelI(f|13__nv_bfloat16)Li(\d+)ELi"
                          r"(\d+)ELi(\d+)ELb([01])E")


def gate_instance(mangled: str):
    """'fp32 BN 128 WG 2 KS 1 zr' for a mangled gate-kernel name, else
    None."""
    m = _GATE_KERNEL.search(mangled)
    if m is None:
        return None
    return (f"{'fp32' if m.group(1) == 'f' else 'bf16'} BN {m.group(2)} WG "
            f"{m.group(3)} KS {m.group(4)} "
            f"{'zr' if m.group(5) == '1' else 'q'}")


def gate_ptxas(report: str):
    """{instance: 'N registers, ...'} from the gate library's ptxas -v."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            name = gate_instance(line)
        elif name and "spill" in line:
            out[name] = line.strip()
        elif name and "registers" in line:
            out[name] = f"{line.split(':', 1)[1].strip()}; {out.get(name, '')}"
    return out


def gate_sass(sass: str):
    """{instance: {tensor-core opcode: count}} from ``cuobjdump -sass``."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = gate_instance(line)
            if name:
                out[name] = {}
        elif name:
            m = re.search(r"\b(HGMMA|HMMA)(\.[\w.]+)?", line)
            if m:
                op = m.group(0)
                out[name][op] = out[name].get(op, 0) + 1
    return out


def cuobjdump(nvcc: str) -> str:
    """The toolkit's cuobjdump, else the copy in Triton's package."""
    found = [os.path.join(os.path.dirname(nvcc), "cuobjdump")]
    try:
        import triton
        found.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for path in found:
        if os.path.exists(path):
            return path
    raise RuntimeError(f"no cuobjdump (looked at {found})")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "raft_stereo_tpu_torch")):
        print("chip_smoke.py needs the raft_stereo_tpu_torch package beside "
              "it", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    import raft_stereo_tpu_torch
    if not os.path.abspath(raft_stereo_tpu_torch.__file__).startswith(HERE):
        print("raft_stereo_tpu_torch resolved outside this checkout",
              file=sys.stderr)
        return 2
    from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner, full_fp32
    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.kernels.corr_alt import (
        alt_lookup_bwd_fused, alt_lookup_bwd_xla, alt_lookup_fused,
        alt_lookup_xla, plan_bwd, plan_fwd)
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_bwd_fused, lookup_pyramid_bwd_xla,
        lookup_pyramid_fused, lookup_pyramid_xla)
    from raft_stereo_tpu_torch.kernels.gru_fused import (TILES,
                                                         _gates_reference,
                                                         _gates_twin, blocks,
                                                         gru_gates_fused,
                                                         smem_bytes, tile)
    from raft_stereo_tpu_torch.kernels.corr_alt import alt_lookup_fused_q
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_fused_q)
    from raft_stereo_tpu_torch.models import raft_stereo as raft_module
    from raft_stereo_tpu_torch.models.corr import (build_corr_pyramid,
                                                   pool_axis)
    from raft_stereo_tpu_torch.models.extractor import Conv2d
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.quant import core as qcore
    from raft_stereo_tpu_torch.quant.calibrate import (calibrate,
                                                       conv_input_scales,
                                                       corr_scales)
    from raft_stereo_tpu_torch.quant.matmul import int8_conv_int32
    from raft_stereo_tpu_torch.training.state import create_train_state
    from raft_stereo_tpu_torch.training.step import train_step
    from raft_stereo_tpu_torch.training.train_loop import train

    # ------------------------------------------------------------ phase 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    full_fp32()
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in built.items()})})")
    for src in _build.sources():
        if src == "gru_gates":    # reported per instantiation below
            continue
        report = _build.library_path(src).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")
    gate_lib = _build.library_path("gru_gates")
    for inst, line in sorted(gate_ptxas(
            gate_lib.with_suffix(".log").read_text()).items()):
        dt_, _, bn_, _, wg_, *_ = inst.split()
        smem = smem_bytes(torch.float32 if dt_ == "fp32" else torch.bfloat16,
                          int(bn_), int(wg_))
        log(f"  gates {inst}: {line}; dynamic shared memory {smem} B")
    sass = subprocess.run([cuobjdump(_build._nvcc()), "-sass", str(gate_lib)],
                          capture_output=True, text=True, check=True).stdout
    tensor_ops = gate_sass(sass)
    for inst, ops in sorted(tensor_ops.items()):
        log(f"  gates {inst} SASS tensor-core instructions: {ops}")
    bare = [i for i, ops in tensor_ops.items()
            if not any(op.startswith("HGMMA") for op in ops)]
    if len(tensor_ops) != 2 * 2 * len(TILES) or bare:
        raise AssertionError(f"gate kernels without HGMMA: {bare} (of "
                             f"{sorted(tensor_ops)})")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)

    def gate_timing(label, args, calls):
        """Time one gate call (graph replays and single calls), its plain
        version and the library call; print TFLOP/s, the share of the
        bound, the factor against the library and each launch's tile."""
        h_, x_ = args[0], args[1]
        b_, hh_, ww_, ch_ = h_.shape
        cin_ = ch_ + x_.shape[-1]
        fp32 = h_.dtype == torch.float32
        flops = 2 * b_ * hh_ * ww_ * 9 * cin_ * 3 * ch_
        item = h_.element_size()
        nbytes = (item * b_ * hh_ * ww_ * (cin_ + ch_ + 3 * ch_)
                  + item * 9 * cin_ * 3 * ch_ + 4 * 3 * ch_)
        ops_ms = (3 * flops / TF32_RATE if fp32 else flops / BF16_RATE) * 1e3
        bytes_ms = nbytes / MEM_RATE * 1e3
        bound = max(ops_ms, bytes_ms)
        lib_fn = gates_library(args)
        ms = graph_ms(lambda: gru_gates_fused(*args), flush)
        single = time_ms(lambda: gru_gates_fused(*args), flush)
        plain = graph_ms(lambda: _gates_reference(*args), flush)
        lib = graph_ms(lib_fn, flush)
        lib_single = time_ms(lib_fn, flush)
        grids = []
        for what, cout in (("zr", 2 * ch_), ("q", ch_)):
            bn, wg, ks = tile((b_, hh_, ww_), cout, sms)
            n = blocks((b_, hh_, ww_), cout, bn, wg, ks)
            grids.append(f"{what} {bn}x{wg}{f' K/{ks}' if ks > 1 else ''}: "
                         f"{n} blocks, {n / sms:.2f}/SM")
        log(f"gates {'fp32' if fp32 else 'bf16'} timing {label}"
            f"{f' (x{calls} per iteration)' if calls > 1 else ''}: kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} "
            f"of the bound; single call {single:.4f}), plain {plain:.4f}, "
            f"conv2d x2 {lib:.4f} (single call {lib_single:.4f}): "
            f"{lib / ms:.2f}x; bound {bound:.5f} ms ({flops / 1e9:.2f} GFLOP"
            f"{', 3xTF32 on the tensor cores' if fp32 else ''}; "
            f"{flops / FP32_RATE * 1e3:.4f} ms on the fp32 CUDA cores; "
            f"{nbytes / 1e6:.1f} MB: {bytes_ms:.5f} ms); {'; '.join(grids)}")
        return {"ms": ms, "plain": plain, "lib": lib, "bound": bound,
                "by": "operations" if ops_ms >= bytes_ms else "bytes"}

    def per_iteration(rows, times):
        """Sum over a path's levels, each times its calls per iteration."""
        tot = {k_: sum(c_ * times[n_][k_] for n_, c_ in rows if c_)
               for k_ in ("ms", "plain", "lib", "bound")}
        tot["by"] = ("bytes" if any(times[n_]["by"] == "bytes"
                                    for n_, c_ in rows if c_)
                     else "operations")
        return tot

    # ------------------------------------------------------------ phase 2
    vol = torch.randn((1, ROWS, W1, W1), generator=gen).to(dev)
    pyramid = build_corr_pyramid(vol, LEVELS)
    w2s = [v.shape[-1] for v in pyramid]
    coords = (torch.rand((1, ROWS, W1), generator=gen) * (W1 + 20) - 10).to(dev)
    got = lookup_pyramid_fused(pyramid, coords, RADIUS)
    torch.cuda.synchronize()
    lookup_err = float((got - lookup_pyramid_xla(pyramid, coords, RADIUS)
                        ).abs().max())
    log(f"lookup, 4 levels {w2s}: max |kernel - plain| = {lookup_err:.3e} "
        f"(atol {LOOKUP_ATOL})")
    for i, v in enumerate(pyramid):
        c = coords / 2 ** i
        one = lookup_pyramid_fused([v], c, RADIUS)
        torch.cuda.synchronize()
        err = float((one - lookup_pyramid_xla([v], c, RADIUS)).abs().max())
        log(f"lookup, level {i} alone (W2 {v.shape[-1]}, scale 1/{2 ** i}): "
            f"max |kernel - plain| = {err:.3e}")
        lookup_err = max(lookup_err, err)
    if not lookup_err <= LOOKUP_ATOL:
        raise AssertionError(f"lookup kernel disagrees: {lookup_err}")

    # ------------------------------------------------------------ phase 3
    gate_cases = {}
    gates_err = 0.0
    for name_, *shape, calls in GATE_ROWS_FP32 + tuple(
            o + (0,) for o in GATE_ODD):
        label = f"{name_} {tuple(shape[:3])} Ch {shape[3]} Cx {shape[4]}"
        args = gate_args(gen, dev, shape, torch.float32)
        got = gru_gates_fused(*args)
        torch.cuda.synchronize()
        want = _gates_reference(*args)
        err = max(float((g - wv).abs().max()) for g, wv in zip(got, want))
        line = (f"gates fp32 {label}: max |kernel - plain| = {err:.3e} "
                f"(atol {GATES_ATOL})")
        if not name_.startswith(("odd", "TINY")):
            ref = gates_fp64(*args)
            d_k = max(float((g.double() - r_).abs().max())
                      for g, r_ in zip(got, ref))
            d_p = max(float((wv.double() - r_).abs().max())
                      for wv, r_ in zip(want, ref))
            ok64 = d_k <= GATES_FP64_FACTOR * d_p + GATES_FP64_ATOL
            line += (f"; against fp64: kernel {d_k:.3e}, plain {d_p:.3e} "
                     f"(kernel <= {GATES_FP64_FACTOR:g} x plain + "
                     f"{GATES_FP64_ATOL:g}: {'ok' if ok64 else 'FAILED'})")
            del ref
            if not ok64:
                log(line)
                raise AssertionError(f"fp32 gates {label} not of fp32 "
                                     f"accuracy: {d_k} against {d_p}")
        log(line)
        gates_err = max(gates_err, err)
        gate_cases[label] = (args, calls)
    if not gates_err <= GATES_ATOL:
        raise AssertionError(f"gate kernel disagrees: {gates_err}")

    # ------------------------------------------------------------ phase 4
    k = 2 * RADIUS + 1
    taps = torch.arange(-RADIUS, RADIUS + 1, device=dev, dtype=torch.float32)
    grids, sources = [], []
    for i, v in enumerate(pyramid):
        x = coords[..., None] / 2 ** i + taps
        gx = (2 * x / (v.shape[-1] - 1) - 1).reshape(-1, 1, k, 1)
        grids.append(torch.cat([gx, torch.zeros_like(gx)], dim=-1))
        sources.append(v.reshape(-1, 1, 1, v.shape[-1]))

    def lookup_library():
        return torch.cat([F.grid_sample(s, g, mode="bilinear",
                                        padding_mode="zeros",
                                        align_corners=True)
                          for s, g in zip(sources, grids)], dim=-1)

    lib_err = float((lookup_library().reshape(1, ROWS, W1, -1)
                     - lookup_pyramid_xla(pyramid, coords, RADIUS)
                     ).abs().max())
    log(f"lookup yardstick grid_sample: max |library - plain| = "
        f"{lib_err:.3e}")
    lookup_t = timed(lambda: lookup_pyramid_fused(pyramid, coords, RADIUS),
                     lambda: lookup_pyramid_xla(pyramid, coords, RADIUS),
                     lookup_library, flush)
    lookup_bound_ms = lookup_bytes(coords, w2s) / MEM_RATE * 1e3
    log("lookup timing: "
        + describe(lookup_t, "grid_sample x4", lookup_bound_ms, "bytes"))
    log(f"rule 2 on the graph-replay times: lookup fp32 kernel "
        f"{lookup_t['ms']:.4f} ms vs grid_sample x4 {lookup_t['lib']:.4f} ms:"
        f" {'slower' if lookup_t['ms'] > lookup_t['lib'] else 'not slower'}")
    bound_once = host_us(lambda: lookup_pyramid_fused(pyramid, coords,
                                                      RADIUS))
    bound_per_call = host_us(lambda: (_build._entries.clear(),
                                      lookup_pyramid_fused(pyramid, coords,
                                                           RADIUS)))
    log(f"lookup fp32 wrapper, host time per call: {bound_once:.1f} us with "
        f"its C entry bound once, {bound_per_call:.1f} us binding the entry "
        f"on every call (the earlier wrappers)")
    tiny = torch.zeros(1, device=dev)
    floor_ms = graph_ms(tiny.zero_, tiny)
    log(f"graph replay of one one-element kernel: {floor_ms:.4f} ms (the "
        f"replay's own floor, inside every graph-replay time here)")

    def alone(label, fn, bound):
        """Print a short kernel's time without the replay floor."""
        ms_ = graph_each_ms(fn, flush)
        log(f"{label}, 20 calls per replay with the flushes subtracted: "
            f"{ms_:.4f} ms per call, {ms_ / bound:.1f}x the bound")

    alone("lookup fp32", lambda: lookup_pyramid_fused(pyramid, coords, RADIUS),
          lookup_bound_ms)

    gate_times = {label: gate_timing(label, args, calls)
                  for label, (args, calls) in gate_cases.items()}
    gates_fp32 = per_iteration([(lb, c_) for lb, (_, c_) in gate_cases.items()],
                               gate_times)
    log(f"gates fp32 per default iteration: kernel {gates_fp32['ms']:.4f} ms, "
        f"plain {gates_fp32['plain']:.4f}, conv2d {gates_fp32['lib']:.4f} "
        f"({gates_fp32['lib'] / gates_fp32['ms']:.2f}x), bound "
        f"{gates_fp32['bound']:.4f} ms (3xTF32)")
    del gate_cases

    # ------------------------------------------------------------ phase 5
    cfg = RaftStereoConfig()
    torch.manual_seed(SEED)
    model = RAFTStereo(cfg)
    state = {n: t.clone() for n, t in model.state_dict().items()}
    runner = InferenceRunner(cfg, model, iters=MAIN_ITERS, device="cuda")
    rs = np.random.default_rng(SEED)
    left = rs.integers(0, 256, MAIN_HW + (3,), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    runner(left, right)                                    # warm-up
    lookup_pyramid_fused.launches = 0
    gru_gates_fused.launches = 0
    alt_lookup_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    flow, _ = runner(left, right)
    launches = {"lookup": lookup_pyramid_fused.launches,
                "gates": gru_gates_fused.launches,
                "alt": alt_lookup_fused.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"main path {MAIN_HW[0]}x{MAIN_HW[1]} (padded 384x1248), "
        f"iters {MAIN_ITERS}: launches {launches}, peak memory "
        f"{peak_gib:.2f} GiB")
    if flow.shape != MAIN_HW or not np.isfinite(flow).all():
        raise AssertionError(f"bad flow: shape {flow.shape}, finite "
                             f"{np.isfinite(flow).all()}")
    if launches != {"lookup": MAIN_ITERS, "gates": 3 * MAIN_ITERS,
                    "alt": 0}:
        raise AssertionError(f"main path kernel launches {launches}")
    secs = [runner(left, right)[1] for _ in range(5)]
    log(f"main path seconds per pair: median {statistics.median(secs):.4f} "
        f"(runs {[round(s, 4) for s in secs]}); flow range "
        f"[{flow.min():.2f}, {flow.max():.2f}]")

    # ------------------------------------------------------------ phase 6
    small = rs.integers(0, 256, (128, 256, 3), dtype=np.uint8)
    small_r = np.roll(small, -4, axis=1)
    on_card = InferenceRunner(cfg, state, iters=2, device="cuda")(
        small, small_r)[0]
    on_cpu = InferenceRunner(cfg, state, iters=2, device="cpu")(
        small, small_r)[0]
    diff = float(np.abs(on_card - on_cpu).max())
    log(f"card vs CPU, 128x256, iters 2: max |Δflow| = {diff:.3e} px "
        f"(atol {CARD_VS_CPU_ATOL}; flow range [{on_cpu.min():.2f}, "
        f"{on_cpu.max():.2f}])")
    if not diff <= CARD_VS_CPU_ATOL:
        raise AssertionError(f"card and CPU disagree by {diff}")

    # ------------------------------------------------------------ phase 7
    def alt_case(dtype):
        def feats(w):
            return torch.randn((1, RT_ROWS, w, RT_D), generator=gen).to(
                dev, dtype)

        f1, pyr = feats(RT_W1), [feats(RT_W1)]
        for _ in range(LEVELS - 1):
            pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
        c = (torch.rand((1, RT_ROWS, RT_W1), generator=gen) * (RT_W1 + 20)
             - 10).to(dev)
        return f1, pyr, c

    alt_cases, alt_err = {}, {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        f1, pyr, c = alt_cases[tag] = alt_case(dtype)
        calls = [(pyr, c, "all levels")] + [
            ([v], c / 2 ** i, f"level {i} alone (scale 1/{2 ** i})")
            for i, v in enumerate(pyr)]
        worst, ok = 0.0, True
        for levels_, cc, what in calls:
            got = alt_lookup_fused(f1, levels_, cc, RADIUS)
            torch.cuda.synchronize()
            want = alt_lookup_xla(f1, levels_, cc, RADIUS)
            if got.dtype != dtype:
                raise AssertionError(f"alt kernel returned {got.dtype}")
            if dtype == torch.float32:
                err = float((got - want).abs().max())
                ok_ = err <= ALT_ATOL
            else:
                err, ok_ = bf16_ulp_error(got, want, BF16_ULPS, BF16_ATOL)
            log(f"alt {tag}, {what}, W2 {[v.shape[2] for v in levels_]}: "
                f"max |kernel - plain| = {err:.3e}")
            worst, ok = max(worst, err), ok and ok_
        alt_err[tag] = worst
        tol = (f"atol {ALT_ATOL}" if tag == "fp32"
               else f"{BF16_ULPS} bf16 ulp + {BF16_ATOL}")
        log(f"alt {tag}: worst {worst:.3e} ({tol}): "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"alt kernel ({tag}) disagrees: {worst}")

    rt_gate_cases = {}
    gates_bf16_err = 0.0
    for name_, *shape, calls in GATE_ROWS_BF16 + tuple(
            o + (0,) for o in GATE_ODD):
        label = f"{name_} {tuple(shape[:3])} Ch {shape[3]} Cx {shape[4]}"
        args = gate_args(gen, dev, shape, torch.bfloat16)
        got = gru_gates_fused(*args)
        torch.cuda.synchronize()
        errs = [bf16_ulp_error(g, wv, BF16_GATES_ULPS, BF16_GATES_ATOL)
                for g, wv in zip(got, _gates_reference(*args))]
        err = max(e for e, _ in errs)
        ok = all(o for _, o in errs) and all(
            g.dtype == torch.bfloat16 for g in got)
        log(f"gates bf16 {label}: max |kernel - plain| = {err:.3e} "
            f"({BF16_GATES_ULPS} bf16 ulps + {BF16_GATES_ATOL}): "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"bf16 gate kernel disagrees: {err}")
        gates_bf16_err = max(gates_bf16_err, err)
        rt_gate_cases[label] = (args, calls)

    pyr16 = build_corr_pyramid(vol.to(torch.bfloat16), LEVELS)
    got = lookup_pyramid_fused(pyr16, coords, RADIUS)
    torch.cuda.synchronize()
    lookup16_err, ok = bf16_ulp_error(
        got, lookup_pyramid_xla(pyr16, coords, RADIUS), BF16_ULPS, BF16_ATOL)
    log(f"lookup bf16, 4 levels {w2s}: max |kernel - plain| = "
        f"{lookup16_err:.3e} ({BF16_ULPS} bf16 ulp + {BF16_ATOL}): "
        f"{'ok' if ok and got.dtype == torch.bfloat16 else 'FAILED'}")
    if not ok or got.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 lookup kernel disagrees: {lookup16_err}")

    # ------------------------------------------------------------ phase 8
    def alt_bound(f1, pyr, c, out_item, quantized):
        """(bound ms, what bounds it, bytes, operations) of one alt call:
        the features, centers and output moved once; the window dots
        (2D per bin these centers touch) and, in fp32, the interpolation
        at the fp32 rate, or the dots alone at the int8/fp8 tensor rate."""
        k_ = LEVELS * (2 * RADIUS + 1)
        nbytes = ((f1.numel() + sum(v.numel() for v in pyr))
                  * f1.element_size() + c.numel() * 4
                  + c.numel() * k_ * out_item)
        ops = 2 * f1.shape[-1] * window_bins(c, [v.shape[2] for v in pyr])
        if not quantized:
            ops += 3 * c.numel() * k_
        bytes_ms = nbytes / MEM_RATE * 1e3
        ops_ms = ops / (INT8_RATE if quantized else FP32_RATE) * 1e3
        return (max(bytes_ms, ops_ms),
                "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)

    def alt_fields(label, call, f1, pyr, fields, out_item, quantized=False):
        """Time ``call(c)`` on each center field by one-call graph replay
        and as 20 calls per replay with the flushes subtracted, beside its
        bound (every alt bound lies below the replay floor)."""
        res = {}
        for fname, c_ in fields.items():
            bound, by, _, _ = alt_bound(f1, pyr, c_, out_item, quantized)
            one = graph_ms(lambda: call(c_), flush)
            each = graph_each_ms(lambda: call(c_), flush)
            log(f"{label}, {fname} centers: {one:.4f} ms by one-call graph "
                f"replay, {each:.4f} ms per call at 20 calls per replay; "
                f"bound {bound:.5f} ms ({by}): {each / bound:.1f}x the bound "
                f"by 20-call replay")
            res[fname] = {"ms": one, "ms_20": each, "bound_ms": bound,
                          "bound_by": by}
        return res

    alt_time = {}
    for tag, (f1, pyr, c) in alt_cases.items():
        lib_err = float((alt_library(f1, pyr, c)
                         - alt_lookup_xla(f1, pyr, c, RADIUS).float()
                         ).abs().max())
        t = timed(lambda: alt_lookup_fused(f1, pyr, c, RADIUS),
                  lambda: alt_lookup_xla(f1, pyr, c, RADIUS),
                  lambda: alt_library(f1, pyr, c), flush)
        t["bound"], t["by"], nbytes, flops = alt_bound(
            f1, pyr, c, f1.element_size(), False)
        alt_time[tag] = t
        log(f"alt {tag} timing: "
            f"{describe(t, 'grid_sample formulation', t['bound'], t['by'])}; "
            f"max |library - plain| {lib_err:.3e}; {nbytes / 1e6:.2f} MB: "
            f"{nbytes / MEM_RATE * 1e3:.5f} ms; {flops / 1e6:.1f} MFLOP at "
            f"the fp32 rate: {flops / FP32_RATE * 1e3:.5f} ms")
        plan = plan_fwd([v.shape[2] for v in pyr], RADIUS, RT_D, f1.dtype)
        log(f"alt {tag} plan_fwd at (1,{RT_ROWS},{RT_W1}): (pixel tile, "
            f"channel chunk, band rows per pass) {plan}")
        fields = {"random": c, "coherent": coherent_centers(
            gen, 1, RT_ROWS, RT_W1).to(dev)}
        t["fields"] = alt_fields(
            f"alt {tag} (1,{RT_ROWS},{RT_W1}) D {RT_D}",
            lambda c_: alt_lookup_fused(f1, pyr, c_, RADIUS), f1, pyr,
            fields, f1.element_size())
    # #6 at the realtime training step's shape (22 launches per step).
    tb_, th_, tw_ = TRAIN_B, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    f1 = torch.randn((tb_, th_, tw_, RT_D), generator=gen).to(
        dev, torch.bfloat16)
    pyr = [torch.randn((tb_, th_, tw_, RT_D), generator=gen).to(
        dev, torch.bfloat16)]
    for _ in range(LEVELS - 1):
        pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
    fields = {"random": (torch.rand((tb_, th_, tw_), generator=gen)
                         * (tw_ + 20) - 10).to(dev),
              "coherent": coherent_centers(gen, tb_, th_, tw_).to(dev)}
    alt_time["bf16"]["fields"].update({
        f"training {n_}": v_ for n_, v_ in alt_fields(
            f"alt bf16 at the realtime training shape ({tb_},{th_},{tw_}) "
            f"D {RT_D}", lambda c_: alt_lookup_fused(f1, pyr, c_, RADIUS),
            f1, pyr, fields, 2).items()})
    del f1, pyr, fields

    g16_times = {label: gate_timing(label, args, calls)
                 for label, (args, calls) in rt_gate_cases.items()}
    gates_bf16 = per_iteration(
        [(lb, c_) for lb, (_, c_) in rt_gate_cases.items()], g16_times)
    log(f"gates bf16 per realtime iteration: kernel {gates_bf16['ms']:.4f} "
        f"ms, plain {gates_bf16['plain']:.4f}, conv2d {gates_bf16['lib']:.4f}"
        f" ({gates_bf16['lib'] / gates_bf16['ms']:.2f}x), bound "
        f"{gates_bf16['bound']:.5f} ms (bf16 tensor cores)")
    del rt_gate_cases

    src16 = [v.float().reshape(-1, 1, 1, v.shape[-1]) for v in pyr16]

    def lookup16_library():
        return torch.cat([F.grid_sample(s_, g_, mode="bilinear",
                                        padding_mode="zeros",
                                        align_corners=True)
                          for s_, g_ in zip(src16, grids)], dim=-1)

    l16_t = timed(lambda: lookup_pyramid_fused(pyr16, coords, RADIUS),
                  lambda: lookup_pyramid_xla(pyr16, coords, RADIUS),
                  lookup16_library, flush)
    l16_bound = lookup_bytes(coords, w2s, itemsize=2) / MEM_RATE * 1e3
    log("lookup bf16 timing: " + describe(
        l16_t, "grid_sample x4 (fp32 upcast)", l16_bound, "bytes"))
    alone("lookup bf16", lambda: lookup_pyramid_fused(pyr16, coords, RADIUS),
          l16_bound)

    # ------------------------------------------------------------ phase 9
    rt_cfg = RaftStereoConfig.realtime()
    torch.manual_seed(SEED)
    rt_model = RAFTStereo(rt_cfg)
    rt_state = {n: t.clone() for n, t in rt_model.state_dict().items()}
    rt_runner = InferenceRunner(rt_cfg, rt_model, iters=RT_ITERS,
                                device="cuda")
    if rt_runner.effective_config.corr_fp32:
        raise AssertionError("realtime at 7 iterations must keep bf16 "
                             "correlation")
    rt_runner(left, right)                                 # warm-up
    lookup_pyramid_fused.launches = 0
    gru_gates_fused.launches = 0
    alt_lookup_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rt_flow, _ = rt_runner(left, right)
    rt_launches = {"lookup": lookup_pyramid_fused.launches,
                   "gates": gru_gates_fused.launches,
                   "alt": alt_lookup_fused.launches}
    rt_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"realtime path {MAIN_HW[0]}x{MAIN_HW[1]} (padded 384x1248), iters "
        f"{RT_ITERS}, bf16: launches {rt_launches}, peak memory "
        f"{rt_peak_gib:.3f} GiB")
    if rt_flow.shape != MAIN_HW or not np.isfinite(rt_flow).all():
        raise AssertionError(f"bad realtime flow: shape {rt_flow.shape}, "
                             f"finite {np.isfinite(rt_flow).all()}")
    if rt_launches != {"lookup": 0, "gates": 3 * RT_ITERS, "alt": RT_ITERS}:
        raise AssertionError(f"realtime path kernel launches {rt_launches}")
    rt_secs = [rt_runner(left, right)[1] for _ in range(5)]
    log(f"realtime path seconds per pair: median "
        f"{statistics.median(rt_secs):.5f} (runs {rt_secs}); flow range "
        f"[{rt_flow.min():.2f}, {rt_flow.max():.2f}]")

    deep = InferenceRunner(rt_cfg, rt_state, iters=RT_DEEP_ITERS,
                           device="cuda")
    if not deep.effective_config.corr_fp32:
        raise AssertionError(f"realtime at {RT_DEEP_ITERS} iterations must "
                             "turn corr_fp32 on")
    lookup_pyramid_fused.launches = 0
    gru_gates_fused.launches = 0
    alt_lookup_fused.launches = 0
    deep_flow, deep_s = deep(left, right)
    deep_launches = {"lookup": lookup_pyramid_fused.launches,
                     "gates": gru_gates_fused.launches,
                     "alt": alt_lookup_fused.launches}
    log(f"realtime path, iters {RT_DEEP_ITERS} (corr_fp32 on: fp32 alt): "
        f"launches {deep_launches}, {deep_s:.5f} s (first call)")
    if deep_flow.shape != MAIN_HW or not np.isfinite(deep_flow).all():
        raise AssertionError("bad realtime flow at corr_fp32")
    if deep_launches != {"lookup": 0, "gates": 3 * RT_DEEP_ITERS,
                         "alt": RT_DEEP_ITERS}:
        raise AssertionError(f"deep realtime launches {deep_launches}")

    # ----------------------------------------------------------- phase 10
    on_card = InferenceRunner(rt_cfg, rt_state, iters=2, device="cuda")(
        small, small_r)[0]
    card_fp32_corr = InferenceRunner(
        dataclasses.replace(rt_cfg, corr_fp32=True), rt_state, iters=2,
        device="cuda")(small, small_r)[0]
    on_cpu = InferenceRunner(rt_cfg, rt_state, iters=2, device="cpu")(
        small, small_r)[0]
    spread = np.abs(on_card - card_fp32_corr)
    err = np.abs(on_card - on_cpu)
    rt_ok = (err.max() <= RT_SPREAD_FACTOR * spread.max()
             and err.mean() <= RT_SPREAD_FACTOR * spread.mean())
    log(f"realtime card vs CPU, 128x256, iters 2: max / mean |Δflow| = "
        f"{err.max():.4e} / {err.mean():.4e} px; the card's bf16 vs fp32 "
        f"correlation spread {spread.max():.4e} / {spread.mean():.4e} px "
        f"(limit {RT_SPREAD_FACTOR}x); flow range [{on_cpu.min():.2f}, "
        f"{on_cpu.max():.2f}]: {'ok' if rt_ok else 'FAILED'}")
    if not rt_ok:
        raise AssertionError("realtime card and CPU disagree")

    # ----------------------------------------------------------- phase 11
    k = 2 * RADIUS + 1
    tb, th, tw = TRAIN_B, TRAIN_HW[0] // 4, TRAIN_HW[1] // 4
    tw2s = [tw // 2 ** i for i in range(LEVELS)]
    tcoords = (torch.rand((tb, th, tw), generator=gen) * (tw + 20)
               - 10).to(dev)
    tg = torch.randn((tb, th, tw, LEVELS * k), generator=gen).to(dev)
    got = lookup_pyramid_bwd_fused(tg, tcoords, tw2s, RADIUS, torch.float32)
    again = lookup_pyramid_bwd_fused(tg, tcoords, tw2s, RADIUS,
                                     torch.float32)
    torch.cuda.synchronize()
    lookup_bwd_same = all(torch.equal(a, b) for a, b in zip(got, again))
    lookup_bwd_err = max(
        float((a - b).abs().max()) for a, b in zip(
            got, lookup_pyramid_bwd_xla(tg, tcoords, tw2s, RADIUS,
                                        torch.float32)))
    log(f"lookup backward, {tb * th} rows, W1 {tw}, levels {tw2s}: max "
        f"|kernel - plain| = {lookup_bwd_err:.3e} (atol {LOOKUP_BWD_ATOL}); "
        f"a second launch bitwise equal: {lookup_bwd_same}")
    if not lookup_bwd_same:
        raise AssertionError("two launches of the lookup backward differ")
    del got, again
    for i, w2 in enumerate(tw2s):
        args_ = (tg[..., i * k:(i + 1) * k].contiguous(), tcoords / 2 ** i,
                 [w2], RADIUS, torch.float32)
        one, = lookup_pyramid_bwd_fused(*args_)
        torch.cuda.synchronize()
        err = float((one - lookup_pyramid_bwd_xla(*args_)[0]).abs().max())
        log(f"lookup backward, level {i} alone (W2 {w2}, scale 1/{2 ** i}): "
            f"max |kernel - plain| = {err:.3e}")
        lookup_bwd_err = max(lookup_bwd_err, err)
    if not lookup_bwd_err <= LOOKUP_BWD_ATOL:
        raise AssertionError(f"lookup backward disagrees: {lookup_bwd_err}")

    def alt_bwd_case(dtype, b, h, w1, w2, d):
        def feats(w):
            return torch.randn((b, h, w, d), generator=gen).to(dev, dtype)

        f1, pyr = feats(w1), [feats(w2)]
        for _ in range(LEVELS - 1):
            pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
        c = (torch.rand((b, h, w1), generator=gen) * (w2 + 20) - 10).to(dev)
        g = torch.randn((b, h, w1, LEVELS * k), generator=gen).to(dev, dtype)
        return f1, pyr, c, g

    alt_bwd_cases, alt_bwd_err = {}, {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        chunk, tile, tc = plan_bwd(tw // 2, [tw // 2 // 2 ** i
                                             for i in range(LEVELS)],
                                   RADIUS, RT_D, torch.tensor(
                                       [], dtype=dtype).element_size())
        log(f"alt backward {tag} plan at the training row: {chunk} channels "
            f"per block, tile {tile} pixels, "
            f"{'tensor cores' if tc else 'CUDA cores'}")
        worst, worst_abs, ok = 0.0, 0.0, True
        for shape in ((tb, th // 2, tw // 2, tw // 2, RT_D),
                      (1, 3, 37, 43, 64)):
            case = alt_bwd_case(dtype, *shape)
            if shape[0] == tb:
                alt_bwd_cases[tag] = case
            df1, df2 = alt_lookup_bwd_fused(*case, RADIUS)
            torch.cuda.synchronize()
            again = alt_lookup_bwd_fused(*case, RADIUS)
            same = torch.equal(again[0], df1) and all(
                torch.equal(a, b_) for a, b_ in zip(again[1], df2))
            want1, want2 = alt_lookup_bwd_xla(*case, RADIUS)
            for got_, want_ in [(df1, want1)] + list(zip(df2, want2)):
                if got_.dtype != dtype:
                    raise AssertionError(f"alt backward returned {got_.dtype}")
                scale = float(want_.float().abs().max())
                if dtype == torch.float32:
                    err_abs = float((got_ - want_).abs().max())
                    ok_ = err_abs <= ALT_BWD_RTOL * scale
                else:
                    err_abs, ok_ = bf16_ulp_error(got_, want_, BF16_ULPS,
                                                  ALT_BWD_BF16_RTOL * scale)
                worst = max(worst, err_abs / scale)
                worst_abs = max(worst_abs, err_abs)
                ok = ok and ok_ and same
            log(f"alt backward {tag}, (B,H,W1,W2,D) {shape}: worst |kernel - "
                f"plain| / scale = {worst:.3e}; a second launch bitwise "
                f"equal: {same}")
        alt_bwd_err[tag] = worst_abs
        tol = (f"{ALT_BWD_RTOL} of the scale" if tag == "fp32" else
               f"{BF16_ULPS} bf16 ulp + {ALT_BWD_BF16_RTOL} of the scale")
        log(f"alt backward {tag}: worst {worst:.3e} of the scale, "
            f"{worst_abs:.3e} absolute ({tol}): "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"alt backward ({tag}) disagrees: {worst}")

    cin = CH + 256
    ws = (2 / (9 * cin)) ** 0.5

    def leaf(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(
            dev).requires_grad_()

    gargs = (leaf(tb, th, tw, CH), leaf(tb, th, tw, 256), leaf(tb, th, tw, CH),
             leaf(3, 3, cin, 2 * CH, scale=ws), leaf(2 * CH, scale=0.1),
             leaf(3, 3, cin, CH, scale=ws), leaf(CH, scale=0.1))
    gouts = gru_gates_fused(*gargs)
    if any(o.grad_fn is None for o in gouts):
        raise AssertionError("gate outputs carry no grad_fn on the card")
    ggrads = [torch.randn(o.shape, generator=gen).to(dev) for o in gouts]
    got = torch.autograd.grad(gouts, gargs, ggrads)
    want = torch.autograd.grad(_gates_twin(*gargs), gargs, ggrads)
    gates_bwd_err = max(max_rel_err(a, b_) for a, b_ in zip(got, want))
    log(f"gate Function gradients, gru08 ({tb},{th},{tw}) Cin {cin}: max "
        f"|Function - autograd of the twin| / scale = {gates_bwd_err:.3e} "
        f"(rtol {GATES_BWD_RTOL})")
    if not gates_bwd_err <= GATES_BWD_RTOL:
        raise AssertionError(f"gate gradients disagree: {gates_bwd_err}")
    del gargs, gouts, ggrads, got, want

    # ----------------------------------------------------------- phase 12
    # The library backwards are captured on the stream their forwards ran
    # on (graph_ms).
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    n_pix = tb * th * tw
    srcs = [torch.zeros((n_pix, 1, 1, w2), device=dev, requires_grad=True)
            for w2 in tw2s]
    lib_out = []
    with torch.cuda.stream(lib_stream):
        for i, (src, w2) in enumerate(zip(srcs, tw2s)):
            x = tcoords[..., None] / 2 ** i + taps
            gx = (2 * x / (w2 - 1) - 1).reshape(-1, 1, k, 1)
            grid = torch.cat([gx, torch.zeros_like(gx)], dim=-1)
            lib_out.append(F.grid_sample(src, grid, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True))
        lib_out = torch.cat(lib_out, dim=-1)
    torch.cuda.current_stream().wait_stream(lib_stream)
    lib_g = tg.reshape(n_pix, 1, 1, LEVELS * k)

    def lookup_bwd_library():
        return torch.autograd.grad(lib_out, srcs, lib_g, retain_graph=True)

    lib_err = max(float((a.reshape(b_.shape) - b_).abs().max()) for a, b_ in
                  zip(lookup_bwd_library(), lookup_pyramid_bwd_xla(
                      tg, tcoords, tw2s, RADIUS, torch.float32)))
    lbwd_t = timed(lambda: lookup_pyramid_bwd_fused(
        tg, tcoords, tw2s, RADIUS, torch.float32),
        lambda: lookup_pyramid_bwd_xla(tg, tcoords, tw2s, RADIUS,
                                       torch.float32),
        lookup_bwd_library, flush, lib_stream)
    lbwd_bytes = n_pix * (sum(tw2s) * 4 + LEVELS * k * 4 + 4)
    lbwd_bound = lbwd_bytes / MEM_RATE * 1e3
    log(f"lookup backward timing: "
        f"{describe(lbwd_t, 'grid_sample backward x4', lbwd_bound, 'bytes')}"
        f"; max |library - plain| {lib_err:.3e}; {lbwd_bytes / 1e6:.1f} MB")
    # The practical write floor: one memset of the same dV bytes.
    dv_elems = n_pix * sum(tw2s)
    lbwd_t["write_floor_ms"] = graph_ms(
        lambda: torch.zeros(dv_elems, device=dev), flush)
    log(f"lookup backward: torch.zeros of its {dv_elems * 4 / 1e6:.1f} MB of "
        f"dV {lbwd_t['write_floor_ms']:.4f} ms by graph replay, the write "
        f"floor; the kernel {lbwd_t['ms'] / lbwd_t['write_floor_ms']:.2f}x "
        f"it, {lbwd_bound / lbwd_t['ms']:.1%} of the bound; faster than the "
        f"library's backward: {lbwd_t['ms'] < lbwd_t['lib']}")
    del srcs, lib_out

    alt_bwd_time = {}
    for tag, (f1, pyr, c, g) in alt_bwd_cases.items():
        f1l = f1.float().detach().requires_grad_()
        pyrl = [v.float().detach().requires_grad_() for v in pyr]
        lib_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(lib_stream):
            lib_out = alt_library(f1l, pyrl, c)
        torch.cuda.current_stream().wait_stream(lib_stream)

        def alt_bwd_library():
            return torch.autograd.grad(lib_out, [f1l] + pyrl, g.float(),
                                       retain_graph=True)

        t = timed(lambda: alt_lookup_bwd_fused(f1, pyr, c, g, RADIUS),
                  lambda: alt_lookup_bwd_xla(f1, pyr, c, g, RADIUS),
                  alt_bwd_library, flush, lib_stream)
        item = f1.element_size()
        feats = f1.numel() + sum(v.numel() for v in pyr)
        nbytes = 2 * feats * item + g.numel() * item + c.numel() * 4
        bins = window_bins(c, [v.shape[2] for v in pyr])
        flops = 4 * RT_D * bins
        bytes_ms, ops_ms = nbytes / MEM_RATE * 1e3, flops / FP32_RATE * 1e3
        t["bound"] = max(bytes_ms, ops_ms)
        t["by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        alt_bwd_time[tag] = t
        log(f"alt backward {tag} timing: "
            + describe(t, "grid_sample formulation backward", t["bound"],
                       t["by"]) +
            f"; {nbytes / 1e6:.2f} MB: {bytes_ms:.5f} ms; {flops / 1e6:.1f} "
            f"MFLOP at the fp32 rate: {ops_ms:.5f} ms")
        del lib_out

    # ------------------------------------------------------ phases 13, 14
    def counts():
        return {"lookup": lookup_pyramid_fused.launches,
                "lookup_bwd": lookup_pyramid_bwd_fused.launches,
                "gates": gru_gates_fused.launches,
                "alt": alt_lookup_fused.launches,
                "alt_bwd": alt_lookup_bwd_fused.launches}

    def zero_counts():
        for fn in (lookup_pyramid_fused, lookup_pyramid_bwd_fused,
                   gru_gates_fused, alt_lookup_fused, alt_lookup_bwd_fused):
            fn.launches = 0

    def drive_training(model_cfg, what):
        """``train()`` on the card: a warm-up step, then TIMED_STEPS steps
        with the launch counts zeroed before them; seconds per step from
        a synchronised host clock at every batch the loop takes."""
        train_cfg = dataclasses.replace(
            TrainConfig(), batch_size=TRAIN_B, image_size=TRAIN_HW,
            train_iters=TRAIN_ITERS)
        src = SyntheticStereoLoader(train_cfg.batch_size,
                                    train_cfg.image_size, seed=SEED)
        batches = [src.batch(i) for i in range(1 + TIMED_STEPS)]
        marks = []

        def loader():
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                if i == 1:
                    zero_counts()
                    torch.cuda.reset_peak_memory_stats()
                yield b

        seen = []
        state = train(model_cfg, train_cfg, loader(), device=dev,
                      on_step=lambda s, m: seen.append(
                          {k_: float(v) for k_, v in m.items()}))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        launched = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = [marks[i + 1] - marks[i] for i in range(1, 1 + TIMED_STEPS)]
        start = create_train_state(model_cfg, train_cfg, "cpu",
                                   seed=train_cfg.seed).model.state_dict()
        moved = max(float((p.detach().cpu() - start[n]).abs().max())
                    for n, p in state.model.named_parameters())
        log(f"{what} training step, batch {train_cfg.batch_size}, "
            f"{train_cfg.image_size[0]}x{train_cfg.image_size[1]}, iters "
            f"{train_cfg.train_iters}: seconds per step median "
            f"{statistics.median(steps):.4f} (steps {[round(t, 4) for t in steps]}"
            f"; warm-up {marks[1] - marks[0]:.3f}), peak memory {peak:.2f} "
            f"GiB, launches over {TIMED_STEPS} steps {launched}; losses "
            f"{[round(m['loss'], 4) for m in seen]}, grad_norms "
            f"{[round(m['grad_norm'], 3) for m in seen]}; largest "
            f"parameter move {moved:.3e}")
        if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                   for m in seen) or len(seen) != 1 + TIMED_STEPS:
            raise AssertionError(f"{what}: bad metrics {seen}")
        if not moved > 0:
            raise AssertionError(f"{what}: the parameters did not move")
        return launched, statistics.median(steps), peak

    iters_t = TRAIN_ITERS
    train_launches, train_s, train_peak = drive_training(
        RaftStereoConfig(), "default")
    want = {"lookup": iters_t, "lookup_bwd": iters_t, "gates": 6 * iters_t,
            "alt": 0, "alt_bwd": 0}
    if train_launches != {n: TIMED_STEPS * v for n, v in want.items()}:
        raise AssertionError(f"default training launches {train_launches}")
    log(f"default training: lookup backward kernel share of the step "
        f"~{100 * iters_t * lbwd_t['ms'] / 1e3 / train_s:.1f}% ({iters_t} x "
        f"{lbwd_t['ms']:.4f} ms with L2 flushed)")

    rt_train_launches, rt_train_s, rt_train_peak = drive_training(
        RaftStereoConfig.realtime(), "realtime")
    want = {"lookup": 0, "lookup_bwd": 0, "gates": 6 * iters_t,
            "alt": iters_t, "alt_bwd": iters_t}
    if rt_train_launches != {n: TIMED_STEPS * v for n, v in want.items()}:
        raise AssertionError(f"realtime training launches "
                             f"{rt_train_launches}")
    log(f"realtime training: alt backward kernel share of the step "
        f"~{100 * iters_t * alt_bwd_time['bf16']['ms'] / 1e3 / rt_train_s:.1f}"
        f"%")

    # ----------------------------------------------------------- phase 15
    small_tc = TrainConfig(batch_size=1, train_iters=2, image_size=(64, 128))
    small_batch = SyntheticStereoLoader(1, (64, 128), seed=SEED).batch(0)
    step_launches = {}
    for what, cfg_ in (("default", RaftStereoConfig()),
                       ("realtime fp32", dataclasses.replace(
                           RaftStereoConfig.realtime(),
                           mixed_precision=False))):
        weights = create_train_state(cfg_, small_tc, "cpu",
                                     seed=SEED).model.state_dict()
        def one_step(dev_, cfg__=cfg_, w=weights):
            st = create_train_state(cfg__, small_tc, dev_, state_dict=w)
            st, m = train_step(st, small_batch, iters=2, loss_gamma=0.9,
                               max_flow=700.0)
            return ({k_: float(v) for k_, v in m.items()},
                    {n: p.grad.detach().cpu() for n, p in
                     st.model.named_parameters()})

        cm, cg = one_step(torch.device("cpu"))
        zero_counts()
        gm, gg = one_step(dev)
        step_launches[what] = counts()
        with torch.backends.cudnn.flags(enabled=False):
            _, native_g = one_step(dev)
        _, plain_g = one_step(dev, dataclasses.replace(cfg_,
                                                       fused_gru="off"))
        ulp_gen = torch.Generator().manual_seed(SEED)
        moved = {n: t * (1 + 2.0 ** -23 * (2 * torch.randint(
                     0, 2, t.shape, generator=ulp_gen) - 1))
                 for n, t in weights.items()}
        _, ulp_g = one_step(dev, w=moved)
        loss_err = abs(gm["loss"] - cm["loss"]) / cm["loss"]
        norm_err = abs(gm["grad_norm"] - cm["grad_norm"]) / cm["grad_norm"]
        gaps = leaf_errs(gg, cg)
        spreads = {"cuDNN vs native convs": leaf_errs(native_g, gg),
                   "gate kernel vs plain gate convs": leaf_errs(plain_g, gg),
                   "weights moved by one ulp": leaf_errs(ulp_g, gg)}
        spread = max(v[0][0] for v in spreads.values())
        leaf_limit = max(STEP_LEAF_RTOL, STEP_SPREAD_FACTOR * spread)
        ok = (loss_err <= STEP_LOSS_RTOL and norm_err <= STEP_NORM_RTOL
              and gaps[0][0] <= leaf_limit)

        def top(errs):
            return ", ".join(f"{n} {e:.2e}" for e, n in errs[:3])

        log(f"card vs CPU, one {what} step, 64x128, iters 2: loss "
            f"{gm['loss']:.6f} vs {cm['loss']:.6f} (rel {loss_err:.2e}, "
            f"limit {STEP_LOSS_RTOL}), grad_norm {gm['grad_norm']:.5f} vs "
            f"{cm['grad_norm']:.5f} (rel {norm_err:.2e}, limit "
            f"{STEP_NORM_RTOL}), largest leaf differences [{top(gaps)}] "
            f"against the card's own spread {spread:.3e} (limit "
            f"{leaf_limit:.3e}); card launches {step_launches[what]}: "
            f"{'ok' if ok else 'FAILED'}")
        for name_, errs in spreads.items():
            log(f"  card spread, {name_}: [{top(errs)}]")
        if not ok:
            raise AssertionError(f"{what} step: card and CPU disagree")
    if step_launches["realtime fp32"]["alt_bwd"] != 2:
        raise AssertionError("the realtime fp32 step must launch the fp32 "
                             "alt backward twice")

    # ----------------------------------------------------------- phase 16
    def q_codes(x, q_dtype):
        """Per-tensor dynamic quantization in x's dtype, as the model does:
        (codes, scale)."""
        qmax = 127.0 if q_dtype == torch.int8 else qcore.FP8_QMAX
        sc = qcore.dynamic_scale(x, qmax=qmax)
        if q_dtype == torch.int8:
            return qcore.quantize_symmetric(x, sc), sc
        return qcore.quantize_fp8(x, sc, q_dtype), sc

    def rel_check(got, want, rtol):
        """(max |got - want| / max |want|, whether it is within rtol)."""
        err = max_rel_err(got, want)
        return err, err <= rtol

    q_types = ((torch.int8, "int8"), (torch.float8_e4m3fn, "fp8"))
    lq_cases, lq_err = {}, {}
    for q_dtype, tag in q_types:
        pairs = [q_codes(v, q_dtype) for v in pyramid]
        levels_q = [p_[0] for p_ in pairs]
        scales = torch.stack([p_[1].float() for p_ in pairs])
        lq_cases[tag] = levels_q
        calls = [(levels_q, coords, "all levels")] + [
            ([v], coords / 2 ** i, f"level {i} alone (scale 1/{2 ** i})")
            for i, v in enumerate(levels_q)]
        worst = 0.0
        for lv, cc, what in calls:
            got = lookup_pyramid_fused_q(lv, cc, RADIUS, torch.float32)
            torch.cuda.synchronize()
            want = lookup_pyramid_xla(lv, cc, RADIUS, torch.float32)
            err, ok = rel_check(got, want, LOOKUP_Q_RTOL)
            log(f"lookup {tag} levels, {what}: max |kernel - plain| / scale "
                f"= {err:.3e} (rtol {LOOKUP_Q_RTOL})")
            if got.dtype != torch.float32 or not ok:
                raise AssertionError(f"{tag} lookup kernel disagrees: {err}")
            worst = max(worst, float((got - want).abs().max()))
        # The scaled kernel output against the plain reference of the reg
        # backend (levels dequantized, then sampled); the same check must
        # catch the scale vector left out.
        raw = lookup_pyramid_fused_q(levels_q, coords, RADIUS, torch.float32)
        deq = [q_.float() * sc for q_, sc in zip(levels_q, scales)]
        ref = lookup_pyramid_xla(deq, coords, RADIUS)
        scale_vec = scales.repeat_interleave(2 * RADIUS + 1)
        err_scaled, ok_scaled = rel_check(raw * scale_vec, ref, SCALED_RTOL)
        err_unscaled, ok_unscaled = rel_check(raw, ref, SCALED_RTOL)
        log(f"lookup {tag}: kernel x scale vector vs dequantize-then-sample "
            f"{err_scaled:.3e}; without the scale vector {err_unscaled:.3e} "
            f"(must fail: {'caught' if not ok_unscaled else 'NOT caught'})")
        if not ok_scaled or ok_unscaled:
            raise AssertionError(f"{tag} lookup scale check")
        lq_err[tag] = worst

    def alt_q_case(q_dtype, b, h, w1, w2, d):
        """bf16 features pooled in bf16, each quantized per tensor (the
        model's alt path): (f1 codes, level codes, centers, the levels'
        combined scales s1*s2_l as the model computes them)."""
        f1 = torch.randn((b, h, w1, d), generator=gen).to(dev, torch.bfloat16)
        pyr = [torch.randn((b, h, w2, d), generator=gen).to(
            dev, torch.bfloat16)]
        for _ in range(LEVELS - 1):
            pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
        f1_q, s1 = q_codes(f1, q_dtype)
        pq = [q_codes(v, q_dtype) for v in pyr]
        c = (torch.rand((b, h, w1), generator=gen) * (w2 + 20) - 10).to(dev)
        combined = [(s1 * s2).float() for _, s2 in pq]
        return f1_q, [q_ for q_, _ in pq], c, combined

    aq_cases, aq_err = {}, {}
    for q_dtype, tag in q_types:
        rtol = ALT_Q_RTOL[tag]
        worst_abs = 0.0
        for shape in ((1, RT_ROWS, RT_W1, RT_W1, RT_D), (1, 3, 37, 43, 64)):
            f1_q, pq, c, combined = alt_q_case(q_dtype, *shape)
            if shape[1] == RT_ROWS:
                aq_cases[tag] = (f1_q, pq, c)
            calls = [(pq, c, "all levels")] + [
                ([v], c / 2 ** i, f"level {i} alone")
                for i, v in enumerate(pq)]
            for lv, cc, what in calls:
                got = alt_lookup_fused_q(f1_q, lv, cc, RADIUS, torch.float32)
                torch.cuda.synchronize()
                want = alt_lookup_xla(f1_q, lv, cc, RADIUS, torch.float32)
                err, ok = rel_check(got, want, rtol)
                log(f"alt {tag}, (B,H,W1,W2,D) {shape}, {what}: max |kernel "
                    f"- plain| / scale = {err:.3e} (rtol {rtol})")
                if got.dtype != torch.float32 or not ok:
                    raise AssertionError(f"{tag} alt kernel disagrees: {err}")
                worst_abs = max(worst_abs, float((got - want).abs().max()))
            # Dequantized features, level by level (left codes times the
            # level's combined scale), against the scaled kernel output.
            raw = alt_lookup_fused_q(f1_q, pq, c, RADIUS, torch.float32)
            ref = torch.cat([alt_lookup_xla(f1_q.float() * sc, [v], c / 2 ** i,
                                            RADIUS)
                             for i, (v, sc) in enumerate(zip(pq, combined))],
                            dim=-1)
            vec = torch.stack(combined).repeat_interleave(2 * RADIUS + 1)
            err_scaled, ok_scaled = rel_check(raw * vec, ref, SCALED_RTOL)
            err_unscaled, ok_unscaled = rel_check(raw, ref, SCALED_RTOL)
            log(f"alt {tag} {shape}: kernel x scale vector vs the dequantized "
                f"features {err_scaled:.3e}; without the scale vector "
                f"{err_unscaled:.3e} (must fail: "
                f"{'caught' if not ok_unscaled else 'NOT caught'})")
            if not ok_scaled or ok_unscaled:
                raise AssertionError(f"{tag} alt scale check")
        aq_err[tag] = worst_abs

    gemm_cases = [("realtime cnet conv1 7x7/2", (2, 3) + PADDED_HW, 64, 7,
                   2), ("conv2_out 3x3 128->256", (2, 128, RT_ROWS, RT_W1),
                        256, 3, 1)]
    for what, xshape, cout, kk, stride in gemm_cases:
        xq = torch.randint(-127, 128, xshape, generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, xshape[1], kk, kk),
                           generator=gen, dtype=torch.int8)
        got = int8_conv_int32(xq.to(dev), wq.to(dev), stride, kk // 2)
        torch.cuda.synchronize()
        want = int8_conv_int32(xq, wq, stride, kk // 2)
        same = torch.equal(got.cpu(), want)
        log(f"int8 GEMM conv, {what}, x {tuple(xshape)}: int32 accumulator "
            f"bit-equal to the exact CPU conv: {same}")
        if not same:
            raise AssertionError(f"int8 GEMM conv disagrees ({what})")

    # ----------------------------------------------------------- phase 17
    lq_time = {}
    for tag, levels_q in lq_cases.items():
        lsrc = [v.reshape(-1, 1, 1, v.shape[-1]) for v in levels_q]

        def lookup_q_library(src=lsrc):
            return torch.cat([F.grid_sample(s_.float(), g_, mode="bilinear",
                                            padding_mode="zeros",
                                            align_corners=True)
                              for s_, g_ in zip(src, grids)], dim=-1)

        t = timed(lambda: lookup_pyramid_fused_q(
            levels_q, coords, RADIUS, torch.float32),
            lambda: lookup_pyramid_xla(levels_q, coords, RADIUS,
                                       torch.float32),
            lookup_q_library, flush)
        k_out = LEVELS * (2 * RADIUS + 1)
        nbytes = (window_bins(coords, w2s) + coords.numel() * 4
                  + coords.numel() * k_out * 4)
        t["bound"], t["by"] = nbytes / MEM_RATE * 1e3, "bytes"
        lq_time[tag] = t
        log(f"lookup {tag} timing: "
            + describe(t, "grid_sample x4 (fp32 upcast)", t["bound"],
                       "bytes") +
            f"; {nbytes / 1e6:.2f} MB")
        alone(f"lookup {tag}", lambda: lookup_pyramid_fused_q(
            levels_q, coords, RADIUS, torch.float32), t["bound"])
    aq_time = {}
    for tag, (f1_q, pq, c) in aq_cases.items():
        t = timed(lambda: alt_lookup_fused_q(f1_q, pq, c, RADIUS,
                                             torch.float32),
                  lambda: alt_lookup_xla(f1_q, pq, c, RADIUS, torch.float32),
                  lambda: alt_library(f1_q, pq, c), flush)
        t["bound"], t["by"], nbytes, ops = alt_bound(f1_q, pq, c, 4, True)
        aq_time[tag] = t
        log(f"alt {tag} timing: "
            + describe(t, "grid_sample formulation (fp32 upcast)",
                       t["bound"], t["by"]) +
            f"; {nbytes / 1e6:.2f} MB: {nbytes / MEM_RATE * 1e3:.5f} ms; "
            f"{ops / 1e6:.1f} M operations at the int8/fp8 tensor rate: "
            f"{ops / INT8_RATE * 1e3:.6f} ms")
        fields = {"random": c, "coherent": coherent_centers(
            gen, 1, RT_ROWS, RT_W1).to(dev)}
        t["fields"] = alt_fields(
            f"alt {tag} (1,{RT_ROWS},{RT_W1}) D {RT_D}",
            lambda c_: alt_lookup_fused_q(f1_q, pq, c_, RADIUS,
                                          torch.float32),
            f1_q, pq, fields, 4, quantized=True)

    # ------------------------------------------------------ phases 18, 19
    def q_counts():
        return {"lookup": lookup_pyramid_fused.launches,
                "lookup_q": lookup_pyramid_fused_q.launches,
                "alt": alt_lookup_fused.launches,
                "alt_q": alt_lookup_fused_q.launches,
                "gates": gru_gates_fused.launches,
                "gemm": int8_conv_int32.launches}

    def zero_q_counts():
        for fn in (lookup_pyramid_fused, lookup_pyramid_fused_q,
                   alt_lookup_fused, alt_lookup_fused_q, gru_gates_fused,
                   int8_conv_int32):
            fn.launches = 0

    def drive_quant(what, cfg_, state_, iters, quant, want, **kw):
        """The runner on the 375x1242 pair: a warm-up, then one pair with
        the counts zeroed before it and read after it, then 5 timed
        pairs.  Returns (counts, median seconds, peak GiB), the peak being
        the call's own: device memory allocated above what was allocated
        before it (earlier phases leave tensors alive)."""
        runner_ = InferenceRunner(cfg_, state_, iters=iters, device="cuda",
                                  quant=quant, **kw)
        runner_(left, right)
        zero_q_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        flow_, _ = runner_(left, right)
        got = q_counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        secs_ = [runner_(left, right)[1] for _ in range(5)]
        log(f"{what}, {MAIN_HW[0]}x{MAIN_HW[1]} (padded 384x1248), iters "
            f"{iters}: launches {got}; seconds per pair median "
            f"{statistics.median(secs_):.5f} (runs "
            f"{[round(t, 5) for t in secs_]}), peak memory {peak:.3f} GiB; "
            f"flow range [{flow_.min():.2f}, {flow_.max():.2f}]")
        if flow_.shape != MAIN_HW or not np.isfinite(flow_).all():
            raise AssertionError(f"{what}: bad flow")
        if got != want:
            raise AssertionError(f"{what}: launches {got}, want {want}")
        return got, statistics.median(secs_), peak

    n_enc = sum(1 for m_ in RAFTStereo(dataclasses.replace(
        rt_cfg, quant="int8_mxu")).modules()
        if isinstance(m_, Conv2d) and m_.quant == "int8_mxu")
    log(f"realtime int8_mxu: {n_enc} encoder convs run the int8 GEMM, once "
        f"per pair each")
    want_rt = {"lookup": 0, "lookup_q": 0, "alt": 0, "alt_q": RT_ITERS,
               "gates": 3 * RT_ITERS, "gemm": n_enc}
    quant_runs = {}
    quant_runs["rt bf16"] = drive_quant(
        "realtime bf16, unquantized (for comparison)", rt_cfg, rt_state,
        RT_ITERS, "off", dict(want_rt, alt=RT_ITERS, alt_q=0, gemm=0))
    quant_runs["rt int8"] = drive_quant(
        "realtime int8_mxu (int8 features)", rt_cfg, rt_state, RT_ITERS,
        "int8_mxu", want_rt)
    t0 = time.perf_counter()
    rt_record = calibrate(rt_cfg, rt_state, [(left, right)], device="cuda")
    act_scales = conv_input_scales(rt_record)
    log(f"calibrate() of the realtime preset on the seeded pair: "
        f"{time.perf_counter() - t0:.1f} s, {len(rt_record['activations'])} "
        f"sites, {len(act_scales)} conv input scales")
    quant_runs["rt calibrated"] = drive_quant(
        "realtime int8_mxu, calibrated input scales", rt_cfg, rt_state,
        RT_ITERS, "int8_mxu", want_rt, quant_act_scales=act_scales)
    quant_runs["rt fp8"] = drive_quant(
        "realtime int8_mxu (fp8 features)",
        dataclasses.replace(rt_cfg, quant_corr_fp8=True), rt_state, RT_ITERS,
        "int8_mxu", want_rt)

    want_def = {"lookup": 0, "lookup_q": MAIN_ITERS, "alt": 0, "alt_q": 0,
                "gates": 3 * MAIN_ITERS, "gemm": 0}
    quant_runs["def fp32"] = drive_quant(
        "default fp32, unquantized (for comparison)", cfg, state,
        MAIN_ITERS, "off", dict(want_def, lookup=MAIN_ITERS, lookup_q=0))
    quant_runs["def int8"] = drive_quant(
        "default int8 (int8 pyramid)", cfg, state, MAIN_ITERS, "int8",
        want_def)
    t0 = time.perf_counter()
    def_scales = corr_scales(calibrate(cfg, state, [(left, right)],
                                       device="cuda"))
    log(f"calibrate() of the default config on the seeded pair: "
        f"{time.perf_counter() - t0:.1f} s; quant_corr_scales "
        f"{[round(x_, 6) for x_ in def_scales]}")
    quant_runs["def calibrated"] = drive_quant(
        "default int8, calibrated pyramid scales",
        dataclasses.replace(cfg, quant_corr_scales=def_scales), state,
        MAIN_ITERS, "int8", want_def)
    quant_runs["def fp8"] = drive_quant(
        "default int8 (fp8 pyramid)",
        dataclasses.replace(cfg, quant_corr_fp8=True), state, MAIN_ITERS,
        "int8", want_def)

    # ----------------------------------------------------------- phase 20
    captured = []
    real_make_corr_fn = raft_module.make_corr_fn

    def capturing_make_corr_fn(*args):
        fn = real_make_corr_fn(*args)
        captured.append([c_.float().cpu() for c_ in fn.codes])
        return fn

    raft_module.make_corr_fn = capturing_make_corr_fn
    ulp_gen = torch.Generator().manual_seed(SEED)
    variants = (("realtime int8_mxu int8", rt_cfg, rt_state, "int8_mxu"),
                ("realtime int8_mxu fp8", dataclasses.replace(
                    rt_cfg, quant_corr_fp8=True), rt_state, "int8_mxu"),
                ("default int8 int8", cfg, state, "int8"),
                ("default int8 fp8", dataclasses.replace(
                    cfg, quant_corr_fp8=True), state, "int8"))
    try:
        for what, cfg_, state_, quant in variants:
            moved = {n_: t_ * (1 + 2.0 ** -23 * (2 * torch.randint(
                0, 2, t_.shape, generator=ulp_gen) - 1))
                for n_, t_ in state_.items()}
            captured.clear()
            on_card = InferenceRunner(cfg_, state_, iters=2, device="cuda",
                                      quant=quant)(small, small_r)[0]
            on_cpu = InferenceRunner(cfg_, state_, iters=2, device="cpu",
                                     quant=quant)(small, small_r)[0]
            card_codes, cpu_codes = captured
            ulp = InferenceRunner(cfg_, moved, iters=2, device="cuda",
                                  quant=quant)(small, small_r)[0]
            flipped = sum(int((a_ != b_).sum())
                          for a_, b_ in zip(card_codes, cpu_codes))
            total = sum(a_.numel() for a_ in card_codes)
            spread, err = np.abs(ulp - on_card), np.abs(on_card - on_cpu)
            ok = (err.max() <= Q_SPREAD_FACTOR * spread.max()
                  and err.mean() <= Q_SPREAD_FACTOR * spread.mean()
                  and np.isfinite(on_card).all())
            log(f"card vs CPU, {what}, 128x256, iters 2: max / mean |Δflow| "
                f"= {err.max():.4e} / {err.mean():.4e} px; the card's spread "
                f"(weights moved by one fp32 ulp) {spread.max():.4e} / "
                f"{spread.mean():.4e} px (limit {Q_SPREAD_FACTOR}x); "
                f"correlation codes flipped card vs CPU {flipped} of {total} "
                f"({100 * flipped / total:.4f}%); flow range "
                f"[{on_cpu.min():.2f}, {on_cpu.max():.2f}]: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"{what}: card and CPU disagree")
    finally:
        raft_module.make_corr_fn = real_make_corr_fn

    def row(name_, source, replaces, launched, err, t, design=None):
        """One entry of the kernels line; ``t`` holds graph-replay times."""
        out = {"name": name_, "route": "cuda",
               "source": f"raft_stereo_tpu_torch/csrc/{source}",
               "replaces": f"raft_stereo_tpu/kernels/{replaces}",
               "launches": launched, "max_abs_err": err, "ms": t["ms"],
               "plain_ms": t["plain"], "bound_ms": t["bound"],
               "bound_by": t["by"], "library_ms": t["lib"]}
        # the alt rows' center fields and 20-call replays (phases 8, 17),
        # the lookup backward's write floor (phase 12)
        for key in ("fields", "write_floor_ms"):
            if key in t:
                out[key] = t[key]
        if design:
            out["design"] = design
        return out

    lookup_t.update(bound=lookup_bound_ms, by="bytes")
    lbwd_t.update(bound=lbwd_bound, by="bytes")
    kernels = [
        row("corr_lookup", "corr_lookup.cu", "corr_lookup.py:293",
            launches["lookup"], lookup_err, lookup_t,
            "a thread per pixel and level"),
        row("gru_gates", "gru_gates.cu", "gru_fused.py:153",
            launches["gates"], gates_err, gates_fp32,
            "wgmma implicit GEMM, 3xTF32"),
        row("gru_gates_bf16", "gru_gates.cu", "gru_fused.py:153",
            rt_launches["gates"], gates_bf16_err, gates_bf16,
            "wgmma implicit GEMM"),
        row("corr_alt", "corr_alt.cu", "corr_alt.py:273", rt_launches["alt"],
            alt_err["bf16"], alt_time["bf16"],
            "row tiles, bands in shared memory, mma.sync bf16 dots"),
        row("corr_alt_fp32", "corr_alt.cu", "corr_alt.py:75",
            deep_launches["alt"], alt_err["fp32"], alt_time["fp32"],
            "row tiles, bands in shared memory, CUDA-core dots"),
        row("corr_lookup_bwd", "corr_lookup.cu", "corr_lookup.py:304",
            train_launches["lookup_bwd"], lookup_bwd_err, lbwd_t,
            "16-byte runs of the flat dV, window sums staged per block"),
        row("corr_alt_bwd", "corr_alt.cu", "corr_alt.py:90",
            rt_train_launches["alt_bwd"], alt_bwd_err["bf16"],
            alt_bwd_time["bf16"],
            "tensor cores, weights split in two bf16 parts"),
        row("corr_alt_bwd_fp32", "corr_alt.cu", "corr_alt.py:90",
            step_launches["realtime fp32"]["alt_bwd"], alt_bwd_err["fp32"],
            alt_bwd_time["fp32"],
            "CUDA cores, pixels bucketed by window start"),
    ]
    for tag in ("int8", "fp8"):
        kernels.append(row(f"corr_lookup_q_{tag}", "corr_lookup.cu",
                           "corr_lookup.py:321",
                           quant_runs[f"def {tag}"][0]["lookup_q"],
                           lq_err[tag], lq_time[tag],
                           "a thread per pixel and level"))
    for tag in ("int8", "fp8"):
        kernels.append(row(f"corr_alt_q_{tag}", "corr_alt.cu",
                           "corr_alt.py:411",
                           quant_runs[f"rt {tag}"][0]["alt_q"], aq_err[tag],
                           aq_time[tag],
                           "row tiles, bands in shared memory, mma.sync "
                           + ("s8 dots" if tag == "int8" else
                              "bf16 dots of the upcast codes")))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
