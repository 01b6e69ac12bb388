#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (raft_stereo_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero without them,
and imports nothing of JAX or of the JAX package.  Phases, each of which
fails the run when it fails:

1. print the card (name, power limit) and versions; build every CUDA
   kernel from csrc/, one nvcc per source, all started together;
2. the pyramid-lookup kernel against its plain version at the main-path
   shapes (96 rows, W1 312, W2 312/156/78/39, radius 4), all four levels
   in one call and each level alone at scale 1/2^i;
3. the ConvGRU gate kernel against its plain version at the gru08, gru16
   and gru32 shapes of a 384x1248 input;
4. timings of both kernels at those shapes: the kernel, its plain
   version, one PyTorch library yardstick the port never calls, and the
   bound from bytes or operations;
5. the main path: ``InferenceRunner`` on the default config at full
   width with seeded random weights, on a 375x1242 pair (padded to
   384x1248) at 32 iterations; checks the output and that the lookup ran
   32 times and the gate kernel 96 times; prints seconds per pair;
6. the same seeded model on the card and on the CPU (plain versions) at
   128x256 and 2 iterations, compared against a stated tolerance.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.  The fp32 path is full fp32:
TF32 is switched off for matmuls and cuDNN convs.
"""

from __future__ import annotations

import json
import os
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
# (name, H, W, Cx) of the three GRU levels at 1/4, 1/8, 1/16; Ch = 128
GRU_LEVELS = (("gru08", 96, 312, 256), ("gru16", 48, 156, 256),
              ("gru32", 24, 78, 128))
CH = 128
LOOKUP_ATOL = 1e-5
GATES_ATOL = 1e-4       # sums over up to 9*384 = 3456 fp32 products
CARD_VS_CPU_ATOL = 1e-2  # two iterations of random weights; see phase 6
MAIN_HW = (375, 1242)
MAIN_ITERS = 32
# Published peaks of the H100 SXM (NVIDIA data sheet, 700 W): memory
# bytes/s, and fp32 FLOP/s on the CUDA cores (no tensor cores: no TF32).
MEM_RATE = 3.35e12
FP32_RATE = 67e12


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


def lookup_bytes(coords, w2s) -> int:
    """Bytes the lookup must move for these centers: each distinct volume
    bin a window touches (read once), the centers, and the output."""
    total = 0
    for i, w2 in enumerate(w2s):
        c = coords.double() / 2 ** i
        lo = torch.floor(c - RADIUS).clamp(0, w2 - 1)
        hi = (torch.floor(c + RADIUS) + 1).clamp(0, w2 - 1)
        inside = (torch.floor(c + RADIUS) + 1 >= 0) & (
            torch.floor(c - RADIUS) <= w2 - 1)
        total += int(torch.where(inside, hi - lo + 1, 0).sum()) * 4
    k = LEVELS * (2 * RADIUS + 1)
    return total + coords.numel() * 4 * (1 + k)


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
    from raft_stereo_tpu_torch.config import RaftStereoConfig
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner, full_fp32
    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.kernels.corr_lookup import (
        lookup_pyramid_fused, lookup_pyramid_xla)
    from raft_stereo_tpu_torch.kernels.gru_fused import (_gates_reference,
                                                         gru_gates_fused)
    from raft_stereo_tpu_torch.models.corr import build_corr_pyramid
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

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
        report = _build.library_path(src).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)

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
    for lvl, h, w, cx in GRU_LEVELS:
        cin = CH + cx
        ws = (2 / (9 * cin)) ** 0.5

        def rnd(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen)).to(dev)

        args = (torch.tanh(rnd(1, h, w, CH)), rnd(1, h, w, cx),
                rnd(1, h, w, CH), rnd(3, 3, cin, 2 * CH, scale=ws),
                rnd(2 * CH, scale=0.1), rnd(3, 3, cin, CH, scale=ws),
                rnd(CH, scale=0.1))
        gate_cases[lvl] = args
        got = gru_gates_fused(*args)
        torch.cuda.synchronize()
        want = _gates_reference(*args)
        want64 = _gates_reference(*(a.double() for a in args))
        err = max(float((g - wv).abs().max()) for g, wv in zip(got, want))
        err64 = max(float((g.double() - wv).abs().max())
                    for g, wv in zip(got, want64))
        log(f"gates {lvl} (1,{h},{w}) Cin {cin}: max |kernel - plain| = "
            f"{err:.3e} (atol {GATES_ATOL}); kernel vs fp64 {err64:.3e}")
        gates_err = max(gates_err, err)
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
    lookup_ms = time_ms(lambda: lookup_pyramid_fused(pyramid, coords, RADIUS),
                        flush)
    lookup_plain_ms = time_ms(
        lambda: lookup_pyramid_xla(pyramid, coords, RADIUS), flush)
    lookup_lib_ms = time_ms(lookup_library, flush)
    lookup_bound_ms = lookup_bytes(coords, w2s) / MEM_RATE * 1e3
    log(f"lookup timing: kernel {lookup_ms:.4f} ms, plain "
        f"{lookup_plain_ms:.4f} ms, grid_sample x4 {lookup_lib_ms:.4f} ms, "
        f"bound {lookup_bound_ms:.4f} ms (bytes)")

    gates_ms = gates_plain_ms = gates_lib_ms = gates_bound_ms = 0.0
    gates_bound_by = "operations"
    for lvl, h, w, cx in GRU_LEVELS:
        args = gate_cases[lvl]
        cin = CH + cx
        nchw = [a.permute(0, 3, 1, 2).contiguous() for a in args[:3]]
        oihw = [args[3].permute(3, 2, 0, 1).contiguous(), args[4],
                args[5].permute(3, 2, 0, 1).contiguous(), args[6]]

        def gates_library(hh=nchw[0], xx=nchw[1], cr=nchw[2]):
            zr = F.conv2d(torch.cat([hh, xx], 1), oihw[0], oihw[1],
                          padding=1)
            r = torch.sigmoid(zr[:, CH:] + cr)
            return zr, F.conv2d(torch.cat([r * hh, xx], 1), oihw[2],
                                oihw[3], padding=1)

        ms = time_ms(lambda: gru_gates_fused(*args), flush)
        plain = time_ms(lambda: _gates_reference(*args), flush)
        lib = time_ms(gates_library, flush)
        flops = 2 * h * w * 9 * cin * 3 * CH
        nbytes = 4 * (h * w * (CH + cx + CH + 3 * CH)
                      + 9 * cin * 3 * CH + 3 * CH)
        ops_ms, bytes_ms = flops / FP32_RATE * 1e3, nbytes / MEM_RATE * 1e3
        log(f"gates timing {lvl}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"conv2d x2 {lib:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms "
            f"({flops / 1e9:.2f} GFLOP: {flops / ms / 1e9:.2f} TFLOP/s)")
        gates_ms += ms
        gates_plain_ms += plain
        gates_lib_ms += lib
        gates_bound_ms += max(ops_ms, bytes_ms)
        if bytes_ms > ops_ms:
            gates_bound_by = "bytes"

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
    torch.cuda.reset_peak_memory_stats()
    flow, _ = runner(left, right)
    launches = {"lookup": lookup_pyramid_fused.launches,
                "gates": gru_gates_fused.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"main path {MAIN_HW[0]}x{MAIN_HW[1]} (padded 384x1248), "
        f"iters {MAIN_ITERS}: launches {launches}, peak memory "
        f"{peak_gib:.2f} GiB")
    if flow.shape != MAIN_HW or not np.isfinite(flow).all():
        raise AssertionError(f"bad flow: shape {flow.shape}, finite "
                             f"{np.isfinite(flow).all()}")
    if launches != {"lookup": MAIN_ITERS, "gates": 3 * MAIN_ITERS}:
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

    kernels = [
        {"name": "corr_lookup", "route": "cuda",
         "source": "raft_stereo_tpu_torch/csrc/corr_lookup.cu",
         "replaces": "raft_stereo_tpu/kernels/corr_lookup.py:293",
         "launches": launches["lookup"], "max_abs_err": lookup_err,
         "ms": lookup_ms, "plain_ms": lookup_plain_ms,
         "bound_ms": lookup_bound_ms, "bound_by": "bytes",
         "library_ms": lookup_lib_ms},
        {"name": "gru_gates", "route": "cuda",
         "source": "raft_stereo_tpu_torch/csrc/gru_gates.cu",
         "replaces": "raft_stereo_tpu/kernels/gru_fused.py:153",
         "launches": launches["gates"], "max_abs_err": gates_err,
         "ms": gates_ms, "plain_ms": gates_plain_ms,
         "bound_ms": gates_bound_ms, "bound_by": gates_bound_by,
         "library_ms": gates_lib_ms},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
