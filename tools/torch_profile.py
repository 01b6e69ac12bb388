#!/usr/bin/env python3
"""Where the time of the PyTorch port's main paths goes, on the card.

    python3 tools/torch_profile.py [--config default|realtime] [--train]
                                   [--quant int8|int8_mxu [--fp8]]

Without ``--train``: runs ``InferenceRunner`` on a config (seeded random
weights) on the main-path shape of chip_smoke.py (375x1242): the default
config at 32 iterations, or ``RaftStereoConfig.realtime()`` at its
protocol depth of 7; the profiled call is a replay of the runner's CUDA
graph (with ``--quant``, the runner's closure run eagerly, so that the
port's ranges are recorded).  With ``--train``: one training step
(``training/step.train_step``) of that config under ``TrainConfig()``
(batch 8, 320x720, 22 iterations) on a seeded synthetic batch.

It runs once to warm up, then once under ``torch.profiler``, and prints:
the card, the wall time of the profiled call, the device time summed over
all kernels and its share of the wall time (the rest is the device's idle
share), and the kernels that took the most device time (name, calls,
total ms, share).  For a training step it also splits the device time by
what launched each kernel: the forward (``raft::train_forward``), the
remat recompute (``raft::gru_iteration`` inside the backward), cuDNN's
convolution backward, the gate op's backward recomputing its plain twin,
the lookup/alt backward kernels, the adds that accumulate their volume or
feature gradients across iterations (inside the lookup's backward node),
the rest of the backward, and the update (``raft::clip_and_update``),
read from the step's Chrome trace (written to a temporary directory and
removed).  With ``--quant`` the inference runner runs the quantized tier
(``--fp8``: float8_e4m3fn correlation codes), and the device time is also
split by the port's ranges: the int8 convs (im2col and cuBLASLt's int8
GEMM), the quantization of their inputs, their fp32 rescale, the
dequantization of int8 weights, the quantization of the correlation, and
the 1-byte lookup kernels with their scaling.  Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ITERS = {"default": 32, "realtime": 7}
HEIGHT, WIDTH = 375, 1242
TOP = 15


# Training-step shares: (label, test on the kernel name and the names of
# the ranges and ops open on the launching thread when it was launched,
# outermost first), first match.
BWD_KERNELS = ("corr_lookup_bwd_kernel", "corr_alt_bwd_kernel")
LOOKUP_NODES = ("_LookupPyramidBackward", "_AltLookupBackward")
SHARES = (
    ("update (clip + AdamW)",
     lambda k, up: "raft::clip_and_update" in up),
    ("lookup/alt backward kernels",
     lambda k, up: any(b in k for b in BWD_KERNELS)),
    ("accumulation of their gradients",
     lambda k, up: any(n in u for u in up for n in LOOKUP_NODES)),
    ("remat recompute",
     lambda k, up: "raft::gru_iteration" in up
     and any(u.startswith("autograd::engine") for u in up)),
    ("forward", lambda k, up: "raft::train_forward" in up),
    ("cuDNN convolution backward",
     lambda k, up: any("convolution_backward" in u for u in up)),
    ("gates' backward: the twin's forward",
     lambda k, up: any("_GatesBackward" in u for u in up)),
    ("rest of the backward", lambda k, up: True),
)
# Inference shares of the quantized tier, by the port's ranges.
Q_KERNELS = ("corr_lookup_kernel", "corr_alt_kernel")
QUANT_SHARES = (
    ("1-byte lookup kernels (#1, #9)",
     lambda k, up: any(q in k for q in Q_KERNELS)),
    ("scaling of the lookup (x scale vector, cast)",
     lambda k, up: "raft::corr_lookup_q" in up),
    ("int8 convs (im2col, int8 GEMM)", lambda k, up: "raft::int8_conv" in up),
    ("quantization of conv inputs",
     lambda k, up: "raft::quantize_activation" in up),
    ("rescale + bias of int8 convs",
     lambda k, up: "raft::int8_rescale" in up),
    ("dequantization of int8 weights",
     lambda k, up: "raft::dequantize_weights" in up),
    ("quantization of the correlation",
     lambda k, up: "raft::quantize_corr" in up),
    ("rest", lambda k, up: True),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _shares(trace_path: str, shares=SHARES):
    """Device ms per ``shares`` label, read from the exported Chrome trace:
    each device event is joined by its correlation id to the runtime call
    that launched it, and labelled by the CPU ops and ranges open on that
    call's thread at that moment (a sweep over each thread's timeline)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    launch_of = {e["args"]["correlation"]: e for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    per_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in ("cpu_op", "user_annotation"):
            per_thread[e["tid"]].append((e["ts"], 0, e["name"]))
            per_thread[e["tid"]].append((e["ts"] + e["dur"], -1, e["name"]))
    for corr, e in launch_of.items():
        per_thread[e["tid"]].append((e["ts"], 1, corr))
    open_at = {}
    for points in per_thread.values():
        stack = []
        # ends before starts before launches at one timestamp
        for _, kind, what in sorted(points, key=lambda x: (x[0], x[1])):
            if kind == 0:
                stack.append(what)
            elif kind == -1:
                if what in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(what)]
            else:
                open_at[what] = list(stack)
    totals = {label: 0.0 for label, _ in shares}
    totals["not linked to a launch"] = 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        up = open_at.get(e.get("args", {}).get("correlation"))
        if up is None:
            totals["not linked to a launch"] += e["dur"] / 1e3
            continue
        for label, test in shares:
            if test(e["name"], up):
                totals[label] += e["dur"] / 1e3
                break
    return totals


def _is_range(name: str) -> bool:
    """A ``record_function`` range of the port: the profiler also shows it
    on the device timeline, spanning the kernels it contains (ranges that
    the profiler flags as user annotations are dropped by that flag)."""
    return name.startswith("raft::")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", choices=sorted(ITERS), default="default")
    parser.add_argument("--train", action="store_true",
                        help="profile one training step")
    parser.add_argument("--quant", choices=("int8", "int8_mxu"),
                        help="run the quantized inference tier")
    parser.add_argument("--fp8", action="store_true",
                        help="float8_e4m3fn correlation codes (--quant)")
    args = parser.parse_args(argv)
    if args.train and args.quant:
        parser.error("--quant profiles inference; the tier does not train")
    iters = ITERS[args.config]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner, full_fp32
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.training.state import create_train_state
    from raft_stereo_tpu_torch.training.step import train_step

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.manual_seed(0)
    cfg = getattr(RaftStereoConfig, args.config)()
    if args.fp8:
        cfg = dataclasses.replace(cfg, quant_corr_fp8=True)
    if args.train:
        full_fp32()
        tc = TrainConfig()
        state = create_train_state(cfg, tc, "cuda", seed=0)
        batch = SyntheticStereoLoader(tc.batch_size, tc.image_size).batch(0)
        what = (f"training step, batch {tc.batch_size}, "
                f"{tc.image_size[0]}x{tc.image_size[1]}, iters "
                f"{tc.train_iters}")

        def run():
            train_step(state, batch, iters=tc.train_iters,
                       loss_gamma=tc.loss_gamma, max_flow=tc.max_flow)
            torch.cuda.synchronize()
    else:
        runner = InferenceRunner(cfg, RAFTStereo(cfg), iters=iters,
                                 device="cuda", quant=args.quant)
        rs = np.random.default_rng(0)
        left = rs.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)
        right = np.roll(left, -4, axis=1)
        what = f"{HEIGHT}x{WIDTH}, iters {iters}"
        if args.quant:
            what += (f", quant {args.quant}, "
                     f"{'fp8' if args.fp8 else 'int8'} correlation")

        if args.quant:
            # The ranges of the split below are recorded only where Python
            # runs the forward: profile the runner's closure eagerly.
            from raft_stereo_tpu_torch.eval.runner import make_forward
            from raft_stereo_tpu_torch.ops.padding import InputPadder

            pl, pr, pt, pb = InputPadder((1, 3, HEIGHT, WIDTH),
                                         divis_by=32).pads
            spec = ((0, 0), (pt, pb), (pl, pr), (0, 0))
            images = [torch.from_numpy(np.pad(im[None], spec, mode="edge")
                                       ).cuda() for im in (left, right)]
            forward = make_forward(runner.model, iters)

            def run():
                with torch.inference_mode():
                    forward(*images).cpu()
        else:
            def run():  # a replay of the runner's CUDA graph
                runner(left, right)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies): the CPU-side operator
    # events carry their children's device time again.
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)
            and not _is_range(ev.key)]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    print(f"card: {card}")
    print(f"{args.config} config {what}: wall {wall_ms:.2f} ms, device "
          f"busy {device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f}% of "
          f"wall)")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for ms, count, key in rows[:TOP]:
        print(f"{ms:10.3f} {100 * ms / device_ms:5.1f}% {count:6d}  "
              f"{key[:110]}")
    if args.train or args.quant:
        with tempfile.TemporaryDirectory() as tmp:
            trace = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            shares = _shares(trace, SHARES if args.train else QUANT_SHARES)
        print(f"device time by what launched it (from the Chrome trace; "
              f"{sum(shares.values()):.2f} ms of device events):")
        for label, ms in shares.items():
            print(f"{ms:10.3f} {100 * ms / device_ms:5.1f}%  {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
