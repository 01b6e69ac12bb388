#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on the card.

    python3 tools/torch_profile.py [--config default|realtime]

Runs ``InferenceRunner`` on a config (seeded random weights) on the
main-path shape of chip_smoke.py (375x1242): the default config at 32
iterations, or ``RaftStereoConfig.realtime()`` at its protocol depth of
7.  It runs once to warm up, then once under ``torch.profiler``, and
prints: the card, the wall seconds of the profiled call, the device time
summed over all kernels and its share of the wall time, and the kernels
that took the most device time (name, calls, total ms, share).  Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ITERS = {"default": 32, "realtime": 7}
HEIGHT, WIDTH = 375, 1242
TOP = 15


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", choices=sorted(ITERS), default="default")
    args = parser.parse_args(argv)
    iters = ITERS[args.config]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_stereo_tpu_torch.config import RaftStereoConfig
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.manual_seed(0)
    cfg = getattr(RaftStereoConfig, args.config)()
    runner = InferenceRunner(cfg, RAFTStereo(cfg), iters=iters,
                             device="cuda")
    rs = np.random.default_rng(0)
    left = rs.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    runner(left, right)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner(left, right)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies): the CPU-side operator
    # events carry their children's device time again.
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    print(f"card: {card}")
    print(f"{args.config} config {HEIGHT}x{WIDTH}, iters {iters}: "
          f"wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
          f"({100 * device_ms / wall_ms:.1f}% of wall)")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for ms, count, key in rows[:TOP]:
        print(f"{ms:10.3f} {100 * ms / device_ms:5.1f}% {count:6d}  "
              f"{key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
