"""Benchmark evaluation CLI of the PyTorch port (the JAX package's
``cli/evaluate.py``).

    python -m raft_stereo_tpu_torch.cli.evaluate \\
        --restore_ckpt models/raftstereo-eth3d.pth --dataset eth3d

``--restore_ckpt`` is a reference ``.pth`` file or a port checkpoint
directory.  Datasets: eth3d | kitti | things | middlebury_F |
middlebury_H | middlebury_Q.  KITTI also reports the FPS protocol (the
first 50 images discarded).  Runs on the CUDA card by default, one CUDA
graph per padded shape; ``--device cpu`` runs the plain versions.
The JAX package's sequence mode and adaptive early exit (``--sequence``,
``--stream_out``, ``--exit_threshold_px``, ``--min_iters``) are accepted
and raise: they wait for ROADMAP.md §D3.
"""

from __future__ import annotations

import argparse
import json
import logging

from raft_stereo_tpu_torch.cli import common

log = logging.getLogger(__name__)

_D3 = "§D3 early exit and state carry"


def run_eval(args) -> dict:
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner
    from raft_stereo_tpu_torch.eval.validate import (validate_eth3d,
                                                     validate_kitti,
                                                     validate_middlebury,
                                                     validate_things)

    for flag, on in (("--sequence", args.sequence),
                     ("--stream_out", args.stream_out is not None),
                     ("--exit_threshold_px",
                      args.exit_threshold_px is not None),
                     ("--min_iters", args.min_iters is not None)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch package yet "
                f"(ROADMAP.md {_D3})")
    overrides = common.arch_overrides(args)
    cfg, state = common.load_any_checkpoint(args.restore_ckpt, **overrides)
    log.info("model config: %s", cfg.to_dict())
    runner = InferenceRunner(cfg, state, iters=args.valid_iters,
                             fetch_dtype=args.fetch_dtype,
                             device=args.device)

    root = args.data_root
    if args.dataset == "eth3d":
        results = validate_eth3d(runner, root=f"{root}/ETH3D",
                                 max_images=args.max_images)
    elif args.dataset == "kitti":
        results = validate_kitti(runner, root=f"{root}/KITTI",
                                 max_images=args.max_images)
    elif args.dataset == "things":
        results = validate_things(runner, root=root,
                                  max_images=args.max_images)
    else:
        results = validate_middlebury(
            runner, root=f"{root}/Middlebury",
            split=args.dataset.removeprefix("middlebury_"),
            max_images=args.max_images)
    log.info("graphs: %d captured, %d replays", runner.captures,
             runner.replays)
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--restore_ckpt", required=True,
                   help="reference .pth file or port checkpoint directory")
    p.add_argument("--dataset", required=True,
                   choices=["eth3d", "kitti", "things", "middlebury_F",
                            "middlebury_H", "middlebury_Q"])
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--valid_iters", type=int, default=32,
                   help="GRU iterations (reference: --valid_iters)")
    p.add_argument("--exit_threshold_px", type=float, default=None,
                   help=f"not ported (ROADMAP.md {_D3}); raises")
    p.add_argument("--min_iters", type=int, default=None,
                   help=f"not ported (ROADMAP.md {_D3}); raises")
    p.add_argument("--fetch_dtype", default=None, choices=["fp16", "bf16"],
                   help="cast the disparity on the device before the "
                        "device->host copy (results stay fp32)")
    p.add_argument("--max_images", type=int, default=None,
                   help="evaluate only the first N images (smoke runs)")
    p.add_argument("--sequence", action="store_true",
                   help=f"not ported (ROADMAP.md {_D3}); raises")
    p.add_argument("--stream_out", default=None,
                   help=f"not ported (ROADMAP.md {_D3}); raises")
    p.add_argument("--json", action="store_true",
                   help="print results as one JSON line")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    common.add_arch_overrides(p)
    return p


def main(argv=None):
    common.setup_logging()
    args = build_parser().parse_args(argv)
    results = run_eval(args)
    if args.json:
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
