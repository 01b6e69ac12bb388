"""Benchmark evaluation CLI of the PyTorch port (the JAX package's
``cli/evaluate.py``).

    python -m raft_stereo_tpu_torch.cli.evaluate \\
        --restore_ckpt models/raftstereo-eth3d.pth --dataset eth3d

``--restore_ckpt`` is a reference ``.pth`` file or a port checkpoint
directory.  Datasets: eth3d | kitti | things | middlebury_F |
middlebury_H | middlebury_Q.  KITTI also reports the FPS protocol (the
first 50 images discarded).  Runs on the CUDA card by default, one CUDA
graph per padded shape; ``--device cpu`` runs the plain versions.
``--exit_threshold_px`` (with ``--min_iters``) turns on the early exit and
adds the mean ``iters_used`` to the results; ``--sequence`` runs the
dataset's frames in order, cold and warm-started
(``eval/validate.sequence_drift``), and ``--stream_out PATH`` writes that
row as a record (``telemetry/events.write_record``, with the run's versions and card).
"""

from __future__ import annotations

import argparse
import json
import logging

from raft_stereo_tpu_torch.cli import common

log = logging.getLogger(__name__)


def run_eval(args) -> dict:
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner
    from raft_stereo_tpu_torch.eval.validate import (sequence_drift,
                                                     validate_eth3d,
                                                     validate_kitti,
                                                     validate_middlebury,
                                                     validate_things)

    overrides = common.arch_overrides(args)
    cfg, state = common.load_any_checkpoint(args.restore_ckpt, **overrides)
    log.info("model config: %s", cfg.to_dict())
    runner = InferenceRunner(cfg, state, iters=args.valid_iters,
                             fetch_dtype=args.fetch_dtype,
                             exit_threshold_px=args.exit_threshold_px,
                             exit_min_iters=args.min_iters,
                             device=args.device)

    root = args.data_root
    if args.sequence:
        from raft_stereo_tpu_torch.data import datasets as ds

        if args.dataset == "eth3d":
            dataset = ds.ETH3D(root=f"{root}/ETH3D")
        elif args.dataset == "kitti":
            dataset = ds.KITTI(root=f"{root}/KITTI")
        elif args.dataset == "things":
            dataset = ds.SceneFlow(root=root, dstype="frames_finalpass",
                                   things_test=True)
        else:
            dataset = ds.Middlebury(
                root=f"{root}/Middlebury",
                split=args.dataset.removeprefix("middlebury_"))
        results = sequence_drift(runner, dataset, args.dataset,
                                 max_images=args.max_images)
        if args.stream_out:
            from raft_stereo_tpu_torch.telemetry.events import write_record
            write_record(args.stream_out, {
                "metric": "warm_start_sequence_drift",
                "value": results[f"{args.dataset}-warm-drift-epe"],
                "unit": "EPE(warm chained) - EPE(cold per-frame), px",
                "dataset": args.dataset,
                "valid_iters": args.valid_iters,
                "exit_threshold_px": args.exit_threshold_px,
                "min_iters": args.min_iters,
                "results": {k: round(v, 5) for k, v in results.items()},
            }, indent=1, device=runner.device)
            log.info("sequence-drift record -> %s", args.stream_out)
        return results
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
    if runner.iters_used_mean() is not None:
        results[f"{args.dataset}-iters-used-mean"] = round(
            runner.iters_used_mean(), 3)
        print(f"Adaptive early exit: mean iters_used "
              f"{runner.iters_used_mean():.2f} of {args.valid_iters} "
              f"(threshold {args.exit_threshold_px} px)")
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
                   help="GRU iterations (reference: --valid_iters); the "
                        "depth cap when --exit_threshold_px is set")
    p.add_argument("--exit_threshold_px", type=float, default=None,
                   help="early exit: stop once an iteration's mean "
                        "|delta disparity| (px at feature resolution) "
                        "falls below this; the results gain the mean "
                        "iters_used.  <= 0 or unset: fixed depth")
    p.add_argument("--min_iters", type=int, default=None,
                   help="iterations that always run before the early-exit "
                        "threshold may fire (default 1)")
    p.add_argument("--fetch_dtype", default=None, choices=["fp16", "bf16"],
                   help="cast the disparity on the device before the "
                        "device->host copy (results stay fp32)")
    p.add_argument("--max_images", type=int, default=None,
                   help="evaluate only the first N images (smoke runs)")
    p.add_argument("--sequence", action="store_true",
                   help="run the dataset's frames in order twice, cold "
                        "and warm-started from the previous frame's "
                        "disparity, and report the warm-start EPE drift "
                        "with each pass's iters and FPS")
    p.add_argument("--stream_out", default=None,
                   help="with --sequence: write the drift row as a JSON "
                        "record to this path")
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
