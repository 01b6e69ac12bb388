"""Inference demo of the PyTorch port: stereo pairs -> disparity images.

    python -m raft_stereo_tpu_torch.cli.demo --restore_ckpt CKPT_DIR \\
        -l 'datasets/ETH3D/two_view_training/*/im0.png' \\
        -r 'datasets/ETH3D/two_view_training/*/im1.png'

``CKPT_DIR`` is a port checkpoint (io/jax_weights.save_checkpoint) or a
reference ``.pth``; the architecture-override flags are the JAX demo's
(``--banded_encoder`` streams the encoders' full-resolution segment in
bands, cli/common.py).
Writes ``<name>-disparity.png`` (jet colormap) and, with
``--save_numpy``, ``<name>.npy`` into ``--output_directory``.  Runs on
the CUDA card by default; ``--device cpu`` runs the plain versions.
``--exit_threshold_px`` (with ``--min_iters``) turns on the early exit;
``--sequence [GLOB]`` treats the frames as an ordered sequence, each
warm-started from the previous frame's disparity.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import time

import numpy as np

from raft_stereo_tpu_torch.cli import common

log = logging.getLogger(__name__)


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """Normalized [0,1] -> uint8 RGB, a piecewise-linear jet."""
    x = np.clip(x, 0, 1)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def run_demo(args) -> int:
    from PIL import Image

    from raft_stereo_tpu_torch.data.frame_utils import read_image
    from raft_stereo_tpu_torch.eval.runner import InferenceRunner

    cfg, state = common.load_any_checkpoint(
        args.restore_ckpt, **common.arch_overrides(args))
    runner = InferenceRunner(cfg, state, iters=args.valid_iters,
                             fetch_dtype=args.fetch_dtype,
                             exit_threshold_px=args.exit_threshold_px,
                             exit_min_iters=args.min_iters,
                             device=args.device)
    os.makedirs(args.output_directory, exist_ok=True)
    sequence = args.sequence is not None
    left_glob = (args.sequence if isinstance(args.sequence, str)
                 else args.left_imgs)
    left_images = sorted(glob.glob(left_glob, recursive=True))
    right_images = sorted(glob.glob(args.right_imgs, recursive=True))
    if len(left_images) != len(right_images) or not left_images:
        raise SystemExit(
            f"found {len(left_images)} left / {len(right_images)} right "
            "images — globs must match pairwise")
    log.info("found %d image pairs; writing to %s%s", len(left_images),
             args.output_directory,
             " (sequence mode: warm-start chaining)" if sequence else "")
    state_low = None            # the previous frame's padded low-res flow
    t_seq = time.perf_counter()
    for idx, (left_path, right_path) in enumerate(zip(left_images,
                                                      right_images)):
        left, right = read_image(left_path), read_image(right_path)
        if sequence:
            try:
                frame = runner.run_stream(left, right,
                                          prev_flow_low=state_low)
            except ValueError:          # the resolution changed: cold
                frame = runner.run_stream(left, right)
            # keyframe guard: a warm frame that ran to the cap never met
            # the exit test, so the next frame starts cold
            state_low = (None if (frame.warm and frame.iters_used is not None
                                  and frame.iters_used >= args.valid_iters)
                         else frame.flow_low)
            disp = frame.disparity
        else:
            disp = runner.disparity(left, right)
        stem = os.path.splitext(os.path.basename(left_path))[0]
        if args.save_numpy:
            np.save(os.path.join(args.output_directory, f"{stem}.npy"), disp)
        vis = jet_colormap(disp / max(float(disp.max()), 1e-6))
        Image.fromarray(vis).save(
            os.path.join(args.output_directory, f"{stem}-disparity.png"))
        if sequence:
            log.info("%s: frame %d %s iters_used %s/%d, cumulative %.2f "
                     "FPS, disparity range [%.2f, %.2f]", stem, idx,
                     "warm" if frame.warm else "cold",
                     frame.iters_used if frame.iters_used is not None
                     else "-", args.valid_iters,
                     (idx + 1) / (time.perf_counter() - t_seq), disp.min(),
                     disp.max())
        elif runner.last_iters_used is not None:
            log.info("%s: disparity range [%.2f, %.2f] (iters_used %d/%d)",
                     stem, disp.min(), disp.max(), runner.last_iters_used,
                     args.valid_iters)
        else:
            log.info("%s: disparity range [%.2f, %.2f]", stem, disp.min(),
                     disp.max())
    if runner.iters_used_mean() is not None:
        log.info("adaptive early exit: mean iters_used %.2f of %d "
                 "(threshold %.4g px, min %d)", runner.iters_used_mean(),
                 args.valid_iters, args.exit_threshold_px or 0.0,
                 args.min_iters or 1)
    return len(left_images)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--restore_ckpt", required=True,
                   help="port checkpoint directory (config.json + weights.pt)")
    p.add_argument("-l", "--left_imgs", required=True,
                   help="glob for left (im0) images")
    p.add_argument("-r", "--right_imgs", required=True,
                   help="glob for right (im1) images")
    p.add_argument("--output_directory", default="demo_output")
    p.add_argument("--sequence", nargs="?", const=True, default=None,
                   metavar="GLOB",
                   help="treat the frames as an ordered sequence: each "
                        "frame warm-starts the GRU from the previous "
                        "frame's disparity; GLOB overrides --left_imgs")
    p.add_argument("--save_numpy", action="store_true")
    p.add_argument("--valid_iters", type=int, default=32,
                   help="GRU iterations; the depth cap under early exit")
    p.add_argument("--exit_threshold_px", type=float, default=None,
                   help="early exit: stop once an iteration's mean "
                        "|delta disparity| (px at feature resolution) "
                        "falls below this.  <= 0 or unset: fixed depth")
    p.add_argument("--min_iters", type=int, default=None,
                   help="iterations that always run before the early-exit "
                        "threshold may fire (default 1)")
    p.add_argument("--fetch_dtype", default=None, choices=["fp16", "bf16"],
                   help="cast the disparity on the device before the "
                        "device->host copy (results stay fp32)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    common.add_arch_overrides(p)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    run_demo(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
