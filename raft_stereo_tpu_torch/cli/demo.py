"""Inference demo of the PyTorch port: stereo pairs -> disparity images.

    python -m raft_stereo_tpu_torch.cli.demo --restore_ckpt CKPT_DIR \\
        -l 'datasets/ETH3D/two_view_training/*/im0.png' \\
        -r 'datasets/ETH3D/two_view_training/*/im1.png'

``CKPT_DIR`` is a port checkpoint (io/jax_weights.save_checkpoint).
Writes ``<name>-disparity.png`` (jet colormap) and, with
``--save_numpy``, ``<name>.npy`` into ``--output_directory``.  Runs on
the CUDA card by default; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np

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
    from raft_stereo_tpu_torch.io.jax_weights import load_checkpoint

    cfg, state = load_checkpoint(args.restore_ckpt)
    runner = InferenceRunner(cfg, state, iters=args.valid_iters,
                             fetch_dtype=args.fetch_dtype,
                             device=args.device)
    os.makedirs(args.output_directory, exist_ok=True)
    left_images = sorted(glob.glob(args.left_imgs, recursive=True))
    right_images = sorted(glob.glob(args.right_imgs, recursive=True))
    if len(left_images) != len(right_images) or not left_images:
        raise SystemExit(
            f"found {len(left_images)} left / {len(right_images)} right "
            "images — globs must match pairwise")
    log.info("found %d image pairs; writing to %s", len(left_images),
             args.output_directory)
    for left_path, right_path in zip(left_images, right_images):
        disp = runner.disparity(read_image(left_path), read_image(right_path))
        stem = os.path.splitext(os.path.basename(left_path))[0]
        if args.save_numpy:
            np.save(os.path.join(args.output_directory, f"{stem}.npy"), disp)
        vis = jet_colormap(disp / max(float(disp.max()), 1e-6))
        Image.fromarray(vis).save(
            os.path.join(args.output_directory, f"{stem}-disparity.png"))
        log.info("%s: disparity range [%.2f, %.2f]", stem, disp.min(),
                 disp.max())
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
    p.add_argument("--save_numpy", action="store_true")
    p.add_argument("--valid_iters", type=int, default=32)
    p.add_argument("--fetch_dtype", default=None, choices=["fp16", "bf16"],
                   help="cast the disparity on the device before the "
                        "device->host copy (results stay fp32)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    run_demo(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
