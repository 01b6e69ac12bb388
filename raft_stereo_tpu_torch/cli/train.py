"""Training CLI of the PyTorch port (the JAX package's ``cli/train.py``;
reference: train_stereo.py:214-258).

    python -m raft_stereo_tpu_torch.cli.train --name raft-stereo \\
        --train_datasets sceneflow --batch_size 8 --train_iters 22

Every flag, dest and default is the JAX package's; everything is captured
into the two config dataclasses and saved with every checkpoint.  Runs on
the CUDA card by default; ``--device cpu`` runs the plain versions.  The
telemetry flags (``--metrics_port``, ``--metrics_host``, ``--event_log``,
``--trace_sample_rate``, ``--cost_telemetry``, ``--device_peak_tflops``,
``--stall_watchdog``, ``--flight_recorder_dir``) are accepted and raise
when set away from their defaults: they wait for ROADMAP.md §D9.
``--data_parallel`` above 1 waits for §D7.
"""

from __future__ import annotations

import argparse
import logging

from raft_stereo_tpu_torch.cli import common
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig

log = logging.getLogger(__name__)

_D9 = "§D9 telemetry"


def configs_from_args(args):
    model_kwargs = dict(
        hidden_dims=tuple(args.hidden_dims),
        n_gru_layers=args.n_gru_layers,
        n_downsample=args.n_downsample,
        corr_levels=args.corr_levels,
        corr_radius=args.corr_radius,
        shared_backbone=args.shared_backbone,
    )
    # flag-gated overrides: the dataclass defaults govern otherwise
    model_kwargs.update(common.arch_overrides(args))
    model_cfg = RaftStereoConfig(**model_kwargs)
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        train_iters=args.train_iters,
        valid_iters=args.valid_iters,
        lr=args.lr,
        num_steps=args.num_steps,
        wdecay=args.wdecay,
        image_size=tuple(args.image_size),
        train_datasets=tuple(args.train_datasets),
        img_gamma=tuple(args.img_gamma) if args.img_gamma else None,
        saturation_range=(tuple(args.saturation_range)
                          if args.saturation_range else None),
        do_flip=args.do_flip,
        spatial_scale=tuple(args.spatial_scale),
        noyjitter=args.noyjitter,
        validation_frequency=args.validation_frequency,
        seed=args.seed,
        data_parallel=args.data_parallel,
        gru_telemetry=args.gru_telemetry,
        trace_sample_rate=args.trace_sample_rate,
        anomaly_policy=args.anomaly_policy,
        anomaly_spike_factor=args.anomaly_spike_factor,
        anomaly_rewind_after=args.anomaly_rewind_after,
        anomaly_max_rewinds=args.anomaly_max_rewinds,
        checkpoint_keep=args.checkpoint_keep,
    )
    return model_cfg, train_cfg


def _positive_int(v):
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"{v}: must be >= 1")
    return n


def _nonneg_int(v):
    n = int(v)
    if n < 0:
        raise argparse.ArgumentTypeError(f"{v}: must be >= 0")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--name", default="raft-stereo")
    p.add_argument("--restore_ckpt", default=None,
                   help=".pth (warm start), port checkpoint directory "
                        "(exact resume), or the word 'latest': the newest "
                        "valid checkpoint under --checkpoint_dir for this "
                        "--name")
    p.add_argument("--warm_start", action="store_true",
                   help="load WEIGHTS ONLY from a checkpoint directory "
                        "(fresh optimizer and schedule: the fine-tune path)")
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--log_dir", default="runs")
    # schedule (reference: train_stereo.py:221-227)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--train_datasets", nargs="+", default=["sceneflow"])
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--num_steps", type=int, default=200_000)
    p.add_argument("--image_size", type=int, nargs=2, default=[320, 720])
    p.add_argument("--train_iters", type=int, default=16)
    p.add_argument("--valid_iters", type=int, default=32)
    p.add_argument("--wdecay", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=1234)
    # architecture (reference: train_stereo.py:233-240)
    p.add_argument("--hidden_dims", type=int, nargs=3, default=[128, 128, 128])
    p.add_argument("--n_gru_layers", type=int, default=3)
    p.add_argument("--n_downsample", type=int, default=2)
    p.add_argument("--corr_levels", type=int, default=4)
    p.add_argument("--corr_radius", type=int, default=4)
    p.add_argument("--shared_backbone", action="store_true")
    # augmentation (reference: train_stereo.py:243-247)
    p.add_argument("--img_gamma", type=float, nargs="+", default=None)
    p.add_argument("--saturation_range", type=float, nargs=2, default=None)
    p.add_argument("--do_flip", default=None, choices=["h", "v"])
    p.add_argument("--spatial_scale", type=float, nargs=2,
                   default=[-0.2, 0.4])
    p.add_argument("--noyjitter", action="store_true")
    # periodic validation (reference: train_stereo.py:183-193)
    p.add_argument("--validate_datasets", nargs="+", default=None,
                   choices=["things", "kitti", "eth3d", "middlebury"],
                   help="run these validators every --validation_frequency "
                        "steps (needs the datasets under --data_root)")
    p.add_argument("--validation_frequency", type=_positive_int,
                   default=10_000)
    p.add_argument("--validate_max_images", type=_positive_int,
                   default=None)
    p.add_argument("--data_parallel", type=_nonneg_int, default=0,
                   help="devices along the data axis (0 = all); above 1 "
                        "not ported (ROADMAP.md §D7), raises")
    p.add_argument("--metrics_port", type=int, default=None,
                   help=f"not ported (ROADMAP.md {_D9}); raises")
    p.add_argument("--metrics_host", default="127.0.0.1",
                   help=f"not ported (ROADMAP.md {_D9}); raises")
    p.add_argument("--event_log", default=None,
                   help=f"not ported (ROADMAP.md {_D9}); raises")
    p.add_argument("--gru_telemetry", action="store_true",
                   help="also record per-iteration GRU disparity-delta "
                        "magnitudes (a small reduction on the device)")
    p.add_argument("--trace_sample_rate", type=float, default=0.0,
                   help=f"above 0 not ported (ROADMAP.md {_D9}); raises")
    p.add_argument("--cost_telemetry", action=argparse.BooleanOptionalAction,
                   default=True,
                   help=f"--no-cost_telemetry not ported (ROADMAP.md "
                        f"{_D9}); raises")
    p.add_argument("--device_peak_tflops", type=float, default=None,
                   help=f"not ported (ROADMAP.md {_D9}); raises")
    p.add_argument("--stall_watchdog", action="store_true",
                   help=f"not ported (ROADMAP.md {_D9}); raises")
    # anomaly policy (training/anomaly.py); off by default
    p.add_argument("--anomaly_policy", action="store_true",
                   help="drop non-finite (and, with --anomaly_spike_factor, "
                        "loss-spike) updates ON THE DEVICE and rewind to the "
                        "newest good checkpoint after K consecutive "
                        "anomalies, reshuffling the remaining epoch order")
    p.add_argument("--anomaly_spike_factor", type=float, default=0.0,
                   help="also drop a finite loss above this factor x the "
                        "device-side loss EWMA (0 = non-finite only)")
    p.add_argument("--anomaly_rewind_after", type=int, default=3,
                   help="consecutive dropped steps that trigger a "
                        "checkpoint rewind (0 = skip-only)")
    p.add_argument("--anomaly_max_rewinds", type=int, default=2,
                   help="rewinds allowed before the run fails typed "
                        "(TrainingDiverged)")
    p.add_argument("--checkpoint_keep", type=int, default=0,
                   help="keep-last-K retention for periodic checkpoints "
                        "(0 = keep all; the newest GOOD-stamped rewind "
                        "target is never pruned)")
    p.add_argument("--flight_recorder_dir", default=None,
                   help=f"not ported (ROADMAP.md {_D9}); raises")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    common.add_arch_overrides(p)
    return p


def _unported_flags(args):
    return [flag for flag, on in (
        ("--metrics_port", args.metrics_port is not None),
        ("--metrics_host", args.metrics_host != "127.0.0.1"),
        ("--event_log", args.event_log is not None),
        ("--trace_sample_rate", args.trace_sample_rate > 0),
        ("--no-cost_telemetry", not args.cost_telemetry),
        ("--device_peak_tflops", args.device_peak_tflops is not None),
        ("--stall_watchdog", args.stall_watchdog),
        ("--flight_recorder_dir", args.flight_recorder_dir is not None),
    ) if on]


def main(argv=None):
    common.setup_logging()
    args = build_parser().parse_args(argv)
    for flag in _unported_flags(args):
        raise NotImplementedError(
            f"{flag} is not ported to the PyTorch package yet "
            f"(ROADMAP.md {_D9})")
    if args.data_parallel > 1:
        raise NotImplementedError(
            "--data_parallel > 1 is not ported to the PyTorch package yet "
            "(ROADMAP.md §D7 parallel executors)")
    model_cfg, train_cfg = configs_from_args(args)
    log.info("model config: %s", model_cfg.to_dict())
    log.info("train config: %s", train_cfg.to_dict())

    validate_fn = None
    if args.validate_datasets:
        from raft_stereo_tpu_torch.eval.validate import make_validation_fn
        validate_fn = make_validation_fn(
            model_cfg, train_cfg, data_root=args.data_root,
            datasets=tuple(args.validate_datasets),
            max_images=args.validate_max_images, device=args.device)

    from raft_stereo_tpu_torch.training.train_loop import train
    return train(model_cfg, train_cfg, name=args.name,
                 data_root=args.data_root,
                 checkpoint_dir=args.checkpoint_dir,
                 restore=args.restore_ckpt, log_dir=args.log_dir,
                 validate_fn=validate_fn, warm_start=args.warm_start,
                 device=args.device)


if __name__ == "__main__":
    main()
