"""Training CLI of the PyTorch port (the JAX package's ``cli/train.py``;
reference: train_stereo.py:214-258).

    python -m raft_stereo_tpu_torch.cli.train --name raft-stereo \\
        --train_datasets sceneflow --batch_size 8 --train_iters 22

Every flag, dest and default is the JAX package's; everything is captured
into the two config dataclasses and saved with every checkpoint.  Runs on
the CUDA card by default; ``--device cpu`` runs the plain versions.  The
telemetry flags (``--metrics_port``, ``--metrics_host``, ``--event_log``,
``--trace_sample_rate``, ``--cost_telemetry``, ``--device_peak_tflops``,
``--stall_watchdog``, ``--flight_recorder_dir``) build the JAX CLI's
instruments (``build_telemetry``); the endpoint answers before training
starts and shuts down when it ends.

Data-parallel training runs one process per card under torchrun:

    torchrun --nproc_per_node=8 -m raft_stereo_tpu_torch.cli.train \
        --data_parallel 8 --batch_size 16 ...

``--batch_size`` is the global batch; each process trains its slice of
it (training/train_loop.py).  ``--data_parallel`` 0 means the world size,
and another value must equal it.  Process 0 alone serves the telemetry
endpoint and writes the event log.
"""

from __future__ import annotations

import argparse
import logging
import os

from raft_stereo_tpu_torch.cli import common
from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.parallel import distributed

log = logging.getLogger(__name__)


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
                   help="data-parallel processes, one per card under "
                        "torchrun (0 = the world size)")
    # observability (telemetry/): off by default; with no --metrics_port
    # and no --event_log the loop runs without any instrument
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve GET /metrics (Prometheus), GET /healthz "
                        "(last-step age), GET /debug/* and POST "
                        "/debug/trace (bounded profiler window) on this "
                        "port; 0 = ephemeral")
    p.add_argument("--metrics_host", default="127.0.0.1")
    p.add_argument("--event_log", default=None,
                   help="append structured JSONL run events (run-start "
                        "config snapshot, step stats, validation, "
                        "checkpoint/preemption, compile events) to this "
                        "file; defaults to <log_dir>/events.jsonl when "
                        "--metrics_port is set")
    p.add_argument("--gru_telemetry", action="store_true",
                   help="also record per-iteration GRU disparity-delta "
                        "magnitudes (a small reduction on the device)")
    p.add_argument("--trace_sample_rate", type=float, default=0.0,
                   help="fraction of train steps whose span tree "
                        "(data-wait/dispatch/drain/checkpoint) is recorded "
                        "and served as Chrome trace JSON on GET "
                        "/debug/spans; 0 (default) disables tracing")
    p.add_argument("--cost_telemetry", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="with the endpoint or event log on, record the "
                        "step's first dispatch (wall time, memory, FLOPs "
                        "from telemetry/flops.py) so GET /debug/compiles "
                        "lists it and the train_mfu / train_step_flops "
                        "gauges are live")
    p.add_argument("--device_peak_tflops", type=float, default=None,
                   help="peak TFLOP/s for the MFU denominator; default: "
                        "the table keyed by the card's name "
                        "(costs.DEVICE_PEAK_TFLOPS); MFU gauges stay 0 "
                        "when unknown")
    p.add_argument("--stall_watchdog", action="store_true",
                   help="alarm (anomaly event + flight-recorder bundle) "
                        "when no step completes within 10x the rolling "
                        "median step time")
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
                   help="debug-bundle directory for the flight recorder "
                        "(spans + events ring, /metrics snapshot, stack "
                        "dump, device memory); defaults to "
                        "<log_dir>/flightrecorder")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    common.add_arch_overrides(p)
    return p


def build_telemetry(args, model_cfg, train_cfg):
    """The instruments the flags ask for: ``(telemetry, server, events)``,
    each None when off.  The endpoint is started, answering /healthz
    before training starts; the caller shuts it down and closes the event
    log.  Its threads and the stall watchdog's may start before the
    loader's process workers: those are spawned, not forked."""
    event_log_path = args.event_log
    if args.metrics_port is not None and event_log_path is None:
        event_log_path = os.path.join(args.log_dir, "events.jsonl")
    if args.metrics_port is None and event_log_path is None:
        return None, None, None
    from raft_stereo_tpu_torch.telemetry import (CompileRegistry, EventLog,
                                                 FlightRecorder,
                                                 MetricsRegistry, SpanTracer,
                                                 TelemetryHTTPServer,
                                                 TraceCapture,
                                                 TrainTelemetry)
    events = EventLog(event_log_path) if event_log_path is not None else None
    tracer = SpanTracer(train_cfg.trace_sample_rate)
    recorder = FlightRecorder(
        args.flight_recorder_dir
        or os.path.join(args.log_dir, "flightrecorder"), tracer=tracer)
    registry = MetricsRegistry()
    costs = None
    if args.cost_telemetry:
        costs = CompileRegistry(
            registry=registry, events=events,
            device_peak_tflops=args.device_peak_tflops,
            dtype="bf16" if model_cfg.mixed_precision else "fp32")
    telemetry = TrainTelemetry(registry=registry, events=events,
                               tracer=tracer, recorder=recorder, costs=costs)
    recorder.registry = telemetry.registry
    if args.stall_watchdog:
        telemetry.enable_stall_watchdog()
    server = None
    if args.metrics_port is not None:
        server = TelemetryHTTPServer(
            telemetry.registry, telemetry.healthz,
            host=args.metrics_host, port=args.metrics_port,
            trace=TraceCapture(root=os.path.join(args.log_dir, "profiles"),
                               gate=telemetry.step_boundary),
            tracer=tracer, recorder=recorder, costs=costs).start()
        log.info("training metrics endpoint on %s (GET /metrics, "
                 "GET /healthz, GET /debug/spans, GET /debug/stacks, "
                 "GET /debug/flightrecorder, GET /debug/compiles, "
                 "POST /debug/trace)", server.url)
    return telemetry, server, events


def main(argv=None):
    common.setup_logging()
    args = build_parser().parse_args(argv)
    model_cfg, train_cfg = configs_from_args(args)
    # the process group before any card is touched (a no-op outside a
    # launcher): with torchrun it picks this process's card
    distributed.initialize(device=args.device)
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
    telemetry, server, events = (
        build_telemetry(args, model_cfg, train_cfg)
        if distributed.process_index() == 0 else (None, None, None))
    try:
        return train(model_cfg, train_cfg, name=args.name,
                     data_root=args.data_root,
                     checkpoint_dir=args.checkpoint_dir,
                     restore=args.restore_ckpt, log_dir=args.log_dir,
                     validate_fn=validate_fn, warm_start=args.warm_start,
                     telemetry=telemetry, device=args.device)
    finally:
        if server is not None:
            server.shutdown()
        if events is not None:
            events.close()
        distributed.shutdown()


if __name__ == "__main__":
    main()
