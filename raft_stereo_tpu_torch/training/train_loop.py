"""The training loop of the port (reference: train_stereo.py:132-211; the
JAX package's ``training/train_loop.py``).

    state = train(model_cfg, train_cfg, data_root="datasets")   # the card
    state = train(model_cfg, train_cfg, loader=loader, device="cpu")

Without a ``loader`` the loop reads ``train_cfg.train_datasets`` under
``data_root`` through ``data/loader.StereoLoader``.  A prefetch thread
uploads each batch to the card ahead of the step (``_DevicePrefetcher``
with ``_Upload``: pinned host memory, a side stream the step waits on).
Every ``validation_frequency`` steps and at ``num_steps`` the loop
checkpoints (training/checkpoint.py: manifest, seal, runtime sidecar),
prunes to ``checkpoint_keep`` and runs ``validate_fn``.  ``restore`` is a
checkpoint directory (exact resume: weights, optimizer, schedule, loop
step, loader position, the numpy global RNG, the anomaly history), the
word ``"latest"`` (the newest checkpoint of run ``name`` whose manifest
verifies), or a reference ``.pth`` (warm start); ``warm_start=True``
loads the weights of a checkpoint directory only.  SIGTERM or SIGINT
checkpoint at the next step boundary and stop; a second signal
force-quits.  With ``anomaly_policy`` the step skips poisoned updates on
the card and the loop rewinds to the newest checkpoint that passes the
finite-state probe after ``anomaly_rewind_after`` skips in a row
(training/anomaly.py).  Metrics stay on the device until a buffered drain
every ``SUM_FREQ`` steps: the loop never waits for the card in between.
The fp32 path is full fp32: TF32 is switched off for matmuls and cuDNN
convs, as in the JAX package.  ``telemetry`` (a ``telemetry.TrainTelemetry``)
receives the JAX loop's calls: run start and end, each step's data wait
and dispatch time, the drained metrics, skips, rewinds, checkpoints and
validations; with its cost registry the step's first dispatch is recorded
with the step's FLOPs (telemetry/flops.py).  Without it the loop reads no
clock and fetches nothing more.

Data parallelism: one process per card, launched by ``torchrun
--nproc_per_node=N`` (or any caller that forms the group with
``parallel.distributed.initialize``).  The loop forms the group first
(a no-op in a plain run), checks ``data_parallel`` against its world size
(0 means the world size), wraps the model in ``DistributedDataParallel``
and reads its slice of every global batch of ``batch_size``; the step
makes the loss, metrics and update those of the global batch
(training/step.py), so every process holds the same state.  Once per
turn every process joins one collective stop decision
(``distributed.any_process``): a signal on one process, or one loader
running dry, stops them all at the same step.  Process 0 writes the
checkpoints (every process then meets at a barrier), the TensorBoard log
and runs the validation; every process restores the same checkpoint.
The checkpoint directory must be one every process reads.
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import inspect
import logging
import os
import queue
import signal
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.eval.runner import full_fp32
from raft_stereo_tpu_torch.parallel import distributed
from raft_stereo_tpu_torch.parallel.mesh import make_mesh
from raft_stereo_tpu_torch.training import checkpoint as ckpt
from raft_stereo_tpu_torch.training.anomaly import (AnomalyPolicy,
                                                    AnomalyTracker,
                                                    TrainingDiverged)
from raft_stereo_tpu_torch.training.logger import SUM_FREQ, Logger
from raft_stereo_tpu_torch.training.optimizer import one_cycle_lr
from raft_stereo_tpu_torch.training.state import (TrainState,
                                                  create_train_state)
from raft_stereo_tpu_torch.training.step import make_train_step

log = logging.getLogger(__name__)

# Config fields that choose how the model executes (backends, precision,
# remat, memory gates), not what the weights are: a weights-only warm
# start takes them from the caller's config and the architecture from
# the checkpoint.
_EXEC_CONFIG_FIELDS = (
    "corr_backend", "fused_gru", "slow_fast_gru", "mixed_precision",
    "corr_fp32", "banded_encoder", "corr_w2_shards", "rows_shards",
    "rows_gru", "rows_gru_halo", "remat_gru", "remat_save",
    "sequential_fnet_pixels", "band_rows",
    "quant", "quant_corr", "quant_corr_scales")


def _in_mesh(step_fn, mesh):
    """``step_fn`` with the mesh contexts of the context-parallel
    executors held around each call."""
    from raft_stereo_tpu_torch.parallel.mesh import mesh_contexts

    @functools.wraps(step_fn)
    def step(*args, **kwargs):
        with mesh_contexts(mesh):
            return step_fn(*args, **kwargs)

    return step


def merge_warm_start_config(caller_cfg: RaftStereoConfig,
                            ckpt_cfg: RaftStereoConfig) -> RaftStereoConfig:
    """The checkpoint's architecture with the caller's execution fields."""
    return dataclasses.replace(
        ckpt_cfg, **{f: getattr(caller_cfg, f) for f in _EXEC_CONFIG_FIELDS})


# Batches uploaded ahead of the step (device memory: depth x batch bytes).
_DEVICE_PREFETCH_DEPTH = 2


class _DevicePrefetcher:
    """Iterator that applies ``put`` (the upload) on a worker thread,
    ``depth`` batches ahead.

    The wrapped iterator's and ``put``'s exceptions re-raise in the
    consumer; the terminal state (exhausted or crashed) is remembered, so
    every later ``next`` re-raises it at once instead of blocking on a
    queue nothing feeds.  ``last_wait_s`` is the seconds the consumer
    blocked for the last batch (the loader's share of that step) and
    ``wait_s`` their sum."""

    _DONE = object()

    def __init__(self, it, put, depth: int = _DEVICE_PREFETCH_DEPTH):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._terminal: Optional[object] = None   # _DONE or BaseException
        self.wait_s = self.last_wait_s = 0.0

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(put(item))
            except BaseException as e:  # surface in the consumer
                self._q.put(e)
            else:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._terminal is not None:
            if self._terminal is self._DONE:
                raise StopIteration
            raise self._terminal  # type: ignore[misc]
        t0 = time.perf_counter()
        item = self._q.get()
        self.last_wait_s = time.perf_counter() - t0
        self.wait_s += self.last_wait_s
        if item is self._DONE:
            self._terminal = item
            raise StopIteration
        if isinstance(item, BaseException):
            self._terminal = item
            raise item
        return item

    def close(self, timeout: float = 5.0):
        """Stop the producer: drain the queue so a blocked ``put`` can
        return, join it (bounded), then close the wrapped iterator, which
        releases the loader's workers.  A producer wedged in an upload
        past ``timeout`` is abandoned with one last join at exit."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            while not self._q.empty():
                try:
                    self._q.get_nowait()
                except queue.Empty:  # pragma: no cover - raced drain
                    break
            self._thread.join(timeout=0.2)
        if not self._thread.is_alive():
            close_it = getattr(self._it, "close", None)
            if close_it is not None:
                try:
                    close_it()
                except Exception:  # pragma: no cover - raced teardown
                    log.debug("loader iterator close raised", exc_info=True)
            return
        log.warning("device prefetch thread still alive after %.1fs; "  # pragma: no cover
                    "abandoning it (final %.1fs join registered at "
                    "interpreter exit)", timeout, timeout)
        atexit.register(self._thread.join, timeout)  # pragma: no cover


def compact(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``TrainConfig.compact_upload``: fp16 flow and uint8 valid (the step
    casts both back to fp32 on the device)."""
    c = dict(batch)
    if c["flow"].dtype == np.float32:
        c["flow"] = c["flow"].astype(np.float16)
    if c["valid"].dtype == np.float32:
        c["valid"] = (c["valid"] > 0.5).astype(np.uint8)
    return c


class _Upload:
    """The prefetcher's ``put`` and the loop's ``take`` for one device.

    On the card, ``put`` (prefetch thread) copies each array into pinned
    host memory and uploads it on a side stream, then records an event;
    ``take`` (loop thread) makes the compute stream wait on that event and
    marks every tensor as used on the compute stream (``record_stream``),
    so the caching allocator does not hand its block to another
    allocation while the step still reads it.  On the CPU the arrays are
    wrapped as tensors."""

    def __init__(self, device: torch.device, compact_upload: bool):
        self.device = device
        self.compact = compact_upload
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def put(self, batch):
        if self.compact:
            batch = compact(batch)
        host = {k: torch.as_tensor(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if self.stream is None:
            return host, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def take(self, item) -> Dict[str, torch.Tensor]:
        out, event = item
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in out.values():
                t.record_stream(compute)
        return out


def _fetch(pending, gru_deltas: bool = False) -> list:
    """The buffered metrics on the host, the device ones in one
    device-to-host copy; host floats pass through.  The per-iteration
    ``gru_delta_px`` vectors stay behind unless ``gru_deltas`` (telemetry
    reads them), when they ride the same copy as numpy arrays."""
    keys = [k for k, v in pending[0].items()
            if isinstance(v, torch.Tensor) and k != "gru_delta_px"]
    vec = gru_deltas and "gru_delta_px" in pending[0]
    rows = [torch.stack([m[k].float().reshape(()) for k in keys])
            for m in pending]
    if vec:
        rows = [torch.cat([r, m["gru_delta_px"].float().reshape(-1)])
                for r, m in zip(rows, pending)]
    values = torch.stack(rows).cpu().numpy()
    out = [dict({k: v for k, v in m.items()
                 if not isinstance(v, torch.Tensor)},
                **dict(zip(keys, map(float, row))))
           for m, row in zip(pending, values)]
    if vec:
        for m, row in zip(out, values):
            m["gru_delta_px"] = row[len(keys):]
    return out


def _get_host_rng():
    """The numpy global RNG state as a JSON-serializable blob."""
    name, keys, pos, has_gauss, cached = np.random.get_state()
    return [name, np.asarray(keys).tolist(), int(pos), int(has_gauss),
            float(cached)]


def _set_host_rng(blob) -> None:
    if not blob:
        return
    try:
        name, keys, pos, has_gauss, cached = blob
        np.random.set_state((name, np.asarray(keys, np.uint32), int(pos),
                             int(has_gauss), float(cached)))
    except (ValueError, TypeError):  # pragma: no cover - foreign blob
        log.warning("could not restore host RNG state from checkpoint")


def _validation_hook(validate_fn, model_cfg):
    """Adapt ``validate_fn``'s arity once, before the loop: a one-argument
    ``validate_fn(state_dict)`` is called as it is, a two-argument one
    with the authoritative model config."""
    if validate_fn is None:
        return None
    try:
        n_params = len(inspect.signature(validate_fn).parameters)
    except (TypeError, ValueError):
        n_params = 2
    if n_params >= 2:
        return lambda sd: validate_fn(sd, model_cfg)
    return validate_fn


def train(model_cfg: RaftStereoConfig, train_cfg: TrainConfig,
          name: str = "raft-stereo",
          data_root: str = "datasets",
          checkpoint_dir: Optional[str] = "checkpoints",
          restore: Optional[str] = None,
          log_dir: Optional[str] = "runs",
          validate_fn=None,
          loader=None,
          warm_start: bool = False,
          telemetry=None,
          device: Union[str, torch.device] = "cuda",
          on_step: Optional[Callable[[int, Dict[str, torch.Tensor]],
                                     None]] = None,
          use_mesh: bool = True,
          mesh_devices: Optional[Sequence[Union[str, torch.device]]] = None
          ) -> TrainState:
    """Train and return the final state (module docstring).

    ``device`` defaults to the card and raises without one; pass
    ``"cpu"`` for the plain versions.  ``checkpoint_dir=None`` saves
    nothing (the anomaly policy needs checkpoints); ``log_dir=None``
    logs to the console only.  ``validate_fn(state_dict, model_cfg) ->
    dict`` (eval/validate.make_validation_fn) runs at every checkpoint
    boundary.  ``on_step(step, metrics)``, when given, sees every step's
    metrics: 0-d tensors on the device, and ``loader_wait_s``, the host
    seconds the loop blocked for that step's batch (also logged).

    ``rows_shards``/``corr_w2_shards`` > 1 run every step over a device
    group of this process (``mesh_devices``, by default its local
    devices; the group's first device is ``device``), inside the data
    axis: each data-parallel process drives its own group, and DDP
    reduces over the processes alone."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the GPU; pass "
                           "device='cpu' to run the plain versions on the "
                           "CPU")
    # the process group first (a no-op in a plain run): with torchrun it
    # also picks this process's card
    distributed.initialize(device=device)
    parallel = torch.distributed.is_initialized()
    if parallel and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # the rows and corr axes: a device group inside this process (the
    # data rank), its first device the training device
    n_corr, n_rows = model_cfg.corr_w2_shards, model_cfg.rows_shards
    if (n_corr > 1 or n_rows > 1) and not use_mesh:
        raise ValueError(
            "corr_w2_shards/rows_shards > 1 requires use_mesh=True")
    group = ([torch.device(d) for d in mesh_devices] if mesh_devices
             else [device] if n_corr * n_rows == 1
             else distributed.local_devices_stable())
    if len(group) < n_corr * n_rows:
        raise ValueError(
            f"corr_w2_shards={n_corr} x rows_shards={n_rows} exceeds the "
            f"{len(group)} available devices — no device is left for the "
            f"data axis")
    if n_rows > 1 and train_cfg.image_size[0] % (4 * n_rows):
        raise ValueError(
            f"rows_shards={n_rows} needs image height "
            f"{train_cfg.image_size[0]} divisible by {4 * n_rows} "
            f"(two stride-2 stages x row shards)")
    mesh = make_mesh(n_data=train_cfg.data_parallel, n_corr=n_corr,
                     n_rows=n_rows, devices=group)
    n_data = mesh.n_data
    if train_cfg.batch_size % n_data:
        raise ValueError(f"batch_size={train_cfg.batch_size} not divisible "
                         f"by {n_data} data-parallel processes")
    if n_corr * n_rows > 1 and mesh.devices[0].type != device.type:
        raise ValueError(f"the mesh's first device {mesh.devices[0]} must "
                         f"be the training device {device}")
    lead = distributed.process_index() == 0
    policy = AnomalyPolicy.from_train_config(train_cfg)
    if policy is not None and checkpoint_dir is None:
        raise ValueError("anomaly_policy rewinds to checkpoints: give a "
                         "checkpoint_dir")
    full_fp32()
    anomaly = policy is not None

    if restore == "latest":
        def _reject(path, reason):
            log.warning("skipping corrupt checkpoint %s (%s)", path, reason)
            if telemetry is not None:
                telemetry.observe_checkpoint_rejected(path, reason)
        restore = ckpt.latest_checkpoint(checkpoint_dir or ".", name=name,
                                         deep=True, on_reject=_reject)
        if restore is None:
            log.warning("restore 'latest': no valid checkpoint under %s for "
                        "run %r; starting fresh", checkpoint_dir, name)
        else:
            log.info("restore 'latest' resolved to %s", restore)

    runtime: Optional[Dict] = None
    loader_state: Optional[Dict] = None
    if restore and restore.endswith(".pth"):
        from raft_stereo_tpu_torch.io.torch_import import (
            import_torch_checkpoint)
        model_cfg, weights = import_torch_checkpoint(
            os.path.abspath(os.path.expanduser(restore)), config=model_cfg)
        state = create_train_state(model_cfg, train_cfg, device,
                                   seed=train_cfg.seed, state_dict=weights,
                                   anomaly=anomaly)
        log.info("warm start from torch checkpoint %s", restore)
    elif restore and warm_start:
        ckpt_cfg, weights = ckpt.load_weights(restore)
        model_cfg = merge_warm_start_config(model_cfg, ckpt_cfg)
        state = create_train_state(model_cfg, train_cfg, device,
                                   seed=train_cfg.seed, state_dict=weights,
                                   anomaly=anomaly)
        log.info("warm start (weights only) from %s", restore)
    elif restore:
        model_cfg, weights, saved = ckpt.read_train_checkpoint(restore)
        state = create_train_state(model_cfg, train_cfg, device,
                                   seed=train_cfg.seed, state_dict=weights,
                                   anomaly=anomaly)
        ckpt.restore_train_state(state, weights, saved)
        runtime = ckpt.load_runtime_state(restore)
        if runtime:
            state.step = int(runtime.get("loop_step", state.step))
            _set_host_rng(runtime.get("host_rng"))
            loader_state = runtime.get("loader")
        else:   # a checkpoint without the sidecar: the loop step's batch
            loader_state = {"offset": state.step, "salts": []}
        # the post-restore probe: finite weights and moments stamp GOOD
        if lead and ckpt.finite_state(weights, saved):
            ckpt.mark_good(restore)
        log.info("exact resume from %s at step %d", restore, state.step)
    else:
        state = create_train_state(model_cfg, train_cfg, device,
                                   seed=train_cfg.seed, anomaly=anomaly)
    start_step = state.step
    if parallel:
        from torch.nn.parallel import DistributedDataParallel
        # the frozen batch norms' statistics are buffers no step changes,
        # and every process loads the same ones: nothing to broadcast
        state.ddp = DistributedDataParallel(
            state.model,
            device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False)

    if loader is None:
        from raft_stereo_tpu_torch.data.datasets import (
            build_training_mixture)
        from raft_stereo_tpu_torch.data.loader import StereoLoader
        mixture = build_training_mixture(train_cfg, data_root)
        loader = StereoLoader(
            mixture, batch_size=train_cfg.batch_size, seed=train_cfg.seed,
            quarantine_path=(os.path.join(checkpoint_dir,
                                          f"{name}.quarantine.json")
                             if checkpoint_dir else None),
            **distributed.loader_shard_kwargs())
    if loader_state is not None and hasattr(loader, "set_state"):
        loader.set_state(loader_state)
        log.info("loader resumed at %s", loader_state)
    run_validation = _validation_hook(validate_fn, model_cfg)

    tracker = AnomalyTracker(policy) if policy is not None else None
    if tracker is not None and runtime:
        tracker.load_history(runtime.get("anomaly"))
    loss_ewma = float(runtime.get("loss_ewma", 0.0)) if runtime else 0.0
    step_fn = make_train_step(train_cfg, anomaly=policy)
    if n_corr * n_rows > 1:
        step_fn = _in_mesh(step_fn, mesh)
    if telemetry is not None and getattr(telemetry, "costs", None) is not None:
        # the first dispatch is the step's build (kernel builds, first
        # allocations): recorded with its wall time, memory and FLOPs
        from raft_stereo_tpu_torch.telemetry.flops import train_step_flops
        from raft_stereo_tpu_torch.telemetry.train_metrics import (
            TRAIN_STEP_COST_KEY)
        step_fn = telemetry.costs.instrument(
            step_fn, key=TRAIN_STEP_COST_KEY, site="train",
            flops=train_step_flops(model_cfg, train_cfg.image_size,
                                   train_cfg.batch_size // n_data,
                                   train_cfg.train_iters),
            device=device)
    schedule = one_cycle_lr(train_cfg.lr, train_cfg.num_steps + 100)
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    total = train_cfg.num_steps
    t0 = time.time()

    if telemetry is not None:
        telemetry.run_start(model_cfg, train_cfg, start_step, name=name)
        if restore:
            telemetry.resumed(restore, start_step)

    # SIGTERM/SIGINT: checkpoint at the next step boundary, then stop; a
    # second signal force-quits (the first keeps the save itself safe).
    stop_requested = False
    peer_stop = False    # the collective stop, asked for by another process
    prev_handlers = {}

    def _restore_handlers():
        while prev_handlers:
            sig, h = prev_handlers.popitem()
            signal.signal(sig, h)

    def _request_stop(signum, frame):
        nonlocal stop_requested
        if stop_requested:
            _restore_handlers()
            raise KeyboardInterrupt(f"second signal {signum}: force quit")
        stop_requested = True
        if telemetry is not None:
            telemetry.stop_requested(signum)
        log.warning("signal %d: checkpointing at next step boundary "
                    "(send again to force-quit)", signum)

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _request_stop)

    # Device metric dicts awaiting the buffered drain: a per-step fetch
    # would make the loop wait for the card every step.
    pending_metrics = []
    upload = _Upload(device, train_cfg.compact_upload)
    run_status = "failed"  # overwritten on every clean exit path

    with Logger(log_dir=log_dir or "runs", total_steps=start_step,
                enable_tensorboard=lead and log_dir is not None) as logger:
        def drain_metrics():
            if not pending_metrics:
                return
            if telemetry is None:
                fetched = _fetch(pending_metrics)
            else:
                t_drain = time.perf_counter()
                fetched = _fetch(pending_metrics, gru_deltas=True)
            pending_metrics.clear()
            first = state.step - len(fetched) + 1
            gru_deltas = [m.pop("gru_delta_px") for m in fetched
                          if "gru_delta_px" in m]
            for offset, m in enumerate(fetched):
                logger.push(m, lr=schedule(first + offset))
                if tracker is not None:
                    kind = tracker.observe(first + offset, m)
                    if kind is not None and telemetry is not None:
                        telemetry.observe_anomaly_skip(first + offset, kind)
            if telemetry is not None:
                means = ({k: float(np.mean([m[k] for m in fetched]))
                          for k in fetched[0]} if fetched else {})
                telemetry.observe_drain(time.perf_counter() - t_drain,
                                        means, state.step,
                                        window=len(fetched))
                for d in gru_deltas:
                    telemetry.observe_gru_deltas(np.asarray(d).ravel())
                if hasattr(loader, "stats"):
                    telemetry.observe_loader_stats(loader.stats)

        batches = _DevicePrefetcher(iter(loader), upload.put)
        # the current iterator started at the loader's own offset when the
        # loop stood at anchor_step
        anchor_step = start_step
        ewma_dev = (torch.full((), loss_ewma, dtype=torch.float32,
                               device=device) if policy is not None
                    else None)

        def runtime_blob() -> Dict:
            blob: Dict = {"loop_step": state.step,
                          "host_rng": _get_host_rng()}
            loader_state_fn = getattr(loader, "state", None)
            if loader_state_fn is not None:
                blob["loader"] = loader_state_fn(
                    consumed=state.step - anchor_step)
            if tracker is not None:
                blob["anomaly"] = tracker.history()
            if ewma_dev is not None:
                blob["loss_ewma"] = float(ewma_dev)
            return blob

        def save(path, prune=False):
            """Process 0 writes (and prunes); every process then meets,
            so none reads a checkpoint before it is sealed."""
            t_save = time.perf_counter() if telemetry is not None else 0.0
            if lead:
                ckpt.save_train_checkpoint(path, state,
                                           runtime_state=runtime_blob())
                log.info("saved checkpoint %s", path)
                if prune and train_cfg.checkpoint_keep > 0:
                    ckpt.prune_checkpoints(checkpoint_dir, name=name,
                                           keep=train_cfg.checkpoint_keep)
            distributed.barrier()
            if telemetry is not None:
                telemetry.observe_checkpoint(time.perf_counter() - t_save,
                                             path, state.step)

        def do_rewind():
            """Restore the newest checkpoint that passes the finite-state
            probe, reshuffle the rest of its epoch (a salt keyed by the
            rewind ordinal) and resume there; ``TrainingDiverged`` when
            the budget or the checkpoints are spent."""
            nonlocal batches, anchor_step, ewma_dev
            if not tracker.rewind_budget_left():
                raise TrainingDiverged(
                    state.step, f"{tracker.consecutive} consecutive "
                    f"anomalous steps and max_rewinds={policy.max_rewinds} "
                    f"exhausted")
            for path in ckpt.valid_checkpoints(checkpoint_dir, name=name,
                                               deep=True):
                try:
                    _, weights, saved = ckpt.read_train_checkpoint(path)
                except Exception:
                    log.warning("rewind: reading %s failed; trying older",
                                path, exc_info=True)
                    continue
                if not ckpt.finite_state(weights, saved):
                    log.warning("rewind: %s fails the finite-state probe; "
                                "trying older", path)
                    continue
                if lead:
                    ckpt.mark_good(path)
                rt = ckpt.load_runtime_state(path) or {}
                from_step = state.step
                ckpt.restore_train_state(state, weights, saved)
                to_step = int(rt.get("loop_step", state.step))
                state.step = to_step
                tracker.note_rewind(from_step, to_step, path)
                _set_host_rng(rt.get("host_rng"))
                if hasattr(loader, "set_state"):
                    loader.set_state(rt.get("loader")
                                     or {"offset": to_step, "salts": []})
                    if hasattr(loader, "add_salt") and len(loader) > 0:
                        e, b = divmod(loader.start_offset, len(loader))
                        loader.add_salt(e, b, tracker.rewinds)
                batches.close()
                batches = _DevicePrefetcher(iter(loader), upload.put)
                pending_metrics.clear()
                anchor_step = to_step
                ewma_dev = torch.full((), float(rt.get("loss_ewma", 0.0)),
                                      dtype=torch.float32, device=device)
                log.warning("anomaly rewind %d/%d: step %d -> %d from %s "
                            "(remaining epoch order reshuffled)",
                            tracker.rewinds, policy.max_rewinds, from_step,
                            to_step, path)
                if telemetry is not None:
                    telemetry.observe_rewind(from_step, to_step, path)
                return
            raise TrainingDiverged(
                state.step, "no checkpoint passes the finite-state probe "
                "— nothing to rewind to")

        try:
            while True:
                # every telemetry site is gated on ``telemetry is not
                # None``: without it the loop reads no clock
                if telemetry is not None:
                    t_loop = time.perf_counter()
                item = next(batches, None)
                if telemetry is not None:
                    t_batch = time.perf_counter()
                # one collective per turn on every process (the step is
                # the same on all of them, so all take the same branch):
                # a stop or a dry loader anywhere stops every process here
                if state.step >= total:
                    break
                if distributed.any_process(stop_requested or item is None):
                    if not stop_requested and item is not None:
                        peer_stop = True
                        log.warning("another process stopped: "
                                    "checkpointing at this step boundary")
                    break
                batch = upload.take(item)
                if telemetry is not None:
                    telemetry.note_batch(batch)
                if policy is not None:
                    state, metrics, ewma_dev = step_fn(state, batch,
                                                       ewma_dev)
                else:
                    state, metrics = step_fn(state, batch)
                del batch, item
                metrics["loader_wait_s"] = batches.last_wait_s
                step = state.step
                if telemetry is not None:
                    # the dispatch leg only: the launches return before
                    # the card finishes; the device-bound tail shows in
                    # the drain histogram
                    telemetry.observe_step(
                        step, data_wait_s=t_batch - t_loop,
                        dispatch_s=time.perf_counter() - t_batch)
                if on_step is not None:
                    on_step(step, metrics)
                pending_metrics.append(metrics)
                if len(pending_metrics) >= SUM_FREQ:
                    drain_metrics()
                    if tracker is not None and tracker.should_rewind():
                        do_rewind()
                        continue
                if step % train_cfg.validation_frequency == 0 or step == total:
                    drain_metrics()
                    # rewind before the save: a checkpoint of a suspect
                    # state would poison the rewind ladder
                    if tracker is not None and tracker.should_rewind():
                        do_rewind()
                        continue
                    if checkpoint_dir:
                        save(os.path.join(checkpoint_dir, f"{step}_{name}"),
                             prune=True)
                    if run_validation is not None and lead:
                        results = run_validation(state.model.state_dict())
                        logger.write_dict(results)
                        if telemetry is not None:
                            telemetry.observe_validation(results, step)
            # final (or preemption) checkpoint, written while the handler
            # is still installed
            if checkpoint_dir:
                save(os.path.join(checkpoint_dir, name))
            run_status = ("stopped" if stop_requested or peer_stop
                          else "complete")
        finally:
            try:
                drain_metrics()
            except Exception:
                log.exception("could not drain buffered metrics")
            batches.close()
            _restore_handlers()
            if telemetry is not None:
                telemetry.run_end(run_status, state.step)

    if stop_requested or peer_stop:
        log.warning("stopped by signal at step %d; resume with restore=%s",
                    state.step, os.path.join(checkpoint_dir or ".", name))
    log.info("training done: %d steps in %.1fs", state.step - start_step,
             time.time() - t0)
    return state
