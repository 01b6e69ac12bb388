"""The training loop of the port (reference: train_stereo.py:132-211).

    state = train(model_cfg, train_cfg, loader=loader)            # the card
    state = train(model_cfg, train_cfg, loader=loader, device="cpu")

``loader`` yields the JAX loader's batch dicts (``training/step.py``);
``data/synthetic.py`` has a seeded one.  The loop runs
``train_cfg.num_steps`` steps or until the loader ends, logs loss,
``grad_norm`` and the LR every ``LOG_EVERY`` steps, saves a checkpoint
every ``validation_frequency`` steps and at the end when
``checkpoint_dir`` is given, and resumes from ``restore`` (a checkpoint
directory), fast-forwarding a loader that has ``set_state``.  It switches
TF32 off for matmuls and cuDNN convs: the fp32 path is full fp32, as in
the JAX package.  Validation, telemetry, the anomaly gate and rewind are
not ported (ROADMAP.md §D2, §D4).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Union

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.eval.runner import full_fp32
from raft_stereo_tpu_torch.training.checkpoint import (
    load_train_checkpoint, save_train_checkpoint)
from raft_stereo_tpu_torch.training.state import (TrainState,
                                                  create_train_state)
from raft_stereo_tpu_torch.training.step import train_step

log = logging.getLogger(__name__)

LOG_EVERY = 100  # the reference logger's SUM_FREQ


def train(model_cfg: RaftStereoConfig, train_cfg: TrainConfig,
          loader: Iterable[Mapping[str, object]],
          device: Union[str, torch.device] = "cuda",
          name: str = "raft-stereo", checkpoint_dir: Optional[str] = None,
          restore: Optional[str] = None,
          on_step: Optional[Callable[[int, Dict[str, torch.Tensor]],
                                     None]] = None
          ) -> TrainState:
    """Train and return the final state.  ``device`` defaults to the
    card and raises without one; pass ``"cpu"`` for the plain versions.
    ``on_step(step, metrics)``, when given, sees every step's metrics
    (0-d tensors on the device)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the GPU; pass "
                           "device='cpu' to run the plain versions on the "
                           "CPU")
    full_fp32()
    if restore:
        state = load_train_checkpoint(restore, device, train_cfg)
        set_state = getattr(loader, "set_state", None)
        if set_state is not None:
            set_state({"batches": state.step})
        log.info("resumed from %s at step %d", restore, state.step)
    else:
        state = create_train_state(model_cfg, train_cfg, device,
                                   seed=train_cfg.seed)
    t0 = time.perf_counter()
    for batch in loader:
        if state.step >= train_cfg.num_steps:
            break
        lr = state.optimizer.param_groups[0]["lr"]
        state, metrics = train_step(
            state, batch, iters=train_cfg.train_iters,
            loss_gamma=train_cfg.loss_gamma, max_flow=train_cfg.max_flow,
            gru_telemetry=train_cfg.gru_telemetry)
        if on_step is not None:
            on_step(state.step, metrics)
        if state.step % LOG_EVERY == 0:
            log.info("step %d: loss %.4f, grad_norm %.4f, lr %.3e, "
                     "%.3f s/step", state.step, float(metrics["loss"]),
                     float(metrics["grad_norm"]), lr,
                     (time.perf_counter() - t0) / LOG_EVERY)
            t0 = time.perf_counter()
        if (checkpoint_dir and train_cfg.validation_frequency
                and state.step % train_cfg.validation_frequency == 0):
            save_train_checkpoint(
                os.path.join(checkpoint_dir, f"{state.step}_{name}"), state)
    if checkpoint_dir:
        save_train_checkpoint(os.path.join(checkpoint_dir, name), state)
    return state
