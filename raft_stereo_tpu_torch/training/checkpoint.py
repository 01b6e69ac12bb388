"""The port's training checkpoint.

A checkpoint is a directory holding
* ``config.json`` and ``weights.pt``: the inference checkpoint of
  ``io/jax_weights.save_checkpoint``, so ``InferenceRunner`` and the demo
  load a trained model directly;
* ``train_config.json``: the ``TrainConfig``;
* ``train_state.pt``: the optimizer, the schedule, the step and the
  position of the loader.

It is written into a temporary directory beside its final name and then
renamed, so a crash mid-save leaves the previous checkpoint or an orphan,
never a torn directory.  Restoring it and stepping on gives the same bits
as a run that was never interrupted (on the CPU; cuDNN may choose other
algorithms on the card).
"""

from __future__ import annotations

import json
import os
import shutil
import torch

from raft_stereo_tpu_torch.config import TrainConfig
from raft_stereo_tpu_torch.io.jax_weights import (load_checkpoint,
                                                  save_checkpoint)
from raft_stereo_tpu_torch.training.state import (TrainState,
                                                  create_train_state)

TRAIN_CONFIG_FILE = "train_config.json"
TRAIN_STATE_FILE = "train_state.pt"


def save_train_checkpoint(directory: str, state: TrainState) -> None:
    directory = os.path.abspath(directory)
    tmp = f"{directory}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    save_checkpoint(tmp, state.model_cfg, state.model.state_dict())
    with open(os.path.join(tmp, TRAIN_CONFIG_FILE), "w") as f:
        json.dump(state.train_cfg.to_dict(), f, indent=2, sort_keys=True)
    torch.save({"optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": state.step},
               os.path.join(tmp, TRAIN_STATE_FILE))
    old = f"{directory}.old-{os.getpid()}"
    if os.path.exists(directory):
        os.replace(directory, old)
    os.replace(tmp, directory)
    shutil.rmtree(old, ignore_errors=True)


def load_train_checkpoint(directory: str, device,
                          train_cfg: TrainConfig) -> TrainState:
    """The state saved in ``directory``, on ``device``.  The model config
    is the checkpoint's, as in the JAX package's restore; ``train_cfg`` is
    the caller's (it builds the schedule), and the saved optimizer and
    schedule state give their values."""
    model_cfg, weights = load_checkpoint(directory)
    state = create_train_state(model_cfg, train_cfg, device,
                               state_dict=weights)
    saved = torch.load(os.path.join(directory, TRAIN_STATE_FILE),
                       map_location=device, weights_only=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])
    return state
