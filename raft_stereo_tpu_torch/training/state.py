"""Train state: the model with its fp32 parameters, the optimizer, the
schedule and the step count.

Under the anomaly policy (training/step.py ``anomaly_train_step``) the
host cannot know whether an update was applied until the metrics drain,
so the update count that drives the schedule lives on the device
(``count``) and the optimizer is ``make_optimizer(..., anomaly=True)``'s
(a device LR, no host ``LambdaLR``).  Both keep torch AdamW's own state
slots, so a checkpoint restores under the policy on or off."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.training.optimizer import (make_optimizer,
                                                      make_scheduler)


@dataclasses.dataclass
class TrainState:
    model: RAFTStereo
    optimizer: torch.optim.AdamW
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]
    model_cfg: RaftStereoConfig
    train_cfg: TrainConfig
    step: int = 0
    # anomaly policy: the applied-update count, an int64 scalar on the
    # device (the schedule's and AdamW's count); None with the policy off
    count: Optional[torch.Tensor] = None
    # data parallelism: the DistributedDataParallel wrapper over ``model``
    # the step runs its forward through (training/train_loop.py); the
    # checkpoints read ``model`` itself
    ddp: Optional[torch.nn.Module] = None

    def update_count(self) -> int:
        """Updates applied so far (a host sync under the policy)."""
        if self.count is not None:
            return int(self.count)
        return int(self.scheduler.last_epoch)

    def set_count(self, n: int) -> None:
        """Stand at ``n`` applied updates: the device count, or a host
        schedule rebuilt at ``n``."""
        if self.count is not None:
            self.count.fill_(n)
        else:
            self.scheduler = make_scheduler(self.optimizer, self.train_cfg, n)


def create_train_state(model_cfg: RaftStereoConfig, train_cfg: TrainConfig,
                       device, seed: int = 0,
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       anomaly: bool = False) -> TrainState:
    """A fresh state on ``device``: the model built from ``seed`` (the
    global RNG is left as it was) or loaded from ``state_dict``.  The
    parameters stay fp32 under mixed precision: the convs cast them to
    bf16 on every call, so the gradients and the update are fp32, as in
    the JAX package (``cast_weights_`` is for inference only).
    ``anomaly`` builds the state the anomaly policy steps: a device
    update count and no host schedule."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = RAFTStereo(model_cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model = model.to(device).train()
    optimizer, scheduler = make_optimizer(model.parameters(), train_cfg,
                                          anomaly=anomaly)
    count = (torch.zeros((), dtype=torch.int64, device=device) if anomaly
             else None)
    return TrainState(model, optimizer, scheduler, model_cfg, train_cfg,
                      count=count)
