"""Train state: the model with its fp32 parameters, the optimizer, the
schedule and the step count."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.training.optimizer import make_optimizer


@dataclasses.dataclass
class TrainState:
    model: RAFTStereo
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    model_cfg: RaftStereoConfig
    train_cfg: TrainConfig
    step: int = 0


def create_train_state(model_cfg: RaftStereoConfig, train_cfg: TrainConfig,
                       device, seed: int = 0,
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> TrainState:
    """A fresh state on ``device``: the model built from ``seed`` (the
    global RNG is left as it was) or loaded from ``state_dict``.  The
    parameters stay fp32 under mixed precision: the convs cast them to
    bf16 on every call, so the gradients and the update are fp32, as in
    the JAX package (``cast_weights_`` is for inference only)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = RAFTStereo(model_cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model = model.to(device).train()
    optimizer, scheduler = make_optimizer(model.parameters(), train_cfg)
    return TrainState(model, optimizer, scheduler, model_cfg, train_cfg)
