"""A module's parameters on another device of a group, differentiably.

The context-parallel executors (``rows_sharded.py``, ``rows_gru.py``)
run shard *i* of a model's computation on the group's device *i*, while
the model's parameters live on the group's first device.  Where a shard's
device differs, ``on_device`` runs the module with every parameter and
buffer replaced by its ``.to(device)`` copy: a differentiable copy, so
each shard's gradient returns to the one parameter on the first device
(autograd sums them), and an optimizer, DDP and the checkpoints see the
model as it is.  Where every tensor already lies on the device (the CPU,
or a group of one card named n times) the module runs as it is.

The swap is made on the module itself, and the autograd engine runs each
card's backward on a thread of its own, where a remat recompute enters
``on_device`` again: so every use, the unswapped one included, holds the
module's lock, and the shards' recomputes take the module one at a time.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, Optional

import torch
from torch.nn.utils.stateless import _reparametrize_module

_LOCKS: "weakref.WeakKeyDictionary[torch.nn.Module, threading.RLock]" = (
    weakref.WeakKeyDictionary())
_LOCKS_GUARD = threading.Lock()


def moved_state(module: torch.nn.Module, device: torch.device
                ) -> Optional[Dict[str, torch.Tensor]]:
    """Copies on ``device`` of ``module``'s parameters and buffers, or
    None where they all lie there already.  Under inference mode the
    copies are made as ordinary tensors without autograd history: an
    inference tensor has no version counter, which the gate kernel's
    weight-packing cache keys on (kernels/gru_fused._packed), so the
    copies pack once per forward and not once per launch."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    if all(t.device == device for t in tensors.values()):
        return None
    if torch.is_inference_mode_enabled():
        with torch.inference_mode(False), torch.no_grad():
            return {k: v.to(device) for k, v in tensors.items()}
    return {k: v.to(device) for k, v in tensors.items()}


def _lock(module: torch.nn.Module) -> threading.RLock:
    with _LOCKS_GUARD:
        lock = _LOCKS.get(module)
        if lock is None:
            lock = _LOCKS[module] = threading.RLock()
        return lock


@contextlib.contextmanager
def on_device(module: torch.nn.Module,
              moved: Optional[Dict[str, torch.Tensor]]):
    """Context in which ``module`` runs on ``moved_state``'s copies (None:
    on its own parameters), holding the module's lock."""
    with _lock(module):
        if moved is None:
            yield
        else:
            with _reparametrize_module(module, moved):
                yield
