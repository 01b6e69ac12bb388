"""Weights: the bridge from the JAX package's variables, and the port's
own checkpoint format.

``state_dict_from_jax(variables)`` takes the JAX ``{"params",
"batch_stats"}`` tree as nested dicts of numpy arrays (for instance
``jax.device_get(variables)`` in a JAX session) and returns the port's
state dict.  The port's modules are named after the Flax paths, so the
map is mechanical: the path joins with dots; a conv ``kernel`` (HWIO)
becomes ``weight`` (OIHW); every other leaf keeps its name (norm
``scale``/``bias`` parameters, ``mean``/``var`` buffers).  Every leaf is
used exactly once, so ``load_state_dict(strict=True)`` checks the rest.
A quantized tree (the JAX package's ``quantize_variables``) maps too: a
``{q8, qscale[, ascale]}`` kernel pack becomes ``<path>.q8`` (int8, HWIO
-> OIHW), ``<path>.qscale`` ([1,1,1,O] -> [O]) and ``<path>.ascale``.

A port checkpoint is a directory with ``config.json`` and a
``torch.save``d state dict in ``weights.pt``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "weights.pt"


_PACK = {"q8", "qscale", "ascale"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _convert(path: Tuple[str, ...], leaf) -> Tuple[Tuple[str, ...],
                                                   np.ndarray]:
    """One JAX leaf -> (port path, array)."""
    name = path[-1]
    if len(path) >= 2 and path[-2] == "kernel" and name in _PACK:
        path = path[:-2] + (name,)        # kernel/q8 -> <module>.q8
        if name == "q8":
            return path, np.asarray(leaf, np.int8).transpose(3, 2, 0, 1)
        arr = np.asarray(leaf, np.float32)
        return path, arr.reshape(-1) if name == "qscale" else arr
    arr = np.asarray(leaf, dtype=np.float32)
    if name == "kernel":
        if arr.ndim != 4:
            raise ValueError(f"{'/'.join(path)}: conv kernel of rank "
                             f"{arr.ndim}")
        return path[:-1] + ("weight",), arr.transpose(3, 2, 0, 1)  # OIHW
    return path, arr


def state_dict_from_jax(variables: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX variables tree of numpy arrays."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            path, arr = _convert(path, leaf)
            key = ".".join(path)
            if key in out:
                raise ValueError(f"two JAX leaves map to {key}")
            out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def save_checkpoint(directory: str, config: RaftStereoConfig,
                    state_dict: Mapping[str, torch.Tensor]) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, CONFIG_FILE), "w") as f:
        f.write(config.to_json())
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(directory, WEIGHTS_FILE))


def load_checkpoint(directory: str
                    ) -> Tuple[RaftStereoConfig, Dict[str, torch.Tensor]]:
    with open(os.path.join(directory, CONFIG_FILE)) as f:
        config = RaftStereoConfig.from_dict(json.load(f))
    state = torch.load(os.path.join(directory, WEIGHTS_FILE),
                       map_location="cpu", weights_only=True)
    return config, state
