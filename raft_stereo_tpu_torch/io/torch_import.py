"""Import the reference's PyTorch ``.pth`` checkpoints into the port.

The JAX package's ``io/torch_import.py`` for the port's state dict: the
published model zoo (raftstereo-{middlebury,eth3d,sceneflow,realtime}.pth)
loads into ``RAFTStereo(config)`` here.  Handles, as the JAX importer does:

* the ``module.`` prefix torch ``DataParallel`` bakes into every key,
* batch norm's ``weight``/``bias``/``running_mean``/``running_var``, which
  become the port's ``scale``/``bias``/``mean``/``var`` (the JAX package's
  names),
* the reference's aliased ``downsample.1`` == ``norm3`` duplicate keys
  (one module registered twice),
* parameters the reference allocates but never uses at n_gru_layers < 3
  (``gru32``/``layer5``/``outputs32``),
* the separate ``convz``/``convr`` gate convs, concatenated into the
  port's ``convzr`` (z first),
* the hidden-dims index-convention flip (``infer_config_from_state_dict``
  reads ``context_zqr_convs.i`` fine to coarse).

Conv weights stay OIHW: the reference and the port are both NCHW.  The
import is checked by construction: every translated tensor must land on
a key of the port's state dict with its exact shape, and every key must
be filled.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Optional, Tuple

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig

log = logging.getLogger(__name__)

_SKIP_SUFFIXES = ("num_batches_tracked",)


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k.removeprefix("module."): v.detach() for k, v in raw.items()}


def infer_config_from_state_dict(state: Dict[str, torch.Tensor],
                                 **overrides) -> RaftStereoConfig:
    """Derive what the weights determine; take the rest from ``overrides``.

    Inferable: n_downsample (mask-head output channels = 9*4^n),
    n_gru_layers (context_zqr_convs ModuleList length), shared_backbone
    (``fnet.*`` absent), hidden and context dims (zqr conv shapes).  Not
    inferable (runtime-only flags): slow_fast_gru, corr_backend, the
    corr_levels/radius split, mixed_precision.
    """
    mask_out = state["update_block.mask.2.weight"].shape[0]
    n_downsample = {9 * 16: 2, 9 * 64: 3, 9 * 4: 1}[mask_out]
    n_gru = len({m.group(1) for k in state
                 if (m := re.match(r"context_zqr_convs\.(\d+)\.", k))})
    shared = not any(k.startswith("fnet.") for k in state)
    # context_zqr_convs.i maps level i fine->coarse: out = 3*hidden_dims[i]
    hidden_dims = tuple(
        state[f"context_zqr_convs.{i}.weight"].shape[0] // 3
        for i in range(n_gru))
    context_dims = tuple(
        state[f"context_zqr_convs.{i}.weight"].shape[1]
        for i in range(n_gru))
    # pad unused coarse levels so len(hidden_dims) stays 3
    while len(hidden_dims) < 3:
        hidden_dims += (hidden_dims[-1],)
        context_dims += (context_dims[-1],)
    defaults = dict(hidden_dims=hidden_dims, context_dims=context_dims,
                    n_gru_layers=n_gru, n_downsample=n_downsample,
                    shared_backbone=shared)
    defaults.update(overrides)
    return RaftStereoConfig(**defaults)


_RES_INNER = ("conv1", "conv2", "norm1", "norm2", "norm3")


def _translate_residual(parts) -> Optional[Tuple[str, ...]]:
    """ResidualBlock inner names; None for keys to skip."""
    head = parts[0]
    if head == "downsample":
        if parts[1] == "0":
            return ("downsample_conv",) + tuple(parts[2:])
        return None  # downsample.1 duplicates norm3
    if head in _RES_INNER:
        return (head,) + tuple(parts[1:])
    raise KeyError(f"unknown residual-block member {parts}")


def _translate(key: str) -> Optional[Tuple[str, ...]]:
    """Reference key (``module.`` stripped) -> the port's module path and
    the reference's leaf name; None for keys to skip."""
    parts = key.split(".")
    root = parts[0]

    if root in ("cnet", "fnet"):
        sub = parts[1]
        if sub in ("conv1", "norm1"):
            return (root, "trunk", sub) + tuple(parts[2:])
        m = re.fullmatch(r"layer([1-5])", sub)
        if m:
            layer, block = m.group(1), parts[2]
            inner = _translate_residual(parts[3:])
            if inner is None:
                return None
            where = (root, "trunk") if int(layer) <= 3 else (root,)
            return where + (f"layer{layer}_{block}",) + inner
        if sub == "conv2":  # fnet's 1x1 output projection
            return (root, "conv2") + tuple(parts[2:])
        m = re.fullmatch(r"outputs(08|16|32)", sub)
        if m:
            res, h = m.group(1), parts[2]
            if res == "32":  # bare Conv2d, no Sequential
                return (root, f"outputs32_{h}_conv") + tuple(parts[3:])
            if parts[3] == "0":  # Sequential[0] = ResidualBlock
                inner = _translate_residual(parts[4:])
                if inner is None:
                    return None
                return (root, f"outputs{res}_{h}_res") + inner
            return (root, f"outputs{res}_{h}_conv") + tuple(parts[4:])
        raise KeyError(f"unknown {root} member: {key}")

    if root == "update_block":
        sub = parts[1]
        if sub in ("encoder", "flow_head") or re.fullmatch(r"gru(08|16|32)",
                                                          sub):
            return ("update_block", sub) + tuple(parts[2:])
        if sub == "mask":
            which = {"0": "mask_conv1", "2": "mask_conv2"}[parts[2]]
            return ("update_block", which) + tuple(parts[3:])
        raise KeyError(f"unknown update_block member: {key}")

    if root == "context_zqr_convs":
        return (f"context_zqr_conv{parts[1]}",) + tuple(parts[2:])

    if root == "conv2":  # shared-backbone head Sequential
        if parts[1] == "0":
            inner = _translate_residual(parts[2:])
            if inner is None:
                return None
            return ("conv2_res",) + inner
        return ("conv2_out",) + tuple(parts[2:])

    raise KeyError(f"unknown root module: {key}")


# The reference's leaf names -> the port's (conv weights keep ``weight``).
_LEAVES = {"bias": "bias", "running_mean": "mean", "running_var": "var"}


def _port_leaf(leaf: str, value: torch.Tensor, key: str) -> str:
    if leaf == "weight":
        return "weight" if value.dim() == 4 else "scale"
    if leaf in _LEAVES:
        return _LEAVES[leaf]
    raise KeyError(f"unknown leaf {leaf!r} in {key}")


def import_torch_checkpoint(path: str,
                            config: Optional[RaftStereoConfig] = None,
                            **config_overrides
                            ) -> Tuple[RaftStereoConfig,
                                       Dict[str, torch.Tensor]]:
    """Load a reference ``.pth`` -> ``(config, state_dict)``; the state
    dict loads into ``RAFTStereo(config)`` with ``strict=True``."""
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

    state = _load_state_dict(path)
    if config is None:
        config = infer_config_from_state_dict(state, **config_overrides)
    with torch.device("meta"):  # shapes only
        template = {k: tuple(v.shape)
                    for k, v in RAFTStereo(config).state_dict().items()}

    out: Dict[str, torch.Tensor] = {}
    skipped = []
    # convz and convr of one GRU, concatenated below (z first) into the
    # port's one ``convzr`` conv over the shared [h, x] input.
    pending_zr: Dict[Tuple[str, ...], Dict[str, torch.Tensor]] = {}
    for key, value in state.items():
        if key.endswith(_SKIP_SUFFIXES):
            continue
        module_path = _translate(key)
        if module_path is None:
            continue
        leaf, module_path = module_path[-1], module_path[:-1]
        if module_path and module_path[-1] in ("convz", "convr"):
            gate = module_path[-1][-1]  # 'z' | 'r'
            pending_zr.setdefault(module_path[:-1] + ("convzr", leaf),
                                  {})[gate] = value
            continue
        entry = ".".join(module_path + (_port_leaf(leaf, value, key),))
        if entry not in template:
            # unused reference modules (gru32/layer5/outputs32 at
            # n_gru_layers < 3)
            skipped.append(key)
            continue
        if tuple(value.shape) != template[entry]:
            raise ValueError(f"{key}: shape {tuple(value.shape)} != "
                             f"expected {template[entry]} at {entry}")
        out[entry] = value.float().clone()

    for (*path, leaf), halves in pending_zr.items():
        if set(halves) != {"z", "r"}:
            raise ValueError(
                f"incomplete convz/convr pair at {'.'.join(path)}: got "
                f"{sorted(halves)}")
        entry = ".".join(path + [leaf])
        if entry not in template:
            skipped.append(entry)  # unused GRU level
            continue
        value = torch.cat([halves["z"], halves["r"]], dim=0)  # O axis
        if tuple(value.shape) != template[entry]:
            raise ValueError(f"fused convzr: shape {tuple(value.shape)} != "
                             f"expected {template[entry]} at {entry}")
        out[entry] = value.float()

    missing = sorted(set(template) - set(out))
    if missing:
        raise ValueError(
            "torch checkpoint left state-dict entries unfilled: "
            + ", ".join(missing[:10])
            + (f" ... +{len(missing) - 10} more" if len(missing) > 10
               else ""))
    if skipped:
        log.info("skipped %d unused reference params (e.g. %s)",
                 len(skipped), skipped[0])
    return config, out
