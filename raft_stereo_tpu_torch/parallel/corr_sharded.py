"""Disparity-axis (W2) sharded correlation (the JAX package's
``parallel/corr_sharded.py``).

The ``reg`` volume is O(B·H·W1·W2) memory; at full resolution it
dominates the device's memory.  This module splits the disparity-search
axis W2 over the ``corr`` axis of a device group (``parallel/mesh.py``),
driven by this one process:

* **Build**: shard *i* takes its W-slice of the right features onto its
  device and builds its (B, H, W1, W2/n) slice of the volume there; the
  pyramid is pooled locally (shard widths are divisible by
  2^(levels-1), so 2-wide stride-2 pooling never crosses a shard
  boundary and matches the global floor pooling).  The whole volume
  never exists on one device.
* **Lookup**: linear interpolation is a 2-tap weighted sum, so each
  shard samples its slice at shard-local centres (taps outside the shard
  read zero) and the sum of the shards' lookups on the first device is
  the global window: every global bin is owned by exactly one shard.
  Under ``reg_fused`` that is kernel #1 (``lookup_pyramid_fused``) once
  per shard and iteration with the centres shifted by ``shard·lw_0``;
  under ``reg`` the plain sampler, level by level, as in the JAX package.
  The JAX ``psum`` becomes that sum, its transpose (autograd's) a copy of
  the gradient to every shard.

Exactness: W2 is zero-padded to ``n · 2^(levels-1)`` divisibility (zero
right features give zero correlation), and after every pooling step the
bins whose global index lies at or past the floor-semantics level width
are zeroed, so boundary taps read zero exactly where the unsharded
lookup's out-of-range taps do.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

from raft_stereo_tpu_torch.config import RaftStereoConfig
from raft_stereo_tpu_torch.kernels.corr_lookup import (lookup_pyramid_fused,
                                                       window_coords)
from raft_stereo_tpu_torch.models.corr import build_corr_volume, pool_axis
from raft_stereo_tpu_torch.ops.sampler import linear_sampler_1d
from raft_stereo_tpu_torch.parallel.mesh import CORR_AXIS, Mesh

# The active mesh, per thread: a serving engine's xl workers each drive
# their own group from their own thread.
_state = threading.local()


@contextlib.contextmanager
def corr_sharding(mesh: Mesh):
    """Activate ``mesh`` for W2-sharded correlation within the block:
    wrap every forward of a model whose config has ``corr_w2_shards >
    1`` (training step, evaluation forward)."""
    if CORR_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {CORR_AXIS!r} axis")
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def active_corr_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def _level_widths(w2: int, num_levels: int) -> List[int]:
    """True (unpadded) level widths under floor pooling."""
    widths = [w2]
    for _ in range(num_levels - 1):
        widths.append(widths[-1] // 2)
    return widths


def make_corr_fn_w2_sharded(cfg: RaftStereoConfig, fmap1: torch.Tensor,
                            fmap2: torch.Tensor, mesh: Mesh):
    """The sharded counterpart of ``models.corr.make_corr_fn`` for
    ``reg`` and ``reg_fused``: (B,D,H,W) features -> ``corr_fn(coords)``
    giving (B,H,W1,levels·(2r+1)) on ``fmap1``'s device, in fp32 (the
    caller casts, as after the JAX ``psum``)."""
    n = cfg.corr_w2_shards
    devices = mesh.axis_devices(CORR_AXIS)
    if len(devices) != n:
        raise ValueError(
            f"config asks for corr_w2_shards={n} but mesh {CORR_AXIS!r} axis "
            f"has {len(devices)} devices")
    num_levels = cfg.corr_levels
    radius = cfg.corr_radius
    # build in fp32; reg_fused stores the shard volumes in the incoming
    # compute dtype (bf16 under mixed precision), as the unsharded fused
    # backend stores its volume
    store_dtype = (fmap1.dtype if cfg.corr_backend == "reg_fused"
                   else torch.float32)
    out_device = fmap1.device
    fmap1, fmap2 = fmap1.float(), fmap2.float()
    w2 = fmap2.shape[-1]
    widths = _level_widths(w2, num_levels)
    quantum = n * 2 ** (num_levels - 1)
    w2p = -(-w2 // quantum) * quantum
    if w2p != w2:
        fmap2 = torch.nn.functional.pad(fmap2, (0, w2p - w2))
    lw0 = w2p // n

    pyramids = []
    for shard, dev in enumerate(devices):
        vol = build_corr_volume(
            fmap1.to(dev), fmap2[..., shard * lw0:(shard + 1) * lw0].to(dev))
        pyramid = []
        for level in range(num_levels):
            if level:
                vol = pool_axis(vol)
            lw = vol.shape[-1]
            global_bin = shard * lw + torch.arange(lw, device=dev)
            vol = torch.where(global_bin < widths[level], vol,
                              torch.zeros((), device=dev))
            pyramid.append(vol.to(store_dtype).contiguous())
        pyramids.append(pyramid)

    use_kernel = cfg.corr_backend == "reg_fused"

    def lookup_local(shard: int, coords: torch.Tensor) -> torch.Tensor:
        pyramid = pyramids[shard]
        if use_kernel:
            # one shifted centre serves every level: level l's local
            # centre is (coords - shard·lw_0)/2^l = coords/2^l - shard·lw_l
            # exactly (lw_l = lw_0/2^l by the padding quantum), so the
            # whole pyramid samples in one multi-level launch
            return lookup_pyramid_fused(pyramid, coords - shard * lw0,
                                        radius).float()
        outs = []
        for level, vol in enumerate(pyramid):
            taps = (window_coords(coords, level, radius)
                    - shard * vol.shape[-1])
            outs.append(linear_sampler_1d(vol.float(), taps))
        return torch.cat(outs, dim=-1)

    def corr_fn(coords: torch.Tensor) -> torch.Tensor:
        coords = coords.float()
        total = None
        # each global bin is owned by exactly one shard and out-of-shard
        # taps read zero, so the sum over shards is the global window
        for shard, dev in enumerate(devices):
            out = lookup_local(shard, coords.to(dev)).to(out_device)
            total = out if total is None else total + out
        return total

    corr_fn.pyramids = pyramids
    return corr_fn
