"""Row-sharded (context-parallel) full-resolution encoding (the JAX
package's ``parallel/rows_sharded.py``, NCHW).

At full-resolution inputs the encoders' stem activations set the peak
device memory, and stereo correlation is per image row, so the image-row
(H) axis is the context axis.  ``rows_sharded_trunk_apply`` runs the
trunk's full-resolution segment (models/banded.py ``_segment``) with H
split over the ``rows`` devices of a group (``parallel/mesh.py``), driven
by this one process:

* shard *i* holds rows ``[i·H/n, (i+1)·H/n)`` on device *i*, with
  ``halo`` rows copied from each neighbour's slab (the JAX ``ppermute``);
  the edge shards get zero halos, which the segment's row mask turns into
  the zero padding the full-image convolution sees;
* instance-norm statistics are the only global coupling: the shards run
  the segment in step, pausing at each of its five instance norms, and
  every shard gathers the others' masked (mean, M2, count) moments (a
  few KB, each image row counted once, by the shard that owns it) and
  combines them with Chan's formula, as the banded executor combines its
  bands (the JAX ``all_gather``);
* the half-resolution tail (models/banded.py ``trunk_tail``) runs on the
  group's first device over the crops gathered there.

Every exchange is a differentiable copy, so autograd derives the
transposes the JAX package's ``shard_map`` derives.  The JAX executor's
sharding constraints on its outputs work around XLA's SPMD partitioner
(its conv-kernel-gradient double count); an eager single controller has
no partitioner, so they have no counterpart here.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

from raft_stereo_tpu_torch.models.banded import (_HALO, _segment_steps,
                                                 chan_combine, masked_moments,
                                                 trunk_tail)
from raft_stereo_tpu_torch.parallel.group import moved_state, on_device
from raft_stereo_tpu_torch.parallel.mesh import ROWS_AXIS, Mesh

# Halo rows exchanged with each neighbour: the segment's receptive-field
# half-width (models/banded._HALO, 8 rows) with 2x margin, stride-2/4
# aligned.
DEFAULT_HALO = 2 * _HALO

# The active (mesh, axis), per thread (a serving engine's xl workers
# each drive their own group from their own thread).
_state = threading.local()


@contextlib.contextmanager
def rows_sharding(mesh: Mesh, axis: str = ROWS_AXIS):
    """Activate ``(mesh, axis)`` for row-sharded encoding (and, with
    ``rows_gru``, the row-sharded GRU loop) within the block: wrap every
    forward of a model whose config has ``rows_shards > 1``.  The JAX
    package's default axis is its data axis, which is the process group
    in the port; the port's default is the rows axis of the group."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {axis!r} axis")
    prev = getattr(_state, "active", None)
    _state.active = (mesh, axis)
    try:
        yield mesh
    finally:
        _state.active = prev


def active_rows_mesh() -> Optional[Tuple[Mesh, str]]:
    return getattr(_state, "active", None)


def rows_sharded_trunk_apply(trunk, x: torch.Tensor, norm_fn: str,
                             mesh: Mesh, axis: str = ROWS_AXIS,
                             halo: int = DEFAULT_HALO) -> torch.Tensor:
    """``trunk(x)`` (a ``Trunk`` with ``downsample=2``) with its
    full-resolution segment's rows split over ``mesh``'s ``axis``
    devices: the quarter-resolution trunk output on ``x``'s device.

    ``x``: (B, 3, H, W); H must be divisible by ``4 * n``."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    b, c, h, w = x.shape
    if h % (4 * n):
        raise ValueError(f"H={h} must be divisible by 4*n_shards={4 * n}")
    if halo % 4:
        raise ValueError(f"halo={halo} must be divisible by 4")
    slab_h = h // n
    if slab_h < halo:
        # one exchange can only supply rows from the ADJACENT slab
        raise ValueError(
            f"per-shard height H/n = {slab_h} is smaller than halo={halo}; "
            f"use fewer shards or a smaller halo (>= {2 * _HALO} rows of "
            f"receptive field are required for exactness)")
    slabs = [x[:, :, i * slab_h:(i + 1) * slab_h].to(dev)
             for i, dev in enumerate(devices)]
    steps, owned, moved = [], [], []
    for i, dev in enumerate(devices):
        zeros = torch.zeros((b, c, halo, w), dtype=x.dtype, device=dev)
        above = slabs[i - 1][:, :, -halo:].to(dev) if i else zeros
        below = slabs[i + 1][:, :, :halo].to(dev) if i < n - 1 else zeros
        haloed = torch.cat([above, slabs[i], below], dim=2)
        g = torch.arange(slab_h + 2 * halo, device=dev) + i * slab_h - halo
        in_image = (g >= 0) & (g < h)
        # the rows this shard owns: the statistics count each row once
        owned.append(((g >= i * slab_h) & (g < (i + 1) * slab_h))[
            None, None, :, None])
        moved.append(moved_state(trunk, dev))
        steps.append(_segment_steps(trunk, haloed, 6, in_image))

    # the shards run the segment in step: each pauses at norm k, the
    # moments are exchanged, each resumes with the global statistics
    replies, outs = [None] * n, [None] * n
    while True:
        inputs = []
        for i in range(n):
            with on_device(trunk, moved[i]):
                try:
                    inputs.append(steps[i].send(replies[i])[1])
                except StopIteration as done:
                    outs[i] = done.value
        if inputs and len(inputs) != n:
            raise AssertionError("rows shards left the segment apart")
        if not inputs:
            break
        if norm_fn != "instance":
            replies = [None] * n
            continue
        moments = [masked_moments(t, owned[i], w)
                   for i, t in enumerate(inputs)]
        replies = []
        for dev in devices:
            mean, var = chan_combine(
                torch.stack([m[0].to(dev) for m in moments]),
                torch.stack([m[1].to(dev) for m in moments]),
                torch.stack([m[2].to(dev) for m in moments]))
            replies.append((mean[:, :, None, None], var[:, :, None, None]))
    crop = slice(halo // 2, halo // 2 + slab_h // 2)
    u = torch.cat([o[0][:, :, crop].to(x.device) for o in outs], dim=2)
    v = torch.cat([o[1][:, :, crop].to(x.device) for o in outs], dim=2)
    return trunk_tail(trunk, u, v)
