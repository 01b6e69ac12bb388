"""The mesh of the port: the data axis over the process group, and the
rows/corr device group inside each process (the JAX package's
``parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, corr, rows)`` mesh and
lets XLA derive the gradient all-reduce from the batch's sharding.  The
port's data axis is the ``torch.distributed`` group: one process per
card, each holding its contiguous slice of every global batch
(``StereoLoader`` ``process_index``/``process_count``), its model wrapped
in ``DistributedDataParallel``.  The ``corr`` and ``rows`` axes (context
parallelism: ``parallel/corr_sharded.py``, ``rows_sharded.py``,
``rows_gru.py``) are a device group that this one process drives as a
single controller: shard *i* of an image lives on the group's device *i*,
and the executors move halos, moments and lookups between the shards'
devices with differentiable copies.  A group of n on one card is that
card named n times (the port's counterpart of JAX's
``--xla_force_host_platform_device_count``); on the CPU every shard is
the CPU.  The mesh spec helpers of the serving tier's declarations are
the JAX package's, unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from raft_stereo_tpu_torch.parallel import distributed

DATA_AXIS = "data"
CORR_AXIS = "corr"
ROWS_AXIS = "rows"

def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"rows=4"`` / ``"rows=2,corr=2"`` -> ``{"rows": 4, "corr": 2}``:
    the serving tier's mesh declaration, the two inference axes, each
    defaulting to 1.  Raises ``ValueError`` on an unknown axis, a size
    that is not an integer >= 1, an axis named twice or a blank spec."""
    out = {"rows": 1, "corr": 1}
    seen = set()
    parts = [p.strip() for p in str(spec).split(",") if p.strip()]
    if not parts:
        raise ValueError(f"mesh spec {spec!r} is empty: use e.g. 'rows=4' "
                         f"or 'rows=2,corr=2'")
    for part in parts:
        k, sep, v = part.partition("=")
        k = k.strip()
        if k not in out or not sep:
            raise ValueError(
                f"mesh spec {spec!r}: expected comma-separated "
                f"'rows=N'/'corr=N' entries, got {part!r}")
        if k in seen:
            raise ValueError(f"mesh spec {spec!r}: axis {k!r} named twice")
        seen.add(k)
        try:
            out[k] = int(v.strip())
        except ValueError as e:
            raise ValueError(f"mesh spec {spec!r}: size {v!r} for axis "
                             f"{k!r} is not an integer") from e
        if out[k] < 1:
            raise ValueError(f"mesh spec {spec!r}: axis {k!r} size "
                             f"{out[k]} must be >= 1")
    return out


def mesh_spec_label(spec: Dict[str, int]) -> str:
    """Compact stable tag of a parsed mesh spec: ``{"rows": 4, "corr":
    1}`` -> ``"rows4"``, ``{"rows": 2, "corr": 2}`` -> ``"rows2corr2"``,
    nothing sharded -> ``"solo"``."""
    out = ""
    for axis in ("rows", "corr"):
        n = int(spec.get(axis, 1))
        if n > 1:
            out += f"{axis}{n}"
    return out or "solo"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` maps each axis name to its size, ``rank`` is this
    process's place on the data axis, and ``devices`` is this process's
    corr x rows device group, corr-major as the JAX package reshapes its
    grid (``devices[c * n_rows + r]``).  The first device holds the
    model's parameters and the gathered outputs."""

    shape: Dict[str, int]
    rank: int
    devices: Tuple[torch.device, ...] = ()

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (DATA_AXIS, CORR_AXIS, ROWS_AXIS)

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` (``rows`` or ``corr``) through the
        group's first device: shard *i* of that axis runs on entry *i*.
        On a rows x corr group the rows executor (the encoders) runs on
        the first corr row and the corr executor (the volume) on the
        first rows column, as the single controller runs them one after
        the other."""
        n_rows = self.shape[ROWS_AXIS]
        if axis == ROWS_AXIS:
            return tuple(self.devices[:n_rows])
        if axis == CORR_AXIS:
            return tuple(self.devices[::n_rows][:self.shape[CORR_AXIS]])
        raise ValueError(f"mesh axis {axis!r} is not a device axis")


def make_mesh(n_data: int = 0, n_corr: int = 1, n_rows: int = 1,
              world_size: Optional[int] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """The ``(data, corr, rows)`` mesh: the data axis over the process
    group, corr x rows over this process's device group.

    ``n_data`` is the number of data-parallel processes, 0 meaning the
    world size (``world_size``, by default the group's); any other value
    must equal it.  ``devices``: the device group (default: this
    process's local devices, ``distributed.local_devices_stable``), of
    which the first ``n_corr * n_rows`` are used; a group the devices
    cannot supply raises ``ValueError``, with the JAX package's wording.
    A device may be named more than once (several shards on one card)."""
    if n_corr < 1 or n_rows < 1:
        raise ValueError(f"n_corr={n_corr} and n_rows={n_rows} must be "
                         f">= 1")
    world = distributed.process_count() if world_size is None else world_size
    n = n_data or world
    if n != world:
        raise ValueError(
            f"data_parallel={n} differs from the world size {world}: the "
            f"port runs one data-parallel process per card (launch "
            f"torchrun --nproc_per_node={n})")
    if devices is None:
        devices = distributed.local_devices_stable()
    devices = [torch.device(d) for d in devices]
    size = n_corr * n_rows
    if size > len(devices):
        raise ValueError(f"mesh wants {n}×{n_corr}×{n_rows}="
                         f"{n * size} devices but only {len(devices)} are "
                         f"available to this process ({size} needed per "
                         f"process)")
    return Mesh({DATA_AXIS: n, CORR_AXIS: n_corr, ROWS_AXIS: n_rows},
                distributed.process_index(), tuple(devices[:size]))


def mesh_contexts(mesh: Mesh) -> contextlib.ExitStack:
    """The contexts that the model's context-parallel executors read,
    entered for ``mesh``'s axes above 1: ``rows_sharding`` on its rows
    axis and ``corr_sharding`` (parallel/rows_sharded.py,
    corr_sharded.py).  Hold it around every forward of a model whose
    config shards rows or the correlation over ``mesh``."""
    from raft_stereo_tpu_torch.parallel.corr_sharded import corr_sharding
    from raft_stereo_tpu_torch.parallel.rows_sharded import rows_sharding

    stack = contextlib.ExitStack()
    if mesh.shape[ROWS_AXIS] > 1:
        stack.enter_context(rows_sharding(mesh, ROWS_AXIS))
    if mesh.shape[CORR_AXIS] > 1:
        stack.enter_context(corr_sharding(mesh))
    return stack
