"""The mesh of the port: the data axis over the process group (the JAX
package's ``parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, corr, rows)`` mesh and
lets XLA derive the gradient all-reduce from the batch's sharding.  The
port's data axis is the ``torch.distributed`` group: one process per
card, each holding its contiguous slice of every global batch
(``StereoLoader`` ``process_index``/``process_count``), its model wrapped
in ``DistributedDataParallel``.  The ``corr`` and ``rows`` axes (the
context-parallel executors) are not ported: a mesh asking for them
raises ``NotImplementedError`` (ROADMAP.md §D7).  The mesh spec helpers
of the serving tier's declarations are the JAX package's, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from raft_stereo_tpu_torch.parallel import distributed

DATA_AXIS = "data"
CORR_AXIS = "corr"
ROWS_AXIS = "rows"

_D7 = "§D7 parallel executors"


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
    """The data axis: ``shape`` maps each axis name to its size (corr and
    rows 1), ``rank`` is this process's place on the data axis."""

    shape: Dict[str, int]
    rank: int

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]


def make_mesh(n_data: int = 0, n_corr: int = 1, n_rows: int = 1,
              world_size: Optional[int] = None) -> Mesh:
    """The ``(data, corr, rows)`` mesh over the process group.

    ``n_data`` is the number of data-parallel processes, 0 meaning the
    world size (``world_size``, by default the group's); any other value
    must equal it.  ``n_corr`` or ``n_rows`` above 1 raises
    ``NotImplementedError``."""
    for name, n in (("n_corr", n_corr), ("n_rows", n_rows)):
        if n > 1:
            raise NotImplementedError(
                f"{name}={n} is not ported to the PyTorch package yet "
                f"(ROADMAP.md {_D7})")
    world = distributed.process_count() if world_size is None else world_size
    n = n_data or world
    if n != world:
        raise ValueError(
            f"data_parallel={n} differs from the world size {world}: the "
            f"port runs one data-parallel process per card (launch "
            f"torchrun --nproc_per_node={n})")
    return Mesh({DATA_AXIS: n, CORR_AXIS: 1, ROWS_AXIS: 1},
                distributed.process_index())
