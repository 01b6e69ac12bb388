"""Data-parallel training over ``torch.distributed`` (``distributed``,
the data axis of ``mesh``) and context parallelism over a device group
inside each process: the W2-sharded correlation (``corr_sharded``), the
row-sharded encoder (``rows_sharded``) and the row-sharded GRU loop
(``rows_gru``)."""

from raft_stereo_tpu_torch.parallel import distributed
from raft_stereo_tpu_torch.parallel.mesh import (CORR_AXIS, DATA_AXIS,
                                                 ROWS_AXIS, Mesh, make_mesh,
                                                 mesh_spec_label,
                                                 parse_mesh_spec)

__all__ = ["DATA_AXIS", "CORR_AXIS", "ROWS_AXIS", "Mesh", "make_mesh",
           "mesh_spec_label", "parse_mesh_spec", "distributed"]
