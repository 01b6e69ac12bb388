"""Data-parallel training over ``torch.distributed``: the process group
(``distributed``) and the data axis (``mesh``).  The context-parallel
executors of the JAX package (rows and corr sharding) are ROADMAP.md §D7."""

from raft_stereo_tpu_torch.parallel import distributed
from raft_stereo_tpu_torch.parallel.mesh import (CORR_AXIS, DATA_AXIS,
                                                 ROWS_AXIS, Mesh, make_mesh,
                                                 mesh_spec_label,
                                                 parse_mesh_spec)

__all__ = ["DATA_AXIS", "CORR_AXIS", "ROWS_AXIS", "Mesh", "make_mesh",
           "mesh_spec_label", "parse_mesh_spec", "distributed"]
