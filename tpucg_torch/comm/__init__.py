"""Process groups and the transport of the distributed solves."""

from tpucg_torch.comm.mesh import ROWS_AXIS, Mesh, init_distributed, make_mesh

__all__ = ["ROWS_AXIS", "Mesh", "init_distributed", "make_mesh"]
