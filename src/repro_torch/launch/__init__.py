"""Launch layer of the port: the device mesh one controller drives
(``repro_torch.launch.mesh``)."""

from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_mesh,
                                     make_production_mesh, mesh_chips)

__all__ = ["Mesh", "make_mesh", "make_host_mesh", "make_production_mesh",
           "mesh_chips"]
