"""Launch layer of the port: the device mesh one controller drives and
the layouts of tensors over it (``repro_torch.launch.mesh``)."""

from repro_torch.launch.mesh import (Mesh, NamedSharding, PartitionSpec,
                                     Placed, all_gather, gather,
                                     local_tree, make_host_mesh, make_mesh,
                                     make_production_mesh, mesh_chips, place,
                                     place_tree, place_zeros, psum)

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "Placed", "all_gather",
           "gather", "local_tree", "make_mesh", "make_host_mesh",
           "make_production_mesh", "mesh_chips", "place", "place_tree",
           "place_zeros", "psum"]
