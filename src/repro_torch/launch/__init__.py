"""Launch layer of the port: the device mesh one controller drives and
the layouts of tensors over it (``repro_torch.launch.mesh``), the
per-cell step bundles (``steps``), the train CLI (``train``), and the
dry run of every cell on a production mesh of meta entries with its
counts and roofline report (``dryrun``, ``collectives``, ``roofline``;
``python -m repro_torch.launch.dryrun --all``, no card needed)."""

from repro_torch.launch.mesh import (Mesh, NamedSharding, PartitionSpec,
                                     Placed, all_gather, gather,
                                     local_tree, make_host_mesh, make_mesh,
                                     make_production_mesh, mesh_chips, place,
                                     place_tree, place_zeros, psum)

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "Placed", "all_gather",
           "gather", "local_tree", "make_mesh", "make_host_mesh",
           "make_production_mesh", "mesh_chips", "place", "place_tree",
           "place_zeros", "psum"]
