"""Distribution layer, mirroring opticalflowhs_tpu/dist/: the tiled solve of
one image over a ("batch", "y", "x") mesh of devices in one process, with
halo exchange between the shards.

  mesh.py           Mesh, make_mesh (virtual meshes: a device may repeat),
                    mesh_for_devices
  halo.py           halo_pad (two-phase exchange), pad_grid, unpad,
                    replicate_global_edges, set_fault_hook
  tiled_solver.py   hs_solve_tiled: halo copies + K9 (halo_impl="ppermute")
                    or K11/K12 with the exchange inside (halo_impl="rdma")
  pyramid_tiled.py  hs_pyramid_tiled (config 5)
"""

from opticalflowhs_tpu_torch.dist.halo import halo_pad
from opticalflowhs_tpu_torch.dist.mesh import Mesh, make_mesh, mesh_for_devices
from opticalflowhs_tpu_torch.dist.pyramid_tiled import hs_pyramid_tiled
from opticalflowhs_tpu_torch.dist.tiled_solver import hs_solve_tiled

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_for_devices",
    "halo_pad",
    "hs_solve_tiled",
    "hs_pyramid_tiled",
]
