"""Distribution layer, mirroring opticalflowhs_tpu/dist/: the tiled solve of
one image over a ("batch", "y", "x") mesh of devices, in one process or
across processes, with halo exchange between the shards, the reference's
GSPMD routes as data parallelism over the batch axis, and layout changes
between phases.

  mesh.py           Mesh, make_mesh (virtual meshes: a device may repeat;
                    rank-major over the processes of a world),
                    mesh_for_devices
  halo.py           halo_pad (two-phase exchange), pad_grid, unpad,
                    replicate_global_edges, set_fault_hook
  tiled_solver.py   hs_solve_tiled: halo copies + K9 (halo_impl="ppermute")
                    or K11/K12 with the exchange inside (halo_impl="rdma");
                    robust and multigrid through gspmd.py
  pyramid_tiled.py  hs_pyramid_tiled (config 5)
  gspmd.py          the batch groups every GSPMD route and mesh= stack runs on
  reshard.py        Sharded, shard, reshard, time_to_space, space_to_time,
                    timesharded_pairs (import them from the module, as the
                    reference's dist/ package exports none of them; in one
                    process or across the processes of a world)
  transport.py      the moves between processes: halo strips as one
                    batch_isend_irecv a phase, all-gathers, all-reduces
                    (NCCL, or gloo with CUDA tensors staged through the host)
  multihost.py      init_multihost (torch.distributed, one process a card)
                    and the `python -m ...dist.multihost` entry

`init_multihost` is imported on first use, so that `python -m
opticalflowhs_tpu_torch.dist.multihost` runs the module once.
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
    "init_multihost",
]


def __getattr__(name):
    if name == "init_multihost":
        from opticalflowhs_tpu_torch.dist.multihost import init_multihost
        return init_multihost
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
