"""Device meshes of the tiled solver, mirroring opticalflowhs_tpu/dist/mesh.py.

A mesh is a (batch, y, x) grid of torch devices with the reference's axis
names: "batch" splits (B, H, W) stacks, "y" and "x" tile the pixel grid. A
shard is a tensor on its device, and several shards may share a device:
`make_mesh(cfg, [torch.device("cuda", 0)] * 16)` is a virtual 4 x 4 mesh on
one card, which runs the whole decomposition (halo exchange, true-edge
clamps, global color parity, the ring kernels' halo stores and flag waits)
on that card; `["cpu"] * 8` is the CPU tests' mesh; on four cards of one
host one shard per card moves its halos by peer copies and peer stores
over NVLink.

A mesh may span processes (dist/multihost.py: one process a card, on
torch.distributed). `ranks` names the process that owns each entry; a mesh
built in an initialized world lays every process's devices out rank-major,
as the reference reshapes `jax.devices()`, which come in process order.
Such a mesh is `collective`: its halos, gathers and reductions go through
the process group (dist/transport.py). A mesh built with no world has every
rank 0 and moves everything by copies in its one process. A process
stacks its shards on a device in coordinate order, so every process
derives where another's shard lies in that process's stack from `ranks`
and `devices` alone (kernels/ring.py), and no index crosses the
processes. `hosts` names each rank's host, for the one route that needs
every process on one host (the ring kernels' stores through CUDA IPC,
`require_one_host`).
"""

from __future__ import annotations

import socket
from typing import Optional, Sequence

import numpy as np
import torch

from opticalflowhs_tpu_torch.config import MeshConfig

# The device of this process in a multi-process world, set by
# dist.multihost.init_multihost; make_mesh's default there.
_PROCESS_DEVICE: Optional[torch.device] = None


class Mesh:
    """An object array of torch devices shaped (batch, y, x), and the rank
    of the process that owns each entry."""

    def __init__(self, devices: np.ndarray, axis_names=("batch", "y", "x"),
                 ranks: Optional[np.ndarray] = None, process_index: int = 0,
                 process_count: int = 1, collective: bool = False,
                 local_device: Optional[torch.device] = None,
                 hosts: Optional[Sequence[str]] = None):
        kinds = {d.type for d in devices.flat}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(
                f"a mesh takes CPU devices or CUDA devices, not {sorted(kinds)}: "
                "a shard's kernels and its neighbours' must run on one kind"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = np.zeros(devices.shape, dtype=int) if ranks is None else ranks
        self.process_index, self.process_count = process_index, process_count
        self.collective = collective
        self._local_device = local_device
        self.hosts = list(hosts) if hosts is not None else None

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as the reference's Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    def is_local(self, coord) -> bool:
        """Whether the calling process owns mesh entry `coord`."""
        return int(self.ranks[coord]) == self.process_index

    @property
    def first(self) -> torch.device:
        """The device that receives whole frames and the assembled flow:
        the calling process's first device of the mesh (every process of a
        multi-process mesh holds the whole frames and the whole flow)."""
        mine = self.devices[self.ranks == self.process_index]
        return mine[0] if mine.size else self._local_device

    def __repr__(self) -> str:
        procs = f", processes={self.process_count}" if self.process_count > 1 else ""
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{procs})"


def require_one_host(mesh: Mesh, what: str) -> None:
    """ValueError for a route that needs every process of the mesh on one
    host: CUDA IPC, through which a process maps its neighbours' memory,
    does not reach another host."""
    if mesh.hosts is None:
        return
    hosts = sorted({mesh.hosts[r] for r in np.unique(mesh.ranks)})
    if len(hosts) > 1:
        raise ValueError(
            f"{what} stores into the neighbours' memory inside the launch, which "
            "across processes goes through CUDA IPC, and CUDA IPC does not reach "
            f"another host: this mesh's processes lie on the hosts {hosts}; use "
            "halo_impl='ppermute' (the halo exchanged between K9 launches)"
        )


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def process_device() -> torch.device:
    """This process's device in a multi-process world: the one
    init_multihost chose, else the current CUDA device; RuntimeError
    without one (nothing falls back to the CPU)."""
    if _PROCESS_DEVICE is not None:
        return _PROCESS_DEVICE
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh over processes takes each process's device from "
            "init_multihost(device=...) or the current CUDA device, and no "
            "CUDA device is available; pass devices= or device='cpu'"
        )
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("batch", "y", "x") Mesh of batch*y*x devices.

    In one process the mesh takes every CUDA device by default, one shard
    each, and raises ValueError, as the reference does, when it needs more
    devices than exist. Give `devices` to choose them; a device may repeat,
    so `[torch.device("cuda", 0)] * 16` is a virtual 4 x 4 mesh on one card.
    A mesh that mixes CPU and CUDA devices raises ValueError.

    In an initialized torch.distributed world every process calls make_mesh
    with its own local devices (`devices`, or by default its own device,
    `process_device()`); the lists are exchanged and laid out rank-major,
    so with 2 processes of 4 shards a (1, 2, 4) mesh has its "y" boundary
    between the processes. The mesh needs at most the world's devices."""
    import torch.distributed as dist

    world = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = ([process_device()] if world else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    local = [_as_device(d) for d in devices]
    rank, size = 0, 1
    if world:
        rank, size = dist.get_rank(), dist.get_world_size()
        lists = [None] * size
        dist.all_gather_object(lists, (socket.gethostname(), [str(d) for d in local]))
        hosts = [host for host, _ in lists]
        devices = [torch.device(d) for _, lst in lists for d in lst]
        owners = [r for r, (_, lst) in enumerate(lists) for _ in lst]
    else:
        devices, owners, hosts = local, [0] * len(local), None
    n = cfg.batch * cfg.y * cfg.x
    if n > len(devices):
        raise ValueError(f"mesh {cfg.shape} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    ranks = np.asarray(owners[:n], dtype=int).reshape(cfg.shape)
    return Mesh(arr.reshape(cfg.shape), cfg.axis_names, ranks, rank, size, world,
                local[0] if local else None, hosts)


def mesh_for_devices(n: int, batch: int = 1) -> MeshConfig:
    """Factor n devices into a near-square (batch, y, x) spatial tiling."""
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    spatial = n // batch
    y = int(np.sqrt(spatial))
    while spatial % y != 0:
        y -= 1
    return MeshConfig(batch=batch, y=y, x=spatial // y)
