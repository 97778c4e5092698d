"""Device meshes of the tiled solver, mirroring opticalflowhs_tpu/dist/mesh.py.

A mesh is a (batch, y, x) grid of torch devices in ONE process, with the
reference's axis names: "batch" splits (B, H, W) stacks, "y" and "x" tile
the pixel grid. A shard is a tensor on its device, and several shards may
share a device: `make_mesh(cfg, [torch.device("cuda", 0)] * 16)` is a
virtual 4 x 4 mesh on one card, which runs the whole decomposition (halo
exchange, true-edge clamps, global color parity, the ring kernels' halo
stores and flag waits) on that card; `["cpu"] * 8` is the CPU tests' mesh;
on four cards of one host one shard per card moves its halos by peer copies
and peer stores over NVLink. The reference is single-controller too: its
mesh is jax devices under one process, and its tests run 8 fake CPU
devices. Multi-process meshes (dist/multihost.py of the reference) are not
ported yet (ROADMAP.md queue 1, item 6.5, the last module of the port).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from opticalflowhs_tpu_torch.config import MeshConfig


class Mesh:
    """An object array of torch devices shaped (batch, y, x)."""

    def __init__(self, devices: np.ndarray, axis_names=("batch", "y", "x")):
        kinds = {d.type for d in devices.flat}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(
                f"a mesh takes CPU devices or CUDA devices, not {sorted(kinds)}: "
                "a shard's kernels and its neighbours' must run on one kind"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as the reference's Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device that receives whole frames and the assembled flow."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("batch", "y", "x") Mesh of batch*y*x devices.

    By default the mesh takes every CUDA device, one shard each, and raises
    ValueError, as the reference does, when it needs more devices than
    exist. Give `devices` to choose them; a device may repeat, so
    `[torch.device("cuda", 0)] * 16` is a virtual 4 x 4 mesh on one card.
    A mesh that mixes CPU and CUDA devices raises ValueError."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_as_device(d) for d in devices]
    n = cfg.batch * cfg.y * cfg.x
    if n > len(devices):
        raise ValueError(f"mesh {cfg.shape} needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(cfg.shape), cfg.axis_names)


def mesh_for_devices(n: int, batch: int = 1) -> MeshConfig:
    """Factor n devices into a near-square (batch, y, x) spatial tiling."""
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    spatial = n // batch
    y = int(np.sqrt(spatial))
    while spatial % y != 0:
        y -= 1
    return MeshConfig(batch=batch, y=y, x=spatial // y)
