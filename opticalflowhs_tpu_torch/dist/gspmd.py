"""Data-parallel routes over a mesh's "batch" axis: the port's counterpart
of the reference's GSPMD routes.

The reference computes tiled robust and multigrid solves
(`_tiled_robust_impl`, `_tiled_mg_impl`, `_level_solve_gspmd`), the tiled
TV-L1 and Lucas-Kanade pyramids and every `mesh=` stack as global jit ops
under `with_sharding_constraint`, and lets XLA partition them; its
docstrings promise values equal to the untiled path. Torch has no such
partitioner, so here:

  * the batch axis is real data parallelism: a (B, H, W) stack splits into
    mesh.shape["batch"] contiguous groups, group g runs on
    mesh.devices[g, 0, 0] through the untiled batched entry, and the flows
    are gathered onto the mesh's first device, where every tiled entry
    returns its flow;
  * within a group the y and x axes are not split: the group's whole
    frames are solved on its first device by the untiled entry, with the
    untiled entry's kernels (K1 + K4 for robust, K1 + the plain V-cycles
    for multigrid, K5 for TV-L1, plain torch for Lucas-Kanade, K1 + K2/K3
    for Jacobi and SOR stacks). The values equal the untiled solve bitwise
    (ROADMAP.md queue 3 records why the shards are not split further).

A single (H, W) pair uses no batch axis, as the reference's P("y", "x"),
and is solved on the mesh's first device. Gradients pass through the
copies and the untiled entries (kernels/autodiff.py).

On a mesh that spans processes (dist/multihost.py) every process holds the
whole frames: each solves the batch groups whose device it owns, and the
groups' flows are all-gathered in group order (dist/transport.py), so
every process returns the whole flow on its own first device; a pair is
solved by the process that owns mesh entry (0, 0, 0) and broadcast.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from opticalflowhs_tpu_torch.dist import transport
from opticalflowhs_tpu_torch.dist.mesh import Mesh
from opticalflowhs_tpu_torch.solver import Flow, as_frame


def check_batch(b: int, mesh: Mesh) -> None:
    """ValueError, with the reference's message, for a stack of b pairs
    that the mesh's batch axis does not divide."""
    if b % mesh.shape["batch"]:
        raise ValueError(
            f"batch {b} not divisible by mesh batch {mesh.shape['batch']}"
        )


def mesh_frames(a, mesh: Optional[Mesh], device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`solver.as_frame` for an entry that takes `mesh=`: numpy frames go
    to `device`, or with a mesh and no device to the mesh's first device; a
    tensor stays where it is (the groups' copies move it)."""
    if mesh is not None and device is None and isinstance(a, np.ndarray):
        device = mesh.first
    return as_frame(a, device, dtype)


def group_devices(mesh: Mesh) -> list[torch.device]:
    """The device each batch group runs on: mesh.devices[g, 0, 0]."""
    return [mesh.devices[g, 0, 0] for g in range(mesh.shape["batch"])]


def run_groups(fn: Callable[..., Flow], mesh: Mesh, *stacks: torch.Tensor) -> Flow:
    """Split the (B, ...) stacks into the mesh's batch groups, call
    fn(*group_stacks) for each on its group's device, and return the
    concatenated flow on the mesh's first device. Each group's launches
    are queued without a host synchronisation of their own, so groups on
    different cards overlap."""
    check_batch(stacks[0].shape[0], mesh)
    k = stacks[0].shape[0] // mesh.shape["batch"]
    groups = list(range(mesh.shape["batch"]))
    flows = {g: fn(*(s[g * k:(g + 1) * k].to(dev) for s in stacks))
             for g, dev in enumerate(group_devices(mesh)) if mesh.is_local((g, 0, 0))}
    flows = [flows[g] for g in groups] if not mesh.collective else _share(flows, mesh, groups)
    first = mesh.first
    if len(flows) == 1:
        return Flow(flows[0].u.to(first), flows[0].v.to(first))
    return Flow(torch.cat([f.u.to(first) for f in flows]),
                torch.cat([f.v.to(first) for f in flows]))


def run_pair_or_groups(fn: Callable[..., Flow], mesh: Mesh, i1: torch.Tensor,
                       i2: torch.Tensor) -> Flow:
    """An (H, W) pair through fn on the mesh's first device; a (B, H, W)
    stack through `run_groups`."""
    if i1.ndim == 2:
        if not mesh.collective:
            return fn(i1.to(mesh.first), i2.to(mesh.first))
        own = {0: fn(i1.to(mesh.first), i2.to(mesh.first))} if mesh.is_local((0, 0, 0)) else {}
        return _share(own, mesh, [0])[0]
    return run_groups(fn, mesh, i1, i2)


def _share(flows: dict, mesh: Mesh, groups: list) -> list[Flow]:
    """The flows of `groups` (this process's own in `flows`, by group) on
    every process of a mesh that spans processes, each (u, v) as one
    tensor, on the mesh's first device."""
    own = {g: torch.stack([f.u, f.v]) for g, f in flows.items()}
    every = transport.all_gather_owned(own, groups, lambda g: int(mesh.ranks[g, 0, 0]),
                                       mesh.first)
    return [Flow(every[g][0], every[g][1]) for g in groups]
