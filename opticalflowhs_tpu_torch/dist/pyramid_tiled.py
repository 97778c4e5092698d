"""Mesh-sharded coarse-to-fine pyramid, mirroring opticalflowhs_tpu/dist/pyramid_tiled.py
(the reference's config-5 path: configs/c5_multihost_4k.json).

The hot per-level solve goes through the tiled solver's shard body
(dist/tiled_solver.py: halo exchange, K9 on CUDA shards, true-edge clamps):
each level is zero-padded to the mesh grid and cropped back, so any level
geometry works, and `halo_sweeps` is clamped per level so coarse shards stay
valid (for SOR by its four halo rings a sweep). The cold per-level ops
(binomial downsample, bilinear flow upsample, backward warp) run once per
level, whole, on the mesh's first device,
through pyramid.py. The reference shards them by GSPMD; the values are the
same (ROADMAP.md queue 3). Robust and multigrid levels take the GSPMD
route instead (`tiled_solver.solve_gspmd`: each batch group's level solved
whole by the untiled entry), as the reference routes them through
`_level_solve_gspmd`, never through the Jacobi shard body. Tiled ==
untiled therefore holds for the whole pyramid, bitwise.

On a mesh that spans processes (dist/multihost.py) the cold ops run whole
on every process's first device, from identical inputs: each level's flow
comes back all-gathered (tiled_solver.gather), so every process warps and
upsamples the same whole flow (ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from opticalflowhs_tpu_torch.config import HSConfig, PyramidConfig
from opticalflowhs_tpu_torch.dist.mesh import Mesh
from opticalflowhs_tpu_torch.dist.tiled_solver import (
    GSPMD_SOLVERS,
    _as_tensor,
    _round_up,
    solve_gspmd,
    solve_padded,
)
from opticalflowhs_tpu_torch.pyramid import add_flows, gaussian_pyramid, upsample_flow, warp
from opticalflowhs_tpu_torch.solver import Flow, tune_omega


def _level_solve(f1: torch.Tensor, f2: torch.Tensor, cfg: HSConfig, s: int,
                 mesh: Mesh) -> Flow:
    """One level's residual solve of a (B, H, W) stack: pad to the mesh
    grid, the tiled shard body, crop back."""
    h, w = f1.shape[-2:]
    my, mx = mesh.shape["y"], mesh.shape["x"]
    hp, wp = _round_up(h, my), _round_up(w, mx)
    # The frames' halo (the halo width + 1) must fit a shard; SOR's halo
    # is four rings a sweep. (The reference clamps by the Jacobi rule only,
    # and its SOR pyramids fail on small coarse shards.)
    per_sweep = 4 if cfg.solver == "sor" else 1
    s = max(1, min(s, (hp // my - 1) // per_sweep, (wp // mx - 1) // per_sweep))
    if (hp, wp) != (h, w):
        pad = (0, wp - w, 0, hp - h)
        f1 = torch.nn.functional.pad(f1, pad)
        f2 = torch.nn.functional.pad(f2, pad)
    flow = solve_padded(f1, f2, cfg, s, mesh, h, w)
    return Flow(flow.u[..., :h, :w], flow.v[..., :h, :w])


def hs_pyramid_tiled(
    i1,
    i2,
    cfg: HSConfig = HSConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    mesh: Optional[Mesh] = None,
    halo_sweeps: int = 1,
) -> Flow:
    """Coarse-to-fine pyramidal HS with every level's solve sharded over the
    mesh. Takes (H, W) pairs or (B, H, W) stacks (split over the "batch"
    axis too); returns the flow on the mesh's first device. Equals
    hs_pyramid bitwise, for any geometry; robust and multigrid levels take
    the GSPMD route (`tiled_solver.solve_gspmd`)."""
    if mesh is None:
        raise ValueError("hs_pyramid_tiled requires a Mesh (dist.make_mesh)")
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs {tuple(i2.shape)}")
    if halo_sweeps < 1:
        raise ValueError("halo_sweeps must be >= 1")
    i1 = _as_tensor(i1, cfg).to(mesh.first)
    i2 = _as_tensor(i2, cfg).to(mesh.first)
    if cfg.solver == "sor" and cfg.omega == 0.0:
        # omega = 0 is the identity update: resolve the auto sentinel as
        # hs_pyramid does (single pairs), or reject stacks.
        if i1.ndim != 2:
            raise ValueError(
                "omega=0 (auto) is single-pair only — call "
                "solver.tune_omega on a representative pair"
            )
        cfg = dataclasses.replace(cfg, omega=tune_omega(i1, i2, cfg))
    min_side = min(i1.shape[-2:])
    if min_side // (2 ** (pyr.levels - 1)) < 8:
        raise ValueError(
            f"{pyr.levels} levels would shrink a {tuple(i1.shape[-2:])} frame below 8 px"
        )
    batched = i1.ndim == 3
    if batched and i1.shape[0] % mesh.shape["batch"]:
        raise ValueError(
            f"batch {i1.shape[0]} not divisible by mesh batch {mesh.shape['batch']}"
        )
    p1 = gaussian_pyramid(i1, pyr.levels)
    p2 = gaussian_pyramid(i2, pyr.levels)
    iters: Sequence[int] = pyr.iters_per_level or (cfg.iters,) * pyr.levels

    flow: Optional[Flow] = None
    for level in range(pyr.levels - 1, -1, -1):
        f1, f2 = p1[level], p2[level]
        if flow is None:
            f2w = f2
        else:
            flow = upsample_flow(flow, f1.shape[-2:])
            f2w = warp(f2, flow.u, flow.v, pyr.warp)
        lcfg = dataclasses.replace(cfg, iters=iters[level])
        if cfg.solver in GSPMD_SOLVERS:
            dflow = solve_gspmd(f1, f2w, lcfg, mesh, iters[level])
            flow = dflow if flow is None else add_flows(flow, dflow)
            continue
        stack = (f1, f2w) if batched else (f1[None], f2w[None])
        dflow = _level_solve(*stack, lcfg, halo_sweeps, mesh)
        if not batched:
            dflow = Flow(dflow.u[0], dflow.v[0])
        if flow is None:
            flow = Flow(dflow.u.contiguous(), dflow.v.contiguous())
        else:
            flow = add_flows(flow, dflow)
    return flow
