"""Batched flow over (B, H, W) stacks of frame pairs, mirroring
opticalflowhs_tpu/batch.py (config 2: batched HS over a video).

The batch axis is pure data parallelism. On the cuda backend a stack runs
as one chain of launches for the whole stack: K1 over (B, H, W), then the
K2 (Jacobi), K3 (SOR) or K4 (IRLS) launches, each image clamped at its own
edges (the Hopper counterpart of the reference's batched resident kernel
and batched banded sweeps; for SOR and IRLS, of its vmapped single-pair
solve). On the torch backend the plain ops run on the stack; the stencils
act on the last two axes, so each image is solved on its own. Gradients
pass through the stack's kernel entries as through a single pair's
(kernels/autodiff.py).

`solve_stack` picks the family for the stream and consistency entry
points: HS, Lucas-Kanade with `lk=` (lucas_kanade.lk_solve_batched) or
TV-L1 with `tvl1=` (tvl1.tvl1_solve_batched). With `mesh=` a stack splits
over the mesh's "batch" axis (dist/gspmd.py): each group of B / batch
pairs is solved on mesh.devices[g, 0, 0] and the flows are gathered on
the mesh's first device. As the reference's mesh-sharded stacks
(`stacked_ok=False`), each group then takes the single-pair rules: a
Jacobi pyramid warps each image by `pyramid.warp`'s rule (`warp_each`,
with pyr.warp and pyr.warp_radius), not by the stacked route's gather or
tiled R = 4 warp.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from opticalflowhs_tpu_torch.config import HSConfig, LKConfig, PyramidConfig, TVL1Config
from opticalflowhs_tpu_torch.dist.gspmd import mesh_frames, run_groups
from opticalflowhs_tpu_torch.lucas_kanade import lk_solve_batched
from opticalflowhs_tpu_torch.pyramid import (
    add_flows,
    gaussian_pyramid,
    upsample_flow,
    warp_bilinear,
    warp_bilinear_tiled,
    warp_each,
)
from opticalflowhs_tpu_torch.solver import (
    Flow,
    as_frame,
    solve_level,
    storage_dtype,
)
from opticalflowhs_tpu_torch.tvl1 import tvl1_solve_batched


def check_family(lk=None, tvl1=None) -> None:
    """The family options of the stream and consistency entry points:
    ValueError for lk= together with tvl1=, as the reference."""
    if lk is not None and tvl1 is not None:
        raise ValueError("pass at most one of lk= and tvl1=")


def _pyramid_batched(i1: torch.Tensor, i2: torch.Tensor, cfg: HSConfig,
                     pyr: PyramidConfig, stacked_ok: bool = True) -> Flow:
    """The reference's batched pyramid (`_batched_pyramid_impl`):
    batch-aware per-level ops, a batched zero-start residual solve per
    level. For Jacobi it follows the reference's batched-kernel route,
    which warps with the gather when pyr.warp == "gather" and otherwise
    with the tiled warp at R = 4, each image with its own tile means, and
    reads neither "checked" nor warp_radius. For the other solvers, and
    for a mesh-sharded stack (stacked_ok=False), the reference vmaps the
    single-pair body, so each image is warped by `pyramid.warp`'s rule
    with pyr.warp and pyr.warp_radius (`warp_each`)."""
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
            if cfg.solver != "jacobi" or not stacked_ok:
                f2w = warp_each(f2, flow.u, flow.v, pyr.warp, pyr.warp_radius)
            elif pyr.warp == "gather":
                f2w = warp_bilinear(f2, flow.u, flow.v)
            else:
                f2w = warp_bilinear_tiled(f2, flow.u, flow.v)
        dflow = solve_level(f1, f2w, cfg, iters[level])
        flow = dflow if flow is None else add_flows(flow, dflow)
    return flow


def hs_solve_batched(
    i1,
    i2,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    mesh=None,
    device=None,
) -> Flow:
    """Solve flow for a (B, H, W) stack of frame pairs; with a PyramidConfig
    of more than one level, coarse to fine.

    Torch tensors stay on their device; numpy stacks go to `device`
    (cuda:0 when None; RuntimeError without CUDA, so the CPU runs only by
    `device="cpu"` or CPU tensors); both are cast to the config's dtype
    there, and the flow has it. SOR's omega == 0 ("auto") is for single
    pairs only: tune it with `solver.tune_omega` on a representative pair
    and pass the result.

    `mesh`: split the stack over the mesh's "batch" axis (B must divide
    by it; dist/gspmd.py): group g of B / batch pairs is solved on
    mesh.devices[g, 0, 0] by this entry, with the reference's
    single-pair warp rule for a pyramid, and the flow is gathered on the
    mesh's first device. numpy stacks go to the mesh's first device when
    `device` is None."""
    if i1.ndim != 3:
        raise ValueError(f"expected (B, H, W) frame stacks, got {tuple(i1.shape)}")
    if cfg.solver == "sor" and cfg.omega == 0.0:
        raise ValueError(
            "omega=0 (auto) is single-pair only: call solver.tune_omega on "
            "a representative pair and pass the result"
        )
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs "
                         f"{tuple(i2.shape)}")
    i1 = mesh_frames(i1, mesh, device, storage_dtype(cfg))
    i2 = as_frame(i2, i1.device, storage_dtype(cfg))
    if mesh is not None:
        return run_groups(lambda a, b: _solve_batched(a, b, cfg, pyr, False), mesh, i1, i2)
    return _solve_batched(i1, i2, cfg, pyr, True)


def _solve_batched(i1: torch.Tensor, i2: torch.Tensor, cfg: HSConfig,
                   pyr: Optional[PyramidConfig], stacked_ok: bool) -> Flow:
    if pyr is not None and pyr.levels > 1:
        return _pyramid_batched(i1, i2, cfg, pyr, stacked_ok)
    return solve_level(i1, i2, cfg, cfg.iters)


def solve_stack(i1, i2, cfg: HSConfig, pyr: Optional[PyramidConfig] = None,
                tvl1: Optional[TVL1Config] = None,
                lk: Optional[LKConfig] = None, mesh=None) -> Flow:
    """A (B, H, W) stack through the chosen family: `hs_solve_batched`
    with (cfg, pyr), or with `lk` the Lucas-Kanade family, with `tvl1` the
    TV-L1 family (cfg is then ignored), on pyr or, when it is None, one
    level, as the reference's streams; `mesh` splits it over the batch
    axis."""
    if lk is None and tvl1 is None:
        return hs_solve_batched(i1, i2, cfg, pyr, mesh=mesh)
    if pyr is None:
        pyr = PyramidConfig(levels=1, iters_per_level=())
    if lk is not None:
        return lk_solve_batched(i1, i2, lk, pyr, mesh=mesh)
    return tvl1_solve_batched(i1, i2, tvl1, pyr, mesh=mesh)


def video_pairs(frames):
    """(T, H, W) video -> ((T-1, H, W), (T-1, H, W)) consecutive pairs."""
    if frames.ndim != 3:
        raise ValueError(f"expected (T, H, W) video, got {tuple(frames.shape)}")
    return frames[:-1], frames[1:]
