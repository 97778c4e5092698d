"""Forward-backward consistency and occlusion masks, mirroring
opticalflowhs_tpu/consistency.py.

A flow vector is trustworthy only where the backward flow, sampled at the
forward target, cancels it. Occluded or unreliable pixels fail

    |f_fwd(x) + f_bwd(x + f_fwd(x))|^2  >  a*(|f_fwd(x)|^2
                                            + |f_bwd(x + f_fwd(x))|^2) + b

with (a, b) = (0.01, 0.5) by default. Both directions solve as one batch-2
solve (batch.solve_stack: HS, Lucas-Kanade with `lk=` or TV-L1 with
`tvl1=`), so they share every kernel launch; `mesh=` shards it as the
reference does (a spatial mesh: one batch-2 `hs_pyramid_tiled`, or the
tiled LK or TV-L1 entry once a direction; a batch-only mesh: the batched
entry with `mesh=`). The functions take one (H, W) flow or a (B, H, W)
stack of flows.
"""

from __future__ import annotations

from typing import Optional

import torch

from opticalflowhs_tpu_torch.batch import check_family, solve_stack
from opticalflowhs_tpu_torch.config import HSConfig, PyramidConfig
from opticalflowhs_tpu_torch.dist.gspmd import mesh_frames
from opticalflowhs_tpu_torch.dist.pyramid_tiled import hs_pyramid_tiled
from opticalflowhs_tpu_torch.lucas_kanade import lk_solve_tiled
from opticalflowhs_tpu_torch.ops.stencils import store
from opticalflowhs_tpu_torch.pyramid import warp
from opticalflowhs_tpu_torch.solver import Flow, as_frame, resolve_omega
from opticalflowhs_tpu_torch.tvl1 import tvl1_solve_tiled


def _warped_backward(fwd: Flow, bwd: Flow, method: str):
    """The backward flow sampled at the forward targets: two warps. A
    stack always takes the gather, as the reference's `warp` does."""
    return (warp(bwd.u, fwd.u, fwd.v, method),
            warp(bwd.v, fwd.u, fwd.v, method))


def fb_error(fwd: Flow, bwd: Flow, method: str = "gather") -> torch.Tensor:
    """|f_fwd(x) + f_bwd(x + f_fwd(x))| per pixel (for bfloat16 flows
    computed in float32 and rounded once)."""
    bu, bv = _warped_backward(fwd, bwd, method)
    return store(lambda fu, fv, gu, gv: torch.sqrt((fu + gu) ** 2 + (fv + gv) ** 2),
                 fwd.u, fwd.v, bu, bv)


def occlusion_mask(fwd: Flow, bwd: Flow, a: float = 0.01, b: float = 0.5,
                   method: str = "gather") -> torch.Tensor:
    """Boolean mask, True where the forward flow FAILS the forward-backward
    test: occluded or unreliable pixels. bfloat16 flows are widened and
    tested in float32."""
    bu, bv = _warped_backward(fwd, bwd, method)
    fu, fv, bu, bv = (x.float() for x in (fwd.u, fwd.v, bu, bv))  # bfloat16
    err2 = (fu + bu) ** 2 + (fv + bv) ** 2
    mag2 = fu ** 2 + fv ** 2 + bu ** 2 + bv ** 2
    return err2 > a * mag2 + b


def solve_bidirectional(
    i1,
    i2,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    lk=None,
    tvl1=None,
    mesh=None,
    halo_sweeps: int = 1,
    device=None,
) -> tuple[Flow, Flow]:
    """(forward, backward) flow of one (H, W) pair through a single batch-2
    solve: HS with (cfg, pyr), or with `lk` the Lucas-Kanade family, with
    `tvl1` the TV-L1 family (cfg is then ignored; pyr defaults to one
    level). numpy frames go to `device` (with `mesh` and no device, the
    mesh's first device), as in hs_solve. SOR's omega == 0 is tuned on the
    pair before the batch-2 solve, which would refuse it.

    `mesh`, as the reference's: on a mesh with y * x > 1 the HS leg rides
    one batch-2 `hs_pyramid_tiled` (a 1-level pyramid is the tiled solve;
    halo blocks of `halo_sweeps`), and LK and TV-L1 run their tiled entries
    once a direction; a batch-only mesh sends every family through its
    batched entry with `mesh=`."""
    if i1.ndim != 2:
        raise ValueError(f"expected (H, W) frames, got {tuple(i1.shape)}")
    check_family(lk, tvl1)
    i1 = mesh_frames(i1, mesh, device)
    i2 = as_frame(i2, i1.device)
    alt_pyr = pyr if pyr is not None else PyramidConfig(levels=1, iters_per_level=())
    spatial = mesh is not None and mesh.shape["y"] * mesh.shape["x"] > 1
    if spatial and (lk is not None or tvl1 is not None):
        tiled, fam = (lk_solve_tiled, lk) if lk is not None else (tvl1_solve_tiled, tvl1)
        return tiled(i1, i2, fam, alt_pyr, mesh=mesh), tiled(i2, i1, fam, alt_pyr, mesh=mesh)
    if lk is None and tvl1 is None:
        cfg = resolve_omega(i1, i2, cfg)
    b1, b2 = torch.stack([i1, i2]), torch.stack([i2, i1])
    if spatial:
        f = hs_pyramid_tiled(b1, b2, cfg, alt_pyr, mesh=mesh, halo_sweeps=halo_sweeps)
    else:
        f = solve_stack(b1, b2, cfg, pyr, tvl1, lk, mesh=mesh)
    return Flow(f.u[0], f.v[0]), Flow(f.u[1], f.v[1])


def flow_with_occlusion(
    i1,
    i2,
    cfg: HSConfig = HSConfig(),
    pyr: Optional[PyramidConfig] = None,
    a: float = 0.01,
    b: float = 0.5,
    lk=None,
    tvl1=None,
    mesh=None,
    halo_sweeps: int = 1,
    device=None,
) -> tuple[Flow, torch.Tensor]:
    """Forward flow plus its occlusion mask, one call (any family,
    optionally over a mesh: see solve_bidirectional)."""
    fwd, bwd = solve_bidirectional(i1, i2, cfg, pyr, lk=lk, tvl1=tvl1,
                                   mesh=mesh, halo_sweeps=halo_sweeps, device=device)
    return fwd, occlusion_mask(fwd, bwd, a=a, b=b)
