"""Forward-backward consistency and occlusion masks, mirroring
opticalflowhs_tpu/consistency.py.

A flow vector is trustworthy only where the backward flow, sampled at the
forward target, cancels it. Occluded or unreliable pixels fail

    |f_fwd(x) + f_bwd(x + f_fwd(x))|^2  >  a*(|f_fwd(x)|^2
                                            + |f_bwd(x + f_fwd(x))|^2) + b

with (a, b) = (0.01, 0.5) by default. Both directions solve as one batch-2
solve (batch.solve_stack: HS, Lucas-Kanade with `lk=` or TV-L1 with
`tvl1=`), so they share every kernel launch. The functions take one (H, W)
flow or a (B, H, W) stack of flows.
"""

from __future__ import annotations

from typing import Optional

import torch

from opticalflowhs_tpu_torch.batch import reject_unported, solve_stack
from opticalflowhs_tpu_torch.config import HSConfig, PyramidConfig
from opticalflowhs_tpu_torch.ops.stencils import store
from opticalflowhs_tpu_torch.pyramid import warp
from opticalflowhs_tpu_torch.solver import Flow, as_frame, resolve_omega


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
    device=None,
) -> tuple[Flow, Flow]:
    """(forward, backward) flow of one (H, W) pair through a single batch-2
    solve: HS with (cfg, pyr), or with `lk` the Lucas-Kanade family, with
    `tvl1` the TV-L1 family (cfg is then ignored; pyr defaults to one
    level). numpy frames go to `device`, as in hs_solve. SOR's omega == 0
    is tuned on the pair before the batch-2 solve, which would refuse it."""
    reject_unported(lk, tvl1, mesh)
    if i1.ndim != 2:
        raise ValueError(f"expected (H, W) frames, got {tuple(i1.shape)}")
    i1 = as_frame(i1, device)
    i2 = as_frame(i2, i1.device)
    if lk is None and tvl1 is None:
        cfg = resolve_omega(i1, i2, cfg)
    f = solve_stack(torch.stack([i1, i2]), torch.stack([i2, i1]), cfg, pyr, tvl1, lk)
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
    device=None,
) -> tuple[Flow, torch.Tensor]:
    """Forward flow plus its occlusion mask, one call."""
    fwd, bwd = solve_bidirectional(i1, i2, cfg, pyr, lk=lk, tvl1=tvl1,
                                   mesh=mesh, device=device)
    return fwd, occlusion_mask(fwd, bwd, a=a, b=b)
