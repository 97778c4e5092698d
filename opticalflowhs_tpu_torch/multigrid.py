"""Geometric multigrid for the Horn-Schunck linear system (solver="multigrid"),
mirroring opticalflowhs_tpu/multigrid.py.

Each pyramid level's HS problem is one linear system in (u, v):

    L(u, v) = (alpha^2 (u - ubar) + Ex (Ex u + Ey v),
               alpha^2 (v - vbar) + Ey (Ex u + Ey v))  =  b
    b       = (-Ex Et, -Ey Et)

V(NU1, NU2) cycles smooth it with 4-color Gauss-Seidel (an exact per-pixel
2x2 solve, omega 1), restrict the residual by full weighting, correct from
the coarser grid by bilinear prolongation, and solve the coarsest grid
with CS_SWEEPS smoothing sweeps. The coarse operators restrict the data
products (Ex^2, Ex*Ey, Ey^2), not Ex and Ey, and scale them and the
restricted residual by 4 a level (the h^2 scaling of the smoothness term);
see the reference's module docstring for why both matter. Every cycle ends
by smoothing the fine equation, so the coarse grids only precondition: the
converged flow is the fixed point of the Jacobi sweeps.

Plain PyTorch on every device, as the reference runs jnp on every backend
(its solver.py:148-155): a cycle is mostly small coarse grids, and on the
cuda backend only the derivatives (K1) run as a kernel. Every op acts on
the last two axes, so a (B, H, W) stack is solved in one pass and equals a
loop of single solves. Gradients pass through K1's entry
(kernels/autodiff.py) and the plain cycles, which torch tapes whole.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.config import HSConfig
from opticalflowhs_tpu_torch.ops import stencils

# V(NU1, NU2) cycles; the coarsest grid is solved by CS_SWEEPS GS sweeps.
NU1 = 2
NU2 = 2
CS_SWEEPS = 32
MIN_SIDE = 8  # stop coarsening when min(h, w) would drop below this


def hs_operator(u, v, exx, exy, eyy, a2):
    """Apply L (the homogeneous HS operator, right-hand side excluded)."""
    lu = a2 * (u - stencils.neighbor_avg(u)) + exx * u + exy * v
    lv = a2 * (v - stencils.neighbor_avg(v)) + exy * u + eyy * v
    return lu, lv


def residual(u, v, gu, gv, exx, exy, eyy, a2):
    lu, lv = hs_operator(u, v, exx, exy, eyy, a2)
    return gu - lu, gv - lv


def gs_general(u, v, gu, gv, lvl, n: int):
    """n sweeps of general-RHS 4-color Gauss-Seidel on L x = g: per color,
    the per-pixel 2x2 system (alpha^2 I + M) x = alpha^2 nbar + g solved
    exactly through the closed-form inverse (idet precomputed)."""
    exx, exy, eyy, a2, idet, colors = lvl
    for _ in range(n):
        for cm in colors:
            mu = a2 * stencils.neighbor_avg(u) + gu
            mv = a2 * stencils.neighbor_avg(v) + gv
            xu = ((a2 + eyy) * mu - exy * mv) * idet
            xv = ((a2 + exx) * mv - exy * mu) * idet
            u = torch.where(cm, xu, u)
            v = torch.where(cm, xv, v)
    return u, v


def restrict(a):
    """Full-weighting restriction: [1,2,1]x[1,2,1]/16, then a 2x subsample,
    with clamped edges. Each separable pass subsamples its own axis right
    away, as the reference does; that equals filter-then-[::2, ::2]
    bitwise, since the passes are independent."""
    t = stencils.shift_down_row(a) + 2.0 * a + stencils.shift_up_row(a)
    t = t[..., ::2, :]
    s = stencils.shift_right_col(t) + 2.0 * t + stencils.shift_left_col(t)
    return s[..., :, ::2] * (1.0 / 16.0)


def prolong(a, h: int, w: int):
    """Bilinear prolongation to (h, w): coarse points land on even fine
    indices, odd indices average their neighbours (clamped at the far
    edge)."""
    hc, wc = a.shape[-2:]
    rows = torch.stack([a, 0.5 * (a + stencils.shift_up_row(a))], dim=-2)
    rows = rows.reshape(*a.shape[:-2], 2 * hc, wc)[..., :h, :]
    cols = torch.stack([rows, 0.5 * (rows + stencils.shift_left_col(rows))], dim=-1)
    return cols.reshape(*rows.shape[:-1], 2 * wc)[..., :w]


def _level(exx, exy, eyy, a2):
    h, w = exx.shape[-2:]
    det = (a2 + exx) * (a2 + eyy) - exy * exy  # >= a2^2 > 0 (M is SPD)
    return (exx, exy, eyy, a2, 1.0 / det,
            stencils.color_masks(h, w, device=exx.device))


def _build_levels(ex, ey, alpha: float):
    """The coefficient hierarchy, coarsened until MIN_SIDE. The data
    products are restricted and scaled by 4 a level."""
    a2 = alpha * alpha
    exx, exy, eyy = ex * ex, ex * ey, ey * ey
    levels = [_level(exx, exy, eyy, a2)]
    while True:
        h, w = exx.shape[-2:]
        if min(h, w) <= 2 * MIN_SIDE or min(h, w) <= 3:
            return levels
        exx, exy, eyy = (4.0 * restrict(c) for c in (exx, exy, eyy))
        levels.append(_level(exx, exy, eyy, a2))


def _vcycle(levels, k: int, u, v, gu, gv):
    lvl = levels[k]
    if k == len(levels) - 1:
        return gs_general(u, v, gu, gv, lvl, CS_SWEEPS)
    u, v = gs_general(u, v, gu, gv, lvl, NU1)
    exx, exy, eyy, a2 = lvl[:4]
    ru, rv = residual(u, v, gu, gv, exx, exy, eyy, a2)
    # x4: the same h^2 rescaling as the coarse data products.
    rcu, rcv = 4.0 * restrict(ru), 4.0 * restrict(rv)
    ze = torch.zeros_like(rcu)
    ecu, ecv = _vcycle(levels, k + 1, ze, ze, rcu, rcv)
    h, w = u.shape[-2:]
    u = u + prolong(ecu, h, w)
    v = v + prolong(ecv, h, w)
    return gs_general(u, v, gu, gv, lvl, NU2)


def mg_solve(u, v, ex, ey, et, alpha: float, cycles: int):
    """`cycles` V(NU1, NU2) cycles on the HS system from the guess (u, v)."""
    levels = _build_levels(ex, ey, alpha)
    gu = -ex * et
    gv = -ey * et
    for _ in range(cycles):
        u, v = _vcycle(levels, 0, u, v, gu, gv)
    return u, v


def mg_sweeps(u, v, ex, ey, et, inv_den, n: int, cfg: HSConfig):
    """The `solver.sweeps` adapter: n counts V-cycles for this solver.
    inv_den is unused (the levels carry their own 2x2 inverses) but kept
    for the uniform signature."""
    del inv_den
    return mg_solve(u, v, ex, ey, et, cfg.alpha, n)
