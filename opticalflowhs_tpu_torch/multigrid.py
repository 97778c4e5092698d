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

bfloat16 (HSConfig.dtype): the storage rule of the package docstring
(`stencils.store`). The hierarchy is formed in float32 from K1's rounded
Ex and Ey (each coarser level from the rounded finer one), and each
level's exx, exy, eyy and idet are rounded once. The right-hand side,
residuals, restricted residuals and prolonged corrections are rounded
once where stored, and so is each corrected flow. A smoother sweep runs
its four color stages in float32, each reading the earlier stages'
float32 values, and rounds u and v once, at the sweep's end, as an SOR
sweep does. a2 = alpha^2 stays a Python float, which torch rounds to
float32 where it meets a tensor, in both dtypes.
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
    exactly through the closed-form inverse (idet precomputed). bfloat16:
    u and v rounded once a sweep, at its end."""
    exx, exy, eyy, a2, idet, colors = lvl

    def sweep(u, v, gu, gv, exx, exy, eyy, idet):
        for cm in colors:
            mu = a2 * stencils.neighbor_avg(u) + gu
            mv = a2 * stencils.neighbor_avg(v) + gv
            xu = ((a2 + eyy) * mu - exy * mv) * idet
            xv = ((a2 + exx) * mv - exy * mu) * idet
            u = torch.where(cm, xu, u)
            v = torch.where(cm, xv, v)
        return u, v

    for _ in range(n):
        u, v = stencils.store(sweep, u, v, gu, gv, exx, exy, eyy, idet)
    return u, v


def restrict(a):
    """Full-weighting restriction: [1,2,1]x[1,2,1]/16, then a 2x subsample,
    with clamped edges. Each separable pass subsamples its own axis right
    away, as the reference does; that equals filter-then-[::2, ::2]
    bitwise, since the passes are independent. A bfloat16 result is
    rounded once."""
    return stencils.store(_restrict, a)


def _restrict(a):
    t = stencils.shift_down_row(a) + 2.0 * a + stencils.shift_up_row(a)
    t = t[..., ::2, :]
    s = stencils.shift_right_col(t) + 2.0 * t + stencils.shift_left_col(t)
    return s[..., :, ::2] * (1.0 / 16.0)


def prolong(a, h: int, w: int):
    """Bilinear prolongation to (h, w): coarse points land on even fine
    indices, odd indices average their neighbours (clamped at the far
    edge). A bfloat16 result is rounded once."""
    return stencils.store(lambda x: _prolong(x, h, w), a)


def _prolong(a, h: int, w: int):
    hc, wc = a.shape[-2:]
    rows = torch.stack([a, 0.5 * (a + stencils.shift_up_row(a))], dim=-2)
    rows = rows.reshape(*a.shape[:-2], 2 * hc, wc)[..., :h, :]
    cols = torch.stack([rows, 0.5 * (rows + stencils.shift_left_col(rows))], dim=-1)
    return cols.reshape(*rows.shape[:-1], 2 * wc)[..., :w]


def _level(exx, exy, eyy, a2):
    h, w = exx.shape[-2:]

    def idet(exx, exy, eyy):
        det = (a2 + exx) * (a2 + eyy) - exy * exy  # >= a2^2 > 0 (M is SPD)
        return 1.0 / det

    return (exx, exy, eyy, a2, stencils.store(idet, exx, exy, eyy),
            stencils.color_masks(h, w, device=exx.device))


def _build_levels(ex, ey, alpha: float):
    """The coefficient hierarchy, coarsened until MIN_SIDE. The data
    products are restricted and scaled by 4 a level. bfloat16: each
    level's products, scaled restrictions and idet rounded once."""
    a2 = alpha * alpha
    exx, exy, eyy = stencils.store(lambda x, y: (x * x, x * y, y * y), ex, ey)
    levels = [_level(exx, exy, eyy, a2)]
    while True:
        h, w = exx.shape[-2:]
        if min(h, w) <= 2 * MIN_SIDE or min(h, w) <= 3:
            return levels
        exx, exy, eyy = (_scaled_restrict(c) for c in (exx, exy, eyy))
        levels.append(_level(exx, exy, eyy, a2))


def _scaled_restrict(a):
    """4 * restrict(a), the h^2 rescaling of a coarser level; a bfloat16
    result rounded once."""
    return stencils.store(lambda x: 4.0 * _restrict(x), a)


def _vcycle(levels, k: int, u, v, gu, gv):
    lvl = levels[k]
    if k == len(levels) - 1:
        return gs_general(u, v, gu, gv, lvl, CS_SWEEPS)
    u, v = gs_general(u, v, gu, gv, lvl, NU1)
    exx, exy, eyy, a2 = lvl[:4]
    ru, rv = stencils.store(lambda *t: residual(*t, a2), u, v, gu, gv, exx, exy, eyy)
    # x4: the same h^2 rescaling as the coarse data products.
    rcu, rcv = _scaled_restrict(ru), _scaled_restrict(rv)
    ze = torch.zeros_like(rcu)
    ecu, ecv = _vcycle(levels, k + 1, ze, ze, rcu, rcv)
    h, w = u.shape[-2:]
    u, v = stencils.store(lambda u, v, pu, pv: (u + pu, v + pv),
                          u, v, prolong(ecu, h, w), prolong(ecv, h, w))
    return gs_general(u, v, gu, gv, lvl, NU2)


def mg_solve(u, v, ex, ey, et, alpha: float, cycles: int):
    """`cycles` V(NU1, NU2) cycles on the HS system from the guess (u, v)."""
    levels = _build_levels(ex, ey, alpha)
    gu, gv = stencils.store(lambda x, y, t: (-x * t, -y * t), ex, ey, et)
    for _ in range(cycles):
        u, v = _vcycle(levels, 0, u, v, gu, gv)
    return u, v


def mg_sweeps(u, v, ex, ey, et, inv_den, n: int, cfg: HSConfig):
    """The `solver.sweeps` adapter: n counts V-cycles for this solver.
    inv_den is unused (the levels carry their own 2x2 inverses) but kept
    for the uniform signature."""
    del inv_den
    return mg_solve(u, v, ex, ey, et, cfg.alpha, n)
