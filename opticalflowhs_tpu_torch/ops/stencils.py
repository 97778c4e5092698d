"""Plain PyTorch Horn-Schunck stencils, mirroring opticalflowhs_tpu/ops/stencils.py.

These are the plain versions every CUDA kernel of the port is held
against. Each op keeps the reference's exact association order, so on a
CUDA card the kernels (built without FMA contraction) reproduce them
bitwise, and on the CPU they agree with the JAX reference to float32
rounding.

All shifts clamp at the edge (replicate), over the last two axes.

bfloat16 (`store`): an array stored in bfloat16 is widened to float32,
the op computes in float32 in the float32 order, and each array it
returns is rounded once, to nearest even, where it is stored. Applied to
each sweep, to the fields and 1/den (kernels/derivatives.py
`derivatives_plain`) and to each resampling, that is the rule the
kernels' bfloat16 builds follow, so they equal the plain twins bitwise as
the float32 builds do. The families' storing points are listed in the
package docstring: multigrid's hierarchy, residuals and corrections and
u, v once a smoother sweep; TV-L1's rescaled frames, five inner-loop
fields, u where the u-step stores it and the duals where the p-step does;
LK's warped frame, gradients, window sums and flow after each refinement
and blur.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

# -- replicate-clamped shifts over the last two axes ---------------------------


def shift_up_row(a: torch.Tensor) -> torch.Tensor:
    """a(i+1, j), clamped at the last row."""
    return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)


def shift_down_row(a: torch.Tensor) -> torch.Tensor:
    """a(i-1, j), clamped at the first row."""
    return torch.cat([a[..., :1, :], a[..., :-1, :]], dim=-2)


def shift_left_col(a: torch.Tensor) -> torch.Tensor:
    """a(i, j+1), clamped at the last column."""
    return torch.cat([a[..., :, 1:], a[..., :, -1:]], dim=-1)


def shift_right_col(a: torch.Tensor) -> torch.Tensor:
    """a(i, j-1), clamped at the first column."""
    return torch.cat([a[..., :, :1], a[..., :, :-1]], dim=-1)


def store(fn, *arrays):
    """fn(*arrays) under the bfloat16 storage rule: where any tensor
    argument is bfloat16, the bfloat16 ones are widened to float32, fn
    computes in float32, and each tensor it returns (one, or a tuple) is
    rounded once to the first argument's dtype. Without a bfloat16
    argument it is fn(*arrays) itself."""
    bf16 = torch.bfloat16
    if not any(isinstance(a, torch.Tensor) and a.dtype == bf16 for a in arrays):
        return fn(*arrays)
    dtype = arrays[0].dtype
    out = fn(*(a.float() if isinstance(a, torch.Tensor) and a.dtype == bf16 else a
               for a in arrays))
    if isinstance(out, torch.Tensor):
        return out.to(dtype)
    return tuple(o.to(dtype) for o in out)


def derivatives(
    i1: torch.Tensor, i2: torch.Tensor, variant: str = "hs_cube"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatiotemporal derivatives Ex, Ey, Et.

    hs_cube: forward differences averaged over the 2x2x2 spatiotemporal
    cube (Horn & Schunck 1981, section 7); central: central differences
    and Et = I2 - I1.
    """
    if variant == "hs_cube":
        ex = torch.zeros_like(i1)
        ey = torch.zeros_like(i1)
        for f in (i1, i2):
            fr = shift_up_row(f)
            fc = shift_left_col(f)
            frc = shift_left_col(fr)
            ex = ex + (fc - f) + (frc - fr)
            ey = ey + (fr - f) + (frc - fc)
        ex = ex * 0.25
        ey = ey * 0.25
        d = i2 - i1
        et = 0.25 * (d + shift_up_row(d) + shift_left_col(d)
                     + shift_left_col(shift_up_row(d)))
        return ex, ey, et
    elif variant == "central":
        ex = 0.5 * (shift_left_col(i1) - shift_right_col(i1))
        ey = 0.5 * (shift_up_row(i1) - shift_down_row(i1))
        et = i2 - i1
        return ex, ey, et
    raise ValueError(f"unknown derivative variant {variant!r}")


def neighbor_avg(u: torch.Tensor) -> torch.Tensor:
    """8-neighbour 1/6-1/12 weighted average, replicate edges.

    Separable form: [1,2,1]x[1,2,1]/12 - u/3, with the reference's
    association order.
    """
    t = shift_down_row(u) + 2.0 * u + shift_up_row(u)
    s = shift_right_col(t) + 2.0 * t + shift_left_col(t)
    return s * (1.0 / 12.0) - u * (1.0 / 3.0)


def jacobi_step(
    u: torch.Tensor,
    v: torch.Tensor,
    ex: torch.Tensor,
    ey: torch.Tensor,
    et: torch.Tensor,
    inv_den: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi sweep: neighbour average, then the HS update.

    `inv_den = 1 / (alpha^2 + Ex^2 + Ey^2)` is loop-invariant.
    """
    ubar = neighbor_avg(u)
    vbar = neighbor_avg(v)
    frac = (ex * ubar + ey * vbar + et) * inv_den
    return ubar - ex * frac, vbar - ey * frac


def checkpoint_block(fn, state):
    """fn(*state) -> tuple of tensors, through `torch.utils.checkpoint`
    (non-reentrant) when grad mode is on: reverse-mode AD then keeps the
    block's input state and recomputes the block's tape during the backward.
    The forward is fn itself, the same ops in the same order; fn draws no
    random numbers, so no RNG state is kept. With grad mode off it is
    fn(*state)."""
    if not torch.is_grad_enabled():
        return tuple(fn(*state))
    return tuple(torch.utils.checkpoint.checkpoint(
        fn, *state, use_reentrant=False, preserve_rng_state=False))


def checkpointed_loop(step, uv, n: int):
    """Run `n` applications of `step` (a tuple of tensors to a tuple of
    tensors) on the state `uv`, with sqrt(n) recomputation: the reference's
    `checkpointed_loop` (opticalflowhs_tpu/ops/stencils.py:268).

    The forward is exactly n applications of `step`, so it equals the plain
    loop bitwise. The loop runs as n // b blocks of b = isqrt(n) steps, each
    through `checkpoint_block`, then the remainder plainly; for b < 2 it is
    the plain loop. Reverse-mode AD then stores the n // b block-boundary
    states (the tensors `step` closes over once) and recomputes one block's
    tape at a time in the backward: O(sqrt(n)) fields instead of every
    step's intermediates."""
    state = tuple(uv)
    b = math.isqrt(max(n, 0))
    if b < 2 or not torch.is_grad_enabled():
        for _ in range(n):
            state = tuple(step(state))
        return state
    n_blocks, rem = divmod(n, b)

    def block(*x):
        for _ in range(b):
            x = tuple(step(x))
        return x

    for _ in range(n_blocks):
        state = checkpoint_block(block, state)
    for _ in range(rem):
        state = tuple(step(state))
    return state


# -- true-edge-masked twins ------------------------------------------------------
#
# The ops above for tiles of a larger global image (the tiled solver, dist/):
# the clamp fires at the TRUE image edge, from boolean masks of global
# coordinates, and at the array's own edge the shifts still clamp. Same
# association order as the unmasked ops, so on the pixels of the true image
# that a tile computes exactly, tiled == untiled bitwise; rows and columns
# outside the image (zero pad, decaying halo) are garbage that true pixels
# never read.


def edge_masks(gr: torch.Tensor, gc: torch.Tensor, h: int, w: int):
    """(top, bottom, left, right) boolean grids from global row/col grids."""
    return (gr == 0, gr == h - 1, gc == 0, gc == w - 1)


def neighbor_avg_masked(u: torch.Tensor, masks) -> torch.Tensor:
    """neighbor_avg with the clamp at the true image edges given by masks."""
    m_top, m_bot, m_lf, m_rt = masks
    up = torch.where(m_top, u, shift_down_row(u))   # u(i-1)
    dn = torch.where(m_bot, u, shift_up_row(u))     # u(i+1)
    t = up + 2.0 * u + dn
    rt = torch.where(m_lf, t, shift_right_col(t))   # t(j-1)
    lf = torch.where(m_rt, t, shift_left_col(t))    # t(j+1)
    s = rt + 2.0 * t + lf
    return s * (1.0 / 12.0) - u * (1.0 / 3.0)


def jacobi_step_masked(u, v, ex, ey, et, inv_den, masks):
    """jacobi_step with true-edge masks (the tiled solver's shard bodies)."""
    ubar = neighbor_avg_masked(u, masks)
    vbar = neighbor_avg_masked(v, masks)
    frac = (ex * ubar + ey * vbar + et) * inv_den
    return ubar - ex * frac, vbar - ey * frac


def sor_step_masked(u, v, ex, ey, et, inv_den, omega: float, colors, masks):
    """sor_step with true-edge masks. `colors` must come from GLOBAL pixel
    coordinates (`global_colors`): a tile whose offset is odd has another
    local parity than the image. A color stage reads pixels updated in the
    same sweep, so the halo decays one ring per stage, four per sweep."""
    for cm in colors:
        ubar = neighbor_avg_masked(u, masks)
        vbar = neighbor_avg_masked(v, masks)
        frac = (ex * ubar + ey * vbar + et) * inv_den
        un = ubar - ex * frac
        vn = vbar - ey * frac
        u = torch.where(cm, u + omega * (un - u), u)
        v = torch.where(cm, v + omega * (vn - v), v)
    return u, v


def global_colors(gr: torch.Tensor, gc: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The four (row % 2, col % 2) color grids from GLOBAL row/col grids, in
    color_masks' order; % is floor-mod, so negative halo rows take the
    image's parity too."""
    return tuple((gr % 2 == pi) & (gc % 2 == pj) for pi in (0, 1) for pj in (0, 1))


def derivatives_masked(i1: torch.Tensor, i2: torch.Tensor, masks,
                       variant: str = "hs_cube"):
    """derivatives with the clamp at the true image edges given by masks."""
    m_top, m_bot, m_lf, m_rt = masks

    def up_row(a):  # a(i+1), clamped at the true bottom edge
        return torch.where(m_bot, a, shift_up_row(a))

    def left_col(a):  # a(j+1), clamped at the true right edge
        return torch.where(m_rt, a, shift_left_col(a))

    if variant == "hs_cube":
        ex = torch.zeros_like(i1)
        ey = torch.zeros_like(i1)
        for f in (i1, i2):
            fr = up_row(f)
            fc = left_col(f)
            frc = left_col(fr)
            ex = ex + (fc - f) + (frc - fr)
            ey = ey + (fr - f) + (frc - fc)
        ex = ex * 0.25
        ey = ey * 0.25
        d = i2 - i1
        et = 0.25 * (d + up_row(d) + left_col(d) + left_col(up_row(d)))
        return ex, ey, et
    elif variant == "central":

        def down_row(a):  # a(i-1), clamped at the true top edge
            return torch.where(m_top, a, shift_down_row(a))

        def right_col(a):  # a(j-1), clamped at the true left edge
            return torch.where(m_lf, a, shift_right_col(a))

        ex = 0.5 * (left_col(i1) - right_col(i1))
        ey = 0.5 * (up_row(i1) - down_row(i1))
        et = i2 - i1
        return ex, ey, et
    raise ValueError(f"unknown derivative variant {variant!r}")


def color_masks(h: int, w: int, device=None) -> tuple[torch.Tensor, ...]:
    """The four (row % 2, col % 2) color grids of 4-color relaxation, in the
    order (0,0), (0,1), (1,0), (1,1). The HS neighbourhood couples all 8
    neighbours, and under this coloring no two same-color pixels are
    neighbours. The (h, w) grids broadcast over a (B, H, W) stack, so the
    parity is each image's own."""
    gr = torch.arange(h, device=device)[:, None]
    gc = torch.arange(w, device=device)[None, :]
    return tuple((gr % 2 == pi) & (gc % 2 == pj) for pi in (0, 1) for pj in (0, 1))


def sor_step(
    u: torch.Tensor,
    v: torch.Tensor,
    ex: torch.Tensor,
    ey: torch.Tensor,
    et: torch.Tensor,
    inv_den: torch.Tensor,
    omega: float,
    colors,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One 4-color SOR sweep: per color, the Jacobi target from the CURRENT
    field (which holds this sweep's earlier colors), then the blend
    u + omega*(u* - u) on that color's pixels only."""
    for cm in colors:
        ubar = neighbor_avg(u)
        vbar = neighbor_avg(v)
        frac = (ex * ubar + ey * vbar + et) * inv_den
        un = ubar - ex * frac
        vn = vbar - ey * frac
        u = torch.where(cm, u + omega * (un - u), u)
        v = torch.where(cm, v + omega * (vn - v), v)
    return u, v
