"""Dense pyramidal Lucas-Kanade optical flow, mirroring
opticalflowhs_tpu/lucas_kanade.py: the second model family.

Lucas & Kanade (IJCAI 1981), in the iterative pyramidal form of Bouguet
(2000): per pixel, the flow that is constant over a window and best
explains the linearised brightness change, solved in closed form from the
window's 2x2 structure tensor. Each refinement warps frame 2 by the
current flow and solves for the update; between refinements the flow may
be smoothed by the pyramid's binomial blur; every pyramid level refines
the same flow.

No kernel: the reference runs LK as XLA ops outside any Pallas kernel, and
here it is plain PyTorch on the frames' device (CPU or CUDA), so it stays
differentiable by torch on both. The window sums are zero-padded shifted
adds in window order, which reproduce the reference's SAME `reduce_window`
sums exactly; a prefix-sum difference would round differently, and a
convolution may run in TF32 on the card.

bfloat16 (LKConfig.dtype): the frames are cast first, and each stored
array is formed in float32 from the widened arrays and rounded once
(`stencils.store`): the pyramid's levels, the upsampled flows, the warped
frame, the gradients Ex, Ey and Et, each window sum (`box_sum`, the five
products being float32 temporaries), the flow after each refinement and
after each blur. The 2x2 solve is float32 arithmetic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from opticalflowhs_tpu_torch.config import LKConfig, PyramidConfig
from opticalflowhs_tpu_torch.ops import stencils
from opticalflowhs_tpu_torch.pyramid import _B5, gaussian_pyramid, upsample_flow, warp_each
from opticalflowhs_tpu_torch.solver import Flow, as_frame, storage_dtype

_SINGLE_PYR = PyramidConfig(levels=1, iters_per_level=())


def _blur5(a: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur (the pyramid's kernel, no subsample);
    a bfloat16 result rounded once."""
    return stencils.store(_blur5_f, a)


def _blur5_f(a: torch.Tensor) -> torch.Tensor:
    r1, r3 = stencils.shift_down_row(a), stencils.shift_up_row(a)
    r2, r4 = stencils.shift_down_row(r1), stencils.shift_up_row(r3)
    a = _B5[2] * a + _B5[1] * (r1 + r3) + _B5[0] * (r2 + r4)
    c1, c3 = stencils.shift_right_col(a), stencils.shift_left_col(a)
    c2, c4 = stencils.shift_right_col(c1), stencils.shift_left_col(c3)
    return _B5[2] * a + _B5[1] * (c1 + c3) + _B5[0] * (c2 + c4)


def box_sum(a: torch.Tensor, window: int) -> torch.Tensor:
    """Separable `window` x `window` box sum over the last two axes, SAME
    extent: the sums shrink over the available support at the borders.
    Rows first, then columns; each is a sum from 0.0 of the zero-padded
    input's `window` shifted views in window order, the reference's
    `lax.reduce_window` sums bitwise. A bfloat16 input is widened and the
    sum (rows, then columns, in float32) rounded once."""
    return stencils.store(lambda x: _box_sum(x, window), a)


def _box_sum(a: torch.Tensor, window: int) -> torch.Tensor:
    lo, hi = (window - 1) // 2, window // 2
    for dim, pad in ((-2, (0, 0, lo, hi)), (-1, (lo, hi))):
        n = a.shape[dim]
        p = F.pad(a, pad)
        out = torch.zeros_like(a)
        for k in range(window):
            out = out + p.narrow(dim, k, n)
        a = out
    return a


def lk_refine(i1: torch.Tensor, i2: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              cfg: LKConfig, warp_radius: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One warp-and-solve Newton refinement of (u, v) at the current level.

    Warps frame 2 by the current flow (on a (B, H, W) stack each image by
    its own flow, as the reference's vmap; `warp_radius` 0 is R = 4 in
    value), then solves the per-pixel windowed normal equations G d = -b
    with G = sum_w [Ex^2, ExEy; ExEy, Ey^2] (+ eps on the diagonal) and
    b = sum_w [Ex*Et, Ey*Et]. The five window sums run as one box sum of
    the five products stacked, the same additions as five box sums.

    In bfloat16 the warped frame, Ex, Ey, Et and the five sums are each
    rounded once where stored, the products and the 2x2 solve are float32,
    and the refined flow is rounded once.
    """
    i2w = warp_each(i2, u, v, cfg.warp, warp_radius)
    ex, ey, et = stencils.store(lambda a, b: stencils.derivatives(a, b, "central"), i1, i2w)
    sums = stencils.store(
        lambda ex, ey, et: _box_sum(torch.stack([ex * ex, ex * ey, ey * ey, ex * et, ey * et]),
                                    cfg.window), ex, ey, et)

    def solve(u, v, sums):
        g11 = sums[0] + cfg.eps
        g12 = sums[1]
        g22 = sums[2] + cfg.eps
        b1, b2 = sums[3], sums[4]
        inv_det = 1.0 / (g11 * g22 - g12 * g12)
        du = (g12 * b2 - g22 * b1) * inv_det
        dv = (g12 * b1 - g11 * b2) * inv_det
        if cfg.max_step > 0:
            # Textureless windows leave the regularised system near-singular:
            # one refinement may move no farther than its linearisation holds.
            du = torch.clamp(du, -cfg.max_step, cfg.max_step)
            dv = torch.clamp(dv, -cfg.max_step, cfg.max_step)
        return u + du, v + dv

    return stencils.store(solve, u, v, sums)


def _lk_level(i1, i2, u, v, cfg: LKConfig, iters: int, warp_radius: int = 0):
    for _ in range(iters):
        u, v = lk_refine(i1, i2, u, v, cfg, warp_radius)
        if cfg.smooth:
            # The reference's measurement: without it, per-pixel noise grows
            # about 22% a refinement through weak-texture windows.
            u, v = _blur5(u), _blur5(v)
    return u, v


def _lk_pyramid_body(i1: torch.Tensor, i2: torch.Tensor, cfg: LKConfig,
                     pyr: PyramidConfig) -> Flow:
    """The reference's `_lk_pyramid_body` on an (H, W) pair or, each pair
    on its own, a (B, H, W) stack."""
    p1 = gaussian_pyramid(i1, pyr.levels)
    p2 = gaussian_pyramid(i2, pyr.levels)
    iters: Sequence[int] = pyr.iters_per_level or (cfg.iters,) * pyr.levels

    flow: Optional[Flow] = None
    for level in range(pyr.levels - 1, -1, -1):
        f1, f2 = p1[level], p2[level]
        if flow is None:
            u, v = torch.zeros_like(f1), torch.zeros_like(f1)
        else:
            u, v = upsample_flow(flow, f1.shape[-2:])
        flow = Flow(*_lk_level(f1, f2, u, v, cfg, iters[level], pyr.warp_radius))
    return flow


def lk_solve(
    i1,
    i2,
    cfg: LKConfig = LKConfig(),
    pyr: PyramidConfig = _SINGLE_PYR,
    device=None,
) -> Flow:
    """Dense (pyramidal) Lucas-Kanade flow for the frame pair (i1, i2).

    pyr.levels == 1 is classic single-level iterative LK; more levels
    reach displacements beyond the window's radius, every level refining
    the same flow (no residual to add). Frames are (H, W) tensors, solved
    on their device, or numpy arrays, which go to `device` (cuda:0 when
    None; RuntimeError without CUDA); both are cast to the config's dtype
    there, and the flow has it. Differentiable on either device."""
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs {tuple(i2.shape)}")
    if i1.ndim != 2:
        raise ValueError(
            "lk_solve takes single 2-D grayscale frames; use "
            "lk_solve_batched for leading batch axes"
        )
    min_side = min(i1.shape[-2:])
    if min_side // (2 ** (pyr.levels - 1)) < 8:
        raise ValueError(
            f"{pyr.levels} levels would shrink a {tuple(i1.shape[-2:])} frame below 8 px"
        )
    i1 = as_frame(i1, device, storage_dtype(cfg))
    return _lk_pyramid_body(i1, as_frame(i2, i1.device, i1.dtype), cfg, pyr)


def lk_solve_batched(
    i1,
    i2,
    cfg: LKConfig = LKConfig(),
    pyr: PyramidConfig = _SINGLE_PYR,
    mesh=None,
    device=None,
) -> Flow:
    """LK over a (B, H, W) stack of frame pairs, each pair on its own: equal
    to a loop of `lk_solve` over the pairs, bitwise. Like the reference's,
    it checks only the rank (and here equal shapes), so it also solves
    frames that lk_solve refuses (levels below 8 px). numpy stacks go to
    `device`, as in lk_solve. `mesh=` comes with the rest of dist/."""
    if i1.ndim != 3:
        raise ValueError(f"expected (B, H, W) frame stacks, got {tuple(i1.shape)}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (sharding a stack over devices) is not ported yet: it comes "
            "with the rest of dist/ (ROADMAP.md queue 1, item 6)"
        )
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs {tuple(i2.shape)}")
    i1 = as_frame(i1, device, storage_dtype(cfg))
    return _lk_pyramid_body(i1, as_frame(i2, i1.device, i1.dtype), cfg, pyr)


def lk_solve_tiled(i1, i2, cfg: LKConfig = LKConfig(),
                   pyr: PyramidConfig = _SINGLE_PYR, mesh=None):
    """Spatially tiled LK over a device mesh: comes with the rest of
    dist/, in both dtypes (ROADMAP.md queue 1, item 6)."""
    if getattr(cfg, "dtype", None) == "bfloat16":
        raise NotImplementedError(
            "lk_solve_tiled in bfloat16 is not ported yet: bfloat16 on dist/ runs "
            "the tiled HS solves; this entry comes with the rest of dist/ "
            "(ROADMAP.md queue 1, item 6), in both dtypes"
        )
    raise NotImplementedError(
        "lk_solve_tiled shards a frame over devices and is not ported yet: "
        "it comes with the rest of dist/ (ROADMAP.md queue 1, item 6)"
    )
