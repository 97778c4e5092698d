"""TV-L1 optical flow (Zach, Pock & Bischof 2007), mirroring
opticalflowhs_tpu/tvl1.py: an L1 data term with a total-variation prior,
minimised by the duality-based alternation (pointwise thresholding for the
data term, Chambolle's projected dual ascent for the TV term).

Each warp iteration warps frame 2 by the current flow, linearises the
residual around it, runs `cfg.iters` alternations of the inner loop and,
optionally, a 3x3 median of each flow field. The inner loop is K5
(kernels/tvl1_inner.py) on the cuda backend and its plain version on the
torch backend; the warp, the gradients, the median and the pyramid are
plain PyTorch on both, as they are XLA in the reference.

Each pair is rescaled jointly to [0, 255] first (the convention lambda is
calibrated for), per pair in a stack. Every pyramid level refines the same
flow; unlike HS there is no residual to add.

Stacks run as one chain for the whole stack, K5 included. (The reference
keeps its stacks on its jnp loop, because its manual-DMA kernel has no
batching rule; K5 has a batch grid and equals the plain loop.)

Gradients reach the frames through the warps and the inner loop: K5's
entry is a kernel forward and a plain-twin backward (kernels/autodiff.py).

bfloat16 (TVL1Config.dtype): the frames are cast first, and every array
the reference holds in the config's dtype is bfloat16 here, formed in
float32 from the widened arrays and rounded once where it is stored
(`stencils.store`): the rescaled frames (lo, hi and the scale are float32
temporaries), the pyramid's levels, the upsampled flows, the warped frame,
the five inner-loop fields (formed from the rounded warped frame, frame 1
and flow), and the inner loop's u and duals (K5's bfloat16 build or the
plain twin). median3 is min/max only and exact in bfloat16.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from opticalflowhs_tpu_torch.config import PyramidConfig, TVL1Config
from opticalflowhs_tpu_torch.dist.gspmd import mesh_frames, run_groups, run_pair_or_groups
from opticalflowhs_tpu_torch.kernels.tvl1_inner import tvl1_inner, tvl1_inner_plain
from opticalflowhs_tpu_torch.ops import stencils
from opticalflowhs_tpu_torch.pyramid import gaussian_pyramid, upsample_flow, warp_each
from opticalflowhs_tpu_torch.solver import Flow, as_frame, resolve_backend, storage_dtype

_G2_EPS = 1e-9  # guards the |grad I|^2 division in textureless pixels


def grad_forward(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences with Neumann boundaries: gx[..., j] = a[j+1] - a[j],
    0 at the last column (the clamped shift), gy likewise on rows."""
    gx = stencils.shift_left_col(a) - a
    gy = stencils.shift_up_row(a) - a
    return gx, gy


def _zshift_right_col(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(a[..., :, :1]), a[..., :, :-1]], dim=-1)


def _zshift_down_row(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(a[..., :1, :]), a[..., :-1, :]], dim=-2)


def _mask_dual(px: torch.Tensor, py: torch.Tensor):
    """Zero the structurally unused dual entries (last column of px, last
    row of py), so that `divergence` is the exact adjoint of `grad_forward`."""
    px = torch.cat([px[..., :, :-1], torch.zeros_like(px[..., :, -1:])], dim=-1)
    py = torch.cat([py[..., :-1, :], torch.zeros_like(py[..., -1:, :])], dim=-2)
    return px, py


def divergence(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, the negative adjoint of
    `grad_forward` for masked duals: div[j] = p[j] - p[j-1], with p[-1] = 0."""
    return (px - _zshift_right_col(px)) + (py - _zshift_down_row(py))


def _safe_norm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2) in the reference's double-where form (its gradient is
    finite at the origin); in value it equals the plain sqrt."""
    n2 = x * x + y * y
    pos = n2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)


def median3(a: torch.Tensor) -> torch.Tensor:
    """3x3 median with replicate borders: the 9 clamp-shifted copies through
    the 19-exchange median-of-9 selection network, pure pairwise min/max.
    It equals the median of the sorted 9 taps, ties included."""
    up, dn = stencils.shift_up_row(a), stencils.shift_down_row(a)
    p = []
    for r in (dn, a, up):
        p.extend((stencils.shift_right_col(r), r, stencils.shift_left_col(r)))
    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7),
                 (1, 2), (4, 5), (7, 8), (0, 3), (5, 8), (4, 7),
                 (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
                 (4, 2)):
        p[i], p[j] = torch.minimum(p[i], p[j]), torch.maximum(p[i], p[j])
    return p[4]


def _central_grad(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    gx = 0.5 * (stencils.shift_left_col(a) - stencils.shift_right_col(a))
    gy = 0.5 * (stencils.shift_up_row(a) - stencils.shift_down_row(a))
    return gx, gy


def inner_fields(i1: torch.Tensor, i2w: torch.Tensor, u1: torch.Tensor,
                 u2: torch.Tensor, cfg: TVL1Config):
    """The inner loop's constant fields, linearised at the flow (u1, u2)
    with i2w frame 2 warped by it: (rho0, gx, gy, 1/(|g|^2 + eps),
    lambda*theta*|g|^2), where rho(u) = rho0 + u.g. In bfloat16 all five
    are formed in float32 and each is rounded once (`stencils.store`)."""

    def fields(i1, i2w, u1, u2):
        gx, gy = _central_grad(i2w)
        rho0 = i2w - i1 - u1 * gx - u2 * gy  # rho(u) = rho0 + u.g, affine in u
        g2 = gx * gx + gy * gy
        return rho0, gx, gy, 1.0 / (g2 + _G2_EPS), cfg.lambda_ * cfg.theta * g2

    return stencils.store(fields, i1, i2w, u1, u2)


def inner_scalars(cfg: TVL1Config) -> tuple[float, float, float]:
    """(theta, sigma = tau/theta, lambda*theta) of the inner loop."""
    return cfg.theta, cfg.tau / cfg.theta, cfg.lambda_ * cfg.theta


def rescale_pair(i1: torch.Tensor, i2: torch.Tensor):
    """The pair rescaled jointly to [0, 255], the convention lambda is
    calibrated for. The min/max run over the last two axes, so a stack is
    rescaled per pair, as under the reference's vmap.

    In bfloat16 lo, hi and the scale are float32 temporaries of the widened
    frames and each rescaled frame is rounded once. The 1e-6 guard is then
    float32's, where the reference forms it in bfloat16; it only acts on a
    constant pair, whose rescaled frames are 0 either way."""

    def rescale(i1, i2):
        lo = torch.minimum(i1.amin(dim=(-2, -1), keepdim=True),
                           i2.amin(dim=(-2, -1), keepdim=True))
        hi = torch.maximum(i1.amax(dim=(-2, -1), keepdim=True),
                           i2.amax(dim=(-2, -1), keepdim=True))
        # A tensor numerator keeps 255/x one IEEE division (a Python float
        # over a tensor is a reciprocal and a multiply in torch).
        scale = torch.full_like(lo, 255.0) / torch.maximum(hi - lo, lo.new_tensor(1e-6))
        return (i1 - lo) * scale, (i2 - lo) * scale

    return stencils.store(rescale, i1, i2)


def tvl1_warp_iteration(
    i1: torch.Tensor,
    i2: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    cfg: TVL1Config,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One warp-and-relinearise step of Zach et al. (2007), Alg. 1, on an
    (H, W) pair or a (B, H, W) stack: warp frame 2 by (u1, u2), linearise
    rho(u) = rho0 + u.grad(I2w) around it, run cfg.iters alternations of
    the inner loop (K5 on the cuda backend, `tvl1_inner_plain` on the
    torch backend), then the optional median. With `divergence` the
    negative adjoint of `grad_forward`, the u-step is v + theta*div p and
    pairs with dual ascent p + sigma*grad u (the IPOL sign convention)."""
    # "auto" means "checked" for TV-L1: its sharp motion boundaries can
    # break the tiled warp's per-tile contract. A stack warps each image by
    # the single-pair rule, as the reference's vmapped body.
    i2w = warp_each(i2, u1, u2, "checked" if cfg.warp == "auto" else cfg.warp)
    inner = tvl1_inner if resolve_backend(cfg.backend, i1) == "cuda" else tvl1_inner_plain
    u1, u2 = inner(u1, u2, *inner_fields(i1, i2w, u1, u2, cfg), cfg.iters,
                   *inner_scalars(cfg))
    if cfg.median:
        u1, u2 = median3(u1), median3(u2)
    return u1, u2


def _tvl1_level(i1, i2, u1, u2, cfg: TVL1Config, warps: int):
    for _ in range(warps):
        u1, u2 = tvl1_warp_iteration(i1, i2, u1, u2, cfg)
    return u1, u2


def _tvl1_pyramid_body(i1: torch.Tensor, i2: torch.Tensor, cfg: TVL1Config,
                       pyr: PyramidConfig) -> Flow:
    """The reference's `_tvl1_pyramid_body` on an (H, W) pair or, with
    each pair on its own, a (B, H, W) stack."""
    i1, i2 = rescale_pair(i1, i2)
    p1 = gaussian_pyramid(i1, pyr.levels)
    p2 = gaussian_pyramid(i2, pyr.levels)
    # Warps per level come from TVL1Config, never from pyr.iters_per_level
    # (which counts HS sweeps).
    warps: Sequence[int] = cfg.warps_per_level or (cfg.warps,) * pyr.levels

    flow: Optional[Flow] = None
    for level in range(pyr.levels - 1, -1, -1):
        f1, f2 = p1[level], p2[level]
        if flow is None:
            u1, u2 = torch.zeros_like(f1), torch.zeros_like(f1)
        else:
            u1, u2 = upsample_flow(flow, f1.shape[-2:])
        flow = Flow(*_tvl1_level(f1, f2, u1, u2, cfg, warps[level]))
    return flow


def _check(i1, i2, cfg: TVL1Config, pyr: PyramidConfig, rank: int) -> None:
    """The reference's checks: tvl1_solve's (rank 2: shapes, rank, levels,
    warps per level) or tvl1_solve_batched's (rank 3: the rank only, with
    equal shapes, where the reference's vmap fails anyway, and a
    warps_per_level too short for the levels, where it raises IndexError)."""
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs "
                         f"{tuple(i2.shape)}")
    if i1.ndim != rank:
        raise ValueError(
            "tvl1_solve takes single 2-D grayscale frames; use "
            "tvl1_solve_batched for leading batch axes" if rank == 2
            else f"expected (B, H, W) frame stacks, got {tuple(i1.shape)}"
        )
    if rank == 3:
        if cfg.warps_per_level and len(cfg.warps_per_level) < pyr.levels:
            raise ValueError(f"warps_per_level {cfg.warps_per_level} is shorter than "
                             f"levels={pyr.levels}")
        return
    min_side = min(i1.shape[-2:])
    if min_side // (2 ** (pyr.levels - 1)) < 8:
        raise ValueError(
            f"{pyr.levels} levels would shrink a {tuple(i1.shape[-2:])} frame "
            "below 8 px"
        )
    if cfg.warps_per_level and len(cfg.warps_per_level) != pyr.levels:
        raise ValueError(
            f"warps_per_level {cfg.warps_per_level} must match levels={pyr.levels}"
        )


def tvl1_solve(
    i1,
    i2,
    cfg: TVL1Config = TVL1Config(),
    pyr: PyramidConfig = PyramidConfig(levels=1),
    device=None,
) -> Flow:
    """TV-L1 flow for the frame pair (i1, i2).

    pyr.levels == 1 solves at full resolution (about 1 px of motion per
    warp iteration); more levels handle large motions, every level
    refining the same flow. Frames are (H, W) tensors, solved on their
    device, or numpy arrays, which go to `device` (cuda:0 when None;
    RuntimeError without CUDA); both are cast to the config's dtype there,
    and the flow has it."""
    _check(i1, i2, cfg, pyr, rank=2)
    i1 = as_frame(i1, device, storage_dtype(cfg))
    return _tvl1_pyramid_body(i1, as_frame(i2, i1.device, i1.dtype), cfg, pyr)


def tvl1_solve_batched(
    i1,
    i2,
    cfg: TVL1Config = TVL1Config(),
    pyr: PyramidConfig = PyramidConfig(levels=1),
    mesh=None,
    device=None,
) -> Flow:
    """TV-L1 over a (B, H, W) stack of frame pairs, each pair on its own
    (own [0, 255] rescale, own warp rule): equal to a loop of `tvl1_solve`
    over the pairs that it takes. Like the reference's, it checks only the
    rank, so it also solves frames that tvl1_solve refuses (pyramid levels
    below 8 px, sides below 8 px at one level) and takes a warps_per_level
    longer than the levels (its first entries); one shorter raises
    ValueError. One chain of launches serves the whole stack. numpy stacks
    go to `device` (with `mesh` and no device, the mesh's first device),
    as in tvl1_solve. `mesh`: the stack splits over the mesh's "batch"
    axis (dist/gspmd.py), each group one chain of launches on its device,
    the flow gathered on the mesh's first device."""
    _check(i1, i2, cfg, pyr, rank=3)
    i1 = mesh_frames(i1, mesh, device, storage_dtype(cfg))
    i2 = as_frame(i2, i1.device, i1.dtype)
    if mesh is not None:
        return run_groups(lambda a, b: _tvl1_pyramid_body(a, b, cfg, pyr), mesh, i1, i2)
    return _tvl1_pyramid_body(i1, i2, cfg, pyr)


def tvl1_solve_tiled(i1, i2, cfg: TVL1Config = TVL1Config(),
                     pyr: PyramidConfig = PyramidConfig(levels=1), mesh=None) -> Flow:
    """Spatially tiled TV-L1 over a ("y", "x") device mesh, in float32 or
    bfloat16. The reference runs the whole pyramid as global ops under
    GSPMD sharding constraints, byte-identical to the untiled path; TV-L1's
    warps are data-dependent and have no fixed halo, so the port solves
    the frame whole on the mesh's first device through the untiled body
    (K5 on the card; dist/gspmd.py) and returns the flow there, equal to
    `tvl1_solve` bitwise. As the reference's, it checks the rank, the
    shapes and the mesh only."""
    if i1.ndim != 2:
        raise ValueError("tvl1_solve_tiled takes single 2-D grayscale frames")
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs {tuple(i2.shape)}")
    if mesh is None:
        raise ValueError("tvl1_solve_tiled requires a mesh (use tvl1_solve)")
    i1 = mesh_frames(i1, mesh, None, storage_dtype(cfg))
    i2 = as_frame(i2, i1.device, i1.dtype)
    return run_pair_or_groups(lambda a, b: _tvl1_pyramid_body(a, b, cfg, pyr), mesh, i1, i2)
