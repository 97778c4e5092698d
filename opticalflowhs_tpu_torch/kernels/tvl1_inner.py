"""K5: the TV-L1 inner loop, all `iters` v/u/p alternations of one warp
iteration.

Port of opticalflowhs_tpu/kernels/tvl1_inner.py (`tvl1_inner`, TPU kernel
`_tvl1_kernel`: one launch, 6 state and 5 constant arrays resident in VMEM,
two banded passes an iteration). At 1080p those 11 arrays (92 MB) are far
beyond the H100's shared memory, so the Hopper version blocks the
alternations in time, as K2 blocks Jacobi sweeps (csrc/tvl1.cu): each
launch runs s alternations on 32 x 128 shared-memory windows that hold
all 11 arrays, one persistent block of 1024 threads a multiprocessor, the
state updated in place with a barrier between the u-step and the p-step.
A call is ceil(iters/s) launches, enqueued by one C call; a (B, H, W)
stack is one chain. `k5_launch_schedule_plain` walks that schedule in
plain torch.

`tvl1_inner` launches the kernel for CUDA tensors and runs the plain
version, `tvl1_inner_plain`, for CPU tensors. There is no fallback: a CUDA
tensor goes through the kernel or the call raises. Unlike the TPU kernel,
which returns None outside its VMEM class, K5 takes every size and stacks.

bfloat16 (`hs_tvl1_inner_bf16`): every array bfloat16, the arithmetic
float32 (ops/stencils.py `store`). The u-step rounds u1 and u2 where it
stores them, the p-step the four duals; rho, the step, v, the differences
and the norms are float32 temporaries. The kernel keeps its float32 window,
geometry, plan and launches and widens each array where it stages it, so
it equals `tvl1_inner_plain` bitwise in bfloat16 too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from opticalflowhs_tpu_torch.kernels import _build, autodiff
from opticalflowhs_tpu_torch.kernels.derivatives import BF16_DTYPES, batch_dims, check_frames
from opticalflowhs_tpu_torch.kernels.jacobi import k2_tile
from opticalflowhs_tpu_torch.ops import stencils

# K5's geometry (csrc/tvl1.cu). A block of K5_THREADS threads runs s
# alternations on a K5_WINDOW_H x K5_WINDOW_W window: warp j owns window row
# j, lane l the K5_LANE_COLS columns 4l..4l+3; shared memory holds the
# window's 6 state and 5 constant arrays, and rho0, gx and gy of the next
# window, staged while this one runs (K5_SMEM_BYTES). The tile is K2's rule
# at this window (`k5_tile`): 24 x 120 at s = 4. s is block_iters (at most
# K5_MAX_ITERS), or for 0 the s in [2, 8] that the kernel's cost rule picks
# for the frame (`k5_geometry`): 4 at 1088x1920, 6 at 544x960, 8 at 272x480
# for 100 alternations. Fields kept in registers (60 a thread at 48 x 128
# windows of 3 rows a thread) limited the arithmetic and ran no faster.
K5_WINDOW_H = 32
K5_WINDOW_W = 128
K5_LANE_COLS = 4
K5_THREADS = 1024
K5_SMEM_BYTES = 14 * 4 * K5_WINDOW_H * K5_WINDOW_W  # 229,376
K5_MAX_ITERS = 8


def k5_tile(iters: int, window=(K5_WINDOW_H, K5_WINDOW_W)) -> tuple[int, int, int]:
    """(tile rows, tile columns, left halo) of one K5 window at `iters`
    alternations a launch: K2's rule (`jacobi.k2_tile`)."""
    return k2_tile(iters, window, K5_LANE_COLS)


def _check_block_iters(block_iters: int) -> None:
    if not 0 <= block_iters <= K5_MAX_ITERS:
        raise ValueError(f"block_iters must be in [0, {K5_MAX_ITERS}] (0 = auto), "
                         f"got {block_iters}")


def tvl1_inner_plain(u1, u2, rho0, gx, gy, inv_g2, th, iters: int,
                     theta: float, sigma: float, lam_theta: float):
    """The inner loop of tvl1.tvl1_warp_iteration in plain PyTorch, op for
    op as the reference's loop body: `iters` alternations of the v-step
    (three-case shrinkage of the L1 data term), the u-step
    u = v + theta*div p and the projected dual ascent
    p <- (p + sigma*grad u) / (1 + sigma*|grad u|), from zero duals.
    The alternations run through `stencils.checkpointed_loop`, as the
    reference's twin (`_jnp_twin`). Returns (u1, u2).

    bfloat16 arrays follow the storage rule (`stencils.store`): the u-step
    rounds u1 and u2 where it stores them, the p-step the four duals (the
    masked zeros are exact); rho, the step, v, the gradients and the norms
    are float32 temporaries."""
    # tvl1 routes to this module, so its operators are imported here.
    from opticalflowhs_tpu_torch.tvl1 import _mask_dual, _safe_norm, divergence, grad_forward

    def u_step(u1, u2, p1x, p1y, p2x, p2y, rho0, gx, gy, inv_g2, th):
        rho = rho0 + u1 * gx + u2 * gy
        step = torch.where(
            rho < -th,
            lam_theta,
            torch.where(rho > th, -lam_theta, -rho * inv_g2),
        )
        v1 = u1 + step * gx
        v2 = u2 + step * gy
        return v1 + theta * divergence(p1x, p1y), v2 + theta * divergence(p2x, p2y)

    def p_step(p1x, p1y, p2x, p2y, u1, u2):
        d1x, d1y = grad_forward(u1)
        d2x, d2y = grad_forward(u2)
        n1 = 1.0 + sigma * _safe_norm(d1x, d1y)
        n2 = 1.0 + sigma * _safe_norm(d2x, d2y)
        return (_mask_dual((p1x + sigma * d1x) / n1, (p1y + sigma * d1y) / n1)
                + _mask_dual((p2x + sigma * d2x) / n2, (p2y + sigma * d2y) / n2))

    def body(state):
        u1, u2, p1x, p1y, p2x, p2y = state
        u1, u2 = stencils.store(u_step, u1, u2, p1x, p1y, p2x, p2y, rho0, gx, gy, inv_g2, th)
        return (u1, u2) + stencils.store(p_step, p1x, p1y, p2x, p2y, u1, u2)

    z = torch.zeros_like(u1)
    state = stencils.checkpointed_loop(body, (u1, u2, z, z, z, z), iters)
    return state[0], state[1]


def k5_launch_schedule_plain(u1, u2, duals, rho0, gx, gy, inv_g2, th, iters: int,
                             theta: float, sigma: float, lam_theta: float,
                             last: bool = True,
                             window=(K5_WINDOW_H, K5_WINDOW_W)):
    """One K5 launch of `iters` alternations as csrc/tvl1.cu schedules it,
    in plain torch, on (H, W) or (B, H, W): each image cut into `k5_tile`
    tiles; each tile's window staged with what lies outside the array set
    to NaN (the kernel stages zeros: NaN shows that no exact pixel reads
    it), the duals zero inside the array when `duals` is None (the call's
    first launch). Alternation k runs, in place, its u-step on window rows
    [k, H-k+1) (a warp each) and its p-step on [k, H-k), both cut at the
    array's edges, on all columns (4 a lane); the column neighbours come as
    the warp shuffles give them (the window's first column takes the first
    lane's own last column as its left, the last column the last lane's own
    first one as its right), the row neighbours from inside the window (its
    first and last rows their own). With `last` (the call's last launch)
    the final p-step is skipped and only u is written. Only the owned tile
    is written, into arrays that are NaN elsewhere. Returns (u1, u2, duals), duals None with `last`.

    bfloat16 arrays are staged as the kernel's bfloat16 build stages them:
    widened into float32 windows, where the u-step rounds u1 and u2 and the
    p-step the duals in place (halo cells too), and the owned tile is
    written back in bfloat16."""
    # tvl1 routes to this module, so its operators are imported here.
    from opticalflowhs_tpu_torch.tvl1 import _safe_norm

    single = u1.ndim == 2

    def lift(arrays):
        return [a[None] if single else a for a in arrays]

    us = lift((u1, u2))
    ps = None if duals is None else lift(duals)
    fs = lift((rho0, gx, gy, inv_g2, th))
    b, h, w = us[0].shape
    wh, ww = window
    lane_cols = K5_LANE_COLS
    t_h, t_w, lh = k5_tile(iters, window)
    if t_h < 1 or t_w < lane_cols or ww % lane_cols:
        raise ValueError(f"no K5 tile of {iters} alternations in a {wh} x {ww} window")
    nan = float("nan")
    bf16 = us[0].dtype == torch.bfloat16
    win_dtype = torch.float32 if bf16 else us[0].dtype

    def stored(x):
        return x.to(torch.bfloat16).float() if bf16 else x

    outs = [torch.full_like(us[0], nan) for _ in range(2 if last else 6)]
    rows_w, cols_w = torch.arange(wh), torch.arange(ww)
    up = (rows_w - 1).clamp(min=0)
    down = (rows_w + 1).clamp(max=wh - 1)
    left = torch.cat([torch.tensor([lane_cols - 1]), cols_w[:-1]])
    right = torch.cat([cols_w[1:], torch.tensor([ww - lane_cols])])
    for img in range(b):
        for tr0 in range(0, h, t_h):
            for tc0 in range(0, w, t_w):
                r0, c0 = tr0 - iters, tc0 - lh
                ar, ac = rows_w + r0, cols_w + c0
                rin, cin = (ar >= 0) & (ar < h), (ac >= 0) & (ac < w)
                rs, cs = rin.nonzero()[:, 0], cin.nonzero()[:, 0]
                inside = (slice(int(rs[0]), int(rs[-1]) + 1), slice(int(cs[0]), int(cs[-1]) + 1))
                src = (img, slice(int(ar[rs[0]]), int(ar[rs[-1]]) + 1),
                       slice(int(ac[cs[0]]), int(ac[cs[-1]]) + 1))

                def stage(a):
                    win = torch.full((wh, ww), nan, dtype=win_dtype)
                    win[inside] = 0.0 if a is None else a[src].to(win_dtype)
                    return win

                s1, s2 = (stage(a) for a in us)
                p1x, p1y, p2x, p2y = (stage(None if ps is None else ps[j]) for j in range(4))
                f0, f1, f2, f3, f4 = (stage(a) for a in fs)
                rfirst, rlast = (ar == 0)[:, None], (ar == h - 1)[:, None]
                cfirst, clast = (ac == 0)[None, :], (ac == w - 1)[None, :]
                wr_lo, wr_hi = max(0, -r0), min(wh, h - r0)

                for k in range(1, iters + 1):
                    lo, hi = max(k, wr_lo), min(wh - k + 1, wr_hi)
                    if lo < hi:
                        r = rows_w[lo:hi]
                        a1, a2 = s1[r], s2[r]
                        rho = f0[r] + a1 * f1[r] + a2 * f2[r]
                        step = torch.where(rho < -f4[r], lam_theta,
                                           torch.where(rho > f4[r], -lam_theta, -rho * f3[r]))
                        v1 = a1 + step * f1[r]
                        v2 = a2 + step * f2[r]
                        divs = []
                        for px, py in ((p1x, p1y), (p2x, p2y)):
                            qx = torch.where(cfirst, 0.0, px[r][:, left])
                            qy = torch.where(rfirst[r], 0.0, py[up[r]])
                            divs.append((px[r] - qx) + (py[r] - qy))
                        s1[r] = stored(v1 + theta * divs[0])
                        s2[r] = stored(v2 + theta * divs[1])
                    if last and k == iters:
                        break
                    lo, hi = max(k, wr_lo), min(wh - k, wr_hi)
                    if lo < hi:
                        r = rows_w[lo:hi]
                        for su, px, py in ((s1, p1x, p1y), (s2, p2x, p2y)):
                            c = su[r]
                            dx = torch.where(clast, 0.0, c[:, right] - c)
                            dy = torch.where(rlast[r], 0.0, su[down[r]] - c)
                            n = 1.0 + sigma * _safe_norm(dx, dy)
                            qx = (px[r] + sigma * dx) / n
                            qy = (py[r] + sigma * dy) / n
                            px[r] = torch.where(clast, 0.0, stored(qx))
                            py[r] = torch.where(rlast[r], 0.0, stored(qy))
                # Write the owned tile.
                rt = torch.arange(iters, iters + t_h)
                rt = rt[rin[rt]]
                ct = torch.arange(lh, lh + t_w)
                ct = ct[cin[ct]]
                if len(rt) and len(ct):
                    dst = (img, slice(int(ar[rt[0]]), int(ar[rt[-1]]) + 1),
                           slice(int(ac[ct[0]]), int(ac[ct[-1]]) + 1))
                    wsl = (slice(int(rt[0]), int(rt[-1]) + 1), slice(int(ct[0]), int(ct[-1]) + 1))
                    for o, x in zip(outs, (s1, s2, p1x, p1y, p2x, p2y)):
                        o[dst] = x[wsl].to(o.dtype)
    outs = [o[0] for o in outs] if single else outs
    return outs[0], outs[1], (None if last else tuple(outs[2:]))


def k5_iters_schedule_plain(u1, u2, rho0, gx, gy, inv_g2, th, iters: int, s: int,
                            theta: float, sigma: float, lam_theta: float, **kw):
    """`iters` alternations as K5's ceil(iters/s) launches, each through
    `k5_launch_schedule_plain` (keywords passed on): the first from zero
    duals, the last writing u only. Returns (u1, u2)."""
    duals = None
    while iters > 0:
        k = min(s, iters)
        u1, u2, duals = k5_launch_schedule_plain(
            u1, u2, duals, rho0, gx, gy, inv_g2, th, k, theta, sigma, lam_theta,
            last=k == iters, **kw)
        iters -= k
    return u1, u2


def k5_geometry(device, block_iters: int = 0, shape=(1088, 1920), iters: int = 100,
                dtype=torch.float32) -> dict:
    """K5's plan and geometry for a call of `iters` alternations on an
    (H, W) or (B, H, W) `shape` at block_iters on a CUDA device, as the
    built kernel of `dtype` (float32 or bfloat16) reports it: alternations a
    launch and launches, window rows, tile, threads, shared bytes,
    registers a thread and spilled bytes (cudaFuncGetAttributes), resident
    blocks a multiprocessor and the tiles of one launch."""
    _check_block_iters(block_iters)
    b, h, w = (1,) * (3 - len(shape)) + tuple(shape)
    return dict(_geometry(torch.device(device).index or 0, b, h, w, iters, block_iters,
                          _build.bf16_suffix(dtype)))


@functools.lru_cache(maxsize=256)
def _geometry(index: int, b: int, h: int, w: int, iters: int, block_iters: int,
              suffix: str = "") -> tuple:
    out = (ctypes.c_int * 11)()
    name = "hs_tvl1_geometry" + suffix
    err = getattr(_build.library(), name)(
        b, h, w, iters, block_iters, index, ctypes.cast(out, ctypes.POINTER(ctypes.c_int)))
    _build.check(err, name)
    keys = ("iters_per_launch", "launches", "window_h", "tile_h", "tile_w", "threads",
            "smem_bytes", "registers", "spill_bytes", "blocks_per_sm", "tiles")
    return tuple(zip(keys, list(out)))


def tvl1_inner(u1, u2, rho0, gx, gy, inv_g2, th, iters: int, theta: float,
               sigma: float, lam_theta: float, block_iters: int = 0):
    """K5 wrapper over (H, W) tensors or (B, H, W) stacks: on CUDA tensors
    one C call enqueues ceil(iters/s) launches of s alternations (s =
    block_iters, or the kernel's choice for 0: `k5_geometry`) on the current
    stream, on CPU tensors `tvl1_inner_plain` runs. The state ping-pongs between two slots
    of buffers of its own, so the caller's tensors are not modified. theta,
    sigma and lam_theta reach the kernel as the float32 values torch rounds
    them to. float32 or bfloat16 arrays (one dtype: the bfloat16 build,
    `hs_tvl1_inner_bf16`, for bfloat16). Returns (u1, u2). Differentiable
    with respect to all seven tensors (`autodiff`: the VJP of
    `tvl1_inner_plain`, as the reference's `_inner_ad`)."""
    if autodiff.needs_grad(u1, u2, rho0, gx, gy, inv_g2, th):
        return autodiff.KernelEntry.apply(
            lambda *t: tvl1_inner(*t, iters, theta, sigma, lam_theta, block_iters),
            lambda *t: tvl1_inner_plain(*t, iters, theta, sigma, lam_theta),
            u1, u2, rho0, gx, gy, inv_g2, th)
    check_frames("tvl1_inner", u1, u2, rho0, gx, gy, inv_g2, th, dtypes=BF16_DTYPES)
    if iters < 0:
        raise ValueError(f"tvl1_inner: iters must be >= 0, got {iters}")
    _check_block_iters(block_iters)
    if u1.device.type == "cpu":
        return tvl1_inner_plain(u1, u2, rho0, gx, gy, inv_g2, th, iters,
                                theta, sigma, lam_theta)
    b, h, w = batch_dims("hs_tvl1_inner", u1)
    if iters == 0 or u1.numel() == 0:
        return u1.clone(), u2.clone()
    # Two slots of each state array: u starts in slot 0, the result is in
    # slot launches % 2; the duals' slot 0 is never read.
    state = [torch.empty((2,) + tuple(u1.shape), dtype=u1.dtype, device=u1.device)
             for _ in range(6)]
    state[0][0].copy_(u1)
    state[1][0].copy_(u2)
    launches = ctypes.c_int(0)
    name = "hs_tvl1_inner" + _build.bf16_suffix(u1.dtype)
    err = getattr(_build.library(), name)(
        state[0].data_ptr(), state[1].data_ptr(), rho0.data_ptr(), gx.data_ptr(),
        gy.data_ptr(), inv_g2.data_ptr(), th.data_ptr(),
        *(p.data_ptr() for p in state[2:]), b, h, w, iters, float(theta),
        float(sigma), float(lam_theta), block_iters, u1.device.index,
        torch.cuda.current_stream(u1.device).cuda_stream, ctypes.byref(launches),
    )
    tvl1_inner.launches += launches.value
    _build.check(err, name)
    return state[0][launches.value % 2], state[1][launches.value % 2]


# Every K5 kernel launch, single frame or batched, float32 or bfloat16, as
# the C call reports what it enqueued: ceil(iters/s) a call.
tvl1_inner.launches = 0
