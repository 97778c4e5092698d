"""K2: temporally blocked Jacobi sweeps.

Port of the Jacobi sweep kernels of opticalflowhs_tpu/kernels/jacobi.py
(`jacobi_sweeps` and its whole-image, banded and fused-banded TPU
schedules; `jacobi_sweeps_batched` and its stacked and batched-banded
schedules) and of the sweep stage of the resident whole-solve kernels. The
CUDA source is csrc/jacobi.cu: one launch runs up to `sweeps_per_launch`
sweeps, for one frame or for a whole (B, H, W) stack, with one persistent
block a multiprocessor walking 48 x 128 windows (the tile and its decaying
halo): the fields in registers, u and v in shared memory, each column sum
computed once and passed to the neighbouring lanes by warp shuffles, and
the next window's u and v staged while the current one is swept. That
window loop (csrc/k2_window.cuh) also runs inside K6, K7, K11 and K12.
`k2_launch_schedule_plain` walks it in plain torch (`k2_stage`,
`k2_window_sweeps`, `k2_owned` a window at a time, which K7's twin reuses).

`jacobi_sweeps` (also named `jacobi_sweeps_batched`) takes either rank. It
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors. There is no fallback: a CUDA tensor goes through the kernel or
the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from opticalflowhs_tpu_torch.kernels import _build, autodiff
from opticalflowhs_tpu_torch.kernels.derivatives import (
    BF16_DTYPES,
    batch_dims,
    check_frames,
)
from opticalflowhs_tpu_torch.ops import stencils

# The default sweeps per launch (HSConfig.block_sweeps = 0) of every Jacobi
# kernel, and the rule that caps it: `sweeps_per_launch` cuts a launch's
# sweeps until 8 float32 arrays of a 64 x 64 tile grown by the sweeps fit the
# shared memory of one block (200 KB at s = 8), so at most 10 sweeps a
# launch. That was the window of the shared sweep loop the first kernels
# ran; K2, K9, K6 and K7 keep its rule. K3 and K9's SOR entry take theirs
# from a cost rule over launches and rounds of tiles, at most
# K3_MAX_SWEEPS (`sweeps_per_launch` of kernels/sor.py), and K4's sweeps
# from one of their own for each refreeze block, at most K4_MAX_SWEEPS
# (`sweeps_per_launch` of kernels/solve_robust.py). K11 and K12 take
# their sweep block from the tiled solver, run as passes of at most
# RING_PASS_SWEEPS (kernels/ring.py).
TILE_H = 64
TILE_W = 64
AUTO_SWEEPS = 8
SMEM_BYTES = 232_448  # shared memory one block may use on Hopper
_ARRAYS = 8

# K2's own geometry (csrc/k2_window.cuh; K9, K6, K7, K11 and K12 share it). A block
# of K2_THREADS
# threads sweeps a K2_WINDOW_H x K2_WINDOW_W window: warp j owns rows
# 3j..3j+2 (K2_WARP_ROWS), lane l the K2_LANE_COLS columns 4l..4l+3, and
# the fields of those 12 pixels stay in registers; each column sum is
# computed once and passed to the neighbouring lanes by warp shuffles (27
# float32 operations a pixel a sweep). Shared memory holds three u/v pairs
# of the window (two swept, one staged for the next tile by cp.async):
# K2_SMEM_BYTES; the registers (122-128 a thread) allow one block a
# multiprocessor, and the grid is persistent. At s = 8 the tile is 32 x 112
# (`k2_tile`). Bound: 8 arrays a launch, 19.9 us at 1088x1920; measured on
# an H100 0.0635-0.0664 ms (30-31% of it), held back by the sweep
# arithmetic (PERF.md, tools/torch_k2_limits.py). A 64-row window at 4
# rows a thread spilled registers and ran slower.
K2_WINDOW_H = 48
K2_WINDOW_W = 128
K2_LANE_COLS = 4
K2_WARP_ROWS = 3
K2_THREADS = 512
K2_SMEM_BYTES = 6 * 4 * K2_WINDOW_H * K2_WINDOW_W  # 147,456
K2_MAX_SWEEPS = 16


def k2_tile(sweeps: int, window=(K2_WINDOW_H, K2_WINDOW_W),
            lane_cols: int = K2_LANE_COLS) -> tuple[int, int, int]:
    """(tile rows, tile columns, left halo) of one K2 window at `sweeps`
    (csrc/jacobi.cu `geometry`): the window less s rows above and below,
    and less s columns rounded up to the lane's width on the left and at
    least s on the right, so tile and window columns stay aligned to it."""
    wh, ww = window
    lh = -(-sweeps // lane_cols) * lane_cols
    return wh - 2 * sweeps, (ww - lh - sweeps) // lane_cols * lane_cols, lh


def smem_bytes(sweeps: int, tile_h: int = TILE_H, tile_w: int = TILE_W) -> int:
    """Shared memory of one window of the rule `sweeps_per_launch` keeps:
    the 8 arrays of a tile grown by `sweeps` on each side."""
    return _ARRAYS * 4 * (tile_h + 2 * sweeps) * (tile_w + 2 * sweeps)


def sweeps_per_launch(block_sweeps: int = 0) -> int:
    """Sweeps one K2 launch runs: block_sweeps, or AUTO_SWEEPS for 0, cut
    until `smem_bytes` of that many sweeps fits the shared memory of one
    block."""
    s = block_sweeps if block_sweeps > 0 else AUTO_SWEEPS
    while s > 1 and smem_bytes(s) > SMEM_BYTES:
        s -= 1
    return s


def jacobi_sweeps_plain(u, v, ex, ey, et, inv_den, n: int):
    """n plain Jacobi sweeps (ops/stencils.py), on (H, W) or (B, H, W); on a
    stack each image on its own, as the reference's vmapped twin (the
    stencils clamp per image). The sweeps run through
    `stencils.checkpointed_loop`, as the reference's twin (`_jnp_sweeps`):
    the same values, and a gradient tape of O(sqrt(n)) fields. bfloat16
    arrays follow the storage rule (`stencils.store`): float32 arithmetic,
    u and v rounded at the end of every sweep."""
    return stencils.checkpointed_loop(
        lambda uv: stencils.store(stencils.jacobi_step, *uv, ex, ey, et, inv_den), (u, v), n)


def k2_stage(a, r0: int, c0: int, window=(K2_WINDOW_H, K2_WINDOW_W), group: int = 1):
    """The (wh, ww) window of the (H, W) array `a` whose element (0, 0) is
    array pixel (r0, c0), NaN outside the array (the kernels stage zeros
    there: NaN shows that no exact pixel reads it). `group` > 1 stages the
    columns as the kernels' wide copies do, in groups of that many from the
    window's column 0, a group only where all of it lies inside the array
    (`copy_group` says which width a kernel takes)."""
    wh, ww = window
    h, w = a.shape
    win = torch.full((wh, ww), float("nan"), dtype=a.dtype)
    rlo, rhi = max(0, -r0), min(wh, h - r0)
    clo, chi = max(0, -c0), min(ww, w - c0)
    if group > 1:
        clo, chi = -(-clo // group) * group, chi // group * group
    if rlo < rhi and clo < chi:
        win[rlo:rhi, clo:chi] = a[r0 + rlo:r0 + rhi, c0 + clo:c0 + chi]
    return win


def copy_group(dtype, w: int, c0: int) -> int:
    """Columns one copy stages in the window walks of K3 and K4 (csrc,
    `copy_quad`, `bf16_wide`) for an array of width w whose window starts
    at column c0: 8 bfloat16 values (16 bytes, a lane pair) where w and c0
    are multiples of 8, a lane's 4 where w is a multiple of 4, else 1. The
    groups are then all inside the array or all outside."""
    if dtype == torch.bfloat16 and w % 8 == 0 and c0 % 8 == 0:
        return 8
    return 4 if w % 4 == 0 else 1


def k2_window_sweeps(su, sv, fx, fy, ft, fi, sweeps: int, r0: int, c0: int,
                     hw, org=(0, 0), img_hw=None, lane_cols: int = K2_LANE_COLS,
                     warp_rows: int = K2_WARP_ROWS):
    """The `sweeps` sweeps of one staged K2 window at array pixel (r0, c0)
    of an (h, w) = `hw` array, as the kernel runs them: sweep k on every
    row of each warp (`warp_rows` rows) that meets the window's rows shrunk
    by k (cut at the array's edges), on all columns, into a second buffer
    (NaN at first) that keeps its old rows elsewhere; rows i-1 and i+1 stay
    inside the window; the column sums t(j-1) and t(j+1) come from the
    neighbouring column as the warp shuffles give them, the window's first
    column taking the first lane's own last column and its last column the
    last lane's own first one; the clamps fire at the array's edges and,
    with `img_hw` (K9: `org` the global pixel of array element (0, 0) in an
    img_hw image), at the true image edges. Returns the last sweep's
    (u, v) window."""
    h, w = hw
    wh, ww = su.shape
    shard = img_hw is not None
    ih, iw = img_hw if shard else (h, w)
    rows_w = torch.arange(wh)
    ar, ac = rows_w + r0, torch.arange(ww) + c0
    cin = (ac >= 0) & (ac < w)
    gr, gc = ar + org[0], ac + org[1]
    top = (ar == 0) | (shard & (gr == 0)) | (rows_w == 0)
    bot = (ar == h - 1) | (shard & (gr == ih - 1)) | (rows_w == wh - 1)
    up = torch.where(top, rows_w, rows_w - 1)
    down = torch.where(bot, rows_w, rows_w + 1)
    lcl = cin & ((ac == 0) | (shard & (gc == 0)))
    rcl = cin & ((ac == w - 1) | (shard & (gc == iw - 1)))
    wr_lo, wr_hi = max(0, -r0), min(wh, h - r0)
    du = torch.full((wh, ww), float("nan"))
    dv = torch.full((wh, ww), float("nan"))
    for k in range(1, sweeps + 1):
        rlo, rhi = max(k, wr_lo), min(wh - k, wr_hi)
        lo = rlo // warp_rows * warp_rows
        hi = min(wh, -(-rhi // warp_rows) * warp_rows)
        if rlo < rhi:
            r = rows_w[lo:hi]
            bars = []
            for a in (su, sv):
                t = a[up[r]] + 2.0 * a[r] + a[down[r]]
                tl = torch.cat([t[:, lane_cols - 1:lane_cols], t[:, :-1]], 1)
                tr = torch.cat([t[:, 1:], t[:, ww - lane_cols:ww - lane_cols + 1]], 1)
                tl = torch.where(lcl, t, tl)
                tr = torch.where(rcl, t, tr)
                s = tl + 2.0 * t + tr
                bars.append(s * (1.0 / 12.0) - a[r] * (1.0 / 3.0))
            ubar, vbar = bars
            frac = (fx[r] * ubar + fy[r] * vbar + ft[r]) * fi[r]
            du[r] = ubar - fx[r] * frac
            dv[r] = vbar - fy[r] * frac
        su, du, sv, dv = du, su, dv, sv
    return su, sv


def k2_owned(r0: int, c0: int, sweeps: int, hw, window=(K2_WINDOW_H, K2_WINDOW_W),
             lane_cols: int = K2_LANE_COLS, owned=(0, 0)):
    """The owned tile of the window at array pixel (r0, c0), cut at the
    (h, w) array, or with owned = (oy, ox) at its rows [oy, h - oy) and
    columns [ox, w - ox): (array rows, array columns, window rows, window
    columns) as slices, or None when it holds no such pixel."""
    th, tw, lh = k2_tile(sweeps, window, lane_cols)
    h, w = hw
    oy, ox = owned
    a_r0, a_c0 = max(r0 + sweeps, oy), max(c0 + lh, ox)
    a_r1, a_c1 = min(r0 + sweeps + th, h - oy), min(c0 + lh + tw, w - ox)
    if a_r0 >= a_r1 or a_c0 >= a_c1:
        return None
    return (slice(a_r0, a_r1), slice(a_c0, a_c1),
            slice(a_r0 - r0, a_r1 - r0), slice(a_c0 - c0, a_c1 - c0))


def k2_launch_schedule_plain(u, v, ex, ey, et, inv_den, sweeps: int,
                             origins=None, img_hw=None,
                             window=(K2_WINDOW_H, K2_WINDOW_W),
                             lane_cols: int = K2_LANE_COLS,
                             warp_rows: int = K2_WARP_ROWS, owned=None):
    """One K2 launch of `sweeps` sweeps as csrc/jacobi.cu schedules it, in
    plain torch, on (H, W) or (B, H, W): each image cut into `k2_tile`
    tiles; each tile's window staged with what lies outside the array set
    to NaN (`k2_stage`) and swept as the kernel sweeps it
    (`k2_window_sweeps`; with `origins`, K9's per-image (row, col) of the
    global pixel at element (0, 0), in an `img_hw` image). Only the owned
    tile of the last sweep is written. With owned = (oy, ox) (K11, K12)
    only the rectangle of rows [oy, H - oy) and columns [ox, W - ox) is cut
    into tiles and written, NaN elsewhere. Returns (u, v)."""
    single = u.ndim == 2
    arrays = [a[None] if single else a for a in (u, v, ex, ey, et, inv_den)]
    b, h, w = arrays[0].shape
    wh, ww = window
    th, tw, lh = k2_tile(sweeps, window, lane_cols)
    if th < 1 or tw < lane_cols or ww % lane_cols:
        raise ValueError(f"no K2 tile of {sweeps} sweeps in a {wh} x {ww} window")
    shard = origins is not None
    oy, ox = owned if owned is not None else (0, 0)
    out_u = torch.full_like(arrays[0], float("nan"))
    out_v = torch.full_like(arrays[0], float("nan"))
    for img in range(b):
        org = (int(origins[img][0]), int(origins[img][1])) if shard else (0, 0)
        for tr0 in range(oy, h - oy, th):
            for tc0 in range(ox, w - ox, tw):
                r0, c0 = tr0 - sweeps, tc0 - lh
                wins = [k2_stage(a[img], r0, c0, window) for a in arrays]
                su, sv = k2_window_sweeps(*wins, sweeps, r0, c0, (h, w), org,
                                          img_hw if shard else None, lane_cols, warp_rows)
                own = k2_owned(r0, c0, sweeps, (h, w), window, lane_cols, (oy, ox))
                if own is not None:
                    rows, cols, wrows, wcols = own
                    out_u[img, rows, cols] = su[wrows, wcols]
                    out_v[img, rows, cols] = sv[wrows, wcols]
    return (out_u[0], out_v[0]) if single else (out_u, out_v)


def k2_sweeps_schedule_plain(u, v, ex, ey, et, inv_den, n: int, s: int, **kw):
    """n sweeps as K2's ceil(n/s) launches, each through
    `k2_launch_schedule_plain` (keywords passed on)."""
    while n > 0:
        k = min(s, n)
        u, v = k2_launch_schedule_plain(u, v, ex, ey, et, inv_den, k, **kw)
        n -= k
    return u, v


def k2_geometry(device, sweeps: int = AUTO_SWEEPS, shard: bool = False,
                dtype=torch.float32) -> dict:
    """K2's (with shard=True K9's; with dtype=torch.bfloat16 the bfloat16
    build's) geometry on a CUDA device at `sweeps`, as the built kernel
    reports it: tile, threads, shared bytes, registers a thread and spilled
    bytes (cudaFuncGetAttributes), resident blocks a multiprocessor and
    multiprocessors."""
    out = (ctypes.c_int * 8)()
    ptr = ctypes.cast(out, ctypes.POINTER(ctypes.c_int))
    name = "hs_jacobi_geometry" + _build.bf16_suffix(dtype)
    err = getattr(_build.library(), name)(sweeps, int(shard),
                                          torch.device(device).index or 0, ptr)
    _build.check(err, name)
    keys = ("tile_h", "tile_w", "threads", "smem_bytes", "registers",
            "spill_bytes", "blocks_per_sm", "sms")
    return dict(zip(keys, list(out)))


def launch_sweeps(u, v, ex, ey, et, inv_den, uo, vo, sweeps: int) -> None:
    """One K2 launch: `sweeps` sweeps from (u, v) into (uo, vo), on the
    current stream, over a frame or a whole stack. All eight tensors are
    CUDA tensors of one shape and one dtype, float32 or bfloat16 (checked
    by the callers); uo/vo must not alias u/v."""
    b, h, w = batch_dims("hs_jacobi_sweeps", u)
    if u.numel() == 0:
        return
    err = getattr(_build.library(), "hs_jacobi_sweeps" + _build.bf16_suffix(u.dtype))(
        u.data_ptr(), v.data_ptr(), ex.data_ptr(), ey.data_ptr(),
        et.data_ptr(), inv_den.data_ptr(), uo.data_ptr(), vo.data_ptr(),
        b, h, w, sweeps, u.device.index,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(err, "hs_jacobi_sweeps")
    jacobi_sweeps.launches += 1


def ping_pong(u, v, n: int, s: int, launch, owned: bool = False):
    """Run n sweeps as ceil(n/s) launches, the last one running the
    remainder, ping-ponging between two u/v pairs on one stream with no
    host synchronisation: `launch(u, v, uo, vo, k)` runs k sweeps from
    (u, v) into (uo, vo). owned=True lets the chain overwrite (u, v)."""
    pairs = [None, (u, v) if owned else None]
    src = (u, v)
    i = 0
    while n > 0:
        k = min(s, n)
        if pairs[i % 2] is None:
            pairs[i % 2] = (torch.empty_like(u), torch.empty_like(v))
        dst = pairs[i % 2]
        launch(*src, *dst, k)
        src = dst
        n -= k
        i += 1
    return src


def sweep_chain(u, v, ex, ey, et, inv_den, n: int, s: int,
                owned: bool = False):
    """n Jacobi sweeps as ceil(n/s) K2 launches (`ping_pong`)."""
    def launch(su, sv, du, dv, k):
        launch_sweeps(su, sv, ex, ey, et, inv_den, du, dv, k)
    return ping_pong(u, v, n, s, launch, owned)


def jacobi_sweeps(u, v, ex, ey, et, inv_den, n_sweeps: int,
                  block_sweeps: int = 0):
    """n Jacobi sweeps on (H, W) tensors or a (B, H, W) stack of independent
    images: on CUDA tensors ceil(n/s) K2 launches (for the whole stack,
    each image clamped at its own edges), `jacobi_sweeps_plain` on CPU
    tensors. float32 or bfloat16 (the kernel's bfloat16 build: float32
    arithmetic, u and v rounded at the end of every sweep, the same
    launches). Returns (u, v); the inputs are not modified. Differentiable
    with respect to all six tensors (`autodiff`: the VJP of
    `jacobi_sweeps_plain`, as the reference's `_jacobi_sweeps_ad`)."""
    if autodiff.needs_grad(u, v, ex, ey, et, inv_den):
        return autodiff.KernelEntry.apply(
            lambda *t: jacobi_sweeps(*t, n_sweeps, block_sweeps),
            lambda *t: jacobi_sweeps_plain(*t, n_sweeps), u, v, ex, ey, et, inv_den)
    check_frames("jacobi_sweeps", u, v, ex, ey, et, inv_den, dtypes=BF16_DTYPES)
    if n_sweeps == 0:
        return u, v
    if u.device.type == "cpu":
        return jacobi_sweeps_plain(u, v, ex, ey, et, inv_den, n_sweeps)
    return sweep_chain(u, v, ex, ey, et, inv_den, n_sweeps,
                       sweeps_per_launch(block_sweeps))


# Every K2 launch, single frame or batched, counts here.
jacobi_sweeps.launches = 0

# The reference's names for the batched sweeps: the same functions.
jacobi_sweeps_batched = jacobi_sweeps
jacobi_sweeps_batched_plain = jacobi_sweeps_plain
