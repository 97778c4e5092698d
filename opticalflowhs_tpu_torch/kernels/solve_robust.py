"""K4: the Charbonnier IRLS ("robust") solve, freeze and frozen-weight
sweeps.

Port of opticalflowhs_tpu/kernels/solve_robust.py (`hs_solve_robust_resident`,
TPU kernel `_robust_kernel`: one launch for derivatives, every refreeze and
every sweep, with nine arrays resident in VMEM). At 1080p those arrays
(~75 MB) exceed the H100's shared memory, so the Hopper analog chains
launches through L2 on one stream: K1 for Ex, Ey, Et, then per refreeze
block of m sweeps one K4 freeze launch (`freeze_weights`) and the sweep
launches of the block's plan (`frozen_sweeps`, s from `sweeps_per_launch`).
The CUDA source is csrc/robust.cu; a (B, H, W) stack is one chain.

The sweep kernel is a persistent window walk: one block a multiprocessor
walks K4_WINDOW_H x K4_WINDOW_W windows (the tile and a halo of s rings);
a thread holds u, v and the launch's frozen coefficients (the four edge
weights, a11, a22, a12, c1, c2 and 1/det, formed once a tile) of its
pixels in registers, and a sweep is the 26 operations that read u and v,
with no division. `k4_launch_schedule_plain` walks that schedule in plain
torch.

The wrappers launch the kernels for CUDA tensors and run the plain versions
(robust.py) for CPU tensors. There is no fallback: a CUDA tensor goes
through the kernels or the call raises. Unlike the TPU kernel, which covers
hs_cube frames within its VMEM class, the chain covers both derivative
variants and every size.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from opticalflowhs_tpu_torch import robust as plain
from opticalflowhs_tpu_torch.kernels import _build, autodiff
from opticalflowhs_tpu_torch.kernels.derivatives import (
    BF16_DTYPES,
    batch_dims,
    check_frames,
    derivatives_plain,
    hs_derivatives,
)
from opticalflowhs_tpu_torch.kernels.jacobi import copy_group, k2_stage, ping_pong
from opticalflowhs_tpu_torch.kernels.sor import _check_block_sweeps

# The sweep kernel's geometry (csrc/robust.cu). A block of K4_THREADS
# threads sweeps a K4_WINDOW_H x K4_WINDOW_W window: warp j owns rows
# K4_THREAD_ROWS*j .. (the next K4_THREAD_ROWS), lane l the K4_LANE_COLS
# columns 4l..4l+3, and u, v and the ten coefficients of those pixels stay
# in registers. Shared memory holds the next tile's staged window of the 7
# arrays (u, v, Ex, Ey, Et, wd, ws) and two exchange buffers of every
# warp's first and last rows of u and v: K4_SMEM_BYTES; one block a
# multiprocessor, and the grid is persistent. The tile is the window less s
# rows above and below, s columns rounded up to 4 on the left and at least
# s on the right (`k4_tile`): 16 x 112 at s = 8, 4 x 96 at K4_MAX_SWEEPS.
K4_THREAD_ROWS = 4
K4_THREADS = 256
K4_LANE_COLS = 4
K4_WINDOW_H = K4_THREADS // 32 * K4_THREAD_ROWS
K4_WINDOW_W = 32 * K4_LANE_COLS
K4_SMEM_BYTES = 4 * (7 * K4_WINDOW_H * K4_WINDOW_W + 4 * 2 * (K4_THREADS // 32) * K4_WINDOW_W)
K4_MAX_SWEEPS = (K4_WINDOW_H - K4_THREAD_ROWS) // 2
# The cost rule's prices (`sweeps_per_launch`), in microseconds: a launch
# K4_LAUNCH_US, and each round of windows (one tile a block) the larger of
# K4_ROUND_FLOOR_US, the staging of a window from device memory, and
# K4_TILE_US, its loads and coefficients, + K4_SWEEP_US a sweep slot
# (`k4_sweep_slots`). Fitted (least relative squares) to launch times at s
# 1-14 on 1088x1920, 1088x1900, 8 x 1088x1920, 544x960 and 272x480 (NVIDIA
# H100 80GB HBM3, 700.00 W, tools/torch_whole_solve_timing.py --k4 --scan):
# within 4.7% on the mean, and for a block of 20 sweeps it picks the s
# measured fastest at each of the five shapes (PERF.md).
K4_LAUNCH_US = 7.69
K4_ROUND_FLOOR_US = 5.85
K4_TILE_US = 2.63
K4_SWEEP_US = 0.355
# Warp schedulers of a multiprocessor; warp j issues on scheduler j % 4.
K4_SCHEDULERS = 4


def k4_tile(sweeps: int) -> tuple[int, int, int]:
    """(tile rows, tile columns, left halo) of one K4 sweep window at
    `sweeps`: the window less s rows above and below, and less s columns
    rounded up to the lane's width on the left and at least s on the
    right."""
    lh = -(-sweeps // K4_LANE_COLS) * K4_LANE_COLS
    return (K4_WINDOW_H - 2 * sweeps,
            (K4_WINDOW_W - lh - sweeps) // K4_LANE_COLS * K4_LANE_COLS, lh)


def k4_tiles(shape, sweeps: int) -> int:
    """Tiles of one K4 sweep launch of `sweeps` sweeps over an (H, W) frame
    or a (B, H, W) stack."""
    b, h, w = (1,) * (3 - len(shape)) + tuple(shape)
    th, tw, _ = k4_tile(sweeps)
    return b * -(-h // th) * -(-w // tw)


def k4_sweep_slots(sweeps: int) -> int:
    """The time of `sweeps` sweeps of one window, in sweeps of one warp on
    each scheduler: sweep k runs on the warps that meet the window's rows
    shrunk by k, and takes as long as the scheduler with the most of them
    (2 of the 8 warps up to sweep 7, 1 after)."""
    warps = K4_THREADS // 32
    slots = 0
    for k in range(1, sweeps + 1):
        live = [j for j in range(warps)
                if K4_THREAD_ROWS * j < K4_WINDOW_H - k and K4_THREAD_ROWS * (j + 1) > k]
        slots += max(sum(1 for j in live if j % K4_SCHEDULERS == q)
                     for q in range(K4_SCHEDULERS))
    return slots


def plan_cost(shape, n: int, s: int, blocks: int) -> float:
    """The cost rule's price in microseconds of n sweeps over `shape` at s
    a launch (the last launch running the remainder) on `blocks` resident
    blocks: for each launch K4_LAUNCH_US + rounds of tiles (one tile a
    block) x max(K4_ROUND_FLOOR_US, K4_TILE_US + K4_SWEEP_US x its sweep
    slots)."""
    cost, left = 0.0, n
    while left > 0:
        k = min(s, left)
        rounds = -(-k4_tiles(shape, k) // blocks)
        cost += K4_LAUNCH_US + rounds * max(K4_ROUND_FLOOR_US,
                                            K4_TILE_US + K4_SWEEP_US * k4_sweep_slots(k))
        left -= k
    return cost


def sweeps_per_launch(block_sweeps: int, shape, n: int, blocks: int) -> int:
    """Sweeps a K4 sweep launch runs in a block of n frozen-weight sweeps
    (one refreeze block, `robust.refreeze_blocks`) over `shape` ((H, W) or
    (B, H, W)) on `blocks` resident blocks (`device_blocks`): block_sweeps
    cut to K4_MAX_SWEEPS, or for 0 the s up to min(n, K4_MAX_SWEEPS) of
    least `plan_cost`; ties go to an s that divides n (no short last
    launch), then to the larger s."""
    _check_block_sweeps(block_sweeps)
    if block_sweeps > 0:
        return min(block_sweeps, K4_MAX_SWEEPS)
    if n <= 0:
        return 1
    return _plan(tuple(shape), n, blocks)


@functools.lru_cache(maxsize=256)
def _plan(shape: tuple, n: int, blocks: int) -> int:
    # Cached: a solve plans each refreeze block, and a plan prices every s.
    return min(range(1, min(n, K4_MAX_SWEEPS) + 1),
               key=lambda s: (plan_cost(shape, n, s, blocks), n % s != 0, -s))


def launches(n: int, s: int) -> int:
    """K4 sweep launches of a block of n sweeps at s a launch."""
    return -(-n // s)


def k4_window_sweeps(su, sv, fx, fy, ft, fd, fs, sweeps: int, alpha: float, r0: int,
                     c0: int, hw, skip: bool = True, bf16: bool = False):
    """The `sweeps` sweeps of one staged K4 window at array pixel (r0, c0) of
    an (h, w) = `hw` array, as csrc/robust.cu schedules them: the ten
    coefficients formed once from the staged fields, then sweep k on the
    rows of each warp (K4_THREAD_ROWS rows) that meets the window's rows
    [k, H - k) (cut at the array's edges), on all columns, from the old u
    and v; the other rows keep their values. Every neighbour read comes
    from the window, clamped at the array's edges; what lies beside the
    window (the kernel takes its own first or last row there, and its lanes
    0 and 31 their own columns) is NaN here, so that any value read from
    outside the window shows. skip=False sweeps every row at every sweep.
    The arrays are float32; with `bf16` each sweep's u and v are rounded to
    bfloat16, as the kernel's bfloat16 build rounds them at each sweep's
    end. Returns (u, v)."""
    h, w = hw
    wh, ww = su.shape
    rows_w = torch.arange(wh)
    ar, ac = rows_w + r0, torch.arange(ww) + c0
    tcl, bcl = (ar == 0)[:, None], (ar == h - 1)[:, None]
    lcl, rcl = (ac == 0)[None], (ac == w - 1)[None]
    nan_row = torch.full((1, ww), float("nan"), dtype=su.dtype)
    nan_col = torch.full((wh, 1), float("nan"), dtype=su.dtype)

    def around(a):
        up = torch.where(tcl, a, torch.cat([nan_row, a[:-1]]))
        dn = torch.where(bcl, a, torch.cat([a[1:], nan_row]))
        lf = torch.where(lcl, a, torch.cat([nan_col, a[:, :-1]], 1))
        rt = torch.where(rcl, a, torch.cat([a[:, 1:], nan_col], 1))
        return up, dn, lf, rt

    s_up, s_dn, s_lf, s_rt = around(fs)
    w_up = 0.5 * (fs + s_up)
    w_dn = 0.5 * (fs + s_dn)
    w_lf = 0.5 * (fs + s_lf)
    w_rt = 0.5 * (fs + s_rt)
    w_sum = w_up + w_dn + w_lf + w_rt
    a2 = alpha * alpha
    a11 = fd * fx * fx + a2 * w_sum
    a22 = fd * fy * fy + a2 * w_sum
    a12 = fd * fx * fy
    c1 = fd * fx * ft
    c2 = fd * fy * ft
    inv_det = 1.0 / (a11 * a22 - a12 * a12)
    wr_lo, wr_hi = max(0, -r0), min(wh, h - r0)
    for k in range(1, sweeps + 1):
        rlo, rhi = (max(k, wr_lo), min(wh - k, wr_hi)) if skip else (0, wh)
        if rlo >= rhi:
            continue
        lo = rlo // K4_THREAD_ROWS * K4_THREAD_ROWS
        hi = min(wh, -(-rhi // K4_THREAD_ROWS) * K4_THREAD_ROWS)
        u_up, u_dn, u_lf, u_rt = around(su)
        v_up, v_dn, v_lf, v_rt = around(sv)
        b1 = a2 * (w_up * u_up + w_dn * u_dn + w_lf * u_lf + w_rt * u_rt) - c1
        b2 = a2 * (w_up * v_up + w_dn * v_dn + w_lf * v_lf + w_rt * v_rt) - c2
        un = (a22 * b1 - a12 * b2) * inv_det
        vn = (a11 * b2 - a12 * b1) * inv_det
        if bf16:
            un, vn = (x.to(torch.bfloat16).float() for x in (un, vn))
        su, sv = su.clone(), sv.clone()
        su[lo:hi], sv[lo:hi] = un[lo:hi], vn[lo:hi]
    return su, sv


def k4_launch_schedule_plain(u, v, ex, ey, et, wd, ws, sweeps: int, alpha: float,
                             halo=None, group=None):
    """One K4 sweep launch of `sweeps` sweeps as csrc/robust.cu schedules it,
    in plain torch, on (H, W) or (B, H, W): each image cut into `k4_tile`
    tiles; each tile's window staged with what lies outside the array set
    to NaN and swept as the kernel sweeps it (`k4_window_sweeps`). Only the
    owned tile of the last sweep is written, into arrays that are NaN
    elsewhere. `halo` = (rows, columns) replaces the halo of s rows and s
    columns rounded up to 4 on the left (the tile is then the window less
    it on each side, and every row is swept at every sweep, as the warps'
    skipping assumes the full halo), to show what a smaller one does.
    bfloat16 arrays are staged as the kernel's bfloat16 build stages them
    (`jacobi.copy_group`; `group` forces the column groups, to show what
    copies wider than the alignment allows do) and widened, the
    coefficients are formed in float32 from the widened fields and
    weights, and each sweep's u and v are rounded. Returns (u, v)."""
    single = u.ndim == 2
    arrays = [a[None] if single else a for a in (u, v, ex, ey, et, wd, ws)]
    b, h, w = arrays[0].shape
    th, tw, lh = k4_tile(sweeps)
    hr = sweeps
    if halo is not None:
        hr, lh = halo
        th, tw = K4_WINDOW_H - 2 * hr, K4_WINDOW_W - 2 * lh
    if th < 1 or tw < 1:
        raise ValueError(f"no K4 tile of {sweeps} sweeps in a {K4_WINDOW_H} x "
                         f"{K4_WINDOW_W} window")
    out_u = torch.full_like(arrays[0], float("nan"))
    out_v = torch.full_like(arrays[0], float("nan"))
    for img in range(b):
        for tr0 in range(0, h, th):
            for tc0 in range(0, w, tw):
                r0, c0 = tr0 - hr, tc0 - lh
                g = group or copy_group(arrays[0].dtype, w, c0)
                wins = [k2_stage(a[img], r0, c0, (K4_WINDOW_H, K4_WINDOW_W), g).float()
                        for a in arrays]
                su, sv = k4_window_sweeps(*wins, sweeps, alpha, r0, c0, (h, w),
                                          skip=halo is None,
                                          bf16=arrays[0].dtype == torch.bfloat16)
                r1, c1 = min(tr0 + th, h), min(tc0 + tw, w)
                out_u[img, tr0:r1, tc0:c1] = su[hr:hr + r1 - tr0, lh:lh + c1 - tc0]
                out_v[img, tr0:r1, tc0:c1] = sv[hr:hr + r1 - tr0, lh:lh + c1 - tc0]
    return (out_u[0], out_v[0]) if single else (out_u, out_v)


def k4_sweeps_schedule_plain(u, v, ex, ey, et, wd, ws, n: int, s: int, alpha: float,
                             **kw):
    """n frozen-weight sweeps as K4's ceil(n/s) sweep launches, the last
    running the remainder, each through `k4_launch_schedule_plain`
    (keywords passed on)."""
    while n > 0:
        k = min(s, n)
        u, v = k4_launch_schedule_plain(u, v, ex, ey, et, wd, ws, k, alpha, **kw)
        n -= k
    return u, v


def k4_geometry(device, sweeps: int = 8, dtype=torch.float32) -> dict:
    """The K4 sweep kernel's geometry (of its `dtype` build: float32 or
    bfloat16) on a CUDA device at `sweeps`, as the built kernel reports it:
    sweeps, tile, left halo, window rows, rows a thread, threads, shared
    bytes, registers a thread and spilled bytes (cudaFuncGetAttributes),
    resident blocks a multiprocessor and multiprocessors."""
    return dict(_geometry(torch.device(device).index or 0, sweeps,
                          _build.bf16_suffix(dtype)))


@functools.lru_cache(maxsize=64)
def _geometry(index: int, sweeps: int, bf16: str = "") -> tuple:
    out = (ctypes.c_int * 12)()
    err = getattr(_build.library(), "hs_robust_geometry" + bf16)(
        sweeps, index, ctypes.cast(out, ctypes.POINTER(ctypes.c_int)))
    _build.check(err, "hs_robust_geometry" + bf16)
    keys = ("sweeps", "tile_h", "tile_w", "left_halo", "window_h", "thread_rows",
            "threads", "smem_bytes", "registers", "spill_bytes", "blocks_per_sm", "sms")
    return tuple(zip(keys, list(out)))


def rcp_check(device) -> dict:
    """The sweep kernel's reciprocal of det (`rcp_fast` in csrc/robust.cu:
    the IEEE division's fast path without its branch) held against the
    division over every float it takes, on a CUDA device: the mismatches
    with `1.0f / x`, with 1/x in double rounded to float, and the count of
    floats checked (2 x 252 x 2^23)."""
    device = torch.device(device)
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    err = _build.library().hs_robust_rcp_check(counts.data_ptr(), device.index or 0,
                                               _stream(counts))
    _build.check(err, "hs_robust_rcp_check")
    bad_div, bad_double, checked = (int(c) for c in counts.cpu())
    return {"mismatch_div": bad_div, "mismatch_double": bad_double, "checked": checked}


def device_blocks(device) -> int:
    """K4 sweep blocks resident at once on a CUDA device: its persistent
    grid."""
    geo = k4_geometry(device)
    return geo["blocks_per_sm"] * geo["sms"]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def freeze_weights(u, v, ex, ey, et, eps_d: float, eps_s: float):
    """(wd, ws) from the current flow: one K4 freeze launch on CUDA
    tensors, `robust.charbonnier_weights` on CPU tensors. float32 or
    bfloat16 (the freeze's bfloat16 build: float32 arithmetic, wd and ws
    rounded where they are stored)."""
    check_frames("freeze_weights", u, v, ex, ey, et, dtypes=BF16_DTYPES)
    if u.device.type == "cpu":
        return plain.charbonnier_weights(u, v, ex, ey, et, eps_d, eps_s)
    b, h, w = batch_dims("hs_robust_freeze", u)
    wd, ws = torch.empty_like(u), torch.empty_like(u)
    if u.numel() == 0:
        return wd, ws
    eps_d, eps_s = float(eps_d), float(eps_s)
    # eps^2 rounds to float32 from its double, as `eps * eps` added to a
    # float32 tensor does in the plain version.
    bf16 = _build.bf16_suffix(u.dtype)
    err = getattr(_build.library(), "hs_robust_freeze" + bf16)(
        u.data_ptr(), v.data_ptr(), ex.data_ptr(), ey.data_ptr(),
        et.data_ptr(), wd.data_ptr(), ws.data_ptr(), b, h, w,
        eps_d, eps_d * eps_d, eps_s, eps_s * eps_s, u.device.index, _stream(u),
    )
    _build.check(err, "hs_robust_freeze" + bf16)
    freeze_weights.launches += 1
    return wd, ws


def launch_sweeps(u, v, ex, ey, et, wd, ws, uo, vo, sweeps: int, alpha: float) -> None:
    """One K4 sweep launch: `sweeps` frozen-weight sweeps from (u, v) into
    (uo, vo), on the current stream, over a frame or a whole stack. All
    nine tensors are CUDA tensors of one shape and one dtype, float32 or
    bfloat16 (checked by the caller); uo/vo must not alias u/v."""
    b, h, w = batch_dims("hs_robust_sweeps", u)
    if u.numel() == 0:
        return
    alpha = float(alpha)
    # alpha^2 rounds to float32 from its double, as `alpha * alpha` times a
    # float32 tensor does in the plain version.
    bf16 = _build.bf16_suffix(u.dtype)
    err = getattr(_build.library(), "hs_robust_sweeps" + bf16)(
        u.data_ptr(), v.data_ptr(), ex.data_ptr(), ey.data_ptr(),
        et.data_ptr(), wd.data_ptr(), ws.data_ptr(), uo.data_ptr(),
        vo.data_ptr(), b, h, w, sweeps, alpha * alpha, u.device.index, _stream(u),
    )
    _build.check(err, "hs_robust_sweeps" + bf16)
    frozen_sweeps.launches += 1


def frozen_sweeps(u, v, ex, ey, et, wd, ws, alpha: float, n: int,
                  block_sweeps: int = 0, owned: bool = False):
    """n frozen-weight sweeps: on CUDA tensors ceil(n/s) K4 sweep launches,
    s from `sweeps_per_launch` for this frame or stack on this device
    (`jacobi.ping_pong`; owned=True lets the chain overwrite (u, v)),
    `robust.robust_step` n times on CPU tensors. float32 or bfloat16 (the
    sweeps' bfloat16 build: the coefficients formed in float32 from the
    widened fields and weights, u and v rounded at each sweep's end, the
    float32 plan's launches)."""
    check_frames("frozen_sweeps", u, v, ex, ey, et, wd, ws, dtypes=BF16_DTYPES)
    _check_block_sweeps(block_sweeps)
    if u.device.type == "cpu":
        for _ in range(n):
            u, v = plain.robust_step(u, v, ex, ey, et, wd, ws, alpha)
        return u, v
    s = sweeps_per_launch(block_sweeps, u.shape, n, device_blocks(u.device))

    def launch(su, sv, du, dv, k):
        launch_sweeps(su, sv, ex, ey, et, wd, ws, du, dv, k, alpha)
    return ping_pong(u, v, n, s, launch, owned)


# Every K4 freeze and sweep launch, single frame or batched, counts here.
freeze_weights.launches = 0
frozen_sweeps.launches = 0


def robust_sweeps(u, v, ex, ey, et, n: int, cfg, owned: bool = False):
    """n IRLS sweeps on (H, W) tensors or a (B, H, W) stack, refrozen as
    `robust.robust_sweeps`: on CUDA tensors, per refreeze block of m
    sweeps, one freeze launch and ceil(m/s) sweep launches, s the block's
    plan (`sweeps_per_launch`); the plain version on CPU tensors. The inputs are not modified unless owned.
    Differentiable with respect to all five tensors (`autodiff`: the VJP of
    `robust.robust_sweeps`; the freeze and sweep launches run with grad
    off, never owning the caller's tensors)."""
    if autodiff.needs_grad(u, v, ex, ey, et):
        return autodiff.KernelEntry.apply(
            lambda *t: robust_sweeps(*t, n, cfg),
            lambda *t: plain.robust_sweeps(*t, n, cfg), u, v, ex, ey, et)
    check_frames("robust_sweeps", u, v, ex, ey, et, dtypes=BF16_DTYPES)
    if u.device.type == "cpu":
        return plain.robust_sweeps(u, v, ex, ey, et, n, cfg)
    for m in plain.refreeze_blocks(n, cfg.robust_update_every):
        wd, ws = freeze_weights(u, v, ex, ey, et, cfg.robust_eps_d,
                                cfg.robust_eps_s)
        u, v = frozen_sweeps(u, v, ex, ey, et, wd, ws, cfg.alpha, m,
                             cfg.block_sweeps, owned)
        owned = True  # from here on (u, v) are the chain's own buffers
    return u, v


def hs_solve_robust_resident_plain(i1, i2, cfg, u0=None, v0=None):
    """Plain version of the whole IRLS solve: derivatives, then
    `robust.robust_sweeps` for cfg.iters sweeps from zeros or (u0, v0)."""
    ex, ey, et, _ = derivatives_plain(i1, i2, cfg.alpha, cfg.deriv_variant)
    if u0 is None:
        u0, v0 = torch.zeros_like(i1), torch.zeros_like(i1)
    return plain.robust_sweeps(u0, v0, ex, ey, et, cfg.iters, cfg)


def hs_solve_robust_resident(i1, i2, cfg, u0=None, v0=None):
    """Whole IRLS solve (derivatives, every refreeze, cfg.iters sweeps) of
    an (H, W) pair or a (B, H, W) stack, from zeros or from (u0, v0): K1
    and the K4 chain on CUDA tensors (float32 or their bfloat16 builds),
    the plain version on CPU tensors. Returns (u, v). Differentiable with respect to the frames and the start
    (`autodiff`: the VJP of `hs_solve_robust_resident_plain`, as the
    reference's `_solve_ad`)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    if autodiff.needs_grad(i1, i2, u0, v0):
        return autodiff.KernelEntry.apply(
            lambda a, b, c, d: hs_solve_robust_resident(a, b, cfg, c, d),
            lambda a, b, c, d: hs_solve_robust_resident_plain(a, b, cfg, c, d),
            i1, i2, u0, v0)
    check_frames("hs_solve_robust_resident", i1, i2,
                 *(() if u0 is None else (u0, v0)), dtypes=BF16_DTYPES)
    if i1.device.type == "cpu":
        return hs_solve_robust_resident_plain(i1, i2, cfg, u0, v0)
    if cfg.iters == 0:
        if u0 is None:
            return torch.zeros_like(i1), torch.zeros_like(i1)
        return u0, v0
    ex, ey, et, _ = hs_derivatives(i1, i2, cfg.alpha, cfg.deriv_variant)
    owned = u0 is None
    if owned:
        u0, v0 = torch.zeros_like(i1), torch.zeros_like(i1)
    return robust_sweeps(u0, v0, ex, ey, et, cfg.iters, cfg, owned=owned)
