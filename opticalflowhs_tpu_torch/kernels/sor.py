"""K3: temporally blocked 4-color SOR sweeps.

Port of the SOR sweep kernels of opticalflowhs_tpu/kernels/sor.py (the
whole-image `_sor_vmem_kernel` and the banded `_sor_banded_kernel`, behind
`sor_sweeps`) and of the sweep stage of the resident 4-color whole solve
(`hs_solve_resident_sor`). The CUDA source is csrc/sor.cu: one launch runs
s sweeps for one frame or a whole (B, H, W) stack, with one persistent
block a multiprocessor walking 48 x 128 windows (the tile and a halo of 2s
rows and 4s columns): u, v and the fields in registers, two block barriers
a sweep (the even rows' two color stages, then the odd rows'), the
boundary rows exchanged through shared memory, and the next window staged
while the current one is swept. s comes from `sweeps_per_launch`, a cost
rule over launches and rounds of tiles. `k3_launch_schedule_plain` walks
that schedule in plain torch.

`sor_sweeps` takes either rank. It launches the kernel for CUDA tensors and
runs the plain version for CPU tensors. There is no fallback: a CUDA tensor
goes through the kernel or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from opticalflowhs_tpu_torch.kernels import _build, autodiff
from opticalflowhs_tpu_torch.kernels.derivatives import BF16_DTYPES, batch_dims, check_frames
from opticalflowhs_tpu_torch.kernels.jacobi import copy_group, k2_stage, ping_pong
from opticalflowhs_tpu_torch.ops import stencils

# K3's geometry (csrc/sor.cu). A block of K3_THREADS threads sweeps a
# K3_WINDOW_H x K3_WINDOW_W window: warp j owns rows 4j..4j+3
# (K3_THREAD_ROWS, two of each row parity), lane l the K3_LANE_COLS columns
# 4l..4l+3, and u, v and the fields of those 16 pixels stay in registers.
# Shared memory holds two u/v pairs of the window (one swept, one staged
# for the next tile by cp.async) and the four fields' staged copies:
# K3_SMEM_BYTES; one block a multiprocessor, and the grid is persistent.
# The tile is the window less 2s rows above and below and 4s columns on each
# side (`k3_tile`): 32 x 96 at s = 4, 4 x 40 at K3_MAX_SWEEPS.
K3_WINDOW_H = 48
K3_WINDOW_W = 128
K3_LANE_COLS = 4
K3_THREAD_ROWS = 4
K3_THREADS = 384
K3_SMEM_BYTES = 8 * 4 * K3_WINDOW_H * K3_WINDOW_W  # 196,608
K3_MAX_SWEEPS = (K3_WINDOW_H - K3_THREAD_ROWS) // 4  # 11
# The cost rule's prices (`sweeps_per_launch`), in sweeps of one round of
# windows (a tile a block): a launch, and a round's staging, field loads and
# owned writes beyond its sweeps. Fitted to launch times at s 1, 2, 4, 6,
# 8 and 10 on 1088x1920, 1088x1900, 8 x 1088x1920, 544x960 and 272x480
# (NVIDIA H100 80GB HBM3, 700 W, tools/torch_whole_solve_timing.py --k3
# --scan): a launch 7.1 us, a round 5.6 us and 0.51 us a sweep.
K3_LAUNCH_COST = 14
K3_STAGE_COST = 11
# Resident K3 blocks on an H100 (132 multiprocessors, one block each): the
# cost rule's default where no device is asked.
K3_BLOCKS = 132


def k3_tile(sweeps: int) -> tuple[int, int, int, int]:
    """(tile rows, tile columns, halo rows, halo columns) of one K3 window
    at `sweeps`: the window less 2s rows above and below and 4s columns on
    each side."""
    return K3_WINDOW_H - 4 * sweeps, K3_WINDOW_W - 8 * sweeps, 2 * sweeps, 4 * sweeps


def k3_tiles(shape, sweeps: int) -> int:
    """Tiles of one K3 launch of `sweeps` sweeps over an (H, W) frame or a
    (B, H, W) stack."""
    b, h, w = (1,) * (3 - len(shape)) + tuple(shape)
    th, tw, _, _ = k3_tile(sweeps)
    return b * -(-h // th) * -(-w // tw)


def _check_block_sweeps(block_sweeps: int) -> None:
    if block_sweeps < 0:
        raise ValueError(f"block_sweeps must be >= 0 (0 = auto), got {block_sweeps}")


def sweeps_per_launch(block_sweeps: int, shape, n: int, blocks: int = K3_BLOCKS) -> int:
    """Sweeps a K3 launch runs in a chain of n sweeps over `shape` ((H, W)
    or (B, H, W)) on `blocks` resident blocks: block_sweeps capped at
    K3_MAX_SWEEPS, or for 0 the cost rule's s. It takes the even s up to
    K3_MAX_SWEEPS of least cost, the sum over the chain's launches (the
    last one running the remainder) of K3_LAUNCH_COST + rounds of tiles x
    (the launch's sweeps + K3_STAGE_COST), a round being one tile a block;
    ties go to the larger s, and s is cut to n. Odd s are left out: their
    4s-column halo starts each window row in the middle of a 32-byte
    sector, and they ran 5-15% slower a round than the cost predicts
    (PERF.md)."""
    _check_block_sweeps(block_sweeps)
    if block_sweeps > 0:
        return min(block_sweeps, K3_MAX_SWEEPS)
    if n <= 0:
        return 1
    best, best_cost = 2, None
    for s in range(2, K3_MAX_SWEEPS + 1, 2):
        cost, left = 0, n
        while left > 0:
            k = min(s, left)
            cost += K3_LAUNCH_COST + -(-k3_tiles(shape, k) // blocks) * (k + K3_STAGE_COST)
            left -= k
        if best_cost is None or cost <= best_cost:
            best, best_cost = s, cost
    return min(best, n)


def launches(n: int, s: int) -> int:
    """K3 launches of a chain of n sweeps at s a launch."""
    return -(-n // s)


def sor_sweeps_plain(u, v, ex, ey, et, inv_den, n: int, omega: float):
    """n plain 4-color SOR sweeps (ops/stencils.py sor_step) on (H, W) or
    (B, H, W); the color grids are each image's own. The sweeps run through
    `stencils.checkpointed_loop`, as the reference's twin. bfloat16 arrays
    follow the storage rule (`stencils.store`): the four color stages of a
    sweep in float32, each reading the earlier stages' float32 values, and
    u and v rounded once, at the sweep's end."""
    colors = stencils.color_masks(*u.shape[-2:], device=u.device)
    return stencils.checkpointed_loop(
        lambda uv: stencils.store(stencils.sor_step, *uv, ex, ey, et, inv_den, omega, colors),
        (u, v), n)


def _bf16_round(a):
    """a (float32) rounded to bfloat16 and widened back, exactly."""
    return a.to(torch.bfloat16).float()


def k3_window_sweeps(su, sv, fx, fy, ft, fi, sweeps: int, omega: float, r0: int,
                     c0: int, hw, org=(0, 0), img_hw=None, round_at=None):
    """The `sweeps` sweeps of one staged K3 window at array pixel (r0, c0)
    of an (h, w) = `hw` array, in place, as csrc/sor.cu schedules them:
    sweep k on the rows of each warp (K3_THREAD_ROWS rows) that meets the
    rows [2k - 1, H + 1 - 2k) of the window's H (cut at the array's edges),
    on all columns; in each sweep the global-even rows, then the odd ones,
    each half reading the rows beside its own as they were when the half
    began, and in each row the color stage of the even global columns, then
    of the odd ones, in place. The clamps fire at the array's edges and,
    with `img_hw` (K9: `org` the global pixel of array element (0, 0) in an
    img_hw image), at the true image edges. Whatever lies beside the window
    (the kernel takes the window's own first or last row there, and its
    lanes 0 and 31 their own column sums) is NaN here, so that any value
    read from outside the window shows. The arrays are float32; `round_at`
    "sweep" rounds u and v to bfloat16 at each sweep's end, as the
    kernel's bfloat16 build does (its warps exchange their boundary rows
    in float32 within a sweep), and "half" at the end of each half too, as
    a build that exchanged them in bfloat16 would. Returns (u, v)."""
    h, w = hw
    wh, ww = su.shape
    shard = img_hw is not None
    ih, iw = img_hw if shard else (h, w)
    rows_w, cols_w = torch.arange(wh), torch.arange(ww)
    ar, ac = rows_w + r0, cols_w + c0
    rin, cin = (ar >= 0) & (ar < h), (ac >= 0) & (ac < w)
    gr, gc = ar + org[0], ac + org[1]
    tcl = rin & ((ar == 0) | (shard & (gr == 0)))
    bcl = rin & ((ar == h - 1) | (shard & (gr == ih - 1)))
    lcl = cin & ((ac == 0) | (shard & (gc == 0)))
    rcl = cin & ((ac == w - 1) | (shard & (gc == iw - 1)))
    col_par = gc % 2
    nan_row = torch.full((1, ww), float("nan"), dtype=su.dtype)
    wr_lo, wr_hi = max(0, -r0), min(wh, h - r0)
    for k in range(1, sweeps + 1):
        rlo, rhi = max(2 * k - 1, wr_lo), min(wh + 1 - 2 * k, wr_hi)
        if rlo >= rhi:
            continue
        lo = rlo // K3_THREAD_ROWS * K3_THREAD_ROWS
        hi = min(wh, -(-rhi // K3_THREAD_ROWS) * K3_THREAD_ROWS)
        live = rows_w[lo:hi]
        for parity in (0, 1):
            r = live[gr[live] % 2 == parity]
            tc, bc = tcl[r][:, None], bcl[r][:, None]
            # The rows beside these hold the other parity, which this half
            # does not change (row r of the padded window is row r - 1).
            pads = [torch.cat([nan_row, a, nan_row]) for a in (su, sv)]
            tops, bots = [a[r] for a in pads], [a[r + 2] for a in pads]
            mids = [su[r], sv[r]]
            ex_, ey_, et_, id_ = fx[r], fy[r], ft[r], fi[r]
            for cp in (0, 1):
                # Each stage forms the column sums from the row as it
                # stands (a clamped row is its own neighbour).
                ts = [torch.where(tc, mid, top) + 2.0 * mid + torch.where(bc, mid, bot)
                      for top, mid, bot in zip(tops, mids, bots)]
                bars = []
                for t, mid in zip(ts, mids):
                    nan_col = torch.full_like(t[:, :1], float("nan"))
                    tl = torch.where(lcl, t, torch.cat([nan_col, t[:, :-1]], 1))
                    tr = torch.where(rcl, t, torch.cat([t[:, 1:], nan_col], 1))
                    s = tl + 2.0 * t + tr
                    bars.append(s * (1.0 / 12.0) - mid * (1.0 / 3.0))
                ubar, vbar = bars
                frac = (ex_ * ubar + ey_ * vbar + et_) * id_
                un = ubar - ex_ * frac
                vn = vbar - ey_ * frac
                sel = col_par == cp
                mids = [torch.where(sel, mid + omega * (new - mid), mid)
                        for mid, new in zip(mids, (un, vn))]
            su[r], sv[r] = mids
            if round_at == "half" or (round_at == "sweep" and parity == 1):
                su, sv = _bf16_round(su), _bf16_round(sv)
    return su, sv


def k3_launch_schedule_plain(u, v, ex, ey, et, inv_den, sweeps: int, omega: float,
                             origins=None, img_hw=None, halo=None, group=None,
                             round_at="sweep"):
    """One K3 launch of `sweeps` sweeps as csrc/sor.cu schedules it, in
    plain torch, on (H, W) or (B, H, W): each image cut into `k3_tile`
    tiles; each tile's window staged with what lies outside the array set
    to NaN and swept as the kernel sweeps it (`k3_window_sweeps`; with
    `origins`, K9's per-image (row, col) of the global pixel at element
    (0, 0), in an `img_hw` image). Only the owned tile of the last sweep is
    written, into arrays that are NaN elsewhere. `halo` = (rows, columns)
    replaces the halo of 2s rows and 4s columns (the tile is the window
    less it on each side), to show what a smaller one does.

    bfloat16 arrays are staged as the kernel's bfloat16 build stages them
    (`jacobi.copy_group`: 16-byte copies of 8 columns where the width and
    the window's first column allow, else 4 or 1) and widened; the sweeps
    run in float32 with u and v rounded at each sweep's end (`round_at`,
    see `k3_window_sweeps`), and the owned tile is stored in bfloat16.
    `group` forces the staging's column groups, to show what copies wider
    than the alignment allows do. Returns (u, v)."""
    single = u.ndim == 2
    arrays = [a[None] if single else a for a in (u, v, ex, ey, et, inv_den)]
    b, h, w = arrays[0].shape
    _, _, hr, hc = k3_tile(sweeps)
    if halo is not None:
        hr, hc = halo
    th, tw = K3_WINDOW_H - 2 * hr, K3_WINDOW_W - 2 * hc
    if th < 1 or tw < 1:
        raise ValueError(f"no K3 tile of {sweeps} sweeps in a {K3_WINDOW_H} x "
                         f"{K3_WINDOW_W} window")
    shard = origins is not None
    bf16 = arrays[0].dtype == torch.bfloat16
    out_u = torch.full_like(arrays[0], float("nan"))
    out_v = torch.full_like(arrays[0], float("nan"))
    for img in range(b):
        org = (int(origins[img][0]), int(origins[img][1])) if shard else (0, 0)
        for tr0 in range(0, h, th):
            for tc0 in range(0, w, tw):
                r0, c0 = tr0 - hr, tc0 - hc
                g = group or copy_group(arrays[0].dtype, w, c0)
                wins = [k2_stage(a[img], r0, c0, (K3_WINDOW_H, K3_WINDOW_W), g).float()
                        for a in arrays]
                su, sv = k3_window_sweeps(*wins, sweeps, omega, r0, c0, (h, w), org,
                                          img_hw if shard else None,
                                          round_at if bf16 else None)
                r1, c1 = min(tr0 + th, h), min(tc0 + tw, w)
                out_u[img, tr0:r1, tc0:c1] = su[hr:hr + r1 - tr0, hc:hc + c1 - tc0]
                out_v[img, tr0:r1, tc0:c1] = sv[hr:hr + r1 - tr0, hc:hc + c1 - tc0]
    return (out_u[0], out_v[0]) if single else (out_u, out_v)


def k3_sweeps_schedule_plain(u, v, ex, ey, et, inv_den, n: int, s: int, omega: float,
                             **kw):
    """n sweeps as K3's ceil(n/s) launches, the last running the remainder,
    each through `k3_launch_schedule_plain` (keywords passed on)."""
    while n > 0:
        k = min(s, n)
        u, v = k3_launch_schedule_plain(u, v, ex, ey, et, inv_den, k, omega, **kw)
        n -= k
    return u, v


def k3_geometry(device, sweeps: int = 4, shard: bool = False,
                dtype=torch.float32) -> dict:
    """K3's (with shard=True K9 SOR's; with dtype=torch.bfloat16 the
    bfloat16 build's) geometry on a CUDA device at `sweeps`, as the built
    kernel reports it: sweeps, tile, threads, shared bytes, registers a
    thread and spilled bytes (cudaFuncGetAttributes), resident blocks a
    multiprocessor and multiprocessors."""
    return dict(_geometry(torch.device(device).index or 0, sweeps, bool(shard),
                          _build.bf16_suffix(dtype)))


@functools.lru_cache(maxsize=64)
def _geometry(index: int, sweeps: int, shard: bool, bf16: str = "") -> tuple:
    out = (ctypes.c_int * 9)()
    ptr = ctypes.cast(out, ctypes.POINTER(ctypes.c_int))
    err = getattr(_build.library(), "hs_sor_geometry" + bf16)(sweeps, int(shard), index, ptr)
    _build.check(err, "hs_sor_geometry" + bf16)
    keys = ("sweeps", "tile_h", "tile_w", "threads", "smem_bytes", "registers",
            "spill_bytes", "blocks_per_sm", "sms")
    return tuple(zip(keys, list(out)))


def device_blocks(device) -> int:
    """K3 blocks resident at once on a CUDA device: its persistent grid."""
    geo = k3_geometry(device)
    return geo["blocks_per_sm"] * geo["sms"]


def launch_sweeps(u, v, ex, ey, et, inv_den, uo, vo, sweeps: int,
                  omega: float) -> None:
    """One K3 launch: `sweeps` sweeps from (u, v) into (uo, vo), on the
    current stream, over a frame or a whole stack. All eight tensors are
    CUDA tensors of one shape and one dtype, float32 or bfloat16 (checked by
    the caller); uo/vo must not alias u/v."""
    b, h, w = batch_dims("hs_sor_sweeps", u)
    if u.numel() == 0:
        return
    err = getattr(_build.library(), "hs_sor_sweeps" + _build.bf16_suffix(u.dtype))(
        u.data_ptr(), v.data_ptr(), ex.data_ptr(), ey.data_ptr(),
        et.data_ptr(), inv_den.data_ptr(), uo.data_ptr(), vo.data_ptr(),
        b, h, w, sweeps, float(omega),
        u.device.index, torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(err, "hs_sor_sweeps")
    sor_sweeps.launches += 1


def sor_sweeps(u, v, ex, ey, et, inv_den, n: int, omega: float,
               block_sweeps: int = 0):
    """n 4-color SOR sweeps on (H, W) tensors or a (B, H, W) stack: on CUDA
    tensors ceil(n/s) K3 launches (one chain for the whole stack, two u/v
    pairs ping-ponging, no host synchronisation; s from `sweeps_per_launch`),
    `sor_sweeps_plain` on CPU tensors. Returns (u, v); the inputs are not
    modified. float32 or bfloat16 (the kernel's bfloat16 build: float32
    arithmetic, u and v rounded at each sweep's end, the float32 plan's
    launches). Differentiable with respect to all six tensors (`autodiff`:
    the VJP of `sor_sweeps_plain`, as the reference's `_sor_sweeps_ad`)."""
    if autodiff.needs_grad(u, v, ex, ey, et, inv_den):
        return autodiff.KernelEntry.apply(
            lambda *t: sor_sweeps(*t, n, omega, block_sweeps),
            lambda *t: sor_sweeps_plain(*t, n, omega), u, v, ex, ey, et, inv_den)
    check_frames("sor_sweeps", u, v, ex, ey, et, inv_den, dtypes=BF16_DTYPES)
    _check_block_sweeps(block_sweeps)
    if n == 0:
        return u, v
    if u.device.type == "cpu":
        return sor_sweeps_plain(u, v, ex, ey, et, inv_den, n, omega)
    return sor_chain(u, v, ex, ey, et, inv_den, n, omega, block_sweeps)


def sor_chain(u, v, ex, ey, et, inv_den, n: int, omega: float,
              block_sweeps: int = 0, owned: bool = False):
    """n SOR sweeps as ceil(n/s) K3 launches (`jacobi.ping_pong`), s from
    `sweeps_per_launch` for this frame or stack on this device."""
    s = sweeps_per_launch(block_sweeps, u.shape, n, device_blocks(u.device))

    def launch(su, sv, du, dv, k):
        launch_sweeps(su, sv, ex, ey, et, inv_den, du, dv, k, omega)
    return ping_pong(u, v, n, s, launch, owned)


# Every K3 launch, single frame or batched, counts here.
sor_sweeps.launches = 0
