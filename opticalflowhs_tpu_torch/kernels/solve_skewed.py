"""K7: the whole Jacobi solve with u and v updated in place, K1 and then
ONE persistent cooperative launch of all n sweeps, for a frame or, one
after another, the frames of a (B, H, W) stack.

Port of opticalflowhs_tpu/kernels/solve_skewed.py: `hs_solve_skewed`
(`_skewed_kernel`, zero or warm start) and `hs_solve_skewed_batched`
(`_skewed_kernel_b`, zero start only, as the reference). The CUDA source is
csrc/solve_skewed.cu: K2's window loop (csrc/k2_window.cuh) on bands of K2
tiles. There is no second u/v pair: the working memory is the two output
arrays plus two sigma x W pencils for each of u and v, and time skewing
over row bands keeps the in-place update in Jacobi order (band i reads the
old rows above it from the pencil band i-1 saved). Each block owns up to m
(1-3) tiles of a band; `geometry` picks m and the band by a cost rule, and
`skewed_schedule_plain` walks the schedule, the staging of each band
behind the one before included, in plain PyTorch, so the CPU tests can
show that the order is right.

Unlike the TPU kernel, which returns None outside its class, these entry
points run every float32 size whose band of tiles fits the grid;
`applicable` is the reference's class test, by which `solver.solve_level`
routes. CPU tensors take the plain version; a CUDA tensor goes through the
kernels or the call raises (no fallback).
"""

from __future__ import annotations

import functools

import torch

from opticalflowhs_tpu_torch.kernels import _build, autodiff
from opticalflowhs_tpu_torch.kernels.derivatives import (
    batch_dims,
    check_frames,
    derivatives_plain,
    hs_derivatives,
)
from opticalflowhs_tpu_torch.kernels.jacobi import (
    AUTO_SWEEPS,
    K2_LANE_COLS,
    K2_WARP_ROWS,
    K2_WINDOW_H,
    K2_WINDOW_W,
    k2_owned,
    k2_stage,
    k2_tile,
    k2_window_sweeps,
    sweeps_per_launch,
)
from opticalflowhs_tpu_torch.kernels.solve_fused import (
    MAX_S,
    _ptr,
    barrier_count,
    build_geometry,
    resident_blocks,
)
from opticalflowhs_tpu_torch.kernels.solve_resident import (
    _LANE,
    _SUBLANE,
    _resident_geometry,
    hs_solve_resident_plain,
    round_up,
)

# The reference's skewed class (opticalflowhs_tpu/kernels/solve_skewed.py
# `pick_geometry` :86 and `applicable` :459, float32): frames of at least
# _MIN_PX pixels past the resident class whose two u/v arrays, window set
# and pencils fit a 118 MiB TPU VMEM budget (about 2.6-11 Mpx, so 4K and
# not 8K). The constants are the reference's routing rule, not properties
# of the H100.
_MIN_PX = 6_000_000
_ARRAYS_WIN = 18
_LIMIT = 118 * 1024 * 1024
_ROW_SWEEP_PS = 17
_STEP_PS = 20_000_000

# K7's blocks own up to MAX_TILES K2 tiles a band (four u/v pairs of the
# window in shared memory: the band's windows, the sweeps' second buffer,
# and the next band's windows in what is free). The cost rule counts a
# band step as its m_i tile times (the most tiles a block has in band i)
# and one grid barrier with the exposed staging around it (_STEP_COST tile
# times: about 2-4 us against a tile's 11-14 us on an H100, PERF.md); a
# sweep block of fewer than 3 bands pays one barrier more, before the next
# block's first band is staged.
MAX_TILES = 3
_STEP_COST = 0.25


def _reference_geometry(h: int, w: int, n: int, s_cap: int):
    """The reference's `pick_geometry` for float32: (s, rem, sigma, band,
    hp) of the cheapest modelled schedule, or None."""
    wp = round_up(w, _LANE)
    cap = max(1, min(s_cap, MAX_S, n))
    best = None
    for s in range(4, cap + 1):
        n_full, rem = divmod(n, s)
        if n_full == 0:
            continue
        sigma = round_up(s, _SUBLANE)
        h_units = -(-h // sigma)
        geom = None
        for nb in range(1, h_units + 1):
            band = -(-h_units // nb) * sigma
            hp = band * nb
            win = band + 2 * sigma
            need = (2 * (hp + sigma) * wp + _ARRAYS_WIN * win * wp
                    + 2 * sigma * wp) * 4
            if need <= _LIMIT:
                geom = (nb, band, hp, win)
                break
        if geom is None:
            continue
        nb, band, hp, win = geom
        steps = (n_full + (1 if rem else 0)) * nb
        row_sweeps = (n_full * s + rem) * nb * win
        cost = row_sweeps * wp * _ROW_SWEEP_PS + steps * _STEP_PS
        if best is None or cost < best[0]:
            best = (cost, (s, rem, sigma, band, hp))
    return None if best is None else best[1]


def applicable(h: int, w: int, n: int):
    """The reference's `solve_skewed.applicable(i1, n)` for a float32
    (h, w) frame: its geometry when its skewed kernel takes the solve, else
    None (n < 2, below _MIN_PX, the resident class, or too large for
    2-array residency)."""
    if n < 2 or h * w < _MIN_PX or _resident_geometry(h, w) is not None:
        return None
    return _reference_geometry(h, w, n, MAX_S)


@functools.cache
def geometry(h: int, w: int, s: int, blocks: int, band: int = 0,
             window=(K2_WINDOW_H, K2_WINDOW_W), lane_cols: int = K2_LANE_COLS):
    """K7's plan for an (h, w) frame at s sweeps a block on a grid of
    `blocks`: (tile_h, tile_w, m, band rows, bands). The tile is K2's at s;
    a band is band_ty = band rows / tile_h whole rows of tiles, and each
    block takes up to m tiles of it, so band_ty * tiles across <= m * blocks.
    band = 0 picks band_ty by the cost rule, the sum over the bands of
    (m_i + _STEP_COST), m_i the most tiles a block has in band i (+
    _STEP_COST for fewer than 3 bands), a tie going to fewer bands; band >
    0 forces the band, rounded up to whole tile rows. Raises ValueError when a row of tiles across the
    frame, or the forced band's tiles, outnumber MAX_TILES * blocks."""
    th, tw, _ = k2_tile(s, window, lane_cols)
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    if tiles_x > MAX_TILES * blocks:
        raise ValueError(
            f"hs_solve_skewed: a {w} px wide frame needs more tiles a band "
            f"than {MAX_TILES} a block on {blocks} blocks")

    def plan(band_ty):
        ms = [-(-min(band_ty, tiles_y - ty0) * tiles_x // blocks)
              for ty0 in range(0, tiles_y, band_ty)]
        cost = sum(ms) + _STEP_COST * (len(ms) + (len(ms) < 3))
        return cost, (th, tw, max(ms), band_ty * th, len(ms))

    if band > 0:
        got = plan(min(-(-band // th), tiles_y))[1]
        if got[2] > MAX_TILES:
            raise ValueError(f"hs_solve_skewed: a band of {band} rows has more "
                             f"tiles than {MAX_TILES} a block on {blocks} "
                             "resident blocks")
        return got
    best = plan(1)
    for band_ty in range(2, min(tiles_y, MAX_TILES * blocks // tiles_x) + 1):
        got = plan(band_ty)
        if got[0] <= best[0]:  # a tie goes to fewer bands
            best = got
    return best[1]


def k7_geometry(device, h: int, w: int, sweeps: int = AUTO_SWEEPS,
                band: int = 0, blocks: int = 0) -> dict:
    """K7's plan for an (h, w) frame on a CUDA device (`geometry` on the
    resident grid, or `blocks`) and its build at `sweeps`: tile, m, band
    rows, bands, threads, shared bytes, registers a thread, spilled bytes,
    resident blocks a multiprocessor, multiprocessors."""
    dev = torch.device(device).index or 0
    grid = blocks if blocks > 0 else resident_blocks("hs_solve_skewed_blocks", dev)
    out = build_geometry("hs_solve_skewed_geometry", device, sweeps)
    _, _, out["m"], out["band"], out["bands"] = geometry(h, w, sweeps, grid, band)
    out["grid"] = grid
    return out


def hs_solve_skewed_plain(i1, i2, alpha: float, n: int,
                          variant: str = "hs_cube", u0=None, v0=None):
    """Plain version of the whole solve: `hs_solve_resident_plain`."""
    return hs_solve_resident_plain(i1, i2, alpha, n, variant, u0, v0)


def _k7_steps(b: int, h: int, w: int, n: int, s: int, band_ty: int, window,
              lane_cols: int) -> list[dict]:
    """K7's band steps in launch order (csrc/solve_skewed.cu `step_at`):
    image, sweep block, band, the block's sweeps, K2's tile at them, the
    band's first tile row, tiles, rows and the block's bands."""
    steps = []
    for img in range(b):
        for k in range(-(-n // s)):
            ns = min(s, n - k * s)
            th, tw, lh = k2_tile(ns, window, lane_cols)
            tiles_x, tiles_y = -(-w // tw), -(-h // th)
            n_bands = -(-tiles_y // band_ty)
            for i in range(n_bands):
                ty0 = i * band_ty
                nty = min(band_ty, tiles_y - ty0)
                steps.append(dict(img=img, k=k, i=i, ns=ns, th=th, tw=tw, lh=lh,
                                  tiles_x=tiles_x, ty0=ty0, tiles=nty * tiles_x,
                                  r0=ty0 * th, r_end=min(h, (ty0 + nty) * th)))
    return steps


def skewed_schedule_plain(i1, i2, alpha: float, n: int,
                          variant: str = "hs_cube", u0=None, v0=None,
                          s: int = AUTO_SWEEPS, band: int = 0, blocks: int = 132,
                          window=(K2_WINDOW_H, K2_WINDOW_W),
                          lane_cols: int = K2_LANE_COLS,
                          warp_rows: int = K2_WARP_ROWS,
                          early_block_staging: bool = False):
    """K7's schedule in plain PyTorch, on (H, W) or (B, H, W), as
    csrc/solve_skewed.cu runs it on a grid of `blocks` (`geometry`: K2
    tiles, m tiles a block, bands of whole tile rows): u/v (NaN at first:
    the kernel's empty outputs) updated in place, two pencils (NaN at
    first). A band step: every window of the band staged (rows above the
    band from pencil i % 2, the rest from u/v, or at block 0 from (u0, v0)
    or zeros; NaN outside the array, `jacobi.k2_stage`); the band's last
    sigma rows saved, old, from the windows into pencil (i + 1) % 2; then
    the next step's windows staged while this band is in flight, read from
    a u/v whose band rows are NaN (the kernel may read them before or
    after its writes: NaN shows that it does not), except band 0 of the
    next sweep block when its windows reach this band (fewer than 3
    bands), staged after the writes; then each window swept as K2 sweeps
    it (`jacobi.k2_window_sweeps`) and its owned tile written in place.
    `early_block_staging` stages that band 0 early as well (it then reads
    NaN: the rule is needed). Equals the plain whole solve bitwise (the
    tests hold it to that)."""
    fields = derivatives_plain(i1, i2, alpha, variant)
    single = i1.ndim == 2
    fields = [f[None] if single else f for f in fields]
    b, h, w = fields[0].shape
    th, tw, _ = k2_tile(s, window, lane_cols)
    if th < 1 or tw < lane_cols:
        raise ValueError(f"no K2 tile of {s} sweeps in a {window[0]} x {window[1]} window")
    if band < 0:
        raise ValueError(f"band ({band}) must be >= 0")
    band_rows = geometry(h, w, s, blocks, band, window, lane_cols)[3]
    band_ty = band_rows // th
    nan = float("nan")
    u = torch.full((b, h, w), nan)
    v = torch.full((b, h, w), nan)
    start = [torch.zeros(b, h, w) if u0 is None else (u0[None] if single else u0),
             torch.zeros(b, h, w) if v0 is None else (v0[None] if single else v0)]
    pencil = [torch.full((2, s, w), nan), torch.full((2, s, w), nan)]
    steps = _k7_steps(b, h, w, n, s, band_ty, window, lane_cols)

    def stage(st, src):
        """The windows of a step's tiles: (r0, c0, u window, v window)."""
        wins = []
        for t in range(st["tiles"]):
            ty, tx = divmod(t, st["tiles_x"])
            r0 = (st["ty0"] + ty) * st["th"] - st["ns"]
            c0 = tx * st["tw"] - st["lh"]
            pair = []
            for a, p in zip(src if st["k"] > 0 else start, pencil):
                win = k2_stage(a[st["img"]], r0, c0, window)
                top = st["r0"] - st["ns"]  # the pencil's first row
                for wr in range(window[0]):
                    if 0 <= r0 + wr < st["r0"]:
                        win[wr] = k2_stage(p[st["i"] % 2], r0 + wr - top, c0, (1, window[1]))[0]
                pair.append(win)
            wins.append((r0, c0, *pair))
        return wins

    def save_pencil(st, wins):
        if st["r_end"] >= h:
            return
        top = st["r_end"] - st["ns"]
        for r0, c0, *pair in wins:
            own = k2_owned(r0, c0, st["ns"], (h, w), window, lane_cols)
            if own is None:
                continue
            rows, cols, wrows, wcols = own
            lo, hi = max(rows.start, top), min(rows.stop, st["r_end"])
            if lo >= hi:
                continue  # a tile row above the pencil's rows
            for p, win in zip(pencil, pair):
                p[(st["i"] + 1) % 2, lo - top:hi - top, cols] = (
                    win[lo - r0:hi - r0, wcols])

    staged = stage(steps[0], (u, v))
    for q, st in enumerate(steps):
        save_pencil(st, staged)
        # -- grid barrier: every window of the band is staged --
        nx = steps[q + 1] if q + 1 < len(steps) else None
        early = nx is not None and (
            nx["i"] > 0 or nx["img"] != st["img"] or early_block_staging
            or min(h, nx["r_end"] + nx["ns"]) <= st["r0"])
        if early:
            flight = [a.clone() for a in (u, v)]
            for a in flight:
                a[st["img"], st["r0"]:st["r_end"]] = nan
            next_staged = stage(nx, flight)
        img = st["img"]
        for r0, c0, su, sv in staged:
            fw = [k2_stage(f[img], r0, c0, window) for f in fields]
            su, sv = k2_window_sweeps(su, sv, *fw, st["ns"], r0, c0, (h, w),
                                      lane_cols=lane_cols, warp_rows=warp_rows)
            own = k2_owned(r0, c0, st["ns"], (h, w), window, lane_cols)
            if own is not None:
                rows, cols, wrows, wcols = own
                u[img, rows, cols] = su[wrows, wcols]
                v[img, rows, cols] = sv[wrows, wcols]
        if nx is not None and not early:
            # -- grid barrier: the sweep block's writes are complete --
            next_staged = stage(nx, (u, v))
        if nx is not None:
            staged = next_staged
    return (u[0], v[0]) if single else (u, v)


def launch_skewed(u0, v0, ex, ey, et, invd, n: int, s: int, band: int = 0,
                  blocks: int = 0):
    """One K7 launch: n >= 1 sweeps in place from (u0, v0), or from zeros
    when u0 is None, on the fields of a frame or stack (its frames one
    after another), s sweeps a block. `band` > 0 forces the band rows
    (rounded up to whole rows of K2 tiles), `blocks` > 0 the grid (a grid
    larger than can be resident raises). Returns (u, v)."""
    b, h, w = batch_dims("hs_solve_skewed_sweeps", ex)
    dev = ex.device.index
    grid = blocks if blocks > 0 else resident_blocks("hs_solve_skewed_blocks", dev)
    th, _, m, band_rows, _ = geometry(h, w, s, grid, band)
    u, v = torch.empty_like(ex), torch.empty_like(ex)
    pu, pv = (torch.empty(2 * s * w, dtype=ex.dtype, device=ex.device)
              for _ in range(2))
    stream = torch.cuda.current_stream(ex.device).cuda_stream
    err = _build.library().hs_solve_skewed_sweeps(
        _ptr(u0), _ptr(v0), ex.data_ptr(), ey.data_ptr(), et.data_ptr(),
        invd.data_ptr(), u.data_ptr(), v.data_ptr(), pu.data_ptr(),
        pv.data_ptr(), barrier_count(dev, stream).data_ptr(), b, h, w, n, s,
        m, band_rows // th, grid, dev, stream,
    )
    _build.check(err, "hs_solve_skewed_sweeps")
    hs_solve_skewed.launches += 1
    return u, v


def hs_solve_skewed(i1, i2, alpha: float, n: int, variant: str = "hs_cube",
                    u0=None, v0=None, block_sweeps: int = 0, band: int = 0,
                    blocks: int = 0):
    """Whole HS solve of an (H, W) pair or a (B, H, W) stack, from zero or
    from (u0, v0), with no second u/v pair: on CUDA tensors K1, then one K7
    launch of all n sweeps (s = `jacobi.sweeps_per_launch(block_sweeps)`
    a block; `band` and `blocks` > 0 force the geometry); the plain version
    on CPU tensors. Returns (u, v). Differentiable with respect to the
    frames and the start (`autodiff`: the VJP of `hs_solve_skewed_plain`)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    if autodiff.needs_grad(i1, i2, u0, v0):
        return autodiff.KernelEntry.apply(
            lambda a, b, c, d: hs_solve_skewed(a, b, alpha, n, variant, c, d,
                                               block_sweeps, band, blocks),
            lambda a, b, c, d: hs_solve_skewed_plain(a, b, alpha, n, variant, c, d),
            i1, i2, u0, v0)
    check_frames("hs_solve_skewed", i1, i2, *(() if u0 is None else (u0, v0)))
    if n < 0:
        raise ValueError("n must be >= 0")
    if i1.device.type == "cpu":
        return hs_solve_skewed_plain(i1, i2, alpha, n, variant, u0, v0)
    if n == 0:
        if u0 is None:
            return torch.zeros_like(i1), torch.zeros_like(i1)
        return u0, v0
    ex, ey, et, invd = hs_derivatives(i1, i2, alpha, variant)
    return launch_skewed(u0, v0, ex, ey, et, invd, n,
                         sweeps_per_launch(block_sweeps), band, blocks)


# Every K7 launch, single frame or batched, counts here.
hs_solve_skewed.launches = 0


def hs_solve_skewed_batched(i1, i2, alpha: float, n: int,
                            variant: str = "hs_cube", block_sweeps: int = 0,
                            band: int = 0, blocks: int = 0):
    """The batched twin (the reference's `hs_solve_skewed_batched`): a
    (B, H, W) stack from zero, K1 + one K7 launch that solves its frames
    one after another."""
    if i1.ndim != 3:
        raise ValueError(f"hs_solve_skewed_batched takes (B, H, W) stacks, "
                         f"got {tuple(i1.shape)}")
    return hs_solve_skewed(i1, i2, alpha, n, variant, block_sweeps=block_sweeps,
                           band=band, blocks=blocks)


hs_solve_skewed_batched_plain = hs_solve_skewed_plain
