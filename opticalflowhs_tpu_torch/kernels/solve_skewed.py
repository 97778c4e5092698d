"""K7: the whole Jacobi solve with u and v updated in place, K1 and then
ONE persistent cooperative launch of all n sweeps, for a frame or, one
after another, the frames of a (B, H, W) stack.

Port of opticalflowhs_tpu/kernels/solve_skewed.py: `hs_solve_skewed`
(`_skewed_kernel`, zero or warm start) and `hs_solve_skewed_batched`
(`_skewed_kernel_b`, zero start only, as the reference). The CUDA source is
csrc/solve_skewed.cu. There is no second u/v pair: the working memory is
the two output arrays plus two sigma x W pencils for each of u and v, and
time skewing over row bands keeps the in-place update in Jacobi order
(band i reads the old rows above it from the pencil band i-1 saved).
`skewed_schedule_plain` walks that schedule in plain PyTorch, so the CPU
tests can show that the order is right.

Unlike the TPU kernel, which returns None outside its class, these entry
points run every float32 size whose band of tiles fits the grid;
`applicable` is the reference's class test, by which `solver.solve_level`
routes. CPU tensors take the plain version; a CUDA tensor goes through the
kernels or the call raises (no fallback).
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels.derivatives import (
    batch_dims,
    check_frames,
    derivatives_plain,
    hs_derivatives,
)
from opticalflowhs_tpu_torch.kernels.jacobi import (
    AUTO_SWEEPS,
    SMEM_BYTES,
    THREADS,
    smem_bytes,
    sweeps_per_launch,
)
from opticalflowhs_tpu_torch.kernels.solve_fused import (
    MAX_S,
    _ptr,
    resident_blocks,
)
from opticalflowhs_tpu_torch.kernels.solve_resident import (
    _LANE,
    _SUBLANE,
    _resident_geometry,
    hs_solve_resident_plain,
    round_up,
)
from opticalflowhs_tpu_torch.ops import stencils

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

# Widths of K7's tiles, tried in order until a band row of tiles fits the
# grid; each takes the tallest tile (a multiple of 8 up to 64 rows) whose
# window fits a block's shared memory.
_TILE_WIDTHS = (64, 128, 256)
_MAX_TILE_H = 64


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


def geometry(h: int, w: int, s: int, most_blocks, band: int = 0):
    """(band, tile_h, tile_w) of K7 for an (h, w) frame at s sweeps a block.

    `most_blocks(tile_h, tile_w)` is the most blocks that can be resident.
    The tile is the narrowest of _TILE_WIDTHS whose row of tiles across the
    frame fits that grid (one tile a block a band), and band = 0 picks as
    many rows of tiles a band as fit it. Raises ValueError when no tile
    fits or a given band's tiles outnumber the grid."""
    for tile_w in _TILE_WIDTHS:
        tile_h = _MAX_TILE_H
        while tile_h >= max(s, _SUBLANE) and (
                smem_bytes(s, tile_h, tile_w) > SMEM_BYTES):
            tile_h -= _SUBLANE
        if tile_h < max(s, _SUBLANE):
            continue
        cols = -(-w // tile_w)
        most = most_blocks(tile_h, tile_w)
        if cols <= most:
            break
    else:
        raise ValueError(
            f"hs_solve_skewed: a {w} px wide frame needs more tiles a band "
            "than blocks can be resident at once")
    if band == 0:
        band = tile_h * max(1, most // cols)
    band = max(band, s)
    if -(-min(band, h) // tile_h) * cols > most:
        raise ValueError(f"hs_solve_skewed: a band of {band} rows has more "
                         f"tiles than the {most} resident blocks")
    return band, tile_h, tile_w


def hs_solve_skewed_plain(i1, i2, alpha: float, n: int,
                          variant: str = "hs_cube", u0=None, v0=None):
    """Plain version of the whole solve: `hs_solve_resident_plain`."""
    return hs_solve_resident_plain(i1, i2, alpha, n, variant, u0, v0)


def skewed_schedule_plain(i1, i2, alpha: float, n: int,
                          variant: str = "hs_cube", u0=None, v0=None,
                          s: int = AUTO_SWEEPS, band: int = 64):
    """K7's schedule in plain PyTorch, on (H, W) or (B, H, W): one u/v pair
    updated in place; per block of s sweeps (the last one the remainder,
    sigma = its sweeps) the bands of `band` rows top to bottom, each
    staging its window (the old rows above it from the pencil the band
    before saved, the rest from u/v, cut at the true edges), saving its
    last sigma rows, still old, as the next pencil, running the block's
    plain sweeps on the window and writing its own rows back. Equals the
    plain whole solve bitwise (the tests hold it to that)."""
    if band < s:
        raise ValueError(f"band ({band}) must be >= s ({s})")
    ex, ey, et, invd = derivatives_plain(i1, i2, alpha, variant)
    u = torch.zeros_like(i1) if u0 is None else u0.clone()
    v = torch.zeros_like(i1) if v0 is None else v0.clone()
    h = i1.shape[-2]
    done = 0
    while done < n:
        ns = min(s, n - done)
        pu = pv = None  # old rows [r0 - ns, r0), saved by the band above
        for r0 in range(0, h, band):
            r_end = min(r0 + band, h)
            lo, hi = max(r0 - ns, 0), min(r_end + ns, h)
            uw, vw = u[..., r0:hi, :], v[..., r0:hi, :]
            if pu is not None:
                uw = torch.cat([pu, uw], dim=-2)
                vw = torch.cat([pv, vw], dim=-2)
            if r_end < h:
                pu = uw[..., r_end - ns - lo:r_end - lo, :].clone()
                pv = vw[..., r_end - ns - lo:r_end - lo, :].clone()
            fields = [a[..., lo:hi, :] for a in (ex, ey, et, invd)]
            for _ in range(ns):
                uw, vw = stencils.jacobi_step(uw, vw, *fields)
            u[..., r0:r_end, :] = uw[..., r0 - lo:r_end - lo, :]
            v[..., r0:r_end, :] = vw[..., r0 - lo:r_end - lo, :]
        done += ns
    return u, v


def launch_skewed(u0, v0, ex, ey, et, invd, n: int, s: int, band: int = 0,
                  blocks: int = 0):
    """One K7 launch: n >= 1 sweeps in place from (u0, v0), or from zeros
    when u0 is None, on the fields of a frame or stack (its frames one
    after another). `band` > 0 forces the band rows, `blocks` > 0 the grid
    (a grid larger than can be resident raises). Returns (u, v)."""
    b, h, w = batch_dims("hs_solve_skewed_sweeps", ex)
    dev = ex.device.index

    def most(tile_h, tile_w):
        if blocks > 0:
            return blocks
        return resident_blocks("hs_solve_skewed_blocks", dev, s, tile_h, tile_w)

    band, tile_h, tile_w = geometry(h, w, s, most, band)
    grid = blocks if blocks > 0 else (-(-min(band, h) // tile_h)
                                      * -(-w // tile_w))
    u, v = torch.empty_like(ex), torch.empty_like(ex)
    pu, pv = (torch.empty(2 * s * w, dtype=ex.dtype, device=ex.device)
              for _ in range(2))
    err = _build.library().hs_solve_skewed_sweeps(
        _ptr(u0), _ptr(v0), ex.data_ptr(), ey.data_ptr(), et.data_ptr(),
        invd.data_ptr(), u.data_ptr(), v.data_ptr(), pu.data_ptr(),
        pv.data_ptr(), b, h, w, n, s, band, tile_h, tile_w, THREADS, grid,
        dev, torch.cuda.current_stream(ex.device).cuda_stream,
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
    on CPU tensors. Returns (u, v)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
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
