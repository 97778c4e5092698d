"""K6: the whole Jacobi solve in two launches, K1 and then ONE persistent
cooperative launch that runs all n sweeps, for a frame or a (B, H, W)
stack.

Port of opticalflowhs_tpu/kernels/solve_fused.py: `hs_solve_fused` (the
megakernel `_mega_kernel`, zero or warm start) and
`hs_solve_fused_batched` (`_mega_kernel_b`, zero start only, as the
reference). The CUDA source is csrc/solve_fused.cu: K2's window loop
(csrc/k2_window.cuh) inside a persistent cooperative grid of K2's blocks.
Each sweep block of s sweeps is one K2 launch's walk over the stack's K2
tiles; the u/v pairs ping-pong by block parity, the zero start is staged
as zeros at block 0, the remainder n mod s is the last block at its own K2
tile, and a grid barrier separates the blocks. Launches: K1 + 1 a solve,
where the K1 + K2 chain takes 1 + ceil((n-1)/s). `fused_schedule_plain`
walks that schedule in plain torch.

Unlike the TPU kernel, which returns None outside its class, these entry
points run every float32 size; `applicable` is the reference's class test,
by which `solver.solve_level` routes. CPU tensors take the plain version;
a CUDA tensor goes through the kernels or the call raises (no fallback).
"""

from __future__ import annotations

import ctypes
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
    k2_sweeps_schedule_plain,
    k2_tile,
    sweeps_per_launch,
)
from opticalflowhs_tpu_torch.kernels.solve_resident import (
    _LANE,
    _SUBLANE,
    hs_solve_resident_plain,
    round_up,
)

# The reference's fused class (opticalflowhs_tpu/kernels/solve_fused.py
# `pick_geometry` :71 and `applicable` :274, float32): frames past its
# whole-image VMEM class (17 arrays within 100 MiB), for which a band of at
# least sigma rows of 22 arrays fits the budget. The constants, the
# TPU-calibrated time model that ranks its geometries included, are the
# reference's routing rule, not properties of the H100.
_VMEM_BUDGET = 100 * 1024 * 1024
_VMEM_ARRAYS_WHOLE = 17
_ARRAYS = 22
MAX_S = 32
_ROW_SWEEP_PS = 17
_STEP_PS = 30_000_000


def _reference_geometry(h: int, wp: int, n: int, s_cap: int):
    """The reference's `pick_geometry` for float32: (s, rem, sigma, band,
    hp) of the cheapest modelled schedule, or None."""
    unit = wp * 4 * _ARRAYS
    cap = max(1, min(s_cap, MAX_S, n))
    best = None
    for s in range(8, cap + 1):
        n_full, rem = divmod(n, s)
        if n_full == 0:
            continue
        sigma = round_up(s, _SUBLANE)
        band_max = _VMEM_BUDGET // unit - 2 * sigma
        if band_max < sigma:
            continue
        h_units = -(-h // sigma)
        nb = -(-h_units // max(1, band_max // sigma))
        band = -(-h_units // nb) * sigma
        steps = (n_full + (1 if rem else 0)) * nb
        row_sweeps = (n_full * s + rem) * nb * (band + 2 * sigma)
        cost = row_sweeps * wp * _ROW_SWEEP_PS + steps * _STEP_PS
        if best is None or cost < best[0]:
            best = (cost, (s, rem, sigma, band, band * nb))
    return None if best is None else best[1]


def applicable(h: int, w: int, n: int, s_cap: int):
    """The reference's `solve_fused.applicable(i1, n, s_cap)` for a float32
    (h, w) frame: its geometry when its fused pipeline takes the solve,
    else None (n < 2, the whole-image VMEM class, or no geometry, as for
    s_cap < 8)."""
    if n < 2:
        return None
    wp = round_up(w, _LANE)
    if round_up(h, _SUBLANE) * wp * 4 * _VMEM_ARRAYS_WHOLE <= _VMEM_BUDGET:
        return None
    return _reference_geometry(h, wp, n, s_cap)


def hs_solve_fused_plain(i1, i2, alpha: float, n: int,
                         variant: str = "hs_cube", u0=None, v0=None):
    """Plain version of the whole solve (derivatives, then n sweeps from
    zero or from (u0, v0)): `hs_solve_resident_plain`."""
    return hs_solve_resident_plain(i1, i2, alpha, n, variant, u0, v0)


def fused_schedule_plain(i1, i2, alpha: float, n: int, variant: str = "hs_cube",
                         u0=None, v0=None, s: int = AUTO_SWEEPS,
                         window=(K2_WINDOW_H, K2_WINDOW_W),
                         lane_cols: int = K2_LANE_COLS, warp_rows: int = K2_WARP_ROWS):
    """K6's schedule in plain PyTorch, on (H, W) or (B, H, W): the fields,
    then ceil(n/s) sweep blocks, each one K2 launch's walk
    (`jacobi.k2_launch_schedule_plain`: K2 tiles, NaN-staged windows), the
    last one the remainder at its own tile, from zeros or (u0, v0) into a
    fresh pair each block (the kernel's ping-pong). Equals the plain whole
    solve bitwise (the tests hold it to that)."""
    fields = derivatives_plain(i1, i2, alpha, variant)
    u = torch.zeros_like(i1) if u0 is None else u0
    v = torch.zeros_like(i1) if v0 is None else v0
    return k2_sweeps_schedule_plain(u, v, *fields, n, s, window=window,
                                    lane_cols=lane_cols, warp_rows=warp_rows)


@functools.cache
def resident_blocks(entry: str, device: int) -> int:
    """The most blocks of a persistent kernel (`entry`, the C function
    hs_solve_fused_blocks or hs_solve_skewed_blocks) that can be resident
    on `device` at once: the largest grid its cooperative launch takes."""
    out = ctypes.c_int(0)
    err = getattr(_build.library(), entry)(device, ctypes.byref(out))
    _build.check(err, entry)
    return out.value


def build_geometry(entry: str, device, sweeps: int) -> dict:
    """A persistent kernel's build (`entry`, hs_solve_fused_geometry or
    hs_solve_skewed_geometry) at `sweeps` on a CUDA device: K2's tile,
    threads, shared bytes, registers a thread and spilled bytes
    (cudaFuncGetAttributes), resident blocks a multiprocessor and
    multiprocessors."""
    out = (ctypes.c_int * 8)()
    err = getattr(_build.library(), entry)(
        sweeps, torch.device(device).index or 0,
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int)))
    _build.check(err, entry)
    keys = ("tile_h", "tile_w", "threads", "smem_bytes", "registers",
            "spill_bytes", "blocks_per_sm", "sms")
    return dict(zip(keys, list(out)))


def k6_geometry(device, sweeps: int = 8) -> dict:
    """K6's build at `sweeps` (`build_geometry`)."""
    return build_geometry("hs_solve_fused_geometry", device, sweeps)


def _ptr(a):
    return None if a is None else a.data_ptr()


@functools.cache
def barrier_count(device: int, stream: int) -> torch.Tensor:
    """8 bytes of device memory for the grid barrier of K6 and K7 launches
    on `stream` of CUDA device `device` (the C call clears them on the
    stream before each launch). One buffer a device and stream, kept for
    the process: the launches on one stream run in order, and a buffer
    taken at every launch would add an allocator block to every solve's
    working memory."""
    return torch.empty(1, dtype=torch.int64, device=torch.device("cuda", device))


def launch_fused(u0, v0, ex, ey, et, invd, n: int, s: int, blocks: int = 0):
    """One K6 launch: n >= 1 sweeps from (u0, v0), or from zeros when u0
    is None, on the fields of a frame or stack, s sweeps a block (K2's tile
    at s). `blocks` > 0 forces the grid (a grid larger than can be resident
    raises). Returns (u, v)."""
    b, h, w = batch_dims("hs_solve_fused_sweeps", ex)
    n_blocks = -(-n // s)
    ua, va = torch.empty_like(ex), torch.empty_like(ex)
    ub, vb = (ua, va) if n_blocks == 1 else (torch.empty_like(ex),
                                             torch.empty_like(ex))
    dev = ex.device.index
    th, tw, _ = k2_tile(s)
    tiles = b * -(-h // th) * -(-w // tw)
    grid = blocks if blocks > 0 else min(
        tiles, resident_blocks("hs_solve_fused_blocks", dev))
    stream = torch.cuda.current_stream(ex.device).cuda_stream
    err = _build.library().hs_solve_fused_sweeps(
        _ptr(u0), _ptr(v0), ex.data_ptr(), ey.data_ptr(), et.data_ptr(),
        invd.data_ptr(), ua.data_ptr(), va.data_ptr(), ub.data_ptr(),
        vb.data_ptr(), barrier_count(dev, stream).data_ptr(), b, h, w, n,
        s, grid, dev, stream,
    )
    _build.check(err, "hs_solve_fused_sweeps")
    hs_solve_fused.launches += 1
    return (ua, va) if n_blocks % 2 == 1 else (ub, vb)


def hs_solve_fused(i1, i2, alpha: float, n: int, variant: str = "hs_cube",
                   u0=None, v0=None, block_sweeps: int = 0, blocks: int = 0):
    """Whole HS solve of an (H, W) pair or a (B, H, W) stack, from zero or
    from (u0, v0): on CUDA tensors K1, then one K6 launch of all n sweeps
    (s = `jacobi.sweeps_per_launch(block_sweeps)` a block; `blocks` > 0
    forces the grid); the plain version on CPU tensors. Returns (u, v).
    Differentiable with respect to the frames and the start (`autodiff`:
    the VJP of `hs_solve_fused_plain`)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    if autodiff.needs_grad(i1, i2, u0, v0):
        return autodiff.KernelEntry.apply(
            lambda a, b, c, d: hs_solve_fused(a, b, alpha, n, variant, c, d,
                                              block_sweeps, blocks),
            lambda a, b, c, d: hs_solve_fused_plain(a, b, alpha, n, variant, c, d),
            i1, i2, u0, v0)
    check_frames("hs_solve_fused", i1, i2, *(() if u0 is None else (u0, v0)))
    if n < 0:
        raise ValueError("n must be >= 0")
    if i1.device.type == "cpu":
        return hs_solve_fused_plain(i1, i2, alpha, n, variant, u0, v0)
    if n == 0:
        if u0 is None:
            return torch.zeros_like(i1), torch.zeros_like(i1)
        return u0, v0
    ex, ey, et, invd = hs_derivatives(i1, i2, alpha, variant)
    return launch_fused(u0, v0, ex, ey, et, invd, n,
                        sweeps_per_launch(block_sweeps), blocks)


# Every K6 launch, single frame or batched, counts here.
hs_solve_fused.launches = 0


def hs_solve_fused_batched(i1, i2, alpha: float, n: int,
                           variant: str = "hs_cube", block_sweeps: int = 0,
                           blocks: int = 0):
    """The batched twin (the reference's `hs_solve_fused_batched`): a
    (B, H, W) stack from zero, K1 + one K6 launch for the whole stack."""
    if i1.ndim != 3:
        raise ValueError(f"hs_solve_fused_batched takes (B, H, W) stacks, got "
                         f"{tuple(i1.shape)}")
    return hs_solve_fused(i1, i2, alpha, n, variant, block_sweeps=block_sweeps,
                          blocks=blocks)


hs_solve_fused_batched_plain = hs_solve_fused_plain
