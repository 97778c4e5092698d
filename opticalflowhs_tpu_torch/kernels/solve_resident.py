"""The whole-solve drivers: K1 then a chain of K2 (Jacobi) or K3 (4-color
SOR, `hs_solve_resident_sor`) launches on one stream.

Port of opticalflowhs_tpu/kernels/solve_resident.py (`hs_solve_resident`,
stages=1, and `hs_solve_resident_sor`, stages=4). On the TPU the solve is
one launch with every array resident in VMEM; at 1080p its 8 arrays
(~67 MB) exceed the H100's combined shared memory, so the Hopper analog is
temporal blocking through L2: K1 computes the four fields once, then each
K2 (or K3) launch runs several sweeps on shared-memory tiles.

  * Zero start: K1 also writes the first sweep (u1 = -Ex*Et*invd, the
    reference's zero-init shortcut), then ceil((n-1)/s) K2 launches.
  * Warm start: K1 without the shortcut, then ceil(n/s) K2 launches from
    (u0, v0).
  * SOR has no closed first sweep: K1 without the shortcut, then
    ceil(n/s) K3 launches from zeros or from (u0, v0).

Two u/v pairs ping-pong; nothing synchronises with the host. Unlike the
TPU kernel, which returns None outside its VMEM residency class and for
the central variant, this driver covers every size and both derivative
variants, in float32 and in bfloat16 (K1's, K2's and K3's bfloat16
builds).

`applicable` is the reference's class test for its resident kernel, kept
here as a plain function of the frame's size: `solver.solve_level` routes
by the reference's classes (K6 and K7 take frames beyond this one).

The driver takes an (H, W) pair or a (B, H, W) stack. On a stack it is the
port of the batched TPU kernel (`_resident_kernel_b`, grid (B,), which
starts from zero only; `hs_solve_resident_batched` names it here): each
launch covers the whole stack, so a stack costs 1 K1 launch and
ceil((n-1)/s) K2 launches, not B times that.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels import autodiff, sor
from opticalflowhs_tpu_torch.kernels.derivatives import (
    BF16_DTYPES,
    check_frames,
    derivatives_plain,
    hs_derivatives,
)
from opticalflowhs_tpu_torch.kernels.jacobi import (
    jacobi_sweeps_plain,
    sweep_chain,
    sweeps_per_launch,
)

# The reference's resident class (opticalflowhs_tpu/kernels/solve_resident.py
# `pick_geometry` :94 and `applicable` :607, no HSFLOW_* overrides): 4
# fields + 2 u/v pairs + band temporaries within a 118 MiB TPU VMEM budget,
# counted in the dtype's bytes and sublanes (`sublane`: 8 rows for
# float32, 16 for bfloat16). These are the reference's routing rule, not
# properties of the H100; the port keeps them so that it routes as the
# reference does.
_LANE = 128
_SUBLANE = 8
_RESIDENT_ARRAYS = 8
_TEMP_ARRAYS = 10
_RESIDENT_LIMIT = 118 * 1024 * 1024


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def sublane(itemsize: int) -> int:
    """The reference's `_sublane`: rows of a TPU tile, 8 for 4-byte and 16
    for 2-byte (bfloat16) elements."""
    return _SUBLANE if itemsize == 4 else 2 * _SUBLANE


def _resident_geometry(h: int, w: int, itemsize: int = 4):
    """The reference's `pick_geometry(h, w, dtype)` at stages=1 for a dtype
    of `itemsize` bytes: (nb, band, hp, wp, s, sigma) for the fewest bands
    that fit, or None."""
    sub = sublane(itemsize)
    wp = round_up(w, _LANE)
    h_units = -(-h // sub)
    for nb in range(1, h_units + 1):
        band = -(-h_units // nb) * sub
        hp = band * nb
        sigma = 0 if nb == 1 else sub  # round_up(s = 1, sublane)
        if nb > 1 and sigma > band:
            continue
        resident = _RESIDENT_ARRAYS * hp * wp * itemsize
        temps = _TEMP_ARRAYS * (band + 2 * sigma) * wp * itemsize
        deriv_win = 2 * (band + sub) * wp * itemsize
        if resident + temps + deriv_win <= _RESIDENT_LIMIT:
            return nb, band, hp, wp, 1, sigma
    return None


def applicable(h: int, w: int, n: int, variant: str, itemsize: int = 4):
    """The reference's `solve_resident.applicable` for an (h, w) frame of
    `itemsize`-byte elements: its geometry when its resident kernel takes
    the solve (hs_cube, n >= 1, within the budget), else None."""
    if n < 1 or variant != "hs_cube":
        return None
    return _resident_geometry(h, w, itemsize)


def hs_solve_resident_plain(i1, i2, alpha: float, n: int,
                            variant: str = "hs_cube", u0=None, v0=None):
    """Plain version of the whole solve: derivatives, then n sweeps; on a
    stack each image on its own (the stencils clamp per image). bfloat16
    frames and start follow the storage rule of `stencils.store`."""
    if u0 is None:
        if n == 0:
            return torch.zeros_like(i1), torch.zeros_like(i1)
        ex, ey, et, invd, u, v = derivatives_plain(i1, i2, alpha, variant,
                                                   zero_sweep=True)
        return jacobi_sweeps_plain(u, v, ex, ey, et, invd, n - 1)
    ex, ey, et, invd = derivatives_plain(i1, i2, alpha, variant)
    return jacobi_sweeps_plain(u0, v0, ex, ey, et, invd, n)


def hs_solve_resident(i1, i2, alpha: float, n: int, variant: str = "hs_cube",
                      u0=None, v0=None, block_sweeps: int = 0):
    """Whole HS solve (derivatives + n Jacobi sweeps) of an (H, W) pair or a
    (B, H, W) stack of pairs, from zero or from (u0, v0). K1 + K2 on CUDA
    tensors (one chain for the whole stack; float32 or the bfloat16
    builds), the plain version on CPU tensors. Returns (u, v). Differentiable with respect to the frames and
    the start (`autodiff`: the VJP of `hs_solve_resident_plain`)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    if autodiff.needs_grad(i1, i2, u0, v0):
        return autodiff.KernelEntry.apply(
            lambda a, b, c, d: hs_solve_resident(a, b, alpha, n, variant, c, d,
                                                 block_sweeps),
            lambda a, b, c, d: hs_solve_resident_plain(a, b, alpha, n, variant, c, d),
            i1, i2, u0, v0)
    check_frames("hs_solve_resident", i1, i2, *(() if u0 is None else (u0, v0)),
                 dtypes=BF16_DTYPES)
    if n < 0:
        raise ValueError("n must be >= 0")
    if i1.device.type == "cpu":
        return hs_solve_resident_plain(i1, i2, alpha, n, variant, u0, v0)
    s = sweeps_per_launch(block_sweeps)
    if u0 is None:
        if n == 0:
            return torch.zeros_like(i1), torch.zeros_like(i1)
        ex, ey, et, invd, u1, v1 = hs_derivatives(i1, i2, alpha, variant,
                                                  zero_sweep=True)
        return sweep_chain(u1, v1, ex, ey, et, invd, n - 1, s, owned=True)
    ex, ey, et, invd = hs_derivatives(i1, i2, alpha, variant)
    return sweep_chain(u0, v0, ex, ey, et, invd, n, s)


# The reference's names for the batched solve: the same functions.
hs_solve_resident_batched = hs_solve_resident
hs_solve_resident_batched_plain = hs_solve_resident_plain


def hs_solve_resident_sor_plain(i1, i2, alpha: float, n: int, omega: float,
                                variant: str = "hs_cube", u0=None, v0=None):
    """Plain version of the whole 4-color SOR solve: derivatives, then n
    SOR sweeps from zeros or from (u0, v0)."""
    ex, ey, et, invd = derivatives_plain(i1, i2, alpha, variant)
    if u0 is None:
        u0, v0 = torch.zeros_like(i1), torch.zeros_like(i1)
    return sor.sor_sweeps_plain(u0, v0, ex, ey, et, invd, n, omega)


def hs_solve_resident_sor(i1, i2, alpha: float, n: int, omega: float,
                          variant: str = "hs_cube", u0=None, v0=None,
                          block_sweeps: int = 0):
    """Whole 4-color SOR solve of an (H, W) pair or a (B, H, W) stack, the
    port of the reference's `hs_solve_resident_sor` (`_resident_body` at
    stages=4): on CUDA tensors K1, then ceil(n/s) K3 launches, one chain
    for a whole stack; the plain version on CPU tensors; float32 or
    bfloat16 (K1's and K3's bfloat16 builds). Unlike the TPU
    kernel it covers both derivative variants and every size. Returns
    (u, v). Differentiable with respect to the frames and the start
    (`autodiff`: the VJP of `hs_solve_resident_sor_plain`)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    if autodiff.needs_grad(i1, i2, u0, v0):
        return autodiff.KernelEntry.apply(
            lambda a, b, c, d: hs_solve_resident_sor(a, b, alpha, n, omega, variant,
                                                     c, d, block_sweeps),
            lambda a, b, c, d: hs_solve_resident_sor_plain(a, b, alpha, n, omega,
                                                           variant, c, d),
            i1, i2, u0, v0)
    check_frames("hs_solve_resident_sor", i1, i2,
                 *(() if u0 is None else (u0, v0)), dtypes=BF16_DTYPES)
    if n < 0:
        raise ValueError("n must be >= 0")
    if i1.device.type == "cpu":
        return hs_solve_resident_sor_plain(i1, i2, alpha, n, omega, variant,
                                           u0, v0)
    if n == 0:
        if u0 is None:
            return torch.zeros_like(i1), torch.zeros_like(i1)
        return u0, v0
    ex, ey, et, invd = hs_derivatives(i1, i2, alpha, variant)
    owned = u0 is None
    if owned:
        u0, v0 = torch.zeros_like(i1), torch.zeros_like(i1)
    return sor.sor_chain(u0, v0, ex, ey, et, invd, n, omega, block_sweeps,
                         owned=owned)
