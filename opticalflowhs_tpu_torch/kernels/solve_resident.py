"""The whole-solve driver: K1 then a chain of K2 launches on one stream.

Port of opticalflowhs_tpu/kernels/solve_resident.py (`hs_solve_resident`,
stages=1). On the TPU the solve is one launch with every array resident in
VMEM; at 1080p its 8 arrays (~67 MB) exceed the H100's combined shared
memory, so the Hopper analog is temporal blocking through L2: K1 computes
the four fields once, then each K2 launch runs several sweeps on
shared-memory tiles.

  * Zero start: K1 also writes the first sweep (u1 = -Ex*Et*invd, the
    reference's zero-init shortcut), then ceil((n-1)/s) K2 launches.
  * Warm start: K1 without the shortcut, then ceil(n/s) K2 launches from
    (u0, v0).

Two u/v pairs ping-pong; nothing synchronises with the host. Unlike the
TPU kernel, which returns None outside its VMEM residency class and for
the central variant, this driver covers every 2-D float32 size and both
derivative variants.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels.derivatives import (
    check_frames,
    derivatives_plain,
    hs_derivatives,
)
from opticalflowhs_tpu_torch.kernels.jacobi import (
    jacobi_sweeps_plain,
    sweep_chain,
    sweeps_per_launch,
)


def hs_solve_resident_plain(i1, i2, alpha: float, n: int,
                            variant: str = "hs_cube", u0=None, v0=None):
    """Plain version of the whole solve: derivatives, then n sweeps."""
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
    """Whole HS solve (derivatives + n Jacobi sweeps), from zero or from
    (u0, v0). K1 + K2 on CUDA tensors, the plain version on CPU tensors.
    Returns (u, v)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    check_frames("hs_solve_resident", i1, i2, *(() if u0 is None else (u0, v0)))
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
