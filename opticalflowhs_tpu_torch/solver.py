"""Horn-Schunck solver, mirroring opticalflowhs_tpu/solver.py (Jacobi path).

Backends:
  - "torch": the plain PyTorch ops (ops/stencils.py), on any device; the
             version every kernel is held against.
  - "cuda":  the hand-written kernels (kernels/): K1 derivatives, K2 sweeps.
  - "auto":  cuda for CUDA frames, torch for CPU frames.

`backend="cuda"` on CPU frames raises; nothing falls back from the kernels
to the plain path, and no tensor changes device behind the caller's back.

Scope: Jacobi with a fixed sweep count (`tol == 0`), float32. The other
solvers, solve-to-tolerance and bf16 are still to be ported (ROADMAP.md
queue 1) and raise NotImplementedError rather than solving something else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from opticalflowhs_tpu_torch.config import HSConfig
from opticalflowhs_tpu_torch.kernels.derivatives import (
    derivatives_plain,
    hs_derivatives,
)
from opticalflowhs_tpu_torch.kernels.jacobi import (
    jacobi_sweeps,
    jacobi_sweeps_plain,
)
from opticalflowhs_tpu_torch.kernels.solve_resident import (
    hs_solve_resident,
    hs_solve_resident_plain,
)


class Flow(NamedTuple):
    """Dense flow field. u = horizontal (x / column) motion, v = vertical."""

    u: torch.Tensor
    v: torch.Tensor


def resolve_backend(backend: str, frame: torch.Tensor) -> str:
    """"torch" or "cuda" for a frame on its device."""
    if backend == "auto":
        return "cuda" if frame.is_cuda else "torch"
    if backend == "cuda" and not frame.is_cuda:
        raise ValueError(
            f"backend='cuda' needs CUDA tensors; the frames are on {frame.device}"
        )
    return backend


def check_supported(cfg: HSConfig) -> None:
    """Raise NotImplementedError for configurations the port cannot solve yet."""
    if cfg.solver != "jacobi":
        raise NotImplementedError(
            f"solver={cfg.solver!r} is not ported yet (ROADMAP.md queue 1, "
            "item 9: other HS solvers); only 'jacobi' runs"
        )
    if cfg.tol > 0:
        raise NotImplementedError(
            "tol > 0 (solve-to-tolerance, sweeps_until) is not ported yet "
            "(ROADMAP.md queue 1, item 3)"
        )
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r} is not ported yet (ROADMAP.md queue 1, "
            "item 3: bf16); only float32 runs"
        )


def as_frame(a, device: Optional[torch.device] = None) -> torch.Tensor:
    """A contiguous float32 tensor. Tensors stay on their device (a tensor
    on another device than `device` raises); numpy arrays go to `device`,
    or to the CPU."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a)).to(device or "cpu")
    elif not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a torch tensor or numpy array, got {type(a)}")
    elif device is not None and a.device != device:
        raise ValueError(f"tensor on {a.device}, expected {device}")
    return a.to(torch.float32).contiguous()


def precompute(i1: torch.Tensor, i2: torch.Tensor, cfg: HSConfig):
    """(Ex, Ey, Et, 1/(alpha^2 + Ex^2 + Ey^2)): K1 on the cuda backend."""
    i1 = as_frame(i1)
    i2 = as_frame(i2, i1.device)
    if resolve_backend(cfg.backend, i1) == "cuda":
        return hs_derivatives(i1, i2, cfg.alpha, cfg.deriv_variant)
    return derivatives_plain(i1, i2, cfg.alpha, cfg.deriv_variant)


def sweeps(u, v, ex, ey, et, inv_den, n: int, cfg: HSConfig) -> Flow:
    """n Jacobi sweeps: K2 launches on the cuda backend."""
    check_supported(cfg)
    if n == 0:
        return Flow(u, v)
    if resolve_backend(cfg.backend, u) == "cuda":
        return Flow(*jacobi_sweeps(u, v, ex, ey, et, inv_den, n,
                                   block_sweeps=cfg.block_sweeps))
    return Flow(*jacobi_sweeps_plain(u, v, ex, ey, et, inv_den, n))


def solve_level(
    i1: torch.Tensor,
    i2: torch.Tensor,
    cfg: HSConfig,
    iters: int,
    u0: Optional[torch.Tensor] = None,
    v0: Optional[torch.Tensor] = None,
) -> Flow:
    """One fixed-budget solve of a 2-D pair, from zero or from (u0, v0).

    The cuda backend runs the whole-solve driver (K1, then K2 launches) at
    every frame size and for both derivative variants; the torch backend
    runs the plain ops. Both compute the same sweeps in the same order."""
    check_supported(cfg)
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    i1 = as_frame(i1)
    i2 = as_frame(i2, i1.device)
    if u0 is not None:
        u0 = as_frame(u0, i1.device)
        v0 = as_frame(v0, i1.device)
    if resolve_backend(cfg.backend, i1) == "cuda":
        out = hs_solve_resident(i1, i2, cfg.alpha, iters, cfg.deriv_variant,
                                u0, v0, block_sweeps=cfg.block_sweeps)
    else:
        out = hs_solve_resident_plain(i1, i2, cfg.alpha, iters,
                                      cfg.deriv_variant, u0, v0)
    return Flow(*out)


def hs_solve(
    i1: torch.Tensor,
    i2: torch.Tensor,
    cfg: HSConfig = HSConfig(),
    init: Optional[Flow] = None,
) -> Flow:
    """Solve Horn-Schunck optical flow for the frame pair (i1, i2).

    Frames are (H, W) tensors (or numpy arrays, which stay on the CPU); the
    solve runs on their device. `init` warm-starts u/v; its arrays may be
    numpy arrays (moved to the frames' device) or tensors on that device.
    """
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs "
                         f"{tuple(i2.shape)}")
    if i1.ndim != 2:
        raise ValueError("hs_solve takes single 2-D grayscale frames; use "
                         "batch.hs_solve_batched for leading batch axes")
    if init is None:
        return solve_level(i1, i2, cfg, cfg.iters)
    return solve_level(i1, i2, cfg, cfg.iters, u0=init.u, v0=init.v)
