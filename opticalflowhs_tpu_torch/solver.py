"""Horn-Schunck solver, mirroring opticalflowhs_tpu/solver.py (Jacobi,
4-color SOR, Charbonnier IRLS and multigrid).

Backends:
  - "torch": the plain PyTorch ops (ops/stencils.py, robust.py,
             multigrid.py), on any device; the version every kernel is held
             against.
  - "cuda":  the hand-written kernels (kernels/): K1 derivatives, K2 Jacobi
             sweeps, K3 4-color SOR sweeps, K4 IRLS freeze and sweeps, K6
             and K7 the whole Jacobi solve in one sweep launch. Multigrid
             runs K1 and then its plain V-cycles on the card, as the
             reference runs jnp cycles on every backend.
  - "auto":  cuda for CUDA frames, torch for CPU frames.

`backend="cuda"` on CPU frames raises; nothing falls back from the kernels
to the plain path, and no tensor changes device behind the caller's back.

Devices: torch tensors stay on their own device. numpy inputs go to the
entry point's `device` keyword, which defaults to cuda:0; without a CUDA
device that default raises RuntimeError, so the CPU runs only when the
caller asks for it (`device="cpu"`, or CPU tensors).

Scope: the solvers "jacobi", "sor", "robust" and "multigrid" (iters counts
V-cycles), with a fixed sweep count or solved to tolerance
(`sweeps_until`), in float32 and in bfloat16 (`HSConfig.dtype`), by the
storage rule of the package docstring, through the bfloat16 builds of K1,
K2, K6 and K7 (Jacobi), K3 (SOR) and K4 (IRLS) on the cuda backend;
multigrid runs K1's bfloat16 build, then its plain V-cycles by the same
rule. The tiled solver (dist/) runs Jacobi and SOR in both dtypes, through
the bfloat16 builds of K9-K12, and robust and multigrid through this
module's solve_level per batch group.

Gradients: both backends differentiate with respect to the frames and a
warm start. The plain ops tape through `stencils.checkpointed_loop`
(O(sqrt(n)) fields); on the cuda backend every kernel entry the routes
reach (K1-K8, the whole-solve drivers) is a kernel forward and a
plain-twin backward (kernels/autodiff.py), the reference's `custom_vjp`
scheme, with the same launches forward and none backward.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from opticalflowhs_tpu_torch import multigrid, robust
from opticalflowhs_tpu_torch.config import HSConfig
from opticalflowhs_tpu_torch.kernels import (
    solve_fused,
    solve_resident,
    solve_robust,
    solve_skewed,
)
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
    hs_solve_resident_sor,
    hs_solve_resident_sor_plain,
)
from opticalflowhs_tpu_torch.kernels.sor import sor_sweeps, sor_sweeps_plain
from opticalflowhs_tpu_torch.ops import stencils


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


def storage_dtype(cfg) -> torch.dtype:
    """The torch dtype of a config's `dtype` name (float32 or bfloat16)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def target_device(device=None) -> torch.device:
    """Where numpy inputs go: `device`, or cuda:0 when it is None. With no
    CUDA device the default raises RuntimeError: nothing falls back to the
    CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "numpy inputs go to the `device` keyword, which defaults to "
                "cuda:0, and no CUDA device is available; pass device='cpu' "
                "(or CPU tensors) to run on the CPU"
            )
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_frame(a, device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A contiguous tensor of `dtype` (float32 unless a solve's config says
    bfloat16: the cast to the config's dtype happens here, on the tensor's
    device). Tensors stay on their device (a tensor on another device than
    an explicit `device` raises); numpy arrays go to
    `target_device(device)`."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a)).to(target_device(device))
    elif not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a torch tensor or numpy array, got {type(a)}")
    elif device is not None and a.device != target_device(device):
        raise ValueError(f"tensor on {a.device}, expected {device}")
    return a.to(dtype).contiguous()


def precompute(i1: torch.Tensor, i2: torch.Tensor, cfg: HSConfig):
    """(Ex, Ey, Et, 1/(alpha^2 + Ex^2 + Ey^2)) of the frames cast to the
    config's dtype: K1 on the cuda backend."""
    i1 = as_frame(i1, dtype=storage_dtype(cfg))
    i2 = as_frame(i2, i1.device, storage_dtype(cfg))
    if resolve_backend(cfg.backend, i1) == "cuda":
        return hs_derivatives(i1, i2, cfg.alpha, cfg.deriv_variant)
    return derivatives_plain(i1, i2, cfg.alpha, cfg.deriv_variant)


def sweeps(u, v, ex, ey, et, inv_den, n: int, cfg: HSConfig) -> Flow:
    """n sweeps of cfg.solver on (H, W) or (B, H, W): Jacobi (K2), 4-color
    SOR (K3) or IRLS (K4, refrozen as `robust.robust_sweeps`, inv_den
    unused) on the cuda backend, the plain versions on the torch backend;
    for multigrid n V-cycles (`multigrid.mg_sweeps`), plain on both."""
    if n == 0:
        return Flow(u, v)
    if cfg.solver == "multigrid":
        return Flow(*multigrid.mg_sweeps(u, v, ex, ey, et, inv_den, n, cfg))
    cuda = resolve_backend(cfg.backend, u) == "cuda"
    if cfg.solver == "robust":
        irls = solve_robust.robust_sweeps if cuda else robust.robust_sweeps
        return Flow(*irls(u, v, ex, ey, et, n, cfg))
    if cfg.solver == "sor":
        if cuda:
            return Flow(*sor_sweeps(u, v, ex, ey, et, inv_den, n, cfg.omega,
                                    block_sweeps=cfg.block_sweeps))
        return Flow(*sor_sweeps_plain(u, v, ex, ey, et, inv_den, n, cfg.omega))
    if cuda:
        return Flow(*jacobi_sweeps(u, v, ex, ey, et, inv_den, n,
                                   block_sweeps=cfg.block_sweeps))
    return Flow(*jacobi_sweeps_plain(u, v, ex, ey, et, inv_den, n))


def sweeps_until(u, v, ex, ey, et, inv_den, cfg: HSConfig,
                 budget: Optional[int] = None, run_block=None) -> Flow:
    """Solve to tolerance (cfg.tol > 0), as the reference's sweeps_until:
    check blocks of b = block_sweeps (16 when 0) sweeps, or of one V-cycle
    for multigrid, b at most
    max(budget, 1), run while the next whole block fits the budget
    (cfg.iters unless given; rounded down to whole blocks) and the last
    block's max |update| over u and v exceeds tol (the first "update" is
    float32's max).

    u and v are (H, W) or (B, H, W). On a stack each image stops on its
    own update and is then frozen, so the result equals a loop of single
    solves: the rule of the reference's vmapped jnp route. (Its Pallas
    route stops the whole stack on the stack's max update; ROADMAP.md
    queue 3.)

    Reading the updates back costs one host synchronisation per check
    block. The updates are compared detached, so with grad on the flow keeps
    one graph through the blocks taken: the port differentiates this route,
    where the reference's `while_loop` refuses reverse mode (ROADMAP.md
    queue 3).

    `run_block(u, v, n) -> (u, v)` replaces the default block runner
    (`sweeps` on the given fields, which may then be None), so a caller
    with its own block keeps the stop rule here; on a stack the images
    that have converged are frozen in what it returns too."""
    iters = cfg.iters if budget is None else budget
    if run_block is None:
        def run_block(uu, vv, nn):
            return sweeps(uu, vv, ex, ey, et, inv_den, nn, cfg)

    if cfg.solver == "multigrid":
        b = 1
    else:
        b = cfg.block_sweeps if cfg.block_sweeps > 0 else 16
    b = min(b, max(iters, 1))
    delta = torch.full(u.shape[:-2], torch.finfo(u.dtype).max,
                       dtype=u.dtype, device=u.device)
    k = 0
    while k + b <= iters:
        active = delta > cfg.tol
        n_active = int(active.sum())  # the host sync of this block
        if n_active == 0:
            break
        nu, nv = run_block(u, v, b)
        d = torch.maximum((nu - u).detach().abs().amax(dim=(-2, -1)),
                          (nv - v).detach().abs().amax(dim=(-2, -1)))
        if n_active == active.numel():
            u, v, delta = nu, nv, d
        else:  # freeze the images that have converged
            keep = active[..., None, None]
            u = torch.where(keep, nu, u)
            v = torch.where(keep, nv, v)
            delta = torch.where(active, d, delta)
        k += b
    return Flow(u, v)


@functools.cache
def whole_solve_route(h: int, w: int, iters: int, variant: str,
                      block_sweeps: int = 0, dtype: str = "float32") -> str:
    """Which whole-solve schedule the reference's `solve_level` takes for a
    fixed-count Jacobi solve of one (h, w) frame of `dtype` on its Pallas
    backend (opticalflowhs_tpu/solver.py:344-405), by the reference's own
    class tests in that dtype's bytes (kept here as plain functions of the
    frame's size; their thresholds are the reference's routing rule, not
    properties of the H100): "resident" (iters >= 2 and its resident
    class: hs_cube, up to about 3.7 Mpx in float32, 1440p), else for iters
    >= 64 "skewed" (its 2-array residency class, 6 to about 11 Mpx in
    float32: 4K) or "fused" (the rest past the whole-image VMEM class,
    central 1080p and 8K included; none for block_sweeps in 1..7), else
    "chain". 1080p, 4K and 8K take the same route in both dtypes. The
    start, zero or warm, does not enter.

    Cached: the class tests walk the reference's geometry models in Python,
    thousands of steps at 8K, and a video asks about the same frame size
    again and again."""
    itemsize = 2 if dtype == "bfloat16" else 4
    if iters >= 2 and solve_resident.applicable(h, w, iters, variant, itemsize):
        return "resident"
    if iters >= 64:
        if solve_skewed.applicable(h, w, iters, itemsize):
            return "skewed"
        s_cap = block_sweeps if block_sweeps > 0 else solve_fused.MAX_S
        if solve_fused.applicable(h, w, iters, s_cap, itemsize):
            return "fused"
    return "chain"


def solve_level(
    i1: torch.Tensor,
    i2: torch.Tensor,
    cfg: HSConfig,
    iters: int,
    u0: Optional[torch.Tensor] = None,
    v0: Optional[torch.Tensor] = None,
    whole_solve_ok: bool = True,
) -> Flow:
    """One solve of an (H, W) pair or a (B, H, W) stack of pairs, from zero
    or from (u0, v0): `iters` sweeps, or with cfg.tol > 0 `sweeps_until`
    under a budget of `iters` (on a stack each image stops on its own).

    The cuda backend runs a whole-solve driver (K1, then one chain of K2,
    K3 or K4 launches for a whole stack) at every frame size and for both
    derivative variants, except that a fixed-count Jacobi solve of one
    frame takes the reference's route (`whole_solve_route`): K1 + K7 in
    its skewed class, K1 + K6 in its fused class. To tolerance, K1 once
    and then check blocks of
    `sweeps` (the reference's resident-blocked route re-derives the fields
    per block, with identical values; an IRLS block refreezes at its
    start, as the reference's block does). Multigrid runs K1 (or the plain
    derivatives) and then its plain V-cycles. The torch backend runs the
    plain ops. Both compute the same sweeps in the same order. Frames and
    start are cast to the config's dtype first, as the reference casts.

    whole_solve_ok=False takes no whole-solve kernel, as the reference's
    callers that trace this body under vmap ask: a fixed-count Jacobi pair
    then runs the K1 + K2 chain instead of K1 + K7 or K1 + K6, with the
    same values (K6 and K7 equal the chain bitwise); every other route is
    already a chain of K1 and sweep launches and does not change."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    dtype = storage_dtype(cfg)
    i1 = as_frame(i1, dtype=dtype)
    i2 = as_frame(i2, i1.device, dtype)
    if u0 is not None:
        u0 = as_frame(u0, i1.device, dtype)
        v0 = as_frame(v0, i1.device, dtype)
    if cfg.tol > 0 or cfg.solver == "multigrid":
        # Multigrid must not fall through to the Jacobi drivers below.
        ex, ey, et, inv_den = precompute(i1, i2, cfg)
        if u0 is None:
            u0, v0 = torch.zeros_like(i1), torch.zeros_like(i1)
        if cfg.tol > 0:
            return sweeps_until(u0, v0, ex, ey, et, inv_den, cfg, budget=iters)
        return sweeps(u0, v0, ex, ey, et, inv_den, iters, cfg)
    cuda = resolve_backend(cfg.backend, i1) == "cuda"
    if cfg.solver == "robust":
        rcfg = cfg if iters == cfg.iters else dataclasses.replace(cfg, iters=iters)
        if cuda:
            return Flow(*solve_robust.hs_solve_robust_resident(i1, i2, rcfg, u0, v0))
        return Flow(*solve_robust.hs_solve_robust_resident_plain(i1, i2, rcfg, u0, v0))
    if cfg.solver == "sor":
        if cuda:
            return Flow(*hs_solve_resident_sor(
                i1, i2, cfg.alpha, iters, cfg.omega, cfg.deriv_variant, u0, v0,
                block_sweeps=cfg.block_sweeps))
        return Flow(*hs_solve_resident_sor_plain(
            i1, i2, cfg.alpha, iters, cfg.omega, cfg.deriv_variant, u0, v0))
    if cuda and whole_solve_ok and i1.ndim == 2:
        route = whole_solve_route(*i1.shape, iters, cfg.deriv_variant,
                                  cfg.block_sweeps, cfg.dtype)
        if route in ("skewed", "fused"):
            solve = (solve_skewed.hs_solve_skewed if route == "skewed"
                     else solve_fused.hs_solve_fused)
            return Flow(*solve(i1, i2, cfg.alpha, iters, cfg.deriv_variant,
                               u0, v0, block_sweeps=cfg.block_sweeps))
    if cuda:
        out = hs_solve_resident(i1, i2, cfg.alpha, iters, cfg.deriv_variant,
                                u0, v0, block_sweeps=cfg.block_sweeps)
    else:
        out = hs_solve_resident_plain(i1, i2, cfg.alpha, iters,
                                      cfg.deriv_variant, u0, v0)
    return Flow(*out)


@torch.no_grad()
def tune_omega(i1, i2, cfg: HSConfig = HSConfig(), power_iters: int = 300,
               device=None) -> float:
    """The SOR over-relaxation factor for this problem, as the reference's
    `tune_omega`: power-iterate the homogeneous Jacobi update (et = 0) to
    its spectral radius rho (the geometric mean of the last norm ratios),
    then omega = 2 / (1 + sqrt(1 - rho^2)), clamped to [1, 1.98] and
    rounded to 0.01.

    The start vectors are standard normals from a CPU
    `torch.Generator().manual_seed(0)`, moved to the frames' device, so the
    CPU and the card start from the same vectors (torch cannot reproduce
    `jax.random.normal`). On the cuda backend each iteration is one K2
    launch of one sweep and the norms are reductions on the device; the one
    host synchronisation is the final `float(rho)`. It runs under
    `torch.no_grad()`: omega is a float, and frames that require grad would
    otherwise tape all `power_iters` sweeps.

    rho is that of the config's dtype, as the reference keys it: in
    bfloat16 the fields are K1's bfloat16 ones, each sweep is K2's bfloat16
    build (or the plain sweep under `stencils.store`), the norms and rho
    are formed in float32 from the widened vectors, and the normalised u
    and v, the start included, are rounded to bfloat16 as stored arrays."""
    i1 = as_frame(i1, device)
    i2 = as_frame(i2, i1.device)
    ex, ey, _, inv_den = precompute(i1, i2, cfg)
    zero_et = torch.zeros_like(ex)
    gen = torch.Generator().manual_seed(0)
    u, v = (torch.randn(ex.shape, generator=gen).to(ex.device) for _ in range(2))
    n0 = torch.sqrt(torch.sum(u * u) + torch.sum(v * v))
    u, v = (u / n0).to(ex.dtype), (v / n0).to(ex.dtype)
    tail = max(1, min(10, power_iters // 3))
    cuda = resolve_backend(cfg.backend, i1) == "cuda"
    acc = torch.zeros((), dtype=torch.float32, device=ex.device)
    for k in range(power_iters):
        if cuda:
            nu, nv = jacobi_sweeps(u, v, ex, ey, zero_et, inv_den, 1)
        else:
            nu, nv = stencils.store(stencils.jacobi_step, u, v, ex, ey, zero_et, inv_den)
        nu, nv = nu.float(), nv.float()
        n = torch.sqrt(torch.sum(nu * nu) + torch.sum(nv * nv))
        if k >= power_iters - tail:
            acc = acc + torch.log(n)
        u, v = (nu / n).to(ex.dtype), (nv / n).to(ex.dtype)
    rho = min(float(torch.exp(acc / tail)), 0.9999)
    omega = 2.0 / (1.0 + (1.0 - rho * rho) ** 0.5)
    return round(max(1.0, min(omega, 1.98)), 2)


def resolve_omega(i1, i2, cfg: HSConfig) -> HSConfig:
    """cfg with omega == 0 ("auto", SOR only) replaced by `tune_omega` on
    the pair (i1, i2); any other cfg as it is."""
    if cfg.solver == "sor" and cfg.omega == 0.0:
        return dataclasses.replace(cfg, omega=tune_omega(i1, i2, cfg))
    return cfg


def hs_solve(
    i1: torch.Tensor,
    i2: torch.Tensor,
    cfg: HSConfig = HSConfig(),
    init: Optional[Flow] = None,
    device=None,
) -> Flow:
    """Solve Horn-Schunck optical flow for the frame pair (i1, i2).

    Frames are (H, W) tensors, and the solve runs on their device, or numpy
    arrays, which go to `device` (cuda:0 when None; RuntimeError without
    CUDA). `init` warm-starts u/v; its arrays may be numpy arrays (moved to
    the frames' device) or tensors on that device. cfg.solver="sor" with
    cfg.omega == 0 tunes omega first (`tune_omega`). The flow has the
    config's dtype (bfloat16 for dtype="bfloat16").
    """
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs "
                         f"{tuple(i2.shape)}")
    if i1.ndim != 2:
        raise ValueError("hs_solve takes single 2-D grayscale frames; use "
                         "batch.hs_solve_batched for leading batch axes")
    i1 = as_frame(i1, device, storage_dtype(cfg))
    i2 = as_frame(i2, i1.device, storage_dtype(cfg))
    cfg = resolve_omega(i1, i2, cfg)
    if init is None:
        return solve_level(i1, i2, cfg, cfg.iters)
    return solve_level(i1, i2, cfg, cfg.iters, u0=init.u, v0=init.v)
