"""K4: the Charbonnier IRLS ("robust") solve, freeze and frozen-weight
sweeps.

Port of opticalflowhs_tpu/kernels/solve_robust.py (`hs_solve_robust_resident`,
TPU kernel `_robust_kernel`: one launch for derivatives, every refreeze and
every sweep, with nine arrays resident in VMEM). At 1080p those arrays
(~75 MB) exceed the H100's shared memory, so the Hopper analog chains
launches through L2 on one stream: K1 for Ex, Ey, Et, then per refreeze
block one K4 freeze launch (`freeze_weights`) and ceil(m/s) K4 sweep
launches (`frozen_sweeps`). The CUDA source is csrc/robust.cu; a (B, H, W)
stack is one chain, the image the grid's z index.

The wrappers launch the kernels for CUDA tensors and run the plain versions
(robust.py) for CPU tensors. There is no fallback: a CUDA tensor goes
through the kernels or the call raises. Unlike the TPU kernel, which covers
hs_cube frames within its VMEM class, the chain covers both derivative
variants and every size.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch import robust as plain
from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels.derivatives import (
    batch_dims,
    check_frames,
    derivatives_plain,
    hs_derivatives,
)
from opticalflowhs_tpu_torch.kernels.jacobi import fit_sweeps, ping_pong

# Output tile of one sweep block and threads per block, as K2. A block
# stages 9 float32 arrays of the (tile + 2*sweeps) window in shared memory:
# 225 KB at s = 8, the most that fits, and the default.
TILE_H = 64
TILE_W = 64
THREADS = 512
AUTO_SWEEPS = 8
_ARRAYS = 9


def smem_bytes(sweeps: int) -> int:
    return _ARRAYS * 4 * (TILE_H + 2 * sweeps) * (TILE_W + 2 * sweeps)


def sweeps_per_launch(block_sweeps: int = 0) -> int:
    """Sweeps one K4 sweep launch runs (`jacobi.fit_sweeps`)."""
    return fit_sweeps(block_sweeps, AUTO_SWEEPS, smem_bytes)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def freeze_weights(u, v, ex, ey, et, eps_d: float, eps_s: float):
    """(wd, ws) from the current flow: one K4 freeze launch on CUDA
    tensors, `robust.charbonnier_weights` on CPU tensors."""
    check_frames("freeze_weights", u, v, ex, ey, et)
    if u.device.type == "cpu":
        return plain.charbonnier_weights(u, v, ex, ey, et, eps_d, eps_s)
    b, h, w = batch_dims("hs_robust_freeze", u)
    wd, ws = torch.empty_like(u), torch.empty_like(u)
    if u.numel() == 0:
        return wd, ws
    eps_d, eps_s = float(eps_d), float(eps_s)
    # eps^2 rounds to float32 from its double, as `eps * eps` added to a
    # float32 tensor does in the plain version.
    err = _build.library().hs_robust_freeze(
        u.data_ptr(), v.data_ptr(), ex.data_ptr(), ey.data_ptr(),
        et.data_ptr(), wd.data_ptr(), ws.data_ptr(), b, h, w,
        eps_d, eps_d * eps_d, eps_s, eps_s * eps_s, u.device.index, _stream(u),
    )
    _build.check(err, "hs_robust_freeze")
    freeze_weights.launches += 1
    return wd, ws


def frozen_sweeps(u, v, ex, ey, et, wd, ws, alpha: float, n: int,
                  block_sweeps: int = 0, owned: bool = False):
    """n frozen-weight sweeps: ceil(n/s) K4 sweep launches on CUDA tensors
    (`jacobi.ping_pong`; owned=True lets the chain overwrite (u, v)),
    `robust.robust_step` n times on CPU tensors."""
    check_frames("frozen_sweeps", u, v, ex, ey, et, wd, ws)
    if u.device.type == "cpu":
        for _ in range(n):
            u, v = plain.robust_step(u, v, ex, ey, et, wd, ws, alpha)
        return u, v
    b, h, w = batch_dims("hs_robust_sweeps", u)
    alpha = float(alpha)
    lib = _build.library()

    def launch(su, sv, du, dv, k):
        if su.numel() == 0:
            return
        err = lib.hs_robust_sweeps(
            su.data_ptr(), sv.data_ptr(), ex.data_ptr(), ey.data_ptr(),
            et.data_ptr(), wd.data_ptr(), ws.data_ptr(), du.data_ptr(),
            dv.data_ptr(), b, h, w, k, alpha * alpha, TILE_H, TILE_W,
            THREADS, su.device.index, _stream(su),
        )
        _build.check(err, "hs_robust_sweeps")
        frozen_sweeps.launches += 1

    return ping_pong(u, v, n, sweeps_per_launch(block_sweeps), launch, owned)


# Every K4 freeze and sweep launch, single frame or batched, counts here.
freeze_weights.launches = 0
frozen_sweeps.launches = 0


def robust_sweeps(u, v, ex, ey, et, n: int, cfg, owned: bool = False):
    """n IRLS sweeps on (H, W) tensors or a (B, H, W) stack, refrozen as
    `robust.robust_sweeps`: on CUDA tensors, per refreeze block of m
    sweeps, one freeze launch and ceil(m/s) sweep launches; the plain
    version on CPU tensors. The inputs are not modified unless owned."""
    check_frames("robust_sweeps", u, v, ex, ey, et)
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
    and the K4 chain on CUDA tensors, the plain version on CPU tensors.
    Returns (u, v)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    check_frames("hs_solve_robust_resident", i1, i2,
                 *(() if u0 is None else (u0, v0)))
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
