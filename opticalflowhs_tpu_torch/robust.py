"""Robust-penalty Horn-Schunck (`HSConfig(solver="robust")`), mirroring
opticalflowhs_tpu/robust.py: the plain version of the whole IRLS family.

Both terms take the Charbonnier penalty psi(s^2) = sqrt(s^2 + eps^2),
minimised by IRLS: every `robust_update_every` sweeps the weights

    wd = eps_d / sqrt(r^2 + eps_d^2),          r = Ex u + Ey v + Et
    ws = eps_s / sqrt(|grad u|^2 + |grad v|^2 + eps_s^2)

are refrozen from the current flow, and the frozen-weight system is relaxed
by Jacobi sweeps over the 4-neighbourhood with edge weights
(ws_p + ws_n) / 2, each pixel a closed-form 2x2 solve.

Every op keeps the reference's association order, so the K4 kernels
(csrc/robust.cu, built without FMA contraction) reproduce these functions
bitwise on the card. The functions take (H, W) fields or (B, H, W) stacks;
the shifts clamp per image.
"""

from __future__ import annotations

import functools

import torch

from opticalflowhs_tpu_torch.ops.stencils import (
    checkpoint_block,
    shift_down_row,
    shift_left_col,
    shift_right_col,
    shift_up_row,
    store,
)


def charbonnier_weights(u, v, ex, ey, et, eps_d: float, eps_s: float):
    """(wd, ws) per pixel from the current flow, unit-plateau normalised.
    bfloat16 arrays follow the storage rule (`stencils.store`): float32
    arithmetic, wd and ws rounded once, where they are stored."""
    return store(_weights, u, v, ex, ey, et, eps_d, eps_s)


def _weights(u, v, ex, ey, et, eps_d: float, eps_s: float):
    r = ex * u + ey * v + et
    wd = eps_d * torch.rsqrt(r * r + eps_d * eps_d)
    gxu = shift_left_col(u) - u
    gyu = shift_up_row(u) - u
    gxv = shift_left_col(v) - v
    gyv = shift_up_row(v) - v
    g2 = gxu * gxu + gyu * gyu + gxv * gxv + gyv * gyv
    ws = eps_s * torch.rsqrt(g2 + eps_s * eps_s)
    return wd, ws


def robust_step(u, v, ex, ey, et, wd, ws, alpha: float):
    """One frozen-weight Jacobi sweep of the IRLS inner system. bfloat16
    arrays follow the storage rule: the edge weights and the 2x2 system
    formed in float32 from the widened fields and weights, u and v rounded
    once, at the sweep's end."""
    return store(_step, u, v, ex, ey, et, wd, ws, alpha)


def _step(u, v, ex, ey, et, wd, ws, alpha: float):
    w_up = 0.5 * (ws + shift_down_row(ws))   # edge to (i-1, j)
    w_dn = 0.5 * (ws + shift_up_row(ws))     # edge to (i+1, j)
    w_lf = 0.5 * (ws + shift_right_col(ws))  # edge to (i, j-1)
    w_rt = 0.5 * (ws + shift_left_col(ws))   # edge to (i, j+1)
    w_sum = w_up + w_dn + w_lf + w_rt

    def nsum(a):
        return (
            w_up * shift_down_row(a)
            + w_dn * shift_up_row(a)
            + w_lf * shift_right_col(a)
            + w_rt * shift_left_col(a)
        )

    a2 = alpha * alpha
    a11 = wd * ex * ex + a2 * w_sum
    a22 = wd * ey * ey + a2 * w_sum
    a12 = wd * ex * ey
    b1 = a2 * nsum(u) - wd * ex * et
    b2 = a2 * nsum(v) - wd * ey * et
    inv_det = 1.0 / (a11 * a22 - a12 * a12)
    return (a22 * b1 - a12 * b2) * inv_det, (a11 * b2 - a12 * b1) * inv_det


def refreeze_blocks(n: int, update_every: int) -> list[int]:
    """Sweeps of each weight block of an n-sweep IRLS run: blocks of
    k = max(1, min(update_every, n)), then the remainder."""
    k = max(1, min(update_every, n))
    n_blocks, rem = divmod(n, k)
    return [k] * n_blocks + ([rem] if rem else [])


def robust_sweeps(u, v, ex, ey, et, n: int, cfg):
    """n IRLS sweeps: the weights are refrozen at the start of every block
    of `refreeze_blocks(n, cfg.robust_update_every)`, the first time at the
    start flow. Each block runs through `stencils.checkpoint_block`, as the
    reference's `jax.checkpoint` per block: the gradient tape holds one
    state a block, not one a sweep."""
    alpha = float(cfg.alpha)
    eps_d = float(cfg.robust_eps_d)
    eps_s = float(cfg.robust_eps_s)

    def block(u, v, m):
        wd, ws = charbonnier_weights(u, v, ex, ey, et, eps_d, eps_s)
        for _ in range(m):
            u, v = robust_step(u, v, ex, ey, et, wd, ws, alpha)
        return u, v

    for m in refreeze_blocks(n, cfg.robust_update_every):
        u, v = checkpoint_block(functools.partial(block, m=m), (u, v))
    return u, v
