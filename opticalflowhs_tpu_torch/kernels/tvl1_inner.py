"""K5: the TV-L1 inner loop, all `iters` v/u/p alternations of one warp
iteration.

Port of opticalflowhs_tpu/kernels/tvl1_inner.py (`tvl1_inner`, TPU kernel
`_tvl1_kernel`: one launch, 6 state and 5 constant arrays resident in VMEM,
two banded passes an iteration). At 1080p those 11 arrays (92 MB) are far
beyond the H100's shared memory, so the Hopper version keeps them in device
memory (and, below about 1 Mpx, in the 50 MB L2) and runs each pass as a
launch of its own: a u-step launch and a p-step launch an alternation, all
2*iters of them enqueued by one C call (csrc/tvl1.cu). The launch boundary
is the barrier between the passes, as the band order is on the TPU. A
(B, H, W) stack is one chain, the image the grid's z index.

`tvl1_inner` launches the kernels for CUDA tensors and runs the plain
version, `tvl1_inner_plain`, for CPU tensors. There is no fallback: a CUDA
tensor goes through the kernels or the call raises. Unlike the TPU kernel,
which returns None outside its VMEM class, K5 takes every size and stacks.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels.derivatives import batch_dims, check_frames


def tvl1_inner_plain(u1, u2, rho0, gx, gy, inv_g2, th, iters: int,
                     theta: float, sigma: float, lam_theta: float):
    """The inner loop of tvl1.tvl1_warp_iteration in plain PyTorch, op for
    op as the reference's loop body: `iters` alternations of the v-step
    (three-case shrinkage of the L1 data term), the u-step
    u = v + theta*div p and the projected dual ascent
    p <- (p + sigma*grad u) / (1 + sigma*|grad u|), from zero duals.
    Returns (u1, u2)."""
    # tvl1 routes to this module, so its operators are imported here.
    from opticalflowhs_tpu_torch.tvl1 import _mask_dual, _safe_norm, divergence, grad_forward

    p1x = p1y = p2x = p2y = torch.zeros_like(u1)
    for _ in range(iters):
        rho = rho0 + u1 * gx + u2 * gy
        step = torch.where(
            rho < -th,
            lam_theta,
            torch.where(rho > th, -lam_theta, -rho * inv_g2),
        )
        v1 = u1 + step * gx
        v2 = u2 + step * gy
        u1 = v1 + theta * divergence(p1x, p1y)
        u2 = v2 + theta * divergence(p2x, p2y)
        d1x, d1y = grad_forward(u1)
        d2x, d2y = grad_forward(u2)
        n1 = 1.0 + sigma * _safe_norm(d1x, d1y)
        n2 = 1.0 + sigma * _safe_norm(d2x, d2y)
        p1x, p1y = _mask_dual((p1x + sigma * d1x) / n1, (p1y + sigma * d1y) / n1)
        p2x, p2y = _mask_dual((p2x + sigma * d2x) / n2, (p2y + sigma * d2y) / n2)
    return u1, u2


def tvl1_inner(u1, u2, rho0, gx, gy, inv_g2, th, iters: int, theta: float,
               sigma: float, lam_theta: float):
    """K5 wrapper over (H, W) tensors or (B, H, W) stacks: on CUDA tensors
    one C call enqueues 2*iters launches (u-step, p-step) on the current
    stream, on CPU tensors `tvl1_inner_plain` runs. The duals start at zero
    in buffers of their own, and u1/u2 are copied first, so the caller's
    tensors are not modified. theta, sigma and lam_theta reach the kernels
    as the float32 values torch rounds them to. Returns (u1, u2)."""
    check_frames("tvl1_inner", u1, u2, rho0, gx, gy, inv_g2, th)
    if iters < 0:
        raise ValueError(f"tvl1_inner: iters must be >= 0, got {iters}")
    if u1.device.type == "cpu":
        return tvl1_inner_plain(u1, u2, rho0, gx, gy, inv_g2, th, iters,
                                theta, sigma, lam_theta)
    b, h, w = batch_dims("hs_tvl1_inner", u1)
    u1, u2 = u1.clone(), u2.clone()
    if iters == 0 or u1.numel() == 0:
        return u1, u2
    duals = [torch.zeros_like(u1) for _ in range(4)]
    err = _build.library().hs_tvl1_inner(
        u1.data_ptr(), u2.data_ptr(), rho0.data_ptr(), gx.data_ptr(),
        gy.data_ptr(), inv_g2.data_ptr(), th.data_ptr(),
        *(p.data_ptr() for p in duals), b, h, w, iters, float(theta),
        float(sigma), float(lam_theta), u1.device.index,
        torch.cuda.current_stream(u1.device).cuda_stream,
    )
    _build.check(err, "hs_tvl1_inner")
    tvl1_inner.launches += 2 * iters
    return u1, u2


# Every K5 kernel launch (u-step or p-step), single frame or batched.
tvl1_inner.launches = 0
