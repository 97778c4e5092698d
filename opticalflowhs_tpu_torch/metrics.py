"""Flow metrics, mirroring opticalflowhs_tpu/metrics.py.

EPE: mean over valid pixels of sqrt((u-u_gt)^2 + (v-v_gt)^2); valid = not
marked unknown in the ground truth (|value| > 1e9, the Middlebury .flo
convention). Angular error follows Barron et al. 1994 as used by the
Middlebury evaluation. Both run in NumPy; torch tensors are accepted and
copied to the host. `hs_energy`, the solver's convergence diagnostic, runs
in torch on the frames' device.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowhs_tpu_torch.io.flo import unknown_mask
from opticalflowhs_tpu_torch.ops import stencils
from opticalflowhs_tpu_torch.solver import as_frame


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # torch tensor, on any device
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def epe(flow, gt, valid_mask: np.ndarray | None = None) -> float:
    """Average endpoint error between (H, W, 2) flow and ground truth."""
    flow = _host(flow)
    gt = _host(gt)
    if flow.shape != gt.shape:
        raise ValueError(f"shape mismatch {flow.shape} vs {gt.shape}")
    if valid_mask is None:
        valid_mask = ~unknown_mask(gt)
    err = np.sqrt((flow[..., 0] - gt[..., 0]) ** 2 + (flow[..., 1] - gt[..., 1]) ** 2)
    valid = np.asarray(valid_mask, dtype=bool)
    if not valid.any():
        return float("nan")
    return float(err[valid].mean())


def angular_error(flow, gt, valid_mask: np.ndarray | None = None) -> float:
    """Mean angular error (degrees) of the space-time direction vectors
    (u, v, 1), per Barron et al. / Middlebury."""
    flow = _host(flow)
    gt = _host(gt)
    if valid_mask is None:
        valid_mask = ~unknown_mask(gt)
    num = flow[..., 0] * gt[..., 0] + flow[..., 1] * gt[..., 1] + 1.0
    den = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2 + 1.0) * np.sqrt(
        gt[..., 0] ** 2 + gt[..., 1] ** 2 + 1.0
    )
    cos = np.clip(num / den, -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    valid = np.asarray(valid_mask, dtype=bool)
    if not valid.any():
        return float("nan")
    return float(ang[valid].mean())


def hs_energy(i1, i2, flow, alpha: float = 1.0, deriv_variant: str = "hs_cube",
              axis_names=(), device=None) -> torch.Tensor:
    """The Horn-Schunck objective the Jacobi iteration minimizes [HS81 eq. 6]:

        E = mean( (Ex u + Ey v + Et)^2 ) + alpha^2 * mean( |grad u|^2 + |grad v|^2 )

    (forward-difference gradients), as a 0-d float32 tensor on the frames'
    device; over a (B, H, W) stack the means run over every pixel. Its
    monotone non-increase over sweeps is the convergence diagnostic. numpy
    frames go to `device` (cuda:0 when None), the flow to the frames'
    device. `axis_names` (sums across the shards of a mesh) comes with the
    rest of dist/ and raises NotImplementedError.
    """
    if axis_names:
        raise NotImplementedError(
            "axis_names= (sums across mesh shards) is not ported yet: it comes "
            "with the rest of dist/ (ROADMAP.md queue 1, item 6)"
        )
    i1 = as_frame(i1, device)
    ex, ey, et = stencils.derivatives(i1, as_frame(i2, i1.device), deriv_variant)
    u = as_frame(flow.u, i1.device)
    v = as_frame(flow.v, i1.device)

    data = ((ex * u + ey * v + et) ** 2).sum()

    def grad2(a):
        gx = stencils.shift_left_col(a) - a
        gy = stencils.shift_up_row(a) - a
        return (gx * gx + gy * gy).sum()

    n = torch.ones_like(u).sum()
    return (data + alpha * alpha * (grad2(u) + grad2(v))) / n


def interior(arr: np.ndarray, margin: int) -> np.ndarray:
    """Crop a margin off every spatial edge — used when comparing against
    analytic GT, whose boundary pixels are undefined under replicate padding."""
    if margin == 0:
        return arr
    return arr[..., margin:-margin, margin:-margin] if arr.ndim == 2 else arr[
        margin:-margin, margin:-margin, ...
    ]
