"""Flow metrics (NumPy), mirroring opticalflowhs_tpu/metrics.py.

EPE: mean over valid pixels of sqrt((u-u_gt)^2 + (v-v_gt)^2); valid = not
marked unknown in the ground truth (|value| > 1e9, the Middlebury .flo
convention). Angular error follows Barron et al. 1994 as used by the
Middlebury evaluation. Torch tensors are accepted and copied to the host.
"""

from __future__ import annotations

import numpy as np

from opticalflowhs_tpu_torch.io.flo import unknown_mask


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


def interior(arr: np.ndarray, margin: int) -> np.ndarray:
    """Crop a margin off every spatial edge — used when comparing against
    analytic GT, whose boundary pixels are undefined under replicate padding."""
    if margin == 0:
        return arr
    return arr[..., margin:-margin, margin:-margin] if arr.ndim == 2 else arr[
        margin:-margin, margin:-margin, ...
    ]
