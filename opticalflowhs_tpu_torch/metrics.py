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
from opticalflowhs_tpu_torch.io.host import host_array
from opticalflowhs_tpu_torch.ops import stencils
from opticalflowhs_tpu_torch.solver import as_frame


def _host(a) -> np.ndarray:
    return np.asarray(host_array(a), dtype=np.float64)


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
    device.

    `axis_names`: i1, i2, flow.u and flow.v are `dist.reshard.Sharded`
    arrays of one layout, split over those mesh axes (every axis that
    splits them must be named). This is the port's form of the
    reference's call inside `shard_map`: each block takes a one-pixel halo
    from its neighbours (dist/halo.py), its derivatives and gradients are
    clamped at the true image edges by global coordinates, its sums run
    over its true pixels, and the sums are reduced onto the mesh's first
    device in float32, where E is returned. It equals the whole-image E up
    to the order of the float32 sums.
    """
    if axis_names:
        return _energy_sharded(i1, i2, flow, alpha, deriv_variant, axis_names)
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


def _energy_sharded(i1, i2, flow, alpha: float, deriv_variant: str,
                    axis_names) -> torch.Tensor:
    """hs_energy over `Sharded` frames and flow (see hs_energy)."""
    from opticalflowhs_tpu_torch.dist.reshard import check_sharded
    from opticalflowhs_tpu_torch.kernels import tile

    arrays = (i1, i2, flow.u, flow.v)
    check_sharded("hs_energy", arrays, axis_names, ("batch", "y", "x"))
    lay = i1.layout
    h, w = i1.shape[-2:]
    t = i1.shape[0] if i1.ndim == 3 else 1
    f1, f2, pu, pv = (lay.pad({c: b.float() for c, b in x.blocks.items()}, 1, 1)
                      for x in arrays)
    first = lay.mesh.first
    data = grads = n = torch.zeros((), dtype=torch.float32, device=first)
    for dev in lay.local:
        a, b, uu, vv = (x[dev].flatten(0, 1) for x in (f1, f2, pu, pv))
        rows, cols = lay.slice_origins(dev, -1, -1)
        masks = tile.tile_masks(a.shape, rows, cols, h, w, dev)
        ex, ey, et = stencils.derivatives_masked(a, b, masks, deriv_variant)
        gr, gc = tile.origin_grids(a.shape, rows, cols, dev)
        frame = torch.tensor([c[0] * lay.bl + k for c in lay.local[dev] for k in range(lay.bl)],
                             device=dev)
        own = ((gr < h) & (gc < w) & (frame < t)[:, None, None])[..., 1:-1, 1:-1]

        def crop(t):
            return t[..., 1:-1, 1:-1]

        def grad2(t):
            gx = torch.where(masks[3], t, stencils.shift_left_col(t)) - t
            gy = torch.where(masks[1], t, stencils.shift_up_row(t)) - t
            return torch.where(own, crop(gx * gx + gy * gy), 0.0).sum()

        r = (crop(ex) * crop(uu) + crop(ey) * crop(vv) + crop(et)) ** 2
        data = data + torch.where(own, r, 0.0).sum().to(first)
        grads = grads + (grad2(uu) + grad2(vv)).to(first)
        n = n + own.sum(dtype=torch.float32).to(first)
    return (data + alpha * alpha * grads) / n


def interior(arr: np.ndarray, margin: int) -> np.ndarray:
    """Crop a margin off every spatial edge — used when comparing against
    analytic GT, whose boundary pixels are undefined under replicate padding."""
    if margin == 0:
        return arr
    return arr[..., margin:-margin, margin:-margin] if arr.ndim == 2 else arr[
        margin:-margin, margin:-margin, ...
    ]
