"""Frame-to-frame ego-motion from dense flow, mirroring
opticalflowhs_tpu/egomotion.py (the SLAM front end fed by the streams).

Fits the 4-parameter 2-D rigid+zoom motion model to a dense flow field by
least squares,

    u(x, y) = tx + s*(x - cx) - w*(y - cy)
    v(x, y) = ty + s*(y - cy) + w*(x - cx)

(tx, ty: translation in px a frame; w: roll rate in rad a frame; s: zoom
rate, the signature of forward ego-translation). In coordinates centred at
their centroid the normal equations decouple into closed-form moment
ratios: a few sums over the field, computed on the flow's device.

Focus of expansion: the fixed point of the model, center - (tx, ty)/s.

bfloat16 flows (the storage rule of ROADMAP.md queue 3): the fit runs in
float32 on the widened flow, and tx and ty, which the reference returns in
the flow's dtype, are rounded once to it where they are stored; the
residual's model and the `center` reparametrisation read the stored
values, and the latter follows the reference's promotions (bfloat16 tx
plus float32 terms: float32). omega, scale and the residual stay float32,
as in the reference. The pixel count n is exact here; the reference's
bfloat16 sum of ones is not on large frames (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from opticalflowhs_tpu_torch.solver import Flow, as_frame


class EgoMotion(NamedTuple):
    tx: torch.Tensor        # mean horizontal translation (px/frame)
    ty: torch.Tensor        # mean vertical translation (px/frame)
    omega: torch.Tensor     # roll rate about the optical axis (rad/frame)
    scale: torch.Tensor     # zoom/expansion rate (1/frame); > 0 = approaching
    residual: torch.Tensor  # RMS model residual (px/frame)

    def focus_of_expansion(self, eps: float = 1e-8):
        """(x, y) image point the flow expands from, relative to the center
        used in the fit; meaningful when |scale| is well above noise."""
        return (-self.tx / (self.scale + eps), -self.ty / (self.scale + eps))


def estimate_egomotion(
    flow: Flow,
    center: Optional[tuple[float, float]] = None,
    axis_names: Sequence[str] = (),
    global_offset=None,
    device=None,
) -> EgoMotion:
    """Least-squares 4-parameter ego-motion fit to a dense flow field.

    `center`: reference point for the reported (tx, ty) and the FOE; the
    fit itself always runs in centroid-centred coordinates, and (tx, ty)
    are reparametrised to `center` afterwards (exact: the model is affine
    in the center). `global_offset`: (row0, col0) added to the pixel
    coordinates, as for a tile of a larger image. Works on (H, W) fields or
    any leading batch axes (the sums run over the last two axes), on the
    flow's device; numpy flows go to `device` (cuda:0 when None).
    `axis_names` (sums across the shards of a mesh) comes with the rest of
    dist/ and raises NotImplementedError.
    """
    if axis_names:
        raise NotImplementedError(
            "axis_names= (sums across mesh shards) is not ported yet: it comes "
            "with the rest of dist/ (ROADMAP.md queue 1, item 6)"
        )
    bf16 = isinstance(flow.u, torch.Tensor) and flow.u.dtype == torch.bfloat16
    u = as_frame(flow.u, device)
    v = as_frame(flow.v, u.device)
    h, w = u.shape[-2], u.shape[-1]
    yy = torch.arange(h, dtype=torch.float32, device=u.device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=u.device)[None, :].expand(h, w)
    if global_offset is not None:
        yy = yy + global_offset[0]
        xx = xx + global_offset[1]

    def total(a):
        return a.sum(dim=(-2, -1))

    def b(a):
        return a[..., None, None]

    n = total(torch.ones_like(u))
    # The decoupled moment ratios below are the least-squares solution only
    # when sum(xb) == sum(yb) == 0, so the fit runs centred at the centroid.
    cx = total(xx.expand(u.shape)) / n
    cy = total(yy.expand(u.shape)) / n
    xb = xx - b(cx)
    yb = yy - b(cy)

    tx = total(u) / n
    ty = total(v) / n
    if bf16:
        tx, ty = tx.to(torch.bfloat16), ty.to(torch.bfloat16)
    r2 = total(xb * xb + yb * yb)
    s = total(u * xb + v * yb) / r2
    omega = total(v * xb - u * yb) / r2

    um = b(tx.float()) + b(s) * xb - b(omega) * yb
    vm = b(ty.float()) + b(s) * yb + b(omega) * xb
    residual = torch.sqrt(total((u - um) ** 2 + (v - vm) ** 2) / n)
    if center is not None:
        # u = tx + s(x-cx) - w(y-cy) = tx' + s(x-cx') - w(y-cy') with
        # tx' = tx + s(cx'-cx) - w(cy'-cy) (and the rotated analog for ty).
        dx = float(center[0]) - cx
        dy = float(center[1]) - cy
        tx, ty = tx.float() + s * dx - omega * dy, ty.float() + s * dy + omega * dx
    return EgoMotion(tx, ty, omega, s, residual)
