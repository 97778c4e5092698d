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


class _Part(NamedTuple):
    """One piece of the field: u, v (float32), its pixel coordinates, the
    mask of its true pixels (None: all), and which images of the result it
    feeds (None: the whole field)."""

    u: torch.Tensor
    v: torch.Tensor
    yy: torch.Tensor
    xx: torch.Tensor
    mask: Optional[torch.Tensor]
    sel: Optional[slice]


def _coords(h: int, w: int, r0: float, c0: float, dev) -> tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    if r0 or c0:
        yy, xx = yy + r0, xx + c0
    return yy, xx


def _parts(flow: Flow, axis_names, global_offset, device) -> tuple[list, torch.device, tuple,
                                                                   object]:
    """The field's parts (this process's blocks of a sharded field), the
    device the sums meet on, the shape of the result's leading axes, and
    the sharded field's layout (None for a whole field)."""
    r0, c0 = global_offset if global_offset is not None else (0, 0)
    if not axis_names:
        u = as_frame(flow.u, device)
        v = as_frame(flow.v, u.device)
        yy, xx = _coords(u.shape[-2], u.shape[-1], r0, c0, u.device)
        return [_Part(u, v, yy, xx, None, None)], u.device, None, None
    from opticalflowhs_tpu_torch.dist.reshard import check_sharded

    fu, fv = flow.u, flow.v
    check_sharded("estimate_egomotion", (fu, fv), axis_names, ("y", "x"))
    lay = fu.layout
    h, w = fu.shape[-2:]
    parts = []
    for c in lay.mine:
        _, gr, gc = fu.offset(c)
        dev = fu.blocks[c].device
        yy, xx = _coords(lay.th, lay.tw, gr + r0, gc + c0, dev)
        rows = torch.arange(lay.th, device=dev)[:, None] + gr < h
        cols = torch.arange(lay.tw, device=dev)[None, :] + gc < w
        parts.append(_Part(fu.blocks[c].float(), fv.blocks[c].float(), yy, xx, rows & cols,
                           slice(c[0] * lay.bl, (c[0] + 1) * lay.bl)))
    return parts, lay.mesh.first, fu.shape[:-2], lay


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

    `axis_names`: the flow's u and v are `dist.reshard.Sharded` fields
    split over those mesh axes ("y", "x"; every axis that splits them must
    be named). This is the port's form of the reference's call inside
    `shard_map`: each block's sums are taken on its device with its global
    offset, over its true pixels, and reduced over the named axes onto the
    mesh's first device in float32, where the estimate is returned (one a
    frame of a time-split stack). It equals the whole-field estimate up to
    the order of the float32 sums. On a mesh that spans processes each
    process sums its own blocks and the partial sums are added in rank
    order (`dist.transport.sum_over_processes`), so every process returns
    the same estimate.
    """
    bf16 = getattr(flow.u, "dtype", None) is torch.bfloat16
    parts, out, lead, lay = _parts(flow, axis_names, global_offset, device)

    def total(fn):
        if lead is None:
            return fn(parts[0]).sum(dim=(-2, -1))
        # One sum a frame of each group, over its blocks in coordinate order.
        res = torch.zeros(lay.groups * lay.bl, dtype=torch.float32, device=out)
        for p in parts:
            res[p.sel] = res[p.sel] + torch.where(p.mask, fn(p), 0.0).sum(dim=(-2, -1)).to(out)
        if lay.mesh.collective:
            from opticalflowhs_tpu_torch.dist import transport

            res = transport.sum_over_processes(res)
        return res[0] if len(lead) == 0 else res[:lead[0]]

    def b(a, p):
        if p.sel is not None:  # this block's frames, on its device
            a = (a.reshape(-1) if a.ndim else a.reshape(1))
            a = torch.nn.functional.pad(a, (0, max(0, p.sel.stop - a.numel())))[p.sel]
            a = a.to(p.u.device)
        return a[..., None, None]

    n = total(lambda p: torch.ones_like(p.u))
    # The decoupled moment ratios below are the least-squares solution only
    # when sum(xb) == sum(yb) == 0, so the fit runs centred at the centroid.
    cx = total(lambda p: p.xx.expand(p.u.shape)) / n
    cy = total(lambda p: p.yy.expand(p.u.shape)) / n
    # From here on each part's coordinates are the centred xb, yb.
    parts = [p._replace(xx=p.xx - b(cx, p), yy=p.yy - b(cy, p)) for p in parts]

    tx = total(lambda p: p.u) / n
    ty = total(lambda p: p.v) / n
    if bf16:
        tx, ty = tx.to(torch.bfloat16), ty.to(torch.bfloat16)
    r2 = total(lambda p: p.xx * p.xx + p.yy * p.yy)
    s = total(lambda p: p.u * p.xx + p.v * p.yy) / r2
    omega = total(lambda p: p.v * p.xx - p.u * p.yy) / r2

    def resid(p):
        um = b(tx.float(), p) + b(s, p) * p.xx - b(omega, p) * p.yy
        vm = b(ty.float(), p) + b(s, p) * p.yy + b(omega, p) * p.xx
        return (p.u - um) ** 2 + (p.v - vm) ** 2

    residual = torch.sqrt(total(resid) / n)
    if center is not None:
        # u = tx + s(x-cx) - w(y-cy) = tx' + s(x-cx') - w(y-cy') with
        # tx' = tx + s(cx'-cx) - w(cy'-cy) (and the rotated analog for ty).
        dx = float(center[0]) - cx
        dy = float(center[1]) - cy
        tx, ty = tx.float() + s * dx - omega * dy, ty.float() + s * dy + omega * dx
    return EgoMotion(tx, ty, omega, s, residual)
