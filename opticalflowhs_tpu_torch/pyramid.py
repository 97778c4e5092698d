"""Coarse-to-fine pyramid and bilinear warping, mirroring opticalflowhs_tpu/pyramid.py.

Downsample by a separable 5-tap binomial blur [1,4,6,4,1]/16 and a 2x
subsample; from coarsest to finest: solve HS, upsample the flow bilinearly
to the next level (values scaled by the size ratio), backward-warp frame 2
by it, solve HS on (I1, warped I2) for the residual and add.

These are plain PyTorch ops, as they are XLA (not Pallas) in the reference;
every level's solve goes through `solver.solve_level`, so on CUDA frames
each level runs the K1/K2 kernels.

The warp keeps the reference's values exactly. Its default ("auto" =
"tiled") is the TPU's tiled warp: each 32x128 tile fetches one block at its
rounded-mean integer displacement and reaches at most R = 4 px around it,
so where a tile's displacement deviates more than R from that mean the
sample position clamps. Here that is one gather whose integer sample row is
yy + byt + clamp(dy - byt, -R, R), clamped to the image (likewise for
columns), which equals the reference in every regime.

Gradients reach the frames through the warps, the resampling and each
level's `solve_level` (kernels/autodiff.py on the cuda backend).

bfloat16 (HSConfig.dtype): the frames are cast before the pyramid is
built, and every level, upsampled flow, warped frame and sum of flows is
computed in float32 from the widened arrays and rounded once where it is
stored (`stencils.store`). A warp's result has its image's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from opticalflowhs_tpu_torch.config import HSConfig, PyramidConfig
from opticalflowhs_tpu_torch.ops.stencils import (
    shift_down_row,
    shift_left_col,
    shift_right_col,
    shift_up_row,
    store,
)
from opticalflowhs_tpu_torch.solver import (
    Flow,
    as_frame,
    check_supported,
    resolve_omega,
    solve_level,
    storage_dtype,
)

_B5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """Blur + 2x subsample per axis. Output size is ceil(size / 2)."""
    return store(_downsample2x, img)


def _downsample2x(img: torch.Tensor) -> torch.Tensor:
    r1 = shift_down_row(img)        # i-1
    r2 = shift_down_row(r1)         # i-2
    r3 = shift_up_row(img)          # i+1
    r4 = shift_up_row(r3)           # i+2
    v = _B5[2] * img + _B5[1] * (r1 + r3) + _B5[0] * (r2 + r4)
    v = v[..., ::2, :]
    c1 = shift_right_col(v)
    c2 = shift_right_col(c1)
    c3 = shift_left_col(v)
    c4 = shift_left_col(c3)
    h = _B5[2] * v + _B5[1] * (c1 + c3) + _B5[0] * (c2 + c4)
    return h[..., :, ::2].contiguous()


def gaussian_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[finest, ..., coarsest] — levels entries; level 0 is the input."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2x(pyr[-1]))
    return pyr


# -- flow upsampling and backward warp ----------------------------------------


def _linear_taps(n_in: int, n_out: int, device):
    """The two input taps and weights of each output sample of
    jax.image.resize(method="linear") upsampling along one axis: half-pixel
    centres, scale = n_out / n_in, triangle weights renormalised by their
    sum (so the edges replicate), in float32 as the reference computes
    them. Upsampling only: the triangle then touches at most two inputs.
    Built on `device`, so no host-to-device copy stalls the stream."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)  # rounded to float32 by the multiply
    sf = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    i0 = torch.floor(sf).clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    w0 = torch.clamp(1 - torch.abs(sf - i0), min=0)
    w1 = torch.where(i1 != i0, torch.clamp(1 - torch.abs(sf - i1), min=0), 0.0)
    total = w0 + w1
    ok = torch.abs(total) > 1000.0 * torch.finfo(f32).eps
    safe = torch.where(total != 0, total, 1.0)
    keep = ok & (sf >= -0.5) & (sf <= n_in - 0.5)
    w0 = torch.where(keep, w0 / safe, 0.0)
    w1 = torch.where(keep, w1 / safe, 0.0)
    return i0.long(), i1.long(), w0, w1


def upsample_flow(flow: Flow, shape: tuple[int, int]) -> Flow:
    """Bilinearly resize flow to `shape` (upsampling; an axis of equal size
    is left as it is), scaling values by the size ratio per axis."""
    h0, w0 = flow.u.shape[-2:]
    h1, w1 = shape
    if h1 < h0 or w1 < w0:
        raise NotImplementedError("upsample_flow only enlarges a flow")
    return Flow(*store(lambda u, v: _upsample(u, v, h1, w1), flow.u, flow.v))


def _upsample(u, v, h1: int, w1: int):
    h0, w0 = u.shape[-2:]
    if h1 != h0:
        i0, i1, wa, wb = _linear_taps(h0, h1, u.device)
        wa, wb = wa[:, None], wb[:, None]
        u = u[..., i0, :] * wa + u[..., i1, :] * wb
        v = v[..., i0, :] * wa + v[..., i1, :] * wb
    if w1 != w0:
        i0, i1, wa, wb = _linear_taps(w0, w1, u.device)
        u = u[..., :, i0] * wa + u[..., :, i1] * wb
        v = v[..., :, i0] * wa + v[..., :, i1] * wb
    return (u * (w1 / w0)).contiguous(), (v * (h1 / h0)).contiguous()


def add_flows(a: Flow, b: Flow) -> Flow:
    """a + b, componentwise (a bfloat16 sum rounded once)."""
    return Flow(*store(lambda au, av, bu, bv: (au + bu, av + bv), a.u, a.v, b.u, b.v))


def _grid(h: int, w: int, device):
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return yy, xx


def _bilinear(img, y0, y1, x0, x1, wy, wx):
    """Blend the four integer taps exactly as the reference does. img is
    (..., H, W); the indices are (H, W), one flow shared by every image, or
    of img's shape, a flow per image (the reference's `gather`)."""
    h, w = img.shape[-2:]
    flat = img.reshape(img.shape[:-2] + (h * w,))

    def tap(yi, xi):
        idx = yi * w + xi
        if idx.ndim == 2:
            return flat[..., idx.reshape(-1)].reshape(img.shape)
        idx = idx.expand(img.shape).reshape(flat.shape)
        return torch.gather(flat, -1, idx).reshape(img.shape)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def warp_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Backward warp: out(y, x) = img(y + v(y,x), x + u(y,x)), bilinear,
    sample positions clamped to the image. img is (..., H, W); u and v are
    (H, W), shared by every image, or one flow per image."""
    return store(_warp_gather, img, u, v)


def _warp_gather(img, u, v):
    h, w = img.shape[-2:]
    yy, xx = _grid(h, w, img.device)
    sy = torch.clamp(yy + v.float(), 0.0, h - 1.0)
    sx = torch.clamp(xx + u.float(), 0.0, w - 1.0)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    return _bilinear(img, y0i, y1i, x0i, x1i, sy - y0, sx - x0)


# Tile geometry and select half-width of the reference's tiled warp.
_WARP_TH, _WARP_TW, _WARP_R = 32, 128, 4
_E_MARGIN = 64  # positions are clipped to [-E, size-1+E]


def _tile_offsets(h: int, w: int, u: torch.Tensor, v: torch.Tensor):
    """Clipped sample positions, their integer parts and the per-pixel
    rounded mean integer displacement of the pixel's 32x128 tile (tiles
    edge-padded, means rounded half to even, as the reference), for (H, W)
    or (..., H, W) flows; each image has its own tile means."""
    yy, xx = _grid(h, w, u.device)
    sy = torch.clamp(yy + v.float(), -float(_E_MARGIN), h - 1.0 + _E_MARGIN)
    sx = torch.clamp(xx + u.float(), -float(_E_MARGIN), w - 1.0 + _E_MARGIN)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    dy = y0 - yy
    dx = x0 - xx
    th, tw = _WARP_TH, _WARP_TW
    nh, nw = -(-h // th), -(-w // tw)

    def tile_mean(d):
        # Edge-pad each image to whole tiles; the sums of integer-valued
        # floats are exact, and so is the division by the power-of-two
        # tile size.
        p = torch.nn.functional.pad(
            d.reshape(-1, 1, h, w), (0, nw * tw - w, 0, nh * th - h),
            mode="replicate",
        )
        m = torch.round(p.reshape(-1, nh, th, nw, tw).sum(dim=(2, 4)) / (th * tw))
        m = m.repeat_interleave(th, -2)[..., :h, :].repeat_interleave(tw, -1)
        return m[..., :w].reshape(d.shape)

    return sy, sx, y0, x0, dy, dx, tile_mean(dy), tile_mean(dx)


def warp_bilinear_tiled(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        radius: int = _WARP_R) -> torch.Tensor:
    """The reference's tiled warp, in value: bilinear sampling at positions
    clipped to [-64, size-1+64], whose integer part deviates from the
    tile's rounded mean displacement by at most R (clamped beyond), read
    from the edge-replicated image. radius=0 is the reference's auto mode,
    R = 4 in value.

    On a (B, H, W) stack with a flow per image this is the reference's
    `jax.vmap(warp_bilinear_tiled)`: each image gets its own tile means."""
    return store(lambda a, b, c: _warp_tiled(a, b, c, radius), img, u, v)


def _warp_tiled(img, u, v, radius: int):
    h, w = img.shape[-2:]
    r = float(radius if radius > 0 else _WARP_R)
    sy, sx, y0, x0, dy, dx, byt, bxt = _tile_offsets(h, w, u, v)
    yy, xx = _grid(h, w, img.device)
    ry = yy + byt + torch.clamp(dy - byt, -r, r)
    rx = xx + bxt + torch.clamp(dx - bxt, -r, r)
    y0i = torch.clamp(ry, 0, h - 1).long()
    y1i = torch.clamp(ry + 1, 0, h - 1).long()
    x0i = torch.clamp(rx, 0, w - 1).long()
    x1i = torch.clamp(rx + 1, 0, w - 1).long()
    return _bilinear(img, y0i, y1i, x0i, x1i, sy - y0, sx - x0)


def tile_deviation(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Max |integer displacement - its tile's rounded mean|: a 0-d tensor
    for an (H, W) flow, one value per image for a (B, H, W) stack."""
    h, w = u.shape[-2:]
    _, _, _, _, dy, dx, byt, bxt = _tile_offsets(h, w, u, v)
    return torch.maximum(torch.abs(dy - byt).amax(dim=(-2, -1)),
                         torch.abs(dx - bxt).amax(dim=(-2, -1)))


def _rung(dev: float) -> int:
    """The exactness ladder's rung at deviation `dev`: 0 the tiled warp at
    R = 4, 1 at R = 8, 2 the gather."""
    return 0 if dev <= float(_WARP_R) else 1 if dev <= 8.0 else 2


def _warp_rung(img, u, v, rung: int) -> torch.Tensor:
    if rung == 2:
        return warp_bilinear(img, u, v)
    return warp_bilinear_tiled(img, u, v, _WARP_R if rung == 0 else 8)


def warp_bilinear_checked(img: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The reference's exactness ladder: the tiled warp at R = 4 while the
    per-tile deviation is <= 4, at R = 8 while it is <= 8, else the gather.

    A (B, H, W) stack with a flow per image is the reference's vmapped
    ladder: each image takes the rung of its own deviation, and the images
    of one rung are warped together. Reading the deviations synchronises
    with the device once, for one image or a stack."""
    rungs = [_rung(d) for d in tile_deviation(u, v).reshape(-1).tolist()]
    if len(set(rungs)) == 1:
        return _warp_rung(img, u, v, rungs[0])
    out = torch.empty_like(img)
    for rung in set(rungs):
        idx = torch.tensor([k for k, r in enumerate(rungs) if r == rung],
                           device=img.device)
        out[idx] = _warp_rung(img[idx], u[idx], v[idx], rung)
    return out


def warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
         method: str = "auto", radius: int = _WARP_R) -> torch.Tensor:
    """Dispatch: "tiled"/"auto" (the reference's tiled warp, R = radius or
    4 for 0), "gather" (plain bilinear), "checked" (tiled while exact, else
    gather)."""
    if method == "gather" or img.ndim != 2:
        return warp_bilinear(img, u, v)
    if method == "checked":
        return warp_bilinear_checked(img, u, v)
    return warp_bilinear_tiled(img, u, v, radius)


def warp_each(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              method: str = "auto", radius: int = _WARP_R) -> torch.Tensor:
    """`warp`'s rule applied to each image of a (B, H, W) stack with its own
    flow, as the reference's vmap of the single-pair warp: each image takes
    its own tile means and its own rung of the checked ladder (one host sync
    for the whole stack). On an (H, W) image it is `warp`."""
    if method == "gather":
        return warp_bilinear(img, u, v)
    if method == "checked":
        return warp_bilinear_checked(img, u, v)
    return warp_bilinear_tiled(img, u, v, radius)


# -- coarse-to-fine driver -----------------------------------------------------


def hs_pyramid(
    i1: torch.Tensor,
    i2: torch.Tensor,
    cfg: HSConfig = HSConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    device=None,
) -> Flow:
    """Coarse-to-fine pyramidal Horn-Schunck of an (H, W) pair. With
    pyr.levels == 1 this is exactly hs_solve. numpy frames go to `device`,
    as in hs_solve. SOR's omega == 0 is tuned once, on the full-resolution
    pair (coarser levels are better conditioned)."""
    if i1.shape != i2.shape:
        raise ValueError(f"frame shapes differ: {tuple(i1.shape)} vs "
                         f"{tuple(i2.shape)}")
    min_side = min(i1.shape[-2:])
    if min_side // (2 ** (pyr.levels - 1)) < 8:
        raise ValueError(
            f"{pyr.levels} levels would shrink a {tuple(i1.shape[-2:])} frame "
            "below 8 px"
        )
    check_supported(cfg)
    i1 = as_frame(i1, device, storage_dtype(cfg))
    i2 = as_frame(i2, i1.device, storage_dtype(cfg))
    cfg = resolve_omega(i1, i2, cfg)
    p1 = gaussian_pyramid(i1, pyr.levels)
    p2 = gaussian_pyramid(i2, pyr.levels)
    iters: Sequence[int] = pyr.iters_per_level or (cfg.iters,) * pyr.levels

    flow: Optional[Flow] = None
    for level in range(pyr.levels - 1, -1, -1):
        f1, f2 = p1[level], p2[level]
        if flow is None:
            f2w = f2
        else:
            flow = upsample_flow(flow, f1.shape[-2:])
            f2w = warp(f2, flow.u, flow.v, pyr.warp, pyr.warp_radius)
        dflow = solve_level(f1, f2w, cfg, iters[level])
        flow = dflow if flow is None else add_flows(flow, dflow)
    return flow
