"""Flow visualization, mirroring opticalflowhs_tpu/viz.py.

Middlebury color-wheel encoding [Baker et al., IJCV 2011]: 55-bin wheel
with segment counts RY=15, YG=6, GC=4, CB=11, BM=13, MR=6; hue =
atan2(-v, -u)/pi mapped around the wheel; saturation scales with |flow| /
normalizer. Plus a needle (quiver) plot, the other classic HS demo output.
Renders run in NumPy on the host: flows and backgrounds may be numpy
arrays or torch tensors on any device (a tensor is copied to the host),
and the images are the reference's bitwise.
"""

from __future__ import annotations

import numpy as np

from opticalflowhs_tpu_torch.io.host import host_array

_SEGMENTS = (("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11), ("BM", 13), ("MR", 6))
NCOLS = sum(n for _, n in _SEGMENTS)  # 55


def make_color_wheel() -> np.ndarray:
    """(55, 3) uint8-valued float array of wheel colors, Middlebury layout."""
    wheel = np.zeros((NCOLS, 3))
    col = 0
    ry, yg, gc, cb, bm, mr = (n for _, n in _SEGMENTS)
    # RY: red -> yellow
    wheel[col : col + ry, 0] = 255
    wheel[col : col + ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    # YG: yellow -> green
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    # GC: green -> cyan
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    # CB: cyan -> blue
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    # BM: blue -> magenta
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    # MR: magenta -> red
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


_WHEEL = make_color_wheel()


def _host(a) -> np.ndarray:
    """A numpy view of an array, or a torch tensor's values on the host
    (bfloat16 widened to float32, `io.host.host_array`)."""
    return host_array(a)


def flow_to_color(
    flow: np.ndarray, max_flow: float | None = None, unknown_black: bool = True
) -> np.ndarray:
    """Render (H, W, 2) flow to an (H, W, 3) uint8 Middlebury color image."""
    flow = np.asarray(_host(flow), dtype=np.float64)
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    unknown = (np.abs(u) > 1e9) | (np.abs(v) > 1e9) | ~np.isfinite(u) | ~np.isfinite(v)
    u[unknown] = 0.0
    v[unknown] = 0.0

    rad = np.sqrt(u * u + v * v)
    norm = float(max_flow) if max_flow else max(float(rad.max()), 1e-9)
    u, v, rad = u / norm, v / norm, np.minimum(rad / norm, 1.0)

    angle = np.arctan2(-v, -u) / np.pi              # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (NCOLS - 1)          # [0, NCOLS-1]
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % NCOLS
    f = fk - k0

    img = np.zeros(flow.shape[:2] + (3,), dtype=np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        # Saturate toward white at small radii (Middlebury convention).
        col = 1 - rad * (1 - col)
        if unknown_black:
            col[unknown] = 0.0
        img[..., c] = np.floor(255.0 * col).astype(np.uint8)
    return img


def needle_plot(
    flow: np.ndarray,
    step: int = 16,
    scale: float = 1.0,
    background: np.ndarray | None = None,
) -> np.ndarray:
    """Sparse needle/quiver rendering of (H, W, 2) flow onto an RGB image.

    Pure-NumPy Bresenham lines — no plotting dependency.
    """
    flow = np.asarray(_host(flow), dtype=np.float64)
    h, w = flow.shape[:2]
    if background is None:
        img = np.full((h, w, 3), 255, dtype=np.uint8)
    else:
        bg = _host(background)
        if bg.dtype != np.uint8:
            bg = np.clip(bg * 255.0, 0, 255).astype(np.uint8)
        img = np.stack([bg] * 3, axis=-1) if bg.ndim == 2 else bg.copy()

    def draw_line(y0, x0, y1, x1):
        n = int(max(abs(y1 - y0), abs(x1 - x0), 1))
        ys = np.linspace(y0, y1, n + 1).round().astype(int)
        xs = np.linspace(x0, x1, n + 1).round().astype(int)
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[ok], xs[ok]] = (200, 0, 0)

    for y in range(step // 2, h, step):
        for x in range(step // 2, w, step):
            du, dv = flow[y, x]
            draw_line(y, x, y + dv * scale, x + du * scale)
            img[max(y - 1, 0) : y + 1, max(x - 1, 0) : x + 1] = (0, 0, 0)
    return img
