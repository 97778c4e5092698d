"""Synthetic frame pairs with analytic ground-truth flow.

NumPy-only copy of opticalflowhs_tpu/data/synthetic.py, bitwise equal to it
(importing the reference would load JAX). Frame pairs are exact analytic
samples of a band-limited texture (a sum of random-frequency sinusoids from
numpy default_rng(key)) under a known warp, so the true flow is closed-form
with zero interpolation error.

Conventions: the pattern at frame-1 position p moves to T(p) in frame 2, so
I2(p) = I1(T^{-1}(p)) and GT flow(p) = T(p) - p, with u = x/column
displacement and v = y/row displacement.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class WarpSpec:
    """2x2 linear part A and translation t of the motion p -> A(p-c)+c+t,
    with c the image center. Positions are (x, y) = (col, row)."""

    a: tuple[tuple[float, float], tuple[float, float]] = ((1.0, 0.0), (0.0, 1.0))
    t: tuple[float, float] = (0.0, 0.0)

    @staticmethod
    def translation(tx: float, ty: float) -> "WarpSpec":
        return WarpSpec(t=(tx, ty))

    @staticmethod
    def rotation(degrees: float) -> "WarpSpec":
        r = np.radians(degrees)
        c, s = float(np.cos(r)), float(np.sin(r))
        return WarpSpec(a=((c, -s), (s, c)))

    @staticmethod
    def zoom(factor: float) -> "WarpSpec":
        return WarpSpec(a=((factor, 0.0), (0.0, factor)))


def _texture_params(key: int, n_waves: int, max_freq: float):
    rng = np.random.default_rng(key)
    angles = rng.uniform(0.0, 2 * np.pi, n_waves)
    freqs = rng.uniform(0.02, max_freq, n_waves)
    kx = freqs * np.cos(angles)
    ky = freqs * np.sin(angles)
    phases = rng.uniform(0.0, 2 * np.pi, n_waves)
    amps = rng.uniform(0.5, 1.0, n_waves) / np.sqrt(n_waves)
    return kx, ky, phases, amps


def _sample_texture(xs, ys, kx, ky, phases, amps) -> np.ndarray:
    """Evaluate the sinusoid texture at float positions xs, ys (same shape)."""
    val = np.zeros_like(xs, dtype=np.float64)
    for a, fx, fy, ph in zip(amps, kx, ky, phases):
        val += a * np.sin(2 * np.pi * (fx * xs + fy * ys) + ph)
    # Map from roughly [-1, 1] into [0.1, 0.9] grayscale.
    return (0.5 + 0.4 * np.tanh(val)).astype(np.float64)


def synthetic_pair(
    height: int,
    width: int,
    warp: WarpSpec,
    key: int = 0,
    n_waves: int = 12,
    max_freq: float = 0.15,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (I1, I2, gt_flow) — float32 frames in [0,1], (H, W, 2) GT flow.

    max_freq is in cycles/pixel; keep well under 0.5 (Nyquist) so the
    brightness-constancy linearization that HS relies on holds.
    """
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    kxp, kyp, phases, amps = _texture_params(key, n_waves, max_freq)

    i1 = _sample_texture(xs, ys, kxp, kyp, phases, amps)

    a = np.asarray(warp.a, dtype=np.float64)
    t = np.asarray(warp.t, dtype=np.float64)
    # GT flow: T(p) - p, T(p) = A(p - c) + c + t with p = (x, y).
    dx = xs - cx
    dy = ys - cy
    tx = a[0, 0] * dx + a[0, 1] * dy + cx + t[0]
    ty = a[1, 0] * dx + a[1, 1] * dy + cy + t[1]
    gt = np.stack([tx - xs, ty - ys], axis=-1)

    # I2(p) = I1(T^{-1}(p)): sample the analytic texture at inverse-warped pos.
    ainv = np.linalg.inv(a)
    qx = xs - cx - t[0]
    qy = ys - cy - t[1]
    sx = ainv[0, 0] * qx + ainv[0, 1] * qy + cx
    sy = ainv[1, 0] * qx + ainv[1, 1] * qy + cy
    i2 = _sample_texture(sx, sy, kxp, kyp, phases, amps)

    return i1.astype(np.float32), i2.astype(np.float32), gt.astype(np.float32)


def translation_pair(
    height: int, width: int, tx: float, ty: float, key: int = 0, **kw
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frame pair under uniform translation (tx, ty) px with constant GT flow."""
    return synthetic_pair(height, width, WarpSpec.translation(tx, ty), key=key, **kw)


def two_motion_pair(
    height: int,
    width: int,
    t_left: tuple[float, float],
    t_right: tuple[float, float],
    key: int = 0,
    n_waves: int = 12,
    max_freq: float = 0.15,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frame pair with a MOTION DISCONTINUITY: two independently translating
    texture layers seen through a static vertical-split aperture (left half
    moves t_left px, right half t_right). Because the aperture is fixed,
    every pixel observes its own layer in both frames — the true flow is
    exactly piecewise constant with a hard jump at the seam and no
    occlusion ambiguity. This is the canonical stress case for quadratic
    (HS) smoothness, which blurs the jump; robust penalties keep it sharp.
    """
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    pa = _texture_params(key, n_waves, max_freq)
    pb = _texture_params(key + 1000003, n_waves, max_freq)
    mask = xs < (width / 2.0)

    def frame(k):
        la = _sample_texture(xs - k * t_left[0], ys - k * t_left[1], *pa)
        lb = _sample_texture(xs - k * t_right[0], ys - k * t_right[1], *pb)
        return np.where(mask, la, lb)

    gt = np.where(
        mask[..., None],
        np.asarray(t_left, dtype=np.float64),
        np.asarray(t_right, dtype=np.float64),
    )
    return (
        frame(0).astype(np.float32),
        frame(1).astype(np.float32),
        gt.astype(np.float32),
    )


def synthetic_sequence(
    n_frames: int,
    height: int,
    width: int,
    tx: float = 1.0,
    ty: float = 0.0,
    key: int = 0,
    n_waves: int = 12,
    max_freq: float = 0.15,
) -> tuple[np.ndarray, np.ndarray]:
    """A (T, H, W) video of a texture translating (tx, ty) px/frame, plus the
    constant (2,) GT flow. Used by the batched/streaming configs 2 and 4."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    kxp, kyp, phases, amps = _texture_params(key, n_waves, max_freq)
    frames = np.stack(
        [
            _sample_texture(xs - k * tx, ys - k * ty, kxp, kyp, phases, amps)
            for k in range(n_frames)
        ]
    ).astype(np.float32)
    return frames, np.array([tx, ty], dtype=np.float32)
