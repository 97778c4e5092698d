"""KITTI optical-flow PNG format, mirroring opticalflowhs_tpu/io/kitti.py.

KITTI 2012/2015 store flow ground truth and submissions as 48-bit RGB
PNGs (devkit `flow_read.m`/`flow_write.m`): for each pixel,

    u = (R - 2^15) / 64      v = (G - 2^15) / 64      valid = B > 0

with all three channels uint16. Invalid pixels carry u = v = 0 by
convention. This gives a [-512, 512] px range at 1/64 px resolution.

Decode prefers the native OpenCV path in libhsio (fast, threaded-loader
compatible); the pure-numpy `io.png16` codec is the always-available
fallback and the test oracle for the native path.
"""

from __future__ import annotations

import os

import numpy as np

from opticalflowhs_tpu_torch.io.host import host_array

_OFFSET = 2**15
_SCALE = 64.0
_MAX_ABS = (_OFFSET - 1) / _SCALE  # ±511.98 px representable


def read_flow_png(path: str | os.PathLike):
    """Read a KITTI flow PNG -> ((H, W, 2) float32 flow, (H, W) bool valid)."""
    from opticalflowhs_tpu_torch.io import native

    img = None
    if native.available():
        img = native.read_png16(str(path))
    if img is None:
        from opticalflowhs_tpu_torch.io import png16

        img = png16.read_png(path)
    if img.ndim != 3 or img.shape[2] < 3 or img.dtype != np.uint16:
        raise ValueError(
            f"{path}: KITTI flow PNGs are 16-bit 3-channel, got "
            f"{img.dtype} {img.shape}"
        )
    flow = (img[..., :2].astype(np.float32) - _OFFSET) / _SCALE
    valid = img[..., 2] > 0
    flow[~valid] = 0.0
    return flow, valid


def write_flow_png(
    path: str | os.PathLike, flow: np.ndarray, valid: np.ndarray | None = None
) -> None:
    """Write (H, W, 2) flow (+ optional (H, W) valid mask) as a KITTI PNG.

    Flow values beyond the format's ±512 px range are clipped (the devkit
    encoder overflows silently; clipping is the safer contract).
    """
    flow = np.asarray(host_array(flow), dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"expected (H, W, 2) flow, got {flow.shape}")
    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), bool)
    else:
        valid = np.asarray(valid, dtype=bool)
        if valid.shape != (h, w):
            raise ValueError(f"valid mask {valid.shape} != flow {(h, w)}")
    img = np.zeros((h, w, 3), np.uint16)
    q = np.clip(flow, -_MAX_ABS, _MAX_ABS) * _SCALE + _OFFSET
    img[..., :2] = np.where(valid[..., None], np.round(q), 0).astype(np.uint16)
    img[..., 2] = valid.astype(np.uint16)

    from opticalflowhs_tpu_torch.io import native

    if native.available() and native.write_png16(str(path), img):
        return
    from opticalflowhs_tpu_torch.io import png16

    png16.write_png(path, img)
