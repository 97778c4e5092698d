"""Middlebury .flo flow-field format (copy of opticalflowhs_tpu/io/flo.py).

Format [Baker et al., IJCV 2011]: little-endian; 4-byte magic "PIEH"
(reads as float32 202021.25), int32 width, int32 height, then h*w*2 float32
row-major with channels interleaved (u then v per pixel). |value| > 1e9
marks unknown flow (ground-truth occlusions).
"""

from __future__ import annotations

import os

import numpy as np

from opticalflowhs_tpu_torch.io.host import host_array

FLO_MAGIC = 202021.25
UNKNOWN_FLOW_THRESH = 1e9


def write_flo(path: str | os.PathLike, flow: np.ndarray) -> None:
    """Write an (H, W, 2) float flow field to a .flo file (numpy, or a
    tensor of any float dtype, `host_array`)."""
    flow = host_array(flow)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f".flo flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype("<f4").tofile(f)


def read_flo(path: str | os.PathLike) -> np.ndarray:
    """Read a .flo file into an (H, W, 2) float32 array."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, "<f4", count=1)
        if magic.size != 1 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w = int(np.fromfile(f, "<i4", count=1)[0])
        h = int(np.fromfile(f, "<i4", count=1)[0])
        if not (0 < w < 100000 and 0 < h < 100000):
            raise ValueError(f"{path}: implausible size {w}x{h}")
        data = np.fromfile(f, "<f4", count=h * w * 2)
    if data.size != h * w * 2:
        raise ValueError(f"{path}: truncated payload")
    return data.reshape(h, w, 2)


def unknown_mask(flow: np.ndarray) -> np.ndarray:
    """Boolean (H, W) mask of pixels whose GT flow is marked unknown."""
    return (np.abs(flow[..., 0]) > UNKNOWN_FLOW_THRESH) | (
        np.abs(flow[..., 1]) > UNKNOWN_FLOW_THRESH
    ) | ~np.isfinite(flow[..., 0]) | ~np.isfinite(flow[..., 1])
