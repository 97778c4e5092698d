"""Minimal pure-numpy PNG codec for 16-bit images (KITTI flow maps), a copy
of opticalflowhs_tpu/io/png16.py.

Why this exists: KITTI optical-flow ground truth ships as 48-bit RGB PNGs
(16 bits/channel), which Pillow cannot decode (it has no 48bpp RGB mode)
and this environment has no imageio/pypng/cv2 Python modules. The native
libhsio path decodes them via OpenCV C++ when built; this module is the
dependency-free fallback so `io.kitti` works everywhere (and is the
oracle for the native path's test).

Scope: non-interlaced, non-paletted PNG; bit depth 8 or 16; grayscale
(color type 0) or RGB (2), alpha variants (4, 6) accepted with alpha
dropped by the caller. All five scanline filters are implemented; None /
Sub / Up are vectorized, Average / Paeth loop over a row's bytes in plain
Python integers (the native OpenCV path, or Pillow, is the fast one).

Writer emits bit-depth-16 RGB or grayscale with filter 0 and one zlib
IDAT, which every PNG reader (including the KITTI devkit's) accepts.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"

# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write (H, W) or (H, W, 3) uint8/uint16 as an 8/16-bit PNG."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8/uint16, got {img.dtype}")
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png takes (H,W) or (H,W,3), got {img.shape}")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    # scanlines: filter byte 0 + big-endian samples
    data = img.astype(">u2" if depth == 16 else "u1").reshape(h, -1).view(np.uint8)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), data.reshape(h, -1)], axis=1
    ).tobytes()
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-scanline PNG filters. raw is (h, 1 + stride) uint8.

    None, Sub and Up are vectorised (Sub as a running sum of each channel,
    which uint8 wraps mod 256); Average and Paeth take the byte bpp to
    their left, so they loop over a row's bytes in plain Python integers,
    which is tens of times faster than a loop over NumPy slices."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = int(raw[y, 0])
        line = raw[y, 1:]
        if ft == 0:  # None
            rec = line
        elif ft == 1:  # Sub: rec[i] = line[i] + rec[i-bpp]
            rec = line.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:  # Up
            rec = line + prev
        elif ft in (3, 4):
            r = bytearray(line.tobytes())
            p = prev.tobytes()
            if ft == 3:  # Average
                for c in range(bpp):
                    r[c] = (r[c] + (p[c] >> 1)) & 0xFF
                for c in range(bpp, stride):
                    r[c] = (r[c] + ((r[c - bpp] + p[c]) >> 1)) & 0xFF
            else:  # Paeth; left of the row a = c = 0, so the predictor is b
                for c in range(bpp):
                    r[c] = (r[c] + p[c]) & 0xFF
                for c in range(bpp, stride):
                    a, b, cc = r[c - bpp], p[c], p[c - bpp]
                    pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - cc - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                    r[c] = (r[c] + pred) & 0xFF
            rec = np.frombuffer(bytes(r), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ft}")
        out[y] = rec
        prev = out[y]
    return out


def read_png(path: str | os.PathLike) -> np.ndarray:
    """Read a PNG into (H, W) or (H, W, C) uint8/uint16 (native bit depth)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    w = h = depth = color = interlace = None
    idat = []
    while pos + 8 <= len(buf):
        (ln,) = struct.unpack(">I", buf[pos : pos + 4])
        tag = buf[pos + 4 : pos + 8]
        payload = buf[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if w is None or not idat:
        raise ValueError(f"{path}: missing IHDR/IDAT")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG unsupported")
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: unsupported color type {color}/depth {depth}")
    ch = _CHANNELS[color]
    sample_bytes = depth // 8
    stride = w * ch * sample_bytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: bad IDAT payload size")
    rec = _unfilter(raw.reshape(h, stride + 1), h, stride, ch * sample_bytes)
    if depth == 16:
        img = rec.reshape(h, w * ch, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]  # big-endian samples
    else:
        img = rec.reshape(h, w * ch).astype(np.uint8)
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img
