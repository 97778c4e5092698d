"""Image loading/saving, mirroring opticalflowhs_tpu/io/images.py.

PNM (PGM/PPM) by extension through a dependency-free reader and writer;
other formats through Pillow, then OpenCV. One addition: where neither
Pillow nor OpenCV imports, a PNG goes through the package's own codec
(io/png16.py) and decodes to the values Pillow gives (16-bit grey / 65535;
8-bit samples, and 16-bit colour cut to its high bytes as Pillow does,
/ 255 when the image's max is above 1), and `save_image` writes it as
8-bit grey or RGB. Any other format still raises ImportError there.
"""

from __future__ import annotations

import os

import numpy as np

from opticalflowhs_tpu_torch.io import png16


def _load_pnm(path: str) -> np.ndarray:
    """Minimal binary/ASCII PGM (P2/P5) and PPM (P3/P6) reader."""
    with open(path, "rb") as f:
        data = f.read()

    # Header tokens: magic, width, height, maxval — comments start with '#'.
    tokens: list[bytes] = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if i < len(data) and data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        start = i
        while i < len(data) and not data[i : i + 1].isspace():
            i += 1
        tokens.append(data[start:i])
    i += 1  # single whitespace after maxval

    magic = tokens[0]
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    channels = 3 if magic in (b"P3", b"P6") else 1
    count = w * h * channels
    if magic in (b"P5", b"P6"):
        dtype = np.dtype(">u2") if maxval > 255 else np.uint8
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=i)
    elif magic in (b"P2", b"P3"):
        arr = np.array(data[i:].split()[:count], dtype=np.int32)
    else:
        raise ValueError(f"{path}: unsupported PNM magic {magic!r}")
    arr = arr.reshape(h, w, channels).astype(np.float32) / float(maxval)
    return arr[..., 0] if channels == 1 else arr


def _load_png(path: str) -> np.ndarray:
    """A PNG through io.png16, scaled as the Pillow branch of `load_gray`
    scales Pillow's decode of it."""
    raw = png16.read_png(path)
    if raw.dtype == np.uint16 and raw.ndim == 2:
        return raw.astype(np.float32) / 65535.0  # Pillow's "I;16"
    if raw.dtype == np.uint16:
        raw = (raw >> 8).astype(np.uint8)  # Pillow keeps 8 bits of colour
    img = raw.astype(np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    return img


def load_gray(path: str | os.PathLike) -> np.ndarray:
    """Load an image as float32 grayscale in [0, 1]."""
    path = str(path)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        img = _load_pnm(path)
    else:
        try:
            from PIL import Image

            pim = Image.open(path)
            img = np.asarray(pim, dtype=np.float32)
            if pim.mode in ("I", "I;16", "I;16B", "I;16L"):
                img = img / 65535.0  # 16-bit samples scale by their own max
            elif img.max() > 1.0:
                img = img / 255.0
        except ImportError:
            try:
                import cv2
            except ImportError:
                if ext != ".png":
                    raise
                img = _load_png(path)
            else:
                raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
                if raw is None:
                    raise FileNotFoundError(path)
                img = raw.astype(np.float32) / 255.0
                if img.ndim == 3:
                    img = img[..., ::-1]  # BGR -> RGB
    if img.ndim == 3:
        # ITU-R BT.601 luma, the conventional grayscale conversion.
        img = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return np.ascontiguousarray(img, dtype=np.float32)


def save_image(path: str | os.PathLike, img: np.ndarray) -> None:
    """Save a float [0,1] or uint8 image (grayscale or RGB)."""
    path = str(path)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        if arr.ndim == 2:
            header = f"P5\n{arr.shape[1]} {arr.shape[0]}\n255\n"
        else:
            header = f"P6\n{arr.shape[1]} {arr.shape[0]}\n255\n"
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(arr.tobytes())
        return
    try:
        from PIL import Image

        Image.fromarray(arr).save(path)
    except ImportError:
        try:
            import cv2
        except ImportError:
            if ext != ".png":
                raise
            png16.write_png(path, arr)
            return
        out = arr[..., ::-1] if arr.ndim == 3 else arr
        cv2.imwrite(path, out)
