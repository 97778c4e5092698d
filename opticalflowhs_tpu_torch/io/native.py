"""ctypes bindings for libhsio, the native IO/prefetch library, mirroring
opticalflowhs_tpu/io/native.py.

The compute runtime is PyTorch on the card; this is the native host-side
data path: C++ PNM decode, .flo IO, and a threaded prefetching frame
loader for streaming video (config 4). It binds the same
`native/libhsio.so` as the reference, built by `make -C native` on the
machine that runs it (the Makefile passes -march=native). Every entry
point degrades to the pure-Python implementations in io/images.py /
io/flo.py when the shared library hasn't been built, so the package never
hard-depends on a compiler. A library built without OpenCV holds the PNM
codec only: `can_decode` is then False for a PNG, and callers decode it
in Python.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
from typing import Iterator, Optional, Sequence

import numpy as np

_LIB_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_LIB_DIR, "libhsio.so"))

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def build(force: bool = False) -> bool:
    """Compile libhsio.so with the in-tree Makefile. Returns success.

    Callers in several processes (test workers) take turns through a lock
    file in the temporary directory, so none loads a library that another
    is still linking."""
    lock_path = os.path.join(tempfile.gettempdir(), "hsio_build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH) and not force:
            return True
        try:
            subprocess.run(
                ["make", "-C", os.path.abspath(_LIB_DIR)],
                check=True,
                capture_output=True,
            )
            return os.path.exists(_LIB_PATH)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.hsio_load_gray.argtypes = [ctypes.c_char_p, fp, ip, ip]
    lib.hsio_probe.argtypes = [ctypes.c_char_p, ip, ip]
    lib.hsio_read_flo.argtypes = [ctypes.c_char_p, fp, ip, ip]
    lib.hsio_write_flo.argtypes = [ctypes.c_char_p, fp, ctypes.c_int, ctypes.c_int]
    lib.hsio_loader_open.restype = ctypes.c_void_p
    lib.hsio_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.hsio_loader_next.argtypes = [ctypes.c_void_p, fp, ip, ip, ctypes.c_long]
    lib.hsio_loader_close.argtypes = [ctypes.c_void_p]
    u16p = ctypes.POINTER(ctypes.c_uint16)
    try:
        lib.hsio_read_png16.argtypes = [ctypes.c_char_p, u16p, ip, ip]
        lib.hsio_write_png16.argtypes = [
            ctypes.c_char_p, u16p, ctypes.c_int, ctypes.c_int,
        ]
    except AttributeError:  # pre-1.1 library on disk
        pass
    try:  # 1.2: video ingestion + writer
        lib.hsio_video_open.restype = ctypes.c_void_p
        lib.hsio_video_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.hsio_video_info.argtypes = [
            ctypes.c_void_p, ip, ip,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long),
        ]
        lib.hsio_video_next.argtypes = [ctypes.c_void_p, fp, ip, ip,
                                        ctypes.c_long]
        lib.hsio_video_close.argtypes = [ctypes.c_void_p]
        lib.hsio_vwriter_open.restype = ctypes.c_void_p
        lib.hsio_vwriter_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_char_p,
        ]
        lib.hsio_vwriter_write.argtypes = [ctypes.c_void_p, fp, fp]
        lib.hsio_vwriter_close.argtypes = [ctypes.c_void_p]
    except AttributeError:  # pre-1.2 library on disk
        pass
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


# hsio_codecs() capability bits
CODEC_PNM = 1
CODEC_OPENCV = 2  # PNG/JPEG/BMP/TIFF/... via OpenCV imgcodecs
CODEC_VIDEO = 4   # mp4/avi/V4L2 ingestion + video writer via OpenCV videoio

_PNM_EXTS = (".pgm", ".ppm", ".pnm")


def codecs() -> int:
    """Capability bitmask of the loaded library (0 when unavailable)."""
    lib = _load()
    if lib is None:
        return 0
    return int(lib.hsio_codecs())


def can_decode(path: str) -> bool:
    """True when the native library can decode this file's format."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _PNM_EXTS:
        return bool(codecs() & CODEC_PNM)
    return bool(codecs() & CODEC_OPENCV)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_gray(path: str) -> np.ndarray:
    """Native decode (PNM always; PNG/JPEG/... when the library was built
    with the OpenCV codecs); falls back to io.images.load_gray otherwise."""
    lib = _load()
    if lib is None or not can_decode(path):
        from opticalflowhs_tpu_torch.io.images import load_gray as py_load

        return py_load(path)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.hsio_probe(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"hsio_probe({path}) failed with {rc}")
    out = np.empty((h.value, w.value), dtype=np.float32)
    rc = lib.hsio_load_gray(path.encode(), _fp(out), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"hsio_load_gray({path}) failed with {rc}")
    return out


def read_flo(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        from opticalflowhs_tpu_torch.io.flo import read_flo as py_read

        return py_read(path)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.hsio_read_flo(path.encode(), None, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"hsio_read_flo({path}) failed with {rc}")
    out = np.empty((h.value, w.value, 2), dtype=np.float32)
    rc = lib.hsio_read_flo(path.encode(), _fp(out), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"hsio_read_flo({path}) failed with {rc}")
    return out


def write_flo(path: str, flow: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        from opticalflowhs_tpu_torch.io.flo import write_flo as py_write

        py_write(path, flow)
        return
    arr = np.ascontiguousarray(flow, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[2] != 2:
        raise ValueError(f"expected (H, W, 2) flow, got {arr.shape}")
    rc = lib.hsio_write_flo(path.encode(), _fp(arr), arr.shape[1], arr.shape[0])
    if rc != 0:
        raise IOError(f"hsio_write_flo({path}) failed with {rc}")


def _u16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def read_png16(path: str) -> Optional[np.ndarray]:
    """Native 16-bit 3-channel PNG decode (KITTI flow maps) -> (H, W, 3)
    uint16 RGB, or None when the library lacks the OpenCV codecs (caller
    falls back to io.png16)."""
    lib = _load()
    if lib is None or not hasattr(lib, "hsio_read_png16"):
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.hsio_read_png16(path.encode(), None, ctypes.byref(w), ctypes.byref(h))
    if rc == -10:
        return None
    if rc != 0:
        raise IOError(f"hsio_read_png16({path}) failed with {rc}")
    out = np.empty((h.value, w.value, 3), dtype=np.uint16)
    rc = lib.hsio_read_png16(path.encode(), _u16p(out), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"hsio_read_png16({path}) failed with {rc}")
    return out


def write_png16(path: str, img: np.ndarray) -> bool:
    """Native 16-bit RGB PNG write; returns False when unsupported (caller
    falls back to io.png16)."""
    lib = _load()
    if lib is None or not hasattr(lib, "hsio_write_png16"):
        return False
    arr = np.ascontiguousarray(img, dtype=np.uint16)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint16, got {arr.shape}")
    rc = lib.hsio_write_png16(path.encode(), _u16p(arr), arr.shape[1], arr.shape[0])
    if rc == -10:
        return False
    if rc != 0:
        raise IOError(f"hsio_write_png16({path}) failed with {rc}")
    return True


def stream_frames(
    paths: Sequence[str], n_threads: int = 4, prefetch: int = 8
) -> Iterator[np.ndarray]:
    """Threaded prefetching frame iterator (pipeline stage P6).

    Worker threads decode up to `prefetch` frames ahead while the consumer
    (the solve loop on the card) drains in order. Falls back to synchronous Python
    decode without the library.
    """
    lib = _load()
    if lib is None:
        from opticalflowhs_tpu_torch.io.images import load_gray as py_load

        for p in paths:
            yield py_load(p)
        return
    enc = [p.encode() for p in paths]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    handle = lib.hsio_loader_open(arr, len(enc), n_threads, prefetch)
    if not handle:
        raise IOError("hsio_loader_open failed")
    try:
        if not paths:
            return
        w = ctypes.c_int()
        h = ctypes.c_int()
        # Header-only dimension probe sizes the reusable buffer; a later
        # larger frame is reported by the library (-4) and the buffer grows.
        rc = lib.hsio_probe(paths[0].encode(), ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise IOError(f"hsio_probe({paths[0]}) failed with {rc}")
        out = np.empty((h.value, w.value), dtype=np.float32)
        while True:
            rc = lib.hsio_loader_next(
                handle, _fp(out), ctypes.byref(w), ctypes.byref(h), out.size
            )
            if rc == 1:
                return
            if rc == -4:  # frame larger than the buffer: grow and retry
                out = np.empty((h.value, w.value), dtype=np.float32)
                continue
            if rc != 0:
                raise IOError(f"hsio_loader_next failed with {rc}")
            n = h.value * w.value
            yield out.reshape(-1)[:n].reshape(h.value, w.value).copy()
    finally:
        lib.hsio_loader_close(handle)


def video_available() -> bool:
    """True when the library was built with OpenCV videoio (mp4/avi/V4L2)."""
    return bool(codecs() & CODEC_VIDEO)


def video_info(source: str) -> tuple[int, int, float, int]:
    """(width, height, fps, n_frames) of a container/camera source;
    n_frames is -1 when unknown (cameras)."""
    lib = _load()
    if lib is None or not video_available():
        raise IOError("native video ingestion unavailable (rebuild libhsio "
                      "with OpenCV videoio)")
    handle = lib.hsio_video_open(source.encode(), 1)
    if not handle:
        raise IOError(f"cannot open video source {source!r}")
    try:
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        n = ctypes.c_long()
        lib.hsio_video_info(handle, ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(fps), ctypes.byref(n))
        return w.value, h.value, fps.value, n.value
    finally:
        lib.hsio_video_close(handle)


def stream_video(source: str, prefetch: int = 8) -> Iterator[np.ndarray]:
    """Grayscale float frames from a container file (mp4/avi/...) or a
    camera ("cam:N"), decoded ahead by the native ring (pipeline stage P6 —
    the demux/decode overlaps the solve exactly like stream_frames).
    """
    lib = _load()
    if lib is None or not video_available():
        raise IOError("native video ingestion unavailable (rebuild libhsio "
                      "with OpenCV videoio)")
    handle = lib.hsio_video_open(source.encode(), prefetch)
    if not handle:
        raise IOError(f"cannot open video source {source!r}")
    try:
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        n = ctypes.c_long()
        lib.hsio_video_info(handle, ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(fps), ctypes.byref(n))
        out = np.empty((max(h.value, 1), max(w.value, 1)), dtype=np.float32)
        while True:
            rc = lib.hsio_video_next(
                handle, _fp(out), ctypes.byref(w), ctypes.byref(h), out.size
            )
            if rc == 1:
                return
            if rc == -4:  # stream changed size: grow and retry
                out = np.empty((h.value, w.value), dtype=np.float32)
                continue
            if rc != 0:
                raise IOError(f"hsio_video_next failed with {rc}")
            npx = h.value * w.value
            yield out.reshape(-1)[:npx].reshape(h.value, w.value).copy()
    finally:
        lib.hsio_video_close(handle)


VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".mov", ".webm", ".m4v", ".mpg",
              ".mpeg", ".wmv")


class VideoWriter:
    """Incremental container-video writer (native, lazy-opened on the first
    frame so the geometry comes from the data). Frames are (H, W) gray
    float in [0, 1], or (H, W, 3) float RGB with rgb=True. Context-manager
    friendly."""

    def __init__(self, path: str, fps: float = 25.0, fourcc: str = "MJPG",
                 rgb: bool = False):
        self._lib = _load()
        if self._lib is None or not video_available():
            raise IOError("native video writer unavailable (rebuild libhsio "
                          "with OpenCV videoio)")
        self._path = path
        self._fps = fps
        self._fourcc = fourcc
        self._rgb = rgb
        self._handle = None
        self.count = 0

    def write(self, frame: np.ndarray) -> None:
        arr = np.ascontiguousarray(frame, dtype=np.float32)
        if self._handle is None:
            hh, ww = arr.shape[:2]
            self._handle = self._lib.hsio_vwriter_open(
                self._path.encode(), ww, hh, self._fps, self._fourcc.encode()
            )
            if not self._handle:
                raise IOError(
                    f"cannot open video writer {self._path!r} ({self._fourcc})"
                )
        rc = (self._lib.hsio_vwriter_write(self._handle, None, _fp(arr))
              if self._rgb
              else self._lib.hsio_vwriter_write(self._handle, _fp(arr), None))
        if rc != 0:
            raise IOError(f"hsio_vwriter_write failed with {rc}")
        self.count += 1

    def close(self) -> None:
        if self._handle is not None:
            self._lib.hsio_vwriter_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video(path: str, frames, fps: float = 25.0,
                fourcc: str = "MJPG", rgb: bool = False) -> int:
    """Write frames ((H, W) gray float in [0,1], or (H, W, 3) float RGB
    with rgb=True) to a container file. Returns the frame count written."""
    with VideoWriter(path, fps=fps, fourcc=fourcc, rgb=rgb) as wr:
        for f in frames:
            wr.write(f)
        return wr.count
