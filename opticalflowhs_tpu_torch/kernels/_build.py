"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

The sources expose a plain C interface, so nvcc alone builds them into a
shared library, without PyTorch's headers, in seconds. The library goes
into `opticalflowhs_tpu_torch/_build/` under a name keyed by a hash of the
sources and the command line, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. It is bound with ctypes; every pointer
and the stream are `c_void_p` (an unset argtype would cut a pointer to 32
bits), every scalar `c_int` or `c_float`, and every function returns its
`cudaError_t` as an int.

The flags are part of the numerics: `--fmad=false` stops nvcc contracting
a*b + c into one fused multiply-add, and fast math stays off (IEEE
division), so the kernels round exactly where the plain PyTorch versions
do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every kernel entry point: argument types, in order.
SIGNATURES = {
    # i1, i2, ex, ey, et, invd, u1, v1, h, w, alpha2, variant, device, stream
    "hs_derivatives": [_P] * 8 + [_I, _I, _F, _I, _I, _P],
    # u, v, ex, ey, et, invd, uo, vo, h, w, sweeps, tile_h, tile_w,
    # threads, device, stream
    "hs_jacobi_sweeps": [_P] * 8 + [_I] * 7 + [_P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the default CUDA install."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built"
    )


def nvcc_command(nvcc: str, srcs: list[Path], out: Path) -> list[str]:
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "--fmad=false",
        "-shared", "-Xcompiler", "-fPIC",
        "-o", str(out),
        *(str(s) for s in srcs),
    ]


def _library_path(srcs: list[Path]) -> Path:
    digest = hashlib.sha256()
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(nvcc_command("nvcc", [], Path("lib.so"))).encode())
    return BUILD_DIR / f"libhsflow_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a library for these sources exists; return
    its path. Raises RuntimeError, with nvcc's output, if the build fails."""
    srcs = sources()
    lib = _library_path(srcs)
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name and rename, so a concurrent process
    # never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            nvcc_command(nvcc, srcs, Path(tmp)), capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, with every function's argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.hs_error_string.argtypes = [ctypes.c_int]
    lib.hs_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error: a launch
    refused for its shared memory or block size never runs, and a later
    synchronize would not report it."""
    if err != 0:
        msg = library().hs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
