"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

The sources expose a plain C interface, so nvcc alone builds them into a
shared library, without PyTorch's headers, in seconds: one nvcc per source,
started together, then one link. The library goes
into `opticalflowhs_tpu_torch/_build/` under a name keyed by a hash of the
sources and the command line, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. It is bound with ctypes; every pointer
and the stream are `c_void_p` (an unset argtype would cut a pointer to 32
bits), every scalar `c_int` or `c_float` (the ring kernels' epoch
`c_ulonglong`), and every function returns its `cudaError_t` as an int.

The persistent kernels K6, K7, K8, K11 and K12 synchronise their whole grid
with a barrier on a count in device memory (csrc/cooperative.cuh). That
needs every block resident, which their C entry points ensure by a
cooperative launch, refused for a larger grid, but no extra build flag.

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
_IP = ctypes.POINTER(ctypes.c_int)
_U64 = ctypes.c_ulonglong

# C signature of every kernel entry point: argument types, in order. `b` is
# the batch count (1 for a single frame), the grid's z dimension.
SIGNATURES = {
    # i1, i2, ex, ey, et, invd, u1, v1, b, h, w, alpha2, variant, device,
    # stream
    "hs_derivatives": [_P] * 8 + [_I, _I, _I, _F, _I, _I, _P],
    # u, v, ex, ey, et, invd, uo, vo, b, h, w, sweeps, device, stream
    "hs_jacobi_sweeps": [_P] * 8 + [_I] * 5 + [_P],
    # sweeps, shard, device, out[8]: K2's (K9's) tile, threads, shared
    # bytes, registers, spilled bytes, resident blocks a multiprocessor,
    # multiprocessors
    "hs_jacobi_geometry": [_I, _I, _I, _IP],
    # u, v, ex, ey, et, invd, uo, vo, b, h, w, sweeps, omega, device,
    # stream
    "hs_sor_sweeps": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
    # sweeps, shard, device, out[9]: K3's (K9 SOR's) sweeps, tile, threads,
    # shared bytes, registers, spilled bytes, resident blocks a
    # multiprocessor, multiprocessors
    "hs_sor_geometry": [_I, _I, _I, _IP],
    # u, v, ex, ey, et, wd, ws, b, h, w, eps_d, eps_d^2, eps_s, eps_s^2,
    # device, stream
    "hs_robust_freeze": [_P] * 7 + [_I] * 3 + [_F] * 4 + [_I, _P],
    # u, v, ex, ey, et, wd, ws, uo, vo, b, h, w, sweeps, alpha^2, device,
    # stream
    "hs_robust_sweeps": [_P] * 9 + [_I] * 4 + [_F, _I, _P],
    # sweeps, device, out[12]: K4's sweeps, tile, left halo, window rows,
    # rows a thread, threads, shared bytes, registers, spilled bytes,
    # resident blocks a multiprocessor, multiprocessors
    "hs_robust_geometry": [_I, _I, _IP],
    # counts (3 uint64 on the device), device, stream: K4's reciprocal
    # against the IEEE division over every float it takes
    "hs_robust_rcp_check": [_P, _I, _P],
    # u1, u2, rho0, gx, gy, inv_g2, th, p1x, p1y, p2x, p2y, b, h, w, iters,
    # theta, sigma, lambda*theta, block_iters, device, stream, out: the
    # launches enqueued (the six state arrays with two slots each)
    "hs_tvl1_inner": [_P] * 11 + [_I] * 4 + [_F] * 3 + [_I, _I, _P, _IP],
    # b, h, w, iters, block_iters, device, out[11]: K5's alternations a
    # launch, launches, window rows, tile, threads, shared bytes, registers,
    # spilled bytes, resident blocks a multiprocessor, tiles of a launch
    "hs_tvl1_geometry": [_I] * 6 + [_IP],
    # device, out: the most K6 (K7) blocks that can be resident at once
    "hs_solve_fused_blocks": [_I, _IP],
    "hs_solve_skewed_blocks": [_I, _IP],
    # sweeps, device, out[8]: K6's (K7's) build, as hs_jacobi_geometry's
    "hs_solve_fused_geometry": [_I, _I, _IP],
    "hs_solve_skewed_geometry": [_I, _I, _IP],
    # u0, v0, ex, ey, et, invd, ua, va, ub, vb, barrier (8 bytes), b, h, w,
    # n, s, grid, device, stream
    "hs_solve_fused_sweeps": [_P] * 11 + [_I] * 7 + [_P],
    # u0, v0, ex, ey, et, invd, u, v, pu, pv, barrier (8 bytes), b, h, w, n,
    # s, m, band_ty, grid, device, stream
    "hs_solve_skewed_sweeps": [_P] * 11 + [_I] * 9 + [_P],
    # u0, v0 (both null for a zero start), ex, ey, et, invd, ua, va, ub, vb,
    # barrier (8 bytes), h, w, n, s, omega, grid, device, stream
    "hs_sor_planes": [_P] * 11 + [_I] * 4 + [_F, _I, _I, _P],
    # device, out: the most K8 blocks resident at once
    "hs_sor_planes_blocks": [_I, _IP],
    # sweeps, device, out[8]: K8's build, as hs_solve_fused_geometry's
    "hs_sor_planes_geometry": [_I, _I, _IP],
    # u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w, sweeps,
    # device, stream
    "hs_tile_sweeps": [_P] * 9 + [_I] * 7 + [_P],
    # u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w, sweeps,
    # omega, device, stream
    "hs_sor_tile_sweeps": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
    # table, n, h, w, halo, device, stream
    "hs_ring_halo_exchange": [_P] + [_I] * 5 + [_P],
    # device, peer
    "hs_enable_peer": [_I, _I],
    # device, out: the most K11/K12 blocks resident at once
    "hs_ring_blocks": [_I, _IP],
    # sweeps, two_d, device, out[8]: K11's (K12's) build, as
    # hs_jacobi_geometry's
    "hs_ring_geometry": [_I] * 3 + [_IP],
    # links, org, P0 u, P0 v, P1 u, P1 v, ex, ey, et, invd, barrier (8
    # bytes), b, h, w, sy, sx, img_h, img_w, n, s, epoch0, grid, device,
    # stream
    "hs_ring_fused_sweeps": [_P] * 11 + [_I] * 9 + [_U64] + [_I] * 2 + [_P],
}

# The bfloat16 builds of K1, K2, K6 and K7 (every array bfloat16, the
# arithmetic float32; csrc/k2_window.cuh's storage types) take their float
# builds' arguments; the geometry and resident-block queries report them.
SIGNATURES.update({
    f"{name}_bf16": SIGNATURES[name]
    for name in ("hs_derivatives", "hs_jacobi_sweeps", "hs_solve_fused_blocks",
                 "hs_solve_skewed_blocks", "hs_solve_fused_geometry",
                 "hs_solve_skewed_geometry", "hs_solve_fused_sweeps",
                 "hs_solve_skewed_sweeps")
})
# sweeps, device, out[8]: K2's bfloat16 build, as hs_jacobi_geometry's
SIGNATURES["hs_jacobi_geometry_bf16"] = [_I, _I, _IP]

# Largest batch one launch takes: CUDA's limit on gridDim.z.
MAX_BATCH = 65535


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include (csrc/*.cuh), hashed with them."""
    return sorted(CSRC.glob("*.cuh"))


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


def compile_command(nvcc: str, src: Path, obj: Path) -> list[str]:
    """nvcc command compiling one source into a position-independent
    object for sm_90a."""
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "--fmad=false",
        "-Xcompiler", "-fPIC",
        "-c", "-o", str(obj), str(src),
    ]


def link_command(nvcc: str, objs: list[Path], out: Path) -> list[str]:
    return [nvcc, "-shared", "-o", str(out), *(str(o) for o in objs)]


def _library_path(srcs: list[Path]) -> Path:
    digest = hashlib.sha256()
    for s in srcs + headers():
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(compile_command("nvcc", Path("k.cu"), Path("k.o"))
                           + link_command("nvcc", [], Path("lib.so"))).encode())
    return BUILD_DIR / f"libhsflow_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a library for these sources exists; return
    its path. One nvcc per source, all started together, then one link.
    Raises RuntimeError, with nvcc's output, if the build fails."""
    srcs = sources()
    lib = _library_path(srcs)
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a temporary directory and rename the library into place, so
    # a concurrent process never loads a half-written one.
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp / f"{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen(compile_command(nvcc, s, o), text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for s, o in zip(srcs, objs)]
        errors = []
        for s, p in zip(srcs, procs):
            out, err = p.communicate()
            if p.returncode != 0:
                errors.append(f"{s.name} (exit {p.returncode}):\n{err}{out}")
        if errors:
            raise RuntimeError("nvcc failed on " + "\n".join(errors))
        proc = subprocess.run(link_command(nvcc, objs, tmp / "lib.so"),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}):\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp / "lib.so", lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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


def bf16_suffix(dtype) -> str:
    """"_bf16", the suffix of the bfloat16 builds' C entry points, for
    torch.bfloat16 arrays; "" for float32 ones."""
    return "_bf16" if str(dtype) == "torch.bfloat16" else ""


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error: a launch
    refused for its shared memory or block size never runs, and a later
    synchronize would not report it."""
    if err != 0:
        msg = library().hs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
