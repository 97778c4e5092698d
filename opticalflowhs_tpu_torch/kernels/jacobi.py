"""K2: temporally blocked Jacobi sweeps.

Port of the Jacobi sweep kernels of opticalflowhs_tpu/kernels/jacobi.py
(`jacobi_sweeps` and its whole-image, banded and fused-banded TPU
schedules) and of the sweep stage of the resident whole-solve kernel. The
CUDA source is csrc/jacobi.cu: one launch runs up to `sweeps_per_launch`
sweeps on shared-memory tiles with a decaying halo.

`jacobi_sweeps` launches the kernel for CUDA tensors and runs the plain
version, `jacobi_sweeps_plain`, for CPU tensors. There is no fallback: a
CUDA tensor goes through the kernel or the call raises.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels.derivatives import check_frames
from opticalflowhs_tpu_torch.ops import stencils

# Output tile of one block, threads per block and the default sweeps per
# launch (HSConfig.block_sweeps = 0). A block stages 8 float32 arrays of
# the (tile + 2*sweeps) window in shared memory: 200 KB at 64x64 and s = 8,
# so one block per SM. Chosen by a sweep over tiles 8x128..64x64, s 2..12
# and 128..512 threads at 1088x1920 on an H100 (PERF.md); the best few
# configurations were within 10% of each other.
TILE_H = 64
TILE_W = 64
THREADS = 512
AUTO_SWEEPS = 8
SMEM_BYTES = 232_448  # shared memory one block may use on Hopper
_ARRAYS = 8


def smem_bytes(sweeps: int) -> int:
    return _ARRAYS * 4 * (TILE_H + 2 * sweeps) * (TILE_W + 2 * sweeps)


def sweeps_per_launch(block_sweeps: int = 0) -> int:
    """Sweeps one launch runs: block_sweeps, or AUTO_SWEEPS for 0, cut to
    what the window's shared memory allows."""
    s = block_sweeps if block_sweeps > 0 else AUTO_SWEEPS
    while s > 1 and smem_bytes(s) > SMEM_BYTES:
        s -= 1
    return s


def jacobi_sweeps_plain(u, v, ex, ey, et, inv_den, n: int):
    """n plain Jacobi sweeps (ops/stencils.py)."""
    for _ in range(n):
        u, v = stencils.jacobi_step(u, v, ex, ey, et, inv_den)
    return u, v


def launch_sweeps(u, v, ex, ey, et, inv_den, uo, vo, sweeps: int) -> None:
    """One K2 launch: `sweeps` sweeps from (u, v) into (uo, vo), on the
    current stream. All eight tensors are CUDA float32 (checked by the
    callers); uo/vo must not alias u/v."""
    h, w = u.shape
    lib = _build.library()
    err = lib.hs_jacobi_sweeps(
        u.data_ptr(), v.data_ptr(), ex.data_ptr(), ey.data_ptr(),
        et.data_ptr(), inv_den.data_ptr(), uo.data_ptr(), vo.data_ptr(),
        h, w, sweeps, TILE_H, TILE_W, THREADS, u.device.index,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(err, "hs_jacobi_sweeps")
    jacobi_sweeps.launches += 1


def sweep_chain(u, v, ex, ey, et, inv_den, n: int, s: int,
                owned: bool = False):
    """Run n sweeps as ceil(n/s) K2 launches, the last one running the
    remainder, ping-ponging between two u/v pairs on one stream with no
    host synchronisation. owned=True lets the chain overwrite (u, v)."""
    pairs = [None, (u, v) if owned else None]
    src = (u, v)
    i = 0
    while n > 0:
        k = min(s, n)
        if pairs[i % 2] is None:
            pairs[i % 2] = (torch.empty_like(u), torch.empty_like(v))
        dst = pairs[i % 2]
        launch_sweeps(*src, ex, ey, et, inv_den, *dst, k)
        src = dst
        n -= k
        i += 1
    return src


def jacobi_sweeps(u, v, ex, ey, et, inv_den, n_sweeps: int,
                  block_sweeps: int = 0):
    """n Jacobi sweeps: K2 launches on CUDA tensors, `jacobi_sweeps_plain`
    on CPU tensors. Returns (u, v); the inputs are not modified."""
    check_frames("jacobi_sweeps", u, v, ex, ey, et, inv_den)
    if n_sweeps == 0:
        return u, v
    if u.device.type == "cpu":
        return jacobi_sweeps_plain(u, v, ex, ey, et, inv_den, n_sweeps)
    return sweep_chain(u, v, ex, ey, et, inv_den, n_sweeps,
                       sweeps_per_launch(block_sweeps))


jacobi_sweeps.launches = 0
