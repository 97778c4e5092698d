"""K2: temporally blocked Jacobi sweeps.

Port of the Jacobi sweep kernels of opticalflowhs_tpu/kernels/jacobi.py
(`jacobi_sweeps` and its whole-image, banded and fused-banded TPU
schedules; `jacobi_sweeps_batched` and its stacked and batched-banded
schedules) and of the sweep stage of the resident whole-solve kernels. The
CUDA source is csrc/jacobi.cu: one launch runs up to `sweeps_per_launch`
sweeps on shared-memory tiles with a decaying halo, for one frame or for
a whole (B, H, W) stack (the image is the grid's z index).

`jacobi_sweeps` (also named `jacobi_sweeps_batched`) takes either rank. It
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors. There is no fallback: a CUDA tensor goes through the kernel or
the call raises.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels.derivatives import batch_dims, check_frames
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


def smem_bytes(sweeps: int, tile_h: int = TILE_H, tile_w: int = TILE_W) -> int:
    """Shared memory of one window: the 8 arrays of a tile grown by
    `sweeps` on each side (hs_tile::smem_bytes, for K2, K6 and K7)."""
    return _ARRAYS * 4 * (tile_h + 2 * sweeps) * (tile_w + 2 * sweeps)


def fit_sweeps(block_sweeps: int, auto: int, smem) -> int:
    """Sweeps one launch of a temporally blocked kernel runs: block_sweeps,
    or `auto` for 0, cut until its window, `smem(sweeps)` bytes, fits the
    shared memory of one block (K2, K3 and K4 share this rule)."""
    s = block_sweeps if block_sweeps > 0 else auto
    while s > 1 and smem(s) > SMEM_BYTES:
        s -= 1
    return s


def sweeps_per_launch(block_sweeps: int = 0) -> int:
    """Sweeps one K2 launch runs (`fit_sweeps`)."""
    return fit_sweeps(block_sweeps, AUTO_SWEEPS, smem_bytes)


def jacobi_sweeps_plain(u, v, ex, ey, et, inv_den, n: int):
    """n plain Jacobi sweeps (ops/stencils.py), on (H, W) or (B, H, W); on a
    stack each image on its own, as the reference's vmapped twin (the
    stencils clamp per image)."""
    for _ in range(n):
        u, v = stencils.jacobi_step(u, v, ex, ey, et, inv_den)
    return u, v


def launch_sweeps(u, v, ex, ey, et, inv_den, uo, vo, sweeps: int) -> None:
    """One K2 launch: `sweeps` sweeps from (u, v) into (uo, vo), on the
    current stream, over a frame or a whole stack. All eight tensors are
    CUDA float32 of one shape (checked by the callers); uo/vo must not
    alias u/v."""
    b, h, w = batch_dims("hs_jacobi_sweeps", u)
    if u.numel() == 0:
        return
    lib = _build.library()
    err = lib.hs_jacobi_sweeps(
        u.data_ptr(), v.data_ptr(), ex.data_ptr(), ey.data_ptr(),
        et.data_ptr(), inv_den.data_ptr(), uo.data_ptr(), vo.data_ptr(),
        b, h, w, sweeps, TILE_H, TILE_W, THREADS, u.device.index,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(err, "hs_jacobi_sweeps")
    jacobi_sweeps.launches += 1


def ping_pong(u, v, n: int, s: int, launch, owned: bool = False):
    """Run n sweeps as ceil(n/s) launches, the last one running the
    remainder, ping-ponging between two u/v pairs on one stream with no
    host synchronisation: `launch(u, v, uo, vo, k)` runs k sweeps from
    (u, v) into (uo, vo). owned=True lets the chain overwrite (u, v)."""
    pairs = [None, (u, v) if owned else None]
    src = (u, v)
    i = 0
    while n > 0:
        k = min(s, n)
        if pairs[i % 2] is None:
            pairs[i % 2] = (torch.empty_like(u), torch.empty_like(v))
        dst = pairs[i % 2]
        launch(*src, *dst, k)
        src = dst
        n -= k
        i += 1
    return src


def sweep_chain(u, v, ex, ey, et, inv_den, n: int, s: int,
                owned: bool = False):
    """n Jacobi sweeps as ceil(n/s) K2 launches (`ping_pong`)."""
    def launch(su, sv, du, dv, k):
        launch_sweeps(su, sv, ex, ey, et, inv_den, du, dv, k)
    return ping_pong(u, v, n, s, launch, owned)


def jacobi_sweeps(u, v, ex, ey, et, inv_den, n_sweeps: int,
                  block_sweeps: int = 0):
    """n Jacobi sweeps on (H, W) tensors or a (B, H, W) stack of independent
    images: on CUDA tensors ceil(n/s) K2 launches (for the whole stack,
    each image clamped at its own edges), `jacobi_sweeps_plain` on CPU
    tensors. Returns (u, v); the inputs are not modified."""
    check_frames("jacobi_sweeps", u, v, ex, ey, et, inv_den)
    if n_sweeps == 0:
        return u, v
    if u.device.type == "cpu":
        return jacobi_sweeps_plain(u, v, ex, ey, et, inv_den, n_sweeps)
    return sweep_chain(u, v, ex, ey, et, inv_den, n_sweeps,
                       sweeps_per_launch(block_sweeps))


# Every K2 launch, single frame or batched, counts here.
jacobi_sweeps.launches = 0

# The reference's names for the batched sweeps: the same functions.
jacobi_sweeps_batched = jacobi_sweeps
jacobi_sweeps_batched_plain = jacobi_sweeps_plain
