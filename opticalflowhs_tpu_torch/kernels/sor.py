"""K3: temporally blocked 4-color SOR sweeps.

Port of the SOR sweep kernels of opticalflowhs_tpu/kernels/sor.py (the
whole-image `_sor_vmem_kernel` and the banded `_sor_banded_kernel`, behind
`sor_sweeps`) and of the sweep stage of the resident 4-color whole solve
(`hs_solve_resident_sor`). The CUDA source is csrc/sor.cu: one launch runs
up to `sweeps_per_launch` sweeps on shared-memory tiles whose halo decays
four rings a sweep (one per color stage), for one frame or a whole
(B, H, W) stack (the image is the grid's z index).

`sor_sweeps` takes either rank. It launches the kernel for CUDA tensors and
runs the plain version for CPU tensors. There is no fallback: a CUDA tensor
goes through the kernel or the call raises.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels.derivatives import batch_dims, check_frames
from opticalflowhs_tpu_torch.kernels.jacobi import fit_sweeps, ping_pong
from opticalflowhs_tpu_torch.ops import stencils

# Output tile of one block and threads per block, as K2. A block stages 6
# float32 arrays of the (tile + 8*sweeps) window in shared memory, u and v
# updated in place: 221 KB at s = 4, the most that fits, and the default.
TILE_H = 64
TILE_W = 64
THREADS = 512
AUTO_SWEEPS = 4
_ARRAYS = 6
_STAGES = 4  # color stages, so halo rings, per sweep


def smem_bytes(sweeps: int) -> int:
    halo = _STAGES * sweeps
    return _ARRAYS * 4 * (TILE_H + 2 * halo) * (TILE_W + 2 * halo)


def sweeps_per_launch(block_sweeps: int = 0) -> int:
    """Sweeps one K3 launch runs (`jacobi.fit_sweeps`)."""
    return fit_sweeps(block_sweeps, AUTO_SWEEPS, smem_bytes)


def sor_sweeps_plain(u, v, ex, ey, et, inv_den, n: int, omega: float):
    """n plain 4-color SOR sweeps (ops/stencils.py sor_step) on (H, W) or
    (B, H, W); the color grids are each image's own."""
    colors = stencils.color_masks(*u.shape[-2:], device=u.device)
    for _ in range(n):
        u, v = stencils.sor_step(u, v, ex, ey, et, inv_den, omega, colors)
    return u, v


def launch_sweeps(u, v, ex, ey, et, inv_den, uo, vo, sweeps: int,
                  omega: float) -> None:
    """One K3 launch: `sweeps` sweeps from (u, v) into (uo, vo), on the
    current stream, over a frame or a whole stack. All eight tensors are
    CUDA float32 of one shape (checked by the caller); uo/vo must not alias
    u/v."""
    b, h, w = batch_dims("hs_sor_sweeps", u)
    if u.numel() == 0:
        return
    lib = _build.library()
    err = lib.hs_sor_sweeps(
        u.data_ptr(), v.data_ptr(), ex.data_ptr(), ey.data_ptr(),
        et.data_ptr(), inv_den.data_ptr(), uo.data_ptr(), vo.data_ptr(),
        b, h, w, sweeps, float(omega), TILE_H, TILE_W, THREADS,
        u.device.index, torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(err, "hs_sor_sweeps")
    sor_sweeps.launches += 1


def sor_sweeps(u, v, ex, ey, et, inv_den, n: int, omega: float,
               block_sweeps: int = 0):
    """n 4-color SOR sweeps on (H, W) tensors or a (B, H, W) stack: on CUDA
    tensors ceil(n/s) K3 launches (one chain for the whole stack, two u/v
    pairs ping-ponging, no host synchronisation), `sor_sweeps_plain` on CPU
    tensors. Returns (u, v); the inputs are not modified."""
    check_frames("sor_sweeps", u, v, ex, ey, et, inv_den)
    if n == 0:
        return u, v
    if u.device.type == "cpu":
        return sor_sweeps_plain(u, v, ex, ey, et, inv_den, n, omega)
    return sor_chain(u, v, ex, ey, et, inv_den, n, omega,
                     sweeps_per_launch(block_sweeps))


def sor_chain(u, v, ex, ey, et, inv_den, n: int, omega: float, s: int,
              owned: bool = False):
    """n SOR sweeps as ceil(n/s) K3 launches (`jacobi.ping_pong`)."""
    def launch(su, sv, du, dv, k):
        launch_sweeps(su, sv, ex, ey, et, inv_den, du, dv, k, omega)
    return ping_pong(u, v, n, s, launch, owned)


# Every K3 launch, single frame or batched, counts here.
sor_sweeps.launches = 0
