"""K9: Jacobi and 4-color SOR sweeps on halo-padded shards of a larger image.

Port of the per-shard kernels of the tiled solver: `tile_sweeps`
(opticalflowhs_tpu/kernels/jacobi.py, `_tile_kernel`) and its SOR twin
`sor_tile_sweeps` (opticalflowhs_tpu/kernels/sor.py). A shard carries its
halo; its element (0, 0) sits at the global pixel (row0, col0), which may
be negative, of the true h x w image. The clamps fire at the true image
edges, from global coordinates, and SOR's colors follow the global parity;
the shard's own edges, where the image goes on, are decaying halo.

The CUDA sources are K2's and K3's kernels (csrc/jacobi.cu, csrc/sor.cu)
behind the entries `hs_tile_sweeps` and `hs_sor_tile_sweeps`, which take a
per-slice origin: one launch covers a whole (S, PH, PW) stack, every shard
that lives on one device, each with its own origin. The Jacobi entry runs
K2's design (persistent 48 x 128 windows with a halo of s rows and
columns, fields in registers; its plain schedule is
`jacobi.k2_launch_schedule_plain` with `origins`), the SOR entry K3's
(persistent 48 x 128 windows with a halo of 2s rows and 4s columns, u, v
and fields in registers, two barriers a sweep, s by K3's cost rule for the
stack; `sor.k3_launch_schedule_plain` with `origins`). The reference pads
each shard to the TPU's 8 x 128 tiles; here nothing is padded.

On CPU tensors the wrappers run the plain versions (`stencils.
jacobi_step_masked` and `sor_step_masked` over the whole padded shard), on
CUDA tensors the kernel, or they raise; there is no fallback. Both sides
clamp at the shard's own edges, so the kernel equals the plain version on
every element of the padded shard, halo included.

float32 or bfloat16: the bfloat16 builds (`hs_tile_sweeps_bf16`,
`hs_sor_tile_sweeps_bf16`) run K2's and K3's bfloat16 walks at the float32
geometry and s, and the plain versions follow the storage rule
(`stencils.store`: float32 arithmetic, u and v rounded at the end of every
sweep; an SOR sweep's four color stages in float32).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import sor as k3
from opticalflowhs_tpu_torch.kernels.derivatives import (
    BF16_DTYPES,
    batch_dims,
    check_frames,
)
from opticalflowhs_tpu_torch.ops import stencils

Origins = Union[int, Sequence[int], torch.Tensor]


def origin_grids(shape, row0: Origins, col0: Origins, device):
    """Global row and column grids of an (H, W) shard or an (S, H, W)
    stack: per-slice origins broadcast over the slice."""
    ph, pw = shape[-2:]
    r = torch.as_tensor(row0, dtype=torch.int64, device=device)
    c = torch.as_tensor(col0, dtype=torch.int64, device=device)
    if len(shape) == 3:
        r = r.expand(shape[0])[:, None, None]
        c = c.expand(shape[0])[:, None, None]
    gr = r + torch.arange(ph, device=device)[:, None]
    gc = c + torch.arange(pw, device=device)[None, :]
    return gr, gc


def tile_masks(shape, row0: Origins, col0: Origins, h: int, w: int, device):
    """True-edge masks of a shard (stack) at global origin (row0, col0)."""
    gr, gc = origin_grids(shape, row0, col0, device)
    return stencils.edge_masks(gr, gc, h, w)


def tile_sweeps_plain(u, v, ex, ey, et, inv_den, n_sweeps: int, row0: Origins,
                      col0: Origins, h: int, w: int):
    """n masked Jacobi sweeps over the whole padded shard (or stack); in
    bfloat16 under the storage rule."""
    masks = tile_masks(u.shape, row0, col0, h, w, u.device)
    for _ in range(n_sweeps):
        u, v = stencils.store(stencils.jacobi_step_masked, u, v, ex, ey, et, inv_den, masks)
    return u, v


def sor_tile_sweeps_plain(u, v, ex, ey, et, inv_den, n_sweeps: int,
                          omega: float, row0: Origins, col0: Origins, h: int,
                          w: int):
    """n masked 4-color SOR sweeps, colors by global parity; in bfloat16
    under the storage rule (u and v rounded once a sweep)."""
    gr, gc = origin_grids(u.shape, row0, col0, u.device)
    masks = stencils.edge_masks(gr, gc, h, w)
    colors = stencils.global_colors(gr, gc)
    for _ in range(n_sweeps):
        u, v = stencils.store(stencils.sor_step_masked, u, v, ex, ey, et, inv_den, omega,
                              colors, masks)
    return u, v


def origin_table(u: torch.Tensor, row0: Origins, col0: Origins) -> torch.Tensor:
    """The wrappers' (S, 2) int32 table of per-slice global origins (row0,
    col0: ints or per-slice sequences), on u's device. Build it once per
    solve: the origins of a shard stack do not change from one sweep block
    to the next."""
    s = u.shape[0] if u.ndim == 3 else 1
    r = torch.as_tensor(row0, dtype=torch.int32).expand(s)
    c = torch.as_tensor(col0, dtype=torch.int32).expand(s)
    return torch.stack([r, c], dim=1).contiguous().to(u.device)


def _check_table(u, org):
    s = u.shape[0] if u.ndim == 3 else 1
    if (not isinstance(org, torch.Tensor) or tuple(org.shape) != (s, 2)
            or org.dtype != torch.int32 or org.device != u.device
            or not org.is_contiguous()):
        raise ValueError(f"origins must be an origin_table: a contiguous ({s}, 2) "
                         f"int32 tensor on {u.device}")


def _launcher(entry: str, u, ex, ey, et, inv_den, org, h: int, w: int,
              omega=None):
    """launch(su, sv, du, dv, k) for `jacobi.ping_pong`: one K9 launch of k
    sweeps over the whole stack, through the build of u's dtype."""
    b, ph, pw = batch_dims(entry, u)
    lib = _build.library()
    fn = getattr(lib, entry + _build.bf16_suffix(u.dtype))
    stream = torch.cuda.current_stream(u.device).cuda_stream
    extra = () if omega is None else (float(omega),)

    def launch(su, sv, du, dv, k):
        err = fn(su.data_ptr(), sv.data_ptr(), ex.data_ptr(), ey.data_ptr(),
                 et.data_ptr(), inv_den.data_ptr(), du.data_ptr(), dv.data_ptr(),
                 org.data_ptr(), b, ph, pw, h, w, k, *extra, u.device.index, stream)
        _build.check(err, entry)
        counter = sor_tile_sweeps if omega is not None else tile_sweeps
        counter.launches += 1

    return launch


def tile_sweeps(u, v, ex, ey, et, inv_den, n_sweeps: int, org: torch.Tensor,
                h: int, w: int, block_sweeps: int = 0):
    """n Jacobi sweeps on halo-padded shards, (PH, PW) or an (S, PH, PW)
    stack: clamps at the true h x w image from each slice's global origin,
    given as an `origin_table`. On CUDA tensors ceil(n/s) K9 launches for
    the whole stack (s as K2: `jacobi.sweeps_per_launch(block_sweeps)`), on
    CPU tensors `tile_sweeps_plain`. float32 or bfloat16. Returns the
    padded (u, v)."""
    check_frames("tile_sweeps", u, v, ex, ey, et, inv_den, dtypes=BF16_DTYPES)
    _check_table(u, org)
    if n_sweeps == 0:
        return u, v
    if u.device.type == "cpu":
        return tile_sweeps_plain(u, v, ex, ey, et, inv_den, n_sweeps,
                                 org[:, 0], org[:, 1], h, w)
    launch = _launcher("hs_tile_sweeps", u, ex, ey, et, inv_den, org, h, w)
    return k2.ping_pong(u, v, n_sweeps, k2.sweeps_per_launch(block_sweeps),
                        launch)


def sor_tile_sweeps(u, v, ex, ey, et, inv_den, n_sweeps: int, omega: float,
                    org: torch.Tensor, h: int, w: int, block_sweeps: int = 0):
    """SOR twin of `tile_sweeps`: n 4-color sweeps, colors by global parity;
    ceil(n/s) launches of K9's SOR entry (s by K3's rule,
    `sor.sweeps_per_launch`, for the stack), or the plain version on CPU
    tensors. float32 or bfloat16."""
    check_frames("sor_tile_sweeps", u, v, ex, ey, et, inv_den, dtypes=BF16_DTYPES)
    _check_table(u, org)
    if n_sweeps == 0:
        return u, v
    if u.device.type == "cpu":
        return sor_tile_sweeps_plain(u, v, ex, ey, et, inv_den, n_sweeps, omega,
                                     org[:, 0], org[:, 1], h, w)
    launch = _launcher("hs_sor_tile_sweeps", u, ex, ey, et, inv_den, org, h, w,
                       omega)
    s = k3.sweeps_per_launch(block_sweeps, u.shape, n_sweeps, k3.device_blocks(u.device))
    return k2.ping_pong(u, v, n_sweeps, s, launch)


# Every K9 launch counts here: Jacobi on tile_sweeps, SOR on sor_tile_sweeps.
tile_sweeps.launches = 0
sor_tile_sweeps.launches = 0
