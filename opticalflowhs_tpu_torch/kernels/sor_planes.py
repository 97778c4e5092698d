"""K8: the whole 4-color SOR solve of a frame in one launch.

Port of opticalflowhs_tpu/kernels/sor_planes.py (`hs_solve_sor_planes`, TPU
kernel `_planes_kernel`). The reference holds u, v and the four fields as
the four quarter-resolution parity planes of the frame in VMEM, so that a
color stage of a SOR sweep touches exactly one plane, with no masks and no
idle lanes, and runs all n sweeps in one launch. `sor_planes_plain` keeps
that plane schedule in plain torch: the separable [1,2,1] passes sum the
same three values in the same order as at full resolution, so it equals
the plain SOR sweeps (ops/stencils.py sor_step) bitwise.

On the H100 the planes are not needed (K3's half sweeps, split by row
parity, do no masked work), and the launch is what the reference's kernel
is: csrc/sor_planes.cu runs all n sweeps in ONE persistent cooperative
launch on K3's window walk (csrc/k3_window.cuh), sweep blocks of s sweeps
separated by grid barriers, u/v alternating between two pairs A and B, the
zero start staged as zeros, the remainder n mod s the last block.
`k8_schedule_plain` walks that schedule in plain torch. `sor_planes`
launches it for CUDA tensors and runs `sor_planes_plain` for CPU tensors.
There is no fallback: a CUDA tensor goes through the kernel or the call
raises.

`hs_solve_sor_planes` keeps the reference's contract: None for a stack, no
sweeps, the central variant or a frame outside the reference's plane class
(`applicable_shape`), and never otherwise. As in the reference, the solver
does not route to it: SOR solves take the K1 + K3 chain.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels import _build, autodiff
from opticalflowhs_tpu_torch.kernels.derivatives import (
    BF16_DTYPES,
    check_frames,
    hs_derivatives,
)
from opticalflowhs_tpu_torch.kernels.solve_fused import (
    barrier_count,
    build_geometry,
    resident_blocks,
)
from opticalflowhs_tpu_torch.kernels.solve_resident import round_up
from opticalflowhs_tpu_torch.kernels.sor import (
    K3_BLOCKS,
    k3_launch_schedule_plain,
    k3_tiles,
    sweeps_per_launch,
)
from opticalflowhs_tpu_torch.ops import stencils

# The reference's plane class (opticalflowhs_tpu/kernels/sor_planes.py
# `applicable_shape` :57, no HSFLOW_* override): the plane set and its
# temporaries, 11 full-frame equivalents of the frame padded to 16 x 256,
# in the dtype's bytes, within a 112 MiB TPU VMEM budget. It is the
# reference's rule for where its kernel runs, not a property of the H100.
_FULL_EQUIV = 11
_LIMIT = 112 * 1024 * 1024

# The four colors in stage order: (row % 2, col % 2).
COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))


def applicable_shape(h: int, w: int, itemsize: int = 4):
    """The reference's (hp, wp) for an (h, w) frame of `itemsize`-byte
    elements (4 float32, 2 bfloat16) inside its plane class, else None."""
    hp = round_up(h, 16)
    wp = round_up(w, 256)
    if _FULL_EQUIV * hp * wp * itemsize <= _LIMIT:
        return hp, wp
    return None


def plane_shape(h: int, w: int) -> tuple[int, int]:
    """(ceil(h/2), ceil(w/2)): the shape of every plane of an (h, w) frame."""
    return (h + 1) // 2, (w + 1) // 2


def planes(a: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The four parity planes of an (H, W) array in COLORS order, each of
    `plane_shape`; where H or W is odd, the planes of the short parity end
    in a pad row or column of zeros."""
    h, w = a.shape
    h2, w2 = plane_shape(h, w)
    out = []
    for pi, pj in COLORS:
        p = a.new_zeros((h2, w2))
        src = a[pi::2, pj::2]
        p[:src.shape[0], :src.shape[1]] = src
        out.append(p)
    return tuple(out)


def interleave(p00, p01, p10, p11, h: int, w: int) -> torch.Tensor:
    """The (h, w) array whose parity planes these are (pads dropped)."""
    h2, w2 = p00.shape
    r0 = torch.stack([p00, p01], dim=-1).reshape(h2, 2 * w2)
    r1 = torch.stack([p10, p11], dim=-1).reshape(h2, 2 * w2)
    return torch.stack([r0, r1], dim=1).reshape(2 * h2, 2 * w2)[:h, :w].contiguous()


def sor_planes_plain(u0, v0, ex, ey, et, inv_den, n: int, omega: float):
    """n 4-color SOR sweeps of an (H, W) frame on its parity planes, stage by
    stage, as the reference's `_planes_kernel` (:100-160): the vertical pass
    of a plane mixes the two row parities of its column parity, the
    horizontal pass the two column parities, and the true bottom row and
    right column are clamped by a one-row or one-column fix whose plane
    depends on the parity of h and w. u0/v0 None start from zero. The
    sweeps run through `stencils.checkpointed_loop` on the eight planes of
    u and v. Returns (u, v) at full resolution. bfloat16 arrays follow the
    storage rule (`stencils.store`): each sweep on the widened planes in
    float32, u and v rounded at its end, as `sor.sor_sweeps_plain`."""
    h, w = ex.shape
    h2, w2 = plane_shape(h, w)
    if u0 is None:
        u0, v0 = torch.zeros_like(ex), torch.zeros_like(ex)
    F = [dict(zip(COLORS, planes(f))) for f in (ex, ey, et, inv_den)]
    h_odd = h % 2 == 1
    w_odd = w % 2 == 1
    # The bottom clamp row h-1 lives in the planes of parity (h-1)%2 at plane
    # row (h-1)//2; likewise the right column.
    m_bot = (torch.arange(h2, device=ex.device) == (h - 1) // 2)[:, None]
    m_rt = (torch.arange(w2, device=ex.device) == (w - 1) // 2)[None, :]

    def tpass(P, pi, pjc):
        """Vertical [1,2,1] pass at (row parity pi, column parity pjc)."""
        center = P[(pi, pjc)]
        other = P[(1 - pi, pjc)]
        if pi == 0:
            up = torch.cat([center[0:1], other[:h2 - 1]], dim=0)  # row 0 clamps
            dn = other
            if h_odd:  # the true bottom row is even: clamp to center
                dn = torch.where(m_bot, center, dn)
        else:
            up = other
            dn = torch.cat([other[1:], other[h2 - 1:]], dim=0)
            if not h_odd:  # the true bottom row is odd: clamp to center
                dn = torch.where(m_bot, center, dn)
        return up + 2.0 * center + dn

    def navg_plane(P, pi, pj):
        """neighbor_avg restricted to color (pi, pj), bitwise."""
        t_same = tpass(P, pi, pj)
        t_other = tpass(P, pi, 1 - pj)
        if pj == 0:
            lf = torch.cat([t_same[:, 0:1], t_other[:, :w2 - 1]], dim=1)
            rt = t_other
            if w_odd:
                rt = torch.where(m_rt, t_same, rt)
        else:
            lf = t_other
            rt = torch.cat([t_other[:, 1:], t_other[:, w2 - 1:]], dim=1)
            if not w_odd:
                rt = torch.where(m_rt, t_same, rt)
        s = lf + 2.0 * t_same + rt
        return s * (1.0 / 12.0) - P[(pi, pj)] * (1.0 / 3.0)

    def sweep(state):
        U = dict(zip(COLORS, state[:4]))
        V = dict(zip(COLORS, state[4:]))
        for c in COLORS:
            ubar = navg_plane(U, *c)
            vbar = navg_plane(V, *c)
            e_x, e_y, e_t, ivd = (f[c] for f in F)
            frac = (e_x * ubar + e_y * vbar + e_t) * ivd
            un = ubar - e_x * frac
            vn = vbar - e_y * frac
            U[c] = U[c] + omega * (un - U[c])
            V[c] = V[c] + omega * (vn - V[c])
        return tuple(U[c] for c in COLORS) + tuple(V[c] for c in COLORS)

    state = stencils.checkpointed_loop(
        lambda st: stencils.store(lambda *x: sweep(x), *st), planes(u0) + planes(v0), n)
    return interleave(*state[:4], h, w), interleave(*state[4:], h, w)


def k8_schedule_plain(u0, v0, ex, ey, et, inv_den, n: int, omega: float, s: int = 0):
    """K8's launch in plain torch, on an (H, W) frame: ceil(n/s) sweep
    blocks (s by `sweeps_per_launch(s, ...)`, K3's rule, as the wrapper
    picks it on an H100's 132 blocks), each one K3 launch's walk (`sor.k3_launch_schedule_plain`:
    K3 tiles, windows staged with NaN outside the array, only owned tiles
    written), the last one the remainder n mod s at its own tile. Block 0
    reads (u0, v0), or zeros when both are None; block k writes pair A (k
    even) or B (k odd), which start as NaN, and block k + 1 reads it. Returns
    the pair the last block wrote. Equals `sor_planes_plain` and the plain
    SOR sweeps bitwise (the tests hold it to that)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    if n < 1:
        raise ValueError("n must be >= 1")
    s = sweeps_per_launch(s, ex.shape, n, K3_BLOCKS)
    pairs = [tuple(torch.full_like(ex, float("nan")) for _ in range(2)) for _ in range(2)]
    u, v = (torch.zeros_like(ex), torch.zeros_like(ex)) if u0 is None else (u0, v0)
    for k, done in enumerate(range(0, n, s)):
        du, dv = pairs[k % 2]
        ou, ov = k3_launch_schedule_plain(u, v, ex, ey, et, inv_den, min(s, n - done), omega)
        du.copy_(ou)
        dv.copy_(ov)
        u, v = du, dv
    return u, v


def k8_geometry(device, sweeps: int = 4, dtype=torch.float32) -> dict:
    """K8's build (of `dtype`: float32 or bfloat16) at `sweeps` on a CUDA
    device (`solve_fused.build_geometry`): K3's tile, threads, shared bytes,
    registers a thread, spilled bytes, resident blocks a multiprocessor,
    multiprocessors."""
    return build_geometry("hs_sor_planes_geometry" + _build.bf16_suffix(dtype), device,
                          sweeps)


def sor_planes(u0, v0, ex, ey, et, inv_den, n: int, omega: float,
               block_sweeps: int = 0, blocks: int = 0):
    """n 4-color SOR sweeps of an (H, W) frame, from (u0, v0) or, when both
    are None, from zero: on CUDA tensors one K8 launch (s sweeps a block, s
    by K3's rule `sor.sweeps_per_launch(block_sweeps, ...)`; `blocks` > 0
    forces the grid, and a grid larger than can be resident raises), none
    for n = 0; on CPU tensors `sor_planes_plain`. float32 or bfloat16 (K8's
    bfloat16 build, on K3's bfloat16 walk). Returns new (u, v); the
    inputs are not modified. Differentiable with respect to the start and
    the fields (`autodiff`: the VJP of `sor_planes_plain`)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    if autodiff.needs_grad(u0, v0, ex, ey, et, inv_den):
        return autodiff.KernelEntry.apply(
            lambda *t: sor_planes(*t, n, omega, block_sweeps, blocks),
            lambda *t: sor_planes_plain(*t, n, omega), u0, v0, ex, ey, et, inv_den)
    check_frames("sor_planes", ex, ey, et, inv_den, *(() if u0 is None else (u0, v0)),
                 dtypes=BF16_DTYPES)
    if ex.ndim != 2:
        raise ValueError(f"sor_planes: expected an (H, W) frame, got {tuple(ex.shape)}")
    if n < 0:
        raise ValueError("n must be >= 0")
    if block_sweeps < 0 or blocks < 0:
        raise ValueError("block_sweeps and blocks must be >= 0 (0 = auto)")
    if ex.device.type == "cpu":
        return sor_planes_plain(u0, v0, ex, ey, et, inv_den, n, omega)
    if n == 0 or ex.numel() == 0:
        if u0 is None:
            return torch.zeros_like(ex), torch.zeros_like(ex)
        return u0.clone(), v0.clone()
    h, w = ex.shape
    dev = ex.device.index
    bf16 = _build.bf16_suffix(ex.dtype)
    grid_max = resident_blocks("hs_sor_planes_blocks" + bf16, dev)
    s = sweeps_per_launch(block_sweeps, ex.shape, n, grid_max)
    n_blocks = -(-n // s)
    ua, va = torch.empty_like(ex), torch.empty_like(ex)
    ub, vb = (ua, va) if n_blocks == 1 else (torch.empty_like(ex), torch.empty_like(ex))
    grid = blocks if blocks > 0 else min(k3_tiles(ex.shape, s), grid_max)
    stream = torch.cuda.current_stream(ex.device).cuda_stream
    start = (None, None) if u0 is None else (u0.data_ptr(), v0.data_ptr())
    err = getattr(_build.library(), "hs_sor_planes" + bf16)(
        *start, ex.data_ptr(), ey.data_ptr(), et.data_ptr(), inv_den.data_ptr(),
        ua.data_ptr(), va.data_ptr(), ub.data_ptr(), vb.data_ptr(),
        barrier_count(dev, stream).data_ptr(), h, w, n, s, float(omega), grid, dev, stream,
    )
    _build.check(err, "hs_sor_planes" + bf16)
    sor_planes.launches += 1
    return (ua, va) if n_blocks % 2 == 1 else (ub, vb)


# Every K8 launch: one a call with n >= 1 on CUDA tensors.
sor_planes.launches = 0


def hs_solve_sor_planes(i1, i2, alpha: float, n_sweeps: int, omega: float,
                        variant: str = "hs_cube", u0=None, v0=None):
    """Whole 4-color SOR solve of an (H, W) pair on color planes: K1, then
    one K8 call, on CUDA tensors; `derivatives_plain` and `sor_planes_plain`
    on CPU tensors. Returns (u, v), or None where the reference's kernel
    does: a frame that is not 2-D, n_sweeps < 1, a variant other than
    hs_cube, or a frame outside its plane class (`applicable_shape` in the
    frames' bytes). A build or launch failure raises. Differentiable with respect to the
    frames and the start, through K1's and K8's entries (`autodiff`)."""
    if (u0 is None) != (v0 is None):
        raise ValueError("u0 and v0 must be given together")
    if i1.ndim != 2 or n_sweeps < 1 or variant != "hs_cube":
        return None
    if applicable_shape(*i1.shape, i1.element_size()) is None:
        return None
    if not autodiff.needs_grad(i1, i2, u0, v0):
        check_frames("hs_solve_sor_planes", i1, i2, *(() if u0 is None else (u0, v0)),
                     dtypes=BF16_DTYPES)
    ex, ey, et, invd = hs_derivatives(i1, i2, alpha, variant)
    return sor_planes(u0, v0, ex, ey, et, invd, n_sweeps, omega)
