"""K1: Horn-Schunck derivatives and the hoisted 1/den in one pass.

Port of opticalflowhs_tpu/kernels/derivatives.py (`derivatives_precompute`,
TPU kernel `_deriv_kernel`) and of the derivative stage of the resident
whole-solve kernel. The CUDA source is csrc/derivatives.cu.

`hs_derivatives` launches the kernel for CUDA tensors and runs the plain
version, `derivatives_plain`, for CPU tensors. There is no fallback: a
CUDA tensor goes through the kernel or the call raises.
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.ops import stencils

_VARIANT_CODES = {"hs_cube": 0, "central": 1}


def derivatives_plain(i1: torch.Tensor, i2: torch.Tensor, alpha: float,
                      variant: str = "hs_cube", zero_sweep: bool = False):
    """(Ex, Ey, Et, 1/(alpha^2+Ex^2+Ey^2)), plus (u1, v1) when zero_sweep.

    u1, v1 = 0 - Ex*(Et*invd), 0 - Ey*(Et*invd) is the first Jacobi sweep
    from u = v = 0 exactly (neighbor_avg(0) == 0)."""
    alpha = float(alpha)
    ex, ey, et = stencils.derivatives(i1, i2, variant)
    invd = 1.0 / (alpha * alpha + ex * ex + ey * ey)
    if not zero_sweep:
        return ex, ey, et, invd
    frac = et * invd
    return ex, ey, et, invd, 0.0 - ex * frac, 0.0 - ey * frac


def check_frames(name: str, *arrays: torch.Tensor) -> None:
    """The kernels take 2-D float32 contiguous tensors of one shape on one
    device; raise ValueError on anything else."""
    first = arrays[0]
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            raise ValueError(f"{name}: expected torch tensors, got {type(a)}")
        if a.ndim != 2:
            raise ValueError(f"{name}: expected 2-D tensors, got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if a.shape != first.shape or a.device != first.device:
            raise ValueError(
                f"{name}: tensors differ in shape or device: "
                f"{tuple(a.shape)} on {a.device} vs "
                f"{tuple(first.shape)} on {first.device}"
            )
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")


def hs_derivatives(i1: torch.Tensor, i2: torch.Tensor, alpha: float,
                   variant: str = "hs_cube", zero_sweep: bool = False):
    """K1 wrapper: the kernel on CUDA tensors, `derivatives_plain` on CPU
    tensors. Returns (ex, ey, et, invd) or, with zero_sweep, also (u1, v1)."""
    check_frames("hs_derivatives", i1, i2)
    if variant not in _VARIANT_CODES:
        raise ValueError(f"unknown derivative variant {variant!r}")
    if i1.device.type == "cpu":
        return derivatives_plain(i1, i2, alpha, variant, zero_sweep)
    h, w = i1.shape
    outs = [torch.empty_like(i1) for _ in range(6 if zero_sweep else 4)]
    ptrs = [o.data_ptr() for o in outs] + ([None, None] if not zero_sweep else [])
    alpha2 = float(alpha) * float(alpha)
    lib = _build.library()
    err = lib.hs_derivatives(
        i1.data_ptr(), i2.data_ptr(), *ptrs, h, w, alpha2,
        _VARIANT_CODES[variant], i1.device.index,
        torch.cuda.current_stream(i1.device).cuda_stream,
    )
    _build.check(err, "hs_derivatives")
    hs_derivatives.launches += 1
    return tuple(outs)


hs_derivatives.launches = 0
