"""K1: Horn-Schunck derivatives and the hoisted 1/den in one pass.

Port of opticalflowhs_tpu/kernels/derivatives.py (`derivatives_precompute`,
TPU kernel `_deriv_kernel`, one frame or a (B, H, W) stack) and of the
derivative stage of the resident whole-solve kernels, single and batched.
The CUDA source is csrc/derivatives.cu; a stack is one launch, with the
image as the grid's z index.

`hs_derivatives` launches the kernel for CUDA tensors and runs the plain
version, `derivatives_plain`, for CPU tensors. There is no fallback: a
CUDA tensor goes through the kernel or the call raises. CUDA frames that
need a gradient go through `autodiff.KernelEntry`: the kernel forward,
the VJP of `derivatives_plain` backward (the reference's `_derivatives_ad`).
"""

from __future__ import annotations

import torch

from opticalflowhs_tpu_torch.kernels import _build, autodiff
from opticalflowhs_tpu_torch.ops import stencils

_VARIANT_CODES = {"hs_cube": 0, "central": 1}


def derivatives_plain(i1: torch.Tensor, i2: torch.Tensor, alpha: float,
                      variant: str = "hs_cube", zero_sweep: bool = False):
    """(Ex, Ey, Et, 1/(alpha^2+Ex^2+Ey^2)), plus (u1, v1) when zero_sweep.

    u1, v1 = 0 - Ex*(Et*invd), 0 - Ey*(Et*invd) is the first Jacobi sweep
    from u = v = 0 exactly (neighbor_avg(0) == 0).

    bfloat16 frames give bfloat16 arrays by the storage rule
    (`stencils.store`): the fields are rounded, invd is formed from the
    rounded Ex and Ey and rounded, and the first sweep is formed from the
    rounded arrays. In float32 these are the plain ops with no rounding."""
    alpha2 = float(alpha) * float(alpha)
    ex, ey, et = stencils.store(lambda a, b: stencils.derivatives(a, b, variant), i1, i2)
    invd = stencils.store(lambda x, y: 1.0 / (alpha2 + x * x + y * y), ex, ey)
    if not zero_sweep:
        return ex, ey, et, invd

    def first(x, y, t, i):
        frac = t * i
        return 0.0 - x * frac, 0.0 - y * frac

    return (ex, ey, et, invd) + stencils.store(first, ex, ey, et, invd)


# The storage types of the kernels with a bfloat16 build: every one, K1-K12
# (K4's freeze and sweeps too), and the K1 + K2, K1 + K3 and K1 + K4
# drivers.
BF16_DTYPES = (torch.float32, torch.bfloat16)


def check_frames(name: str, *arrays: torch.Tensor,
                 dtypes=(torch.float32,)) -> None:
    """The kernels take (H, W) or (B, H, W) contiguous tensors of one
    shape, one dtype and one device; raise ValueError on anything else.
    The dtype is float32, or one of `dtypes` for an entry with builds in
    more types (BF16_DTYPES).

    Raise RuntimeError for CUDA tensors of which any requires grad while
    grad mode is on: the kernels write their outputs through raw pointers,
    so a flow computed by them alone has no grad_fn and the gradient would
    be lost without a word. The entries K1-K8 and the whole-solve drivers
    route such calls through `autodiff.KernelEntry` before they get
    here, so only the parts with no autograd scheme of their own reach the
    refusal: K4's freeze and sweep launches (called by K4's entries with
    grad off), K9-K12 and the tiled solver on CUDA shards. CPU tensors run
    the plain path, which torch differentiates itself, and are not
    refused."""
    first = arrays[0]
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            raise ValueError(f"{name}: expected torch tensors, got {type(a)}")
        if a.ndim not in (2, 3):
            raise ValueError(
                f"{name}: expected (H, W) or (B, H, W) tensors, got {tuple(a.shape)}"
            )
        if a.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise ValueError(f"{name}: expected {names}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if (a.shape != first.shape or a.device != first.device
                or a.dtype != first.dtype):
            raise ValueError(
                f"{name}: tensors differ in shape, dtype or device: "
                f"{tuple(a.shape)} {a.dtype} on {a.device} vs "
                f"{tuple(first.shape)} {first.dtype} on {first.device}"
            )
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    if (first.device.type == "cuda" and torch.is_grad_enabled()
            and any(a.requires_grad for a in arrays)):
        raise RuntimeError(
            f"{name}: this kernel does not differentiate, as the reference's "
            "tile and rdma kernels do not, so the gradient would be dropped "
            "(a tiled solve's gradient waits for ROADMAP.md queue 1 item 6; "
            "K4's freeze and sweep launches differentiate only through "
            "robust_sweeps and hs_solve_robust_resident); call under "
            "torch.no_grad(), or solve untiled"
        )


def batch_dims(name: str, a: torch.Tensor) -> tuple[int, int, int]:
    """(B, H, W) of an (H, W) frame (B = 1) or a (B, H, W) stack; raise
    ValueError for a batch beyond one launch's grid."""
    b = a.shape[0] if a.ndim == 3 else 1
    if b > _build.MAX_BATCH:
        raise ValueError(
            f"{name}: batch {b} exceeds {_build.MAX_BATCH}, the most one "
            "launch's grid takes; split the stack"
        )
    return b, a.shape[-2], a.shape[-1]


def hs_derivatives(i1: torch.Tensor, i2: torch.Tensor, alpha: float,
                   variant: str = "hs_cube", zero_sweep: bool = False):
    """K1 wrapper over an (H, W) pair or a (B, H, W) stack of pairs: the
    kernel on CUDA tensors (one launch for the whole stack),
    `derivatives_plain` on CPU tensors. Returns (ex, ey, et, invd) or, with
    zero_sweep, also (u1, v1), each of the frames' shape and dtype
    (float32, or bfloat16 through the kernel's bfloat16 build, which
    computes in float32 and rounds each array once where it is stored).
    Differentiable with respect to both frames (`autodiff`)."""
    if autodiff.needs_grad(i1, i2):
        return autodiff.KernelEntry.apply(
            lambda a, b: hs_derivatives(a, b, alpha, variant, zero_sweep),
            lambda a, b: derivatives_plain(a, b, alpha, variant, zero_sweep), i1, i2)
    check_frames("hs_derivatives", i1, i2, dtypes=BF16_DTYPES)
    if variant not in _VARIANT_CODES:
        raise ValueError(f"unknown derivative variant {variant!r}")
    if i1.device.type == "cpu":
        return derivatives_plain(i1, i2, alpha, variant, zero_sweep)
    b, h, w = batch_dims("hs_derivatives", i1)
    outs = [torch.empty_like(i1) for _ in range(6 if zero_sweep else 4)]
    if i1.numel() == 0:
        return tuple(outs)
    ptrs = [o.data_ptr() for o in outs] + ([None, None] if not zero_sweep else [])
    alpha2 = float(alpha) * float(alpha)
    err = getattr(_build.library(), "hs_derivatives" + _build.bf16_suffix(i1.dtype))(
        i1.data_ptr(), i2.data_ptr(), *ptrs, b, h, w, alpha2,
        _VARIANT_CODES[variant], i1.device.index,
        torch.cuda.current_stream(i1.device).cuda_stream,
    )
    _build.check(err, "hs_derivatives")
    hs_derivatives.launches += 1
    return tuple(outs)


hs_derivatives.launches = 0
