"""Plain PyTorch Horn-Schunck stencils, mirroring opticalflowhs_tpu/ops/stencils.py.

These are the plain versions every CUDA kernel of the port is held
against. Each op keeps the reference's exact association order, so on a
CUDA card the kernels (built without FMA contraction) reproduce them
bitwise, and on the CPU they agree with the JAX reference to float32
rounding.

All shifts clamp at the edge (replicate), over the last two axes.
"""

from __future__ import annotations

import torch

# -- replicate-clamped shifts over the last two axes ---------------------------


def shift_up_row(a: torch.Tensor) -> torch.Tensor:
    """a(i+1, j), clamped at the last row."""
    return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)


def shift_down_row(a: torch.Tensor) -> torch.Tensor:
    """a(i-1, j), clamped at the first row."""
    return torch.cat([a[..., :1, :], a[..., :-1, :]], dim=-2)


def shift_left_col(a: torch.Tensor) -> torch.Tensor:
    """a(i, j+1), clamped at the last column."""
    return torch.cat([a[..., :, 1:], a[..., :, -1:]], dim=-1)


def shift_right_col(a: torch.Tensor) -> torch.Tensor:
    """a(i, j-1), clamped at the first column."""
    return torch.cat([a[..., :, :1], a[..., :, :-1]], dim=-1)


def derivatives(
    i1: torch.Tensor, i2: torch.Tensor, variant: str = "hs_cube"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatiotemporal derivatives Ex, Ey, Et.

    hs_cube: forward differences averaged over the 2x2x2 spatiotemporal
    cube (Horn & Schunck 1981, section 7); central: central differences
    and Et = I2 - I1.
    """
    if variant == "hs_cube":
        ex = torch.zeros_like(i1)
        ey = torch.zeros_like(i1)
        for f in (i1, i2):
            fr = shift_up_row(f)
            fc = shift_left_col(f)
            frc = shift_left_col(fr)
            ex = ex + (fc - f) + (frc - fr)
            ey = ey + (fr - f) + (frc - fc)
        ex = ex * 0.25
        ey = ey * 0.25
        d = i2 - i1
        et = 0.25 * (d + shift_up_row(d) + shift_left_col(d)
                     + shift_left_col(shift_up_row(d)))
        return ex, ey, et
    elif variant == "central":
        ex = 0.5 * (shift_left_col(i1) - shift_right_col(i1))
        ey = 0.5 * (shift_up_row(i1) - shift_down_row(i1))
        et = i2 - i1
        return ex, ey, et
    raise ValueError(f"unknown derivative variant {variant!r}")


def neighbor_avg(u: torch.Tensor) -> torch.Tensor:
    """8-neighbour 1/6-1/12 weighted average, replicate edges.

    Separable form: [1,2,1]x[1,2,1]/12 - u/3, with the reference's
    association order.
    """
    t = shift_down_row(u) + 2.0 * u + shift_up_row(u)
    s = shift_right_col(t) + 2.0 * t + shift_left_col(t)
    return s * (1.0 / 12.0) - u * (1.0 / 3.0)


def jacobi_step(
    u: torch.Tensor,
    v: torch.Tensor,
    ex: torch.Tensor,
    ey: torch.Tensor,
    et: torch.Tensor,
    inv_den: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi sweep: neighbour average, then the HS update.

    `inv_den = 1 / (alpha^2 + Ex^2 + Ey^2)` is loop-invariant.
    """
    ubar = neighbor_avg(u)
    vbar = neighbor_avg(v)
    frac = (ex * ubar + ey * vbar + et) * inv_den
    return ubar - ex * frac, vbar - ey * frac
