"""Solver and pyramid configuration, mirroring opticalflowhs_tpu/config.py.

The field names, defaults and `__post_init__` checks are the reference's,
so a configuration moves between the two packages unchanged. Only the
backend names differ: "torch" is the plain PyTorch path (the counterpart
of the reference's "jnp") and "cuda" the hand-written Hopper kernels (the
counterpart of "pallas"). `from_reference` translates a reference config.

Horn-Schunck has no learned weights, so a config plus an optional
warm-start flow is all the state that crosses between the packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

DERIV_VARIANTS = ("hs_cube", "central")

BACKENDS = ("auto", "torch", "cuda")

SOLVERS = ("jacobi", "sor", "multigrid", "robust")

# Reference backend name -> port backend name.
_BACKEND_FROM_REFERENCE = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}


@dataclass(frozen=True)
class HSConfig:
    """Core Horn-Schunck solver configuration."""

    alpha: float = 1.0          # regularization weight; den = alpha^2 + Ex^2 + Ey^2
    iters: int = 100            # fixed Jacobi iteration count
    dtype: str = "float32"      # compute dtype (the port runs float32 only)
    deriv_variant: str = "hs_cube"
    backend: str = "auto"       # auto -> cuda for CUDA frames, torch otherwise
    block_sweeps: int = 0       # sweeps per Jacobi kernel launch (0 = auto)
    checkpoint_every: int = 0   # reference chunking knob; values never depend on it
    solver: str = "jacobi"      # relaxation scheme (SOLVERS)
    omega: float = 1.9          # SOR over-relaxation factor, (0, 2); 0 = auto
    robust_eps_d: float = 0.05  # Charbonnier eps of the data term
    robust_eps_s: float = 0.05  # Charbonnier eps of the smoothness term
    robust_update_every: int = 20  # sweeps between IRLS weight refreezes
    tol: float = 0.0            # > 0: solve-to-tolerance; 0 = fixed iters

    def __post_init__(self):
        if self.deriv_variant not in DERIV_VARIANTS:
            raise ValueError(f"deriv_variant must be one of {DERIV_VARIANTS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if self.solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}")
        if not (self.omega == 0.0 or 0.0 < self.omega < 2.0):
            raise ValueError("omega must be in (0, 2), or 0 for auto-tuned "
                             "(solver.tune_omega; hs_solve only)")
        if self.tol < 0:
            raise ValueError("tol must be >= 0")
        if self.tol > 0 and self.checkpoint_every > 0:
            raise ValueError(
                "tol-based early stopping and checkpoint_every chunking "
                "are mutually exclusive (the chunked loop needs a fixed "
                "sweep schedule)"
            )
        if self.iters < 0:
            raise ValueError("iters must be >= 0")
        if self.robust_eps_d <= 0 or self.robust_eps_s <= 0:
            raise ValueError("robust_eps_d/robust_eps_s must be > 0")
        if self.robust_update_every < 1:
            raise ValueError("robust_update_every must be >= 1")
        if self.block_sweeps < 0:
            raise ValueError("block_sweeps must be >= 0 (0 = auto)")


@dataclass(frozen=True)
class PyramidConfig:
    """Coarse-to-fine pyramid configuration."""

    levels: int = 3             # 1 = single-level (no pyramid)
    blur: str = "binomial5"     # 5-tap binomial [1,4,6,4,1]/16, separable
    iters_per_level: Tuple[int, ...] = ()  # empty -> HSConfig.iters everywhere
    # Warp semantics: "tiled" = the reference's tiled warp (per-tile rounded
    # mean displacement, local offsets clamped to +/-R), "gather" = plain
    # bilinear gather, "checked" = tiled while provably exact, else gather,
    # "auto" = tiled.
    warp: str = "auto"
    warp_radius: int = 0        # tiled-warp R; 0 = auto (R = 4 in value)

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError("levels must be >= 1")
        if self.warp not in ("auto", "tiled", "gather", "checked"):
            raise ValueError("warp must be auto|tiled|gather|checked")
        if not 0 <= self.warp_radius <= 8:
            raise ValueError("warp_radius must be 0 (auto) or 1..8")
        if self.iters_per_level and len(self.iters_per_level) != self.levels:
            raise ValueError("iters_per_level must match levels")


_HS_FIELDS = {f.name for f in dataclasses.fields(HSConfig)}
_PYR_FIELDS = {f.name for f in dataclasses.fields(PyramidConfig)}


def from_reference(d: dict[str, Any]) -> HSConfig | PyramidConfig:
    """Build the port's config from a reference config.

    `d` is `dataclasses.asdict()` of an opticalflowhs_tpu HSConfig or
    PyramidConfig, or the "hs" / "pyramid" section of a configs/*.json
    file. The class is chosen by the field names; backend "jnp" maps to
    "torch" and "pallas" to "cuda".
    """
    keys = set(d)
    if keys <= _HS_FIELDS:
        vals = dict(d)
        if "backend" in vals:
            if vals["backend"] not in _BACKEND_FROM_REFERENCE:
                raise ValueError(f"unknown reference backend {vals['backend']!r}")
            vals["backend"] = _BACKEND_FROM_REFERENCE[vals["backend"]]
        return HSConfig(**vals)
    if keys <= _PYR_FIELDS:
        vals = dict(d)
        if "iters_per_level" in vals:
            vals["iters_per_level"] = tuple(int(n) for n in vals["iters_per_level"])
        return PyramidConfig(**vals)
    raise ValueError(
        f"fields {sorted(keys - _HS_FIELDS)} match neither HSConfig nor "
        "PyramidConfig"
    )
