"""Solver, pyramid, Lucas-Kanade, TV-L1, mesh and run configuration,
mirroring opticalflowhs_tpu/config.py.

The field names, defaults and `__post_init__` checks are the reference's,
so a configuration moves between the two packages unchanged. Only the
backend names differ: "torch" is the plain PyTorch path (the counterpart
of the reference's "jnp") and "cuda" the hand-written Hopper kernels (the
counterpart of "pallas"). `from_reference` translates a reference config,
`load_config` a configs/*.json file with dotted overrides, and
`config_hash` tags checkpoints with the reference's hash.

Neither family has learned weights, so a config plus an optional
warm-start flow is all the state that crosses between the packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Any, Tuple

DERIV_VARIANTS = ("hs_cube", "central")

BACKENDS = ("auto", "torch", "cuda")

SOLVERS = ("jacobi", "sor", "multigrid", "robust")

# Storage types of `dtype`: bfloat16 stores every array in 16 bits and
# computes in float32 (the package docstring's rule); it runs for every
# HS solver, TV-L1 and LK untiled, and for the tiled Jacobi and SOR solves
# of dist/.
DTYPES = ("float32", "bfloat16")

# Reference backend name -> port backend name.
_BACKEND_FROM_REFERENCE = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}


def check_dtype(dtype: str) -> None:
    """ValueError unless `dtype` names one of DTYPES."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")


@dataclass(frozen=True)
class HSConfig:
    """Core Horn-Schunck solver configuration."""

    alpha: float = 1.0          # regularization weight; den = alpha^2 + Ex^2 + Ey^2
    iters: int = 100            # fixed Jacobi iteration count
    dtype: str = "float32"      # storage dtype (DTYPES; bfloat16 untiled)
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
        check_dtype(self.dtype)
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


@dataclass(frozen=True)
class LKConfig:
    """Dense pyramidal Lucas-Kanade configuration (lucas_kanade.py), the
    second model family."""

    window: int = 15            # odd box-window side for the local least squares
    iters: int = 3              # warp-refine Newton steps per pyramid level
    eps: float = 1e-3           # Tikhonov diagonal regularization of the 2x2
                                # structure tensor (textureless windows)
    dtype: str = "float32"      # storage dtype (DTYPES; bfloat16 untiled)
    max_step: float = 0.0       # > 0: clamp each refinement's |du|,|dv| (px);
                                # 0 = unclamped
    smooth: bool = True         # binomial-blur the flow between refinements
    warp: str = "auto"          # tiled | gather | auto (= tiled)

    def __post_init__(self):
        check_dtype(self.dtype)
        if self.window < 3 or self.window % 2 == 0:
            raise ValueError("window must be odd and >= 3")
        if self.iters < 1:
            raise ValueError("iters must be >= 1")
        if self.eps <= 0:
            raise ValueError("eps must be > 0")
        if self.max_step < 0:
            raise ValueError("max_step must be >= 0 (0 = unclamped)")
        if self.warp not in ("auto", "tiled", "gather"):
            raise ValueError("warp must be auto|tiled|gather")


@dataclass(frozen=True)
class TVL1Config:
    """TV-L1 flow configuration (tvl1.py): L1 data term, total-variation
    prior, duality-based alternation (Zach, Pock & Bischof 2007)."""

    lambda_: float = 0.15       # data-term weight, in the [0, 255]-intensity
                                # convention: tvl1_solve rescales each pair
                                # jointly to [0, 255] first
    theta: float = 0.3          # quadratic-coupling relaxation parameter
    tau: float = 0.25           # dual ascent step (stable for tau <= 1/4)
    warps: int = 5              # warp-and-relinearize steps per level
    warps_per_level: Tuple[int, ...] = ()  # per-level override of `warps`
                                # (finest first, like iters_per_level);
                                # pyr.iters_per_level is not read
    iters: int = 100            # v/u alternations per warp iteration
    median: bool = True         # 3x3 median of the flow after each warp
    dtype: str = "float32"      # storage dtype (DTYPES; bfloat16 untiled)
    backend: str = "auto"       # inner loop: cuda (K5) for CUDA frames,
                                # torch otherwise
    warp: str = "auto"          # tiled | gather | checked | auto (= checked)

    def __post_init__(self):
        check_dtype(self.dtype)
        if self.lambda_ <= 0 or self.theta <= 0:
            raise ValueError("lambda_ and theta must be > 0")
        if not 0 < self.tau <= 0.25:
            raise ValueError("tau must be in (0, 0.25] (Chambolle stability)")
        if self.warps < 1 or self.iters < 1:
            raise ValueError("warps and iters must be >= 1")
        if any(w < 1 for w in self.warps_per_level):
            raise ValueError("warps_per_level entries must be >= 1")
        if self.warp not in ("auto", "tiled", "gather", "checked"):
            raise ValueError("warp must be auto|tiled|gather|checked")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh configuration for the tiled solver (dist/)."""

    batch: int = 1              # data-parallel axis size (frame pairs)
    y: int = 1                  # spatial tiling: rows of shards
    x: int = 1                  # spatial tiling: columns of shards
    halo_sweeps: int = 1        # exchange an s-px halo every s sweeps (blockwise)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("batch", "y", "x")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.batch, self.y, self.x)

    def __post_init__(self):
        if min(self.batch, self.y, self.x) < 1:
            raise ValueError("mesh axis sizes must be >= 1")
        if self.halo_sweeps < 1:
            raise ValueError("halo_sweeps must be >= 1")


@dataclass(frozen=True)
class RunConfig:
    """Top-level bundle: everything a CLI or bench invocation needs."""

    hs: HSConfig = HSConfig()
    pyramid: PyramidConfig = PyramidConfig(levels=1)
    mesh: MeshConfig = MeshConfig()
    lk: LKConfig = LKConfig()
    tvl1: TVL1Config = TVL1Config()
    method: str = "hs"          # flow model family: hs | lk | tvl1

    def __post_init__(self):
        if self.method not in ("hs", "lk", "tvl1"):
            raise ValueError("method must be hs|lk|tvl1")


_HS_FIELDS = {f.name for f in dataclasses.fields(HSConfig)}
_PYR_FIELDS = {f.name for f in dataclasses.fields(PyramidConfig)}
_LK_FIELDS = {f.name for f in dataclasses.fields(LKConfig)}
_TVL1_FIELDS = {f.name for f in dataclasses.fields(TVL1Config)}
_MESH_FIELDS = {f.name for f in dataclasses.fields(MeshConfig)}


def _translate(d: dict[str, Any]) -> dict[str, Any]:
    """The reference's values in the port's terms: backend renamed (the
    port's own names pass as they are), lists (from JSON) made tuples."""
    vals = dict(d)
    if "backend" in vals and vals["backend"] not in BACKENDS:
        if vals["backend"] not in _BACKEND_FROM_REFERENCE:
            raise ValueError(f"unknown reference backend {vals['backend']!r}")
        vals["backend"] = _BACKEND_FROM_REFERENCE[vals["backend"]]
    for key in ("iters_per_level", "warps_per_level"):
        if key in vals:
            vals[key] = tuple(int(n) for n in vals[key])
    return vals


def from_reference(
    d: dict[str, Any],
) -> HSConfig | PyramidConfig | TVL1Config | LKConfig | MeshConfig:
    """Build the port's config from a reference config.

    `d` is `dataclasses.asdict()` of an opticalflowhs_tpu HSConfig,
    PyramidConfig, TVL1Config, LKConfig or MeshConfig, or the "hs" /
    "pyramid" / "tvl1" / "lk" / "mesh" section of a configs/*.json file.
    The class is chosen by the field names, tried in that order: a dict
    whose keys fit more than one class (such as {"iters": 50}, which fits
    HSConfig, TVL1Config and LKConfig, or {"warp": "gather"}, which fits
    PyramidConfig, TVL1Config and LKConfig) resolves to the first, so
    LKConfig, added after the others, takes only dicts that no earlier
    class fits (such as {"window": 11}). Backend "jnp" maps to "torch" and
    "pallas" to "cuda".
    """
    keys = set(d)
    for fields, cls in ((_HS_FIELDS, HSConfig), (_PYR_FIELDS, PyramidConfig),
                        (_TVL1_FIELDS, TVL1Config), (_LK_FIELDS, LKConfig),
                        (_MESH_FIELDS, MeshConfig)):
        if keys <= fields:
            return cls(**_translate(d))
    raise ValueError(
        f"fields {sorted(keys - _HS_FIELDS)} match none of HSConfig, "
        "PyramidConfig, TVL1Config, LKConfig and MeshConfig"
    )


_SECTIONS = {"hs": HSConfig, "pyramid": PyramidConfig, "mesh": MeshConfig,
             "lk": LKConfig, "tvl1": TVL1Config}


def _coerce(cls: type, field_name: str, value: Any) -> Any:
    """A dotted override's value as `cls.field_name` takes it: strings (from
    a command line) parsed by the field's type, other values as given."""
    ftypes = {f.name: f.type for f in dataclasses.fields(cls)}
    if field_name not in ftypes:
        raise KeyError(f"{cls.__name__} has no field '{field_name}'")
    current = getattr(cls(), field_name) if cls is not RunConfig else None
    ftype = ftypes[field_name]
    if isinstance(value, str):
        if ftype in ("int", int):
            return int(value)
        if ftype in ("float", float):
            return float(value)
        if ftype in ("bool", bool):
            if value.lower() in ("1", "true", "yes", "on"):
                return True
            if value.lower() in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"cannot parse boolean from {value!r}")
        if "Tuple" in str(ftype) or isinstance(current, tuple):
            if value.strip() == "":
                return ()
            return tuple(int(v) for v in value.split(","))
    return value


def load_config(path: str | None = None,
                overrides: dict[str, Any] | None = None) -> RunConfig:
    """Build a RunConfig from an optional JSON file plus dotted overrides,
    as the reference's `load_config` does; each section then goes through
    `from_reference`'s translation (backend "jnp" -> "torch", "pallas" ->
    "cuda"; lists -> tuples), so the reference's configs/*.json load
    unchanged.

    JSON layout mirrors the dataclass nesting:
        {"hs": {"alpha": 1.0, "iters": 100}, "pyramid": {"levels": 3}}
    Overrides use dotted keys: {"hs.alpha": 0.5, "mesh.y": 2}, and
    "method" (hs | lk | tvl1).
    """
    data: dict[str, dict[str, Any]] = {k: {} for k in _SECTIONS}
    method = "hs"
    if path is not None:
        with open(path) as f:
            loaded = json.load(f)
        for sect, vals in loaded.items():
            if sect == "method":
                method = vals
                continue
            if sect not in _SECTIONS:
                raise KeyError(f"unknown config section '{sect}'")
            data[sect].update(vals)
    for key, value in (overrides or {}).items():
        if key == "method":
            method = value
            continue
        if "." not in key:
            raise KeyError(f"override '{key}' must be dotted, e.g. hs.alpha")
        sect, field_name = key.split(".", 1)
        if sect not in _SECTIONS:
            raise KeyError(f"unknown config section '{sect}'")
        data[sect][field_name] = _coerce(_SECTIONS[sect], field_name, value)
    return RunConfig(**{sect: cls(**_translate(data[sect]))
                        for sect, cls in _SECTIONS.items()}, method=method)


def config_hash(cfg) -> str:
    """Stable short hash of any config dataclass (RunConfig, HSConfig, ...):
    the reference's (sha256 of its fields as sorted JSON, 16 hex digits),
    so a config whose backends are "auto" hashes alike in both packages.
    Tags checkpoints (checkpoint.py)."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
