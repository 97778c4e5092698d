"""The bfloat16 divergence tables of ROADMAP.md queue 3 (SOR and IRLS;
TV-L1, multigrid and LK): the reference's bfloat16 solve, the port's and
the reference's float32 solve of the same `translation_pair(h, w, 1.0,
0.0, key)` on the CPU, u only, interior (8 px in) mean / max |difference|
in px.

    JAX_PLATFORMS=cpu python tests/port/bf16_divergence.py

Imports the JAX reference, as the port's tests do; not collected by
pytest (its name does not start with test_).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from opticalflowhs_tpu.config import HSConfig as RefHS  # noqa: E402
from opticalflowhs_tpu.config import LKConfig as RefLK  # noqa: E402
from opticalflowhs_tpu.config import PyramidConfig as RefPyr  # noqa: E402
from opticalflowhs_tpu.config import TVL1Config as RefTV  # noqa: E402
from opticalflowhs_tpu.lucas_kanade import lk_solve as ref_lk  # noqa: E402
from opticalflowhs_tpu.pyramid import hs_pyramid as ref_pyramid  # noqa: E402
from opticalflowhs_tpu.solver import hs_solve as ref_solve  # noqa: E402
from opticalflowhs_tpu.tvl1 import tvl1_solve as ref_tvl1  # noqa: E402
from opticalflowhs_tpu_torch import (  # noqa: E402
    HSConfig,
    LKConfig,
    PyramidConfig,
    TVL1Config,
    hs_pyramid,
    hs_solve,
    lk_solve,
    tvl1_solve,
)
from opticalflowhs_tpu_torch.data.synthetic import translation_pair  # noqa: E402

ROWS = [("sor", 64, 96, 0.5, 50, 1.7, 5), ("sor", 128, 192, 0.5, 50, 1.7, 5),
        ("sor", 96, 128, 1.0, 200, 1.8, 3), ("robust", 64, 96, 0.5, 100, 0.0, 5),
        ("robust", 128, 192, 0.25, 100, 0.0, 5), ("robust", 96, 128, 0.1, 400, 0.0, 3)]
# (family, h, w, settings, levels, key): TV-L1 (warps, iters), multigrid
# (alpha, V-cycles), LK (window, refinements).
FAMILY_ROWS = [("tvl1", 64, 96, (2, 20), 1, 5), ("tvl1", 128, 192, (5, 100), 2, 5),
               ("multigrid", 64, 96, (1.0, 4), 1, 5), ("multigrid", 128, 192, (1.0, 8), 1, 3),
               ("multigrid", 96, 128, (0.5, 4), 2, 3), ("lk", 64, 96, (15, 3), 1, 5),
               ("lk", 128, 192, (15, 3), 2, 5)]


def _dist(a, b) -> str:
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))[8:-8, 8:-8]
    return f"{d.mean():.4f} / {d.max():.3f}"


def main() -> None:
    print("| solver h×w, α, iters, ω (key) | ref bf16 vs ref f32 | port bf16 vs ref f32 "
          "| port bf16 vs ref bf16 |")
    for solver, h, w, alpha, iters, omega, key in ROWS:
        i1, i2, _ = translation_pair(h, w, 1.0, 0.0, key=key)
        kw = dict(alpha=alpha, iters=iters, solver=solver, robust_update_every=20)
        if solver == "sor":
            kw["omega"] = omega
        r32, r16 = (ref_solve(jnp.asarray(i1), jnp.asarray(i2),
                              RefHS(backend="jnp", dtype=dt, **kw)).u
                    for dt in ("float32", "bfloat16"))
        p16 = hs_solve(i1, i2, HSConfig(dtype="bfloat16", **kw), device="cpu").u.float().numpy()
        print(f"| {solver} {h}×{w}, {alpha}, i{iters}, {omega} ({key}) | {_dist(r16, r32)} "
              f"| {_dist(p16, r32)} | {_dist(p16, r16)} |", flush=True)
    print("\n| family h×w, settings, levels (key) | ref bf16 vs ref f32 | port bf16 vs ref f32 "
          "| port bf16 vs ref bf16 |")
    for family, h, w, (a, n), levels, key in FAMILY_ROWS:
        i1, i2, _ = translation_pair(h, w, 1.0, 0.0, key=key)
        j1, j2 = jnp.asarray(i1), jnp.asarray(i2)
        rpyr = RefPyr(levels=levels, iters_per_level=())
        pyr = PyramidConfig(levels=levels, iters_per_level=())
        if family == "tvl1":
            what = f"warps {a}, iters {n}"
            r32, r16 = (ref_tvl1(j1, j2, RefTV(warps=a, iters=n, backend="jnp", dtype=dt), rpyr).u
                        for dt in ("float32", "bfloat16"))
            p16 = tvl1_solve(i1, i2, TVL1Config(warps=a, iters=n, dtype="bfloat16"), pyr,
                             device="cpu").u
        elif family == "lk":
            what = f"window {a}, iters {n}"
            r32, r16 = (ref_lk(j1, j2, RefLK(window=a, iters=n, dtype=dt), rpyr).u
                        for dt in ("float32", "bfloat16"))
            p16 = lk_solve(i1, i2, LKConfig(window=a, iters=n, dtype="bfloat16"), pyr,
                           device="cpu").u
        else:
            what = f"α {a}, {n} V-cycles"
            kw = dict(alpha=a, iters=n, solver="multigrid")
            if levels == 1:
                r32, r16 = (ref_solve(j1, j2, RefHS(backend="jnp", dtype=dt, **kw)).u
                            for dt in ("float32", "bfloat16"))
                p16 = hs_solve(i1, i2, HSConfig(dtype="bfloat16", **kw), device="cpu").u
            else:
                r32, r16 = (ref_pyramid(j1, j2, RefHS(backend="jnp", dtype=dt, **kw),
                                        RefPyr(levels=levels)).u
                            for dt in ("float32", "bfloat16"))
                p16 = hs_pyramid(i1, i2, HSConfig(dtype="bfloat16", **kw),
                                 PyramidConfig(levels=levels), device="cpu").u
        p16 = p16.float().numpy()
        print(f"| {family} {h}×{w}, {what}, L{levels} ({key}) | {_dist(r16, r32)} "
              f"| {_dist(p16, r32)} | {_dist(p16, r16)} |", flush=True)


if __name__ == "__main__":
    main()
