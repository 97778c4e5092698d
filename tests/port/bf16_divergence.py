"""The bfloat16 divergence table of ROADMAP.md queue 3 (SOR and IRLS): the
reference's bfloat16 solve, the port's and the reference's float32 solve
of the same `translation_pair(h, w, 1.0, 0.0, key)` on the CPU, u only,
interior (8 px in) mean / max |difference| in px.

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
from opticalflowhs_tpu.solver import hs_solve as ref_solve  # noqa: E402
from opticalflowhs_tpu_torch import HSConfig, hs_solve  # noqa: E402
from opticalflowhs_tpu_torch.data.synthetic import translation_pair  # noqa: E402

ROWS = [("sor", 64, 96, 0.5, 50, 1.7, 5), ("sor", 128, 192, 0.5, 50, 1.7, 5),
        ("sor", 96, 128, 1.0, 200, 1.8, 3), ("robust", 64, 96, 0.5, 100, 0.0, 5),
        ("robust", 128, 192, 0.25, 100, 0.0, 5), ("robust", 96, 128, 0.1, 400, 0.0, 3)]


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


if __name__ == "__main__":
    main()
