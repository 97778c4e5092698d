#!/usr/bin/env python3
"""Time the bfloat16 builds of K2, K6, K7, K3, K8 and K4 beside their
float32 builds on one CUDA card, in one process, on the same noise frames
(default_rng(0)), alpha 0.5, the fields computed once by K1 in each dtype:

  * `k2_8`: one K2 launch of 8 sweeps from zero (`jacobi.launch_sweeps`);
  * `k6_8`: one K6 sweep block of 8 (`solve_fused.launch_fused`);
  * `k6_100`, `k7_100`: a whole K6 or K7 launch of 100 sweeps from zero;
  * `hs_solve`: the entry point, i100 (the route the reference's classes
    pick in each dtype), host time median of 20, synced;
  * `k3_4`: one K3 launch of 4 sweeps from zero (`sor.launch_sweeps`,
    omega 1.71); `k8_50`: one K8 launch of 50 sweeps (`sor_planes`);
  * `k4_freeze`, `k4_5`: one K4 freeze and one K4 sweep launch of 5
    (`solve_robust.launch_sweeps`, alpha 0.25) from zero;
  * `sor_i50`, `robust_i100`: `hs_solve` with S1's and R1's configs,
    host time median of 20, synced.

at 1088x1920, 2160x3840 and 4320x7680 (K3, K8, K4 and the SOR and robust
solves at 1088x1920 only, with `--sor-robust` alone). The kernels' times
are CUDA events over 20 (K2, K3, K4) or 10 calls after a warm-up call
(chip_smoke.py's `event_ms`). With `--l4` alone: L4, the batched twins
`solve_fused.hs_solve_fused_batched` (K1 + K6) and
`solve_skewed.hs_solve_skewed_batched` (K1 + K7) on a 2 x 2160x3840 noise
stack, alpha 0.5, i100, each dtype by CUDA events over 10 calls and by
host time (median of 10, synced). Prints the card's name and power limit,
then one JSON line.

    python3 tools/torch_bf16_timing.py [--sor-robust | --l4]
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402
from opticalflowhs_tpu_torch import HSConfig, hs_solve  # noqa: E402
from opticalflowhs_tpu_torch.kernels import derivatives as k1  # noqa: E402
from opticalflowhs_tpu_torch import robust  # noqa: E402
from opticalflowhs_tpu_torch.kernels import jacobi as k2  # noqa: E402
from opticalflowhs_tpu_torch.kernels import solve_robust as k4  # noqa: E402
from opticalflowhs_tpu_torch.kernels import sor as k3  # noqa: E402
from opticalflowhs_tpu_torch.kernels import sor_planes as k8  # noqa: E402
from opticalflowhs_tpu_torch.kernels import solve_fused as k6  # noqa: E402
from opticalflowhs_tpu_torch.kernels import solve_skewed as k7  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bf16_timing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    sor_robust_only = "--sor-robust" in sys.argv[1:]
    out = {}
    if "--l4" in sys.argv[1:]:
        rng = np.random.default_rng(0)
        a, b = (torch.from_numpy(rng.uniform(0, 1, (2, 2160, 3840)).astype(np.float32)).to(dev)
                for _ in range(2))
        for name, dt in (("bf16", torch.bfloat16), ("float32", torch.float32)):
            x, y = a.to(dt), b.to(dt)
            for cell, solve in (("k6_batched", k6.hs_solve_fused_batched),
                                ("k7_batched", k7.hs_solve_skewed_batched)):
                out[f"L4 2x2160x3840 {cell} {name}"] = cs.event_ms(
                    lambda: solve(x, y, 0.5, 100), 10)
                out[f"L4 2x2160x3840 {cell} {name} host"] = cs.median_ms(
                    lambda: solve(x, y, 0.5, 100), 10)
        print(cs.card_line())
        print(json.dumps(out))
        return 0
    for tag, (h, w) in (("1088x1920", (1088, 1920)), ("2160x3840", (2160, 3840)),
                        ("4320x7680", (4320, 7680))):
        if sor_robust_only and tag != "1088x1920":
            break
        rng = np.random.default_rng(0)
        a, b = (torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).to(dev)
                for _ in range(2))
        for name, dt in (("bf16", torch.bfloat16), ("float32", torch.float32)):
            x, y = a.to(dt), b.to(dt)
            f = k1.hs_derivatives(x, y, 0.5)
            z = torch.zeros_like(x)
            uo, vo = torch.empty_like(x), torch.empty_like(x)
            if tag == "1088x1920":
                wd, ws = robust.charbonnier_weights(z, z, *f[:3], 0.05, 0.05)
                out[f"{tag} k3_4 {name}"] = cs.event_ms(
                    lambda: k3.launch_sweeps(z, z, *f, uo, vo, 4, cs.OMEGA))
                out[f"{tag} k8_50 {name}"] = cs.event_ms(
                    lambda: k8.sor_planes(None, None, *f, 50, cs.OMEGA), 10)
                out[f"{tag} k4_freeze {name}"] = cs.event_ms(
                    lambda: k4.freeze_weights(z, z, *f[:3], 0.05, 0.05))
                out[f"{tag} k4_5 {name}"] = cs.event_ms(
                    lambda: k4.launch_sweeps(z, z, *f[:3], wd, ws, uo, vo, 5, 0.25))
                for cell, cfg in (("sor_i50", HSConfig(alpha=0.5, iters=50, solver="sor",
                                                       omega=cs.OMEGA)),
                                  ("robust_i100", HSConfig(alpha=0.25, iters=100,
                                                           solver="robust",
                                                           robust_update_every=20))):
                    if name == "bf16":
                        cfg = dataclasses.replace(cfg, dtype="bfloat16")
                    out[f"{tag} {cell} {name}"] = cs.median_ms(lambda: hs_solve(a, b, cfg))
            if sor_robust_only:
                continue
            out[f"{tag} k2_8 {name}"] = cs.event_ms(
                lambda: k2.launch_sweeps(z, z, *f, uo, vo, 8))
            out[f"{tag} k6_8 {name}"] = cs.event_ms(lambda: k6.launch_fused(z, z, *f, 8, 8), 10)
            out[f"{tag} k6_100 {name}"] = cs.event_ms(
                lambda: k6.launch_fused(None, None, *f, 100, 8), 10)
            out[f"{tag} k7_100 {name}"] = cs.event_ms(
                lambda: k7.launch_skewed(None, None, *f, 100, 8), 10)
            cfg = HSConfig(alpha=0.5, iters=100, dtype="bfloat16" if name == "bf16"
                           else "float32")
            out[f"{tag} hs_solve {name}"] = cs.median_ms(lambda: hs_solve(a, b, cfg))
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
