#!/usr/bin/env python3
"""Time the bfloat16 builds of K2, K6 and K7 beside their float32 builds on
one CUDA card, in one process, on the same noise frames (default_rng(0)),
alpha 0.5, the fields computed once by K1 in each dtype:

  * `k2_8`: one K2 launch of 8 sweeps from zero (`jacobi.launch_sweeps`);
  * `k6_8`: one K6 sweep block of 8 (`solve_fused.launch_fused`);
  * `k6_100`, `k7_100`: a whole K6 or K7 launch of 100 sweeps from zero;
  * `hs_solve`: the entry point, i100 (the route the reference's classes
    pick in each dtype), host time median of 20, synced.

at 1088x1920, 2160x3840 and 4320x7680. The kernels' times are CUDA
events over 20 (K2) or 10 calls after a warm-up call (chip_smoke.py's
`event_ms`). Prints the card's name and power limit, then one JSON line.

    python3 tools/torch_bf16_timing.py
"""

from __future__ import annotations

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
from opticalflowhs_tpu_torch.kernels import jacobi as k2  # noqa: E402
from opticalflowhs_tpu_torch.kernels import solve_fused as k6  # noqa: E402
from opticalflowhs_tpu_torch.kernels import solve_skewed as k7  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bf16_timing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    out = {}
    for tag, (h, w) in (("1088x1920", (1088, 1920)), ("2160x3840", (2160, 3840)),
                        ("4320x7680", (4320, 7680))):
        rng = np.random.default_rng(0)
        a, b = (torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).to(dev)
                for _ in range(2))
        for name, dt in (("bf16", torch.bfloat16), ("float32", torch.float32)):
            x, y = a.to(dt), b.to(dt)
            f = k1.hs_derivatives(x, y, 0.5)
            z = torch.zeros_like(x)
            uo, vo = torch.empty_like(x), torch.empty_like(x)
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
