#!/usr/bin/env python3
"""Time the port's whole-solve kernels per sweep block on one CUDA card:
one K2 launch of 8 sweeps against K6 (`hs_solve_fused`) and K7
(`hs_solve_skewed`) launches of 8 and 96 sweeps, on the same fields.

    python3 tools/torch_whole_solve_timing.py [--repo DIR] [--reps N]

Frames are chip_smoke.py's noise (default_rng(0)) at 4320x7680, 2160x3840
and 1088x1920, alpha 0.5, the fields computed once by K1; the sweeps start
from zero. A K6 launch of 8 sweeps is one sweep block with no grid barrier,
so it holds K6's per-tile code against K2's launch; 96 sweeps is 12 blocks.
K7 runs at 4K and 1080p with bands of one and two rows of 64 x 64 tiles
(its own choice is two on 132 resident blocks). Each time is the device
time per call from CUDA events over N calls after one warm-up call.

Imports opticalflowhs_tpu_torch from DIR (default: this checkout), so two
trees can be compared on one card in one run. Prints the card's name
and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_whole_solve_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.repo).resolve()))
    sys.path.insert(1, str(HERE))
    import chip_smoke
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import solve_fused as k6
    from opticalflowhs_tpu_torch.kernels import solve_skewed as k7

    dev = torch.device("cuda", 0)
    out = {}
    for h, w in ((4320, 7680), (2160, 3840), (1088, 1920)):
        rng = np.random.default_rng(0)
        i1, i2 = (torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).to(dev)
                  for _ in range(2))
        fields = k1.hs_derivatives(i1, i2, 0.5)
        z = torch.zeros_like(i1)
        uo, vo = torch.empty_like(z), torch.empty_like(z)
        row = {"k2_launch_8": event_ms(
            lambda: k2.launch_sweeps(z, z, *fields, uo, vo, 8), args.reps)}
        for n in (8, 96):
            row[f"k6_{n}"] = event_ms(lambda: k6.launch_fused(z, z, *fields, n, 8), args.reps)
            if h * w < 20_000_000:
                for band in (64, 128):
                    row[f"k7_{n}_band{band}"] = event_ms(
                        lambda: k7.launch_skewed(z, z, *fields, n, 8, band=band), args.reps)
        out[f"{h}x{w}"] = row
        print(f"{h}x{w}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"whole_solve_ms": out, "reps": args.reps,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
