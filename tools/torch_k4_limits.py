#!/usr/bin/env python3
"""What limits K4's sweep kernel (csrc/robust.cu) on one CUDA card: a sweep
launch timed as it is and with parts of its work cut out.

    python3 tools/torch_k4_limits.py [--reps N]

Each variant is a copy of opticalflowhs_tpu_torch/ under _chip/k4_limits/
(git-ignored) with csrc/robust.cu edited, built by its own copy of
kernels/_build.py and timed in a process of its own:
  * full: the kernel as it is;
  * no_staging: no cp.async of the next tile (each tile sweeps whatever
    shared memory holds), so the device-memory reads go;
  * no_coefficients: the ten coefficients set to constants instead of
    formed from the fields (no division, and the fields' own loads go);
  * arithmetic: no staging and no coefficients, the sweeps alone with the
    block's tile loop, exchanges and barriers;
  * memory: no sweeps (staging, the thread's own loads and the owned
    writes; the coefficients, whose results no sweep reads, go with them).
Only "full" computes the IRLS sweeps; the others' outputs are not checked.
Each time is the device time per launch from CUDA events over N launches
after one warm-up, from zero u and v with the weights frozen there (eps
0.05), on chip_smoke.py's noise at 1088x1920 (s 7 and 8) and
on an 8 x 1088x1920 stack (s 7), alpha 0.25. Prints the card's name and
power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "_chip" / "k4_limits"

_STAGE = "  const float* src[kStaged] = {"
_COEFF = "    coefficients<kEdge>(o, f, sa, sb, ln, a.alpha2);\n"
_CONST = """#pragma unroll
    for (int jj = 0; jj < kRows; ++jj)
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q) {
        o.wup[jj][q] = o.wdn[jj][q] = o.wlf[jj][q] = o.wrt[jj][q] = 0.25f;
        o.a11[jj][q] = o.a22[jj][q] = 1.5f;
        o.a12[jj][q] = 0.1f;
        o.c1[jj][q] = o.c2[jj][q] = 0.01f;
        o.inv[jj][q] = 0.45f;
      }
"""
_SWEEPS = "  for (int k = 1; k <= a.sweeps; ++k) {"

_TIMER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import solve_robust as k4
reps = int(sys.argv[2])
dev = torch.device("cuda", 0)
out = {}
for name, shape, sweeps in (("1088x1920", (1088, 1920), (7, 8)), ("8x1088x1920", (8, 1088, 1920), (7,))):
    rng = np.random.default_rng(0)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
              for _ in range(2))
    ex, ey, et, _ = k1.hs_derivatives(i1, i2, 0.25)
    z = torch.zeros_like(i1)
    wd, ws = k4.freeze_weights(z, z, ex, ey, et, 0.05, 0.05)
    uo, vo = torch.empty_like(z), torch.empty_like(z)
    for s in sweeps:
        k4.launch_sweeps(z, z, ex, ey, et, wd, ws, uo, vo, s, 0.25)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            k4.launch_sweeps(z, z, ex, ey, et, wd, ws, uo, vo, s, 0.25)
        b.record()
        torch.cuda.synchronize()
        out[f"{name}_s{s}"] = a.elapsed_time(b) / reps
print(json.dumps(out))
"""


def edit(src: str, variant: str) -> str:
    """csrc/robust.cu with the variant's cut."""
    def sub(s, a, b):
        if a not in s:
            raise RuntimeError(f"{variant}: csrc/robust.cu no longer holds {a[:50]!r}")
        return s.replace(a, b, 1)

    if variant in ("no_staging", "arithmetic"):
        src = sub(src, _STAGE, "  return;\n" + _STAGE)
    if variant in ("no_coefficients", "arithmetic"):
        src = sub(src, _COEFF, _CONST)
    if variant == "memory":
        src = sub(src, _SWEEPS, "  for (int k = 1; k <= 0; ++k) {")
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("torch_k4_limits: no CUDA device", file=sys.stderr)
        return 1
    src = (HERE / "opticalflowhs_tpu_torch" / "csrc" / "robust.cu").read_text()
    out = {}
    for variant in ("full", "no_staging", "no_coefficients", "arithmetic", "memory", "full"):
        tree = OUT / variant
        if not tree.exists():
            shutil.copytree(HERE / "opticalflowhs_tpu_torch", tree / "opticalflowhs_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            (tree / "opticalflowhs_tpu_torch" / "csrc" / "robust.cu").write_text(
                edit(src, variant))
        run = subprocess.run([sys.executable, "-c", _TIMER, str(tree), str(args.reps)],
                             capture_output=True, text=True, check=True)
        ms = json.loads(run.stdout.strip().splitlines()[-1])
        out.setdefault(variant, []).append(ms)
        print(f"{variant}: {ms}", flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    print(chip_smoke.card_line())
    print(json.dumps({"k4_sweep_launch_ms": out, "reps": args.reps,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
