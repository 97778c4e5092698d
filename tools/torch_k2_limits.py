#!/usr/bin/env python3
"""What limits K2 (csrc/jacobi.cu) on one CUDA card: the K2 launch of 8
sweeps timed as it is and with parts of its work cut out.

    python3 tools/torch_k2_limits.py [--reps N]

Each variant is a copy of opticalflowhs_tpu_torch/ under _chip/k2_limits/
(git-ignored) with csrc/jacobi.cu edited, built by its own copy of
kernels/_build.py and timed in a process of its own:
  * full: the kernel as it is;
  * no_fields: the four fields set to constants instead of loaded, so
    their device-memory traffic and 48 of the registers a thread go;
  * no_staging: no cp.async of u and v (the sweeps read whatever shared
    memory holds);
  * arithmetic: both cut, the sweeps alone with the block's tile loop and
    barriers;
  * memory: no sweeps (staging and field loads alone).
Only "full" computes the Jacobi sweeps; the others' outputs are not
checked. Each time is the device time per launch from CUDA events over N
launches after one warm-up, from zero u and v, on chip_smoke.py's noise at
1088x1920 and on an 8 x 1088x1920 stack, alpha 0.5. Prints the card's name
and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "_chip" / "k2_limits"

_FIELDS_FN = "                                           int row0, int col0) {\n  const int ac = t.c0 + col0;"
_STAGE_FN = "                                      const Args& a, const Tile& t, int row0, int col0) {\n"
_SWEEPS = ("    if (edge)\n      run_tile<true, kShard>", "    else\n      run_tile<false, kShard>")

_TIMER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import jacobi as k2
reps = int(sys.argv[2])
dev = torch.device("cuda", 0)
out = {}
for name, shape in (("1088x1920", (1088, 1920)), ("8x1088x1920", (8, 1088, 1920))):
    rng = np.random.default_rng(0)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
              for _ in range(2))
    f = k1.hs_derivatives(i1, i2, 0.5)
    z = torch.zeros_like(i1)
    uo, vo = torch.empty_like(z), torch.empty_like(z)
    k2.launch_sweeps(z, z, *f, uo, vo, 8)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        k2.launch_sweeps(z, z, *f, uo, vo, 8)
    b.record()
    torch.cuda.synchronize()
    out[name] = a.elapsed_time(b) / reps
print(json.dumps(out))
"""


def edit(src: str, variant: str) -> str:
    """csrc/jacobi.cu with the variant's cut."""
    def sub(s, a, b):
        if a not in s:
            raise RuntimeError(f"{variant}: csrc/jacobi.cu no longer holds {a[:50]!r}")
        return s.replace(a, b, 1)

    if variant in ("no_fields", "arithmetic"):
        src = sub(src, _FIELDS_FN, _FIELDS_FN.replace(
            "{\n", "{\n#pragma unroll\n  for (int jj = 0; jj < kRows; ++jj)\n#pragma unroll\n"
            "    for (int q = 0; q < kLaneCols; ++q) f[jj][q] = 0.01f * (q + jj);\n  return;\n"))
    if variant in ("no_staging", "arithmetic"):
        src = sub(src, _STAGE_FN, _STAGE_FN + "  return;\n")
    if variant == "memory":
        src = sub(src, _SWEEPS[0], "    if (a.sweeps < 0)\n      run_tile<true, kShard>")
        src = sub(src, _SWEEPS[1], "    else if (a.sweeps < 0)\n      run_tile<false, kShard>")
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("torch_k2_limits: no CUDA device", file=sys.stderr)
        return 1
    src = (HERE / "opticalflowhs_tpu_torch" / "csrc" / "jacobi.cu").read_text()
    out = {}
    for variant in ("full", "no_fields", "no_staging", "arithmetic", "memory", "full"):
        tree = OUT / variant
        if not tree.exists():
            shutil.copytree(HERE / "opticalflowhs_tpu_torch", tree / "opticalflowhs_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            (tree / "opticalflowhs_tpu_torch" / "csrc" / "jacobi.cu").write_text(
                edit(src, variant))
        run = subprocess.run([sys.executable, "-c", _TIMER, str(tree), str(args.reps)],
                             capture_output=True, text=True, check=True)
        ms = json.loads(run.stdout.strip().splitlines()[-1])
        out.setdefault(variant, []).append(ms)
        print(f"{variant}: {ms}", flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    print(chip_smoke.card_line())
    print(json.dumps({"k2_launch_8_ms": out, "reps": args.reps,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
