#!/usr/bin/env python3
"""The block shapes K4's sweep kernel (csrc/robust.cu) could take, built
and timed side by side on one CUDA card.

    python3 tools/torch_k4_candidates.py [--reps N] [--shapes R:W,R:W,...]

A candidate is kRows rows a thread and kWarps warps a block (the window
is their product by 128 columns; u, v and ten coefficients of each of a
thread's 4 x kRows pixels stay in registers). Each is a copy of
opticalflowhs_tpu_torch/ under _chip/k4_candidates/ (git-ignored) with
those two constants of csrc/robust.cu and K4_THREAD_ROWS, K4_THREADS of
kernels/solve_robust.py edited, built by its own copy of kernels/_build.py
and run in a process of its own:
  * its build: registers a thread, spilled bytes, shared bytes, blocks an
    SM (`k4_geometry`);
  * max |diff| against plain `robust.robust_step` chains at 67x93 and a
    3 x 67x93 stack for every s, and at 1088x1920 for s 8;
  * the device time of one sweep launch at every s at 1088x1920 and of a
    launch of 8 on an 8 x 1088x1920 stack (CUDA events over N launches
    after one warm-up, from chip_smoke.py's noise, alpha 0.25, the weights
    frozen at a zero flow, eps 0.05).
The default candidates are 4 rows x 8 warps (32-row window, 256 threads),
3 x 12 (36 rows, 384 threads) and 2 x 16 (32 rows, 512 threads). Prints
the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "_chip" / "k4_candidates"

_RUN = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from opticalflowhs_tpu_torch import robust
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import solve_robust as k4
reps = int(sys.argv[2])
dev = torch.device("cuda", 0)
out = {"geometry": k4.k4_geometry(dev, 8)}

def problem(shape, seed=0, warm=False):
    rng = np.random.default_rng(seed)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
              for _ in range(2))
    ex, ey, et, _ = k1.hs_derivatives(i1, i2, 0.25)
    if warm:
        u, v = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(dev)
                for _ in range(2))
    else:
        u, v = torch.zeros_like(ex), torch.zeros_like(ex)
    wd, ws = robust.charbonnier_weights(u, v, ex, ey, et, 0.05, 0.05)
    return u, v, ex, ey, et, wd, ws

def diff(p, n, s):
    got = k4.frozen_sweeps(*p, 0.25, n, block_sweeps=s)
    want = p[:2]
    for _ in range(n):
        want = robust.robust_step(*want, *p[2:], 0.25)
    return max(float((g - w).abs().max()) for g, w in zip(got, want))

d = 0.0
for shape in ((67, 93), (3, 67, 93)):
    p = problem(shape, 1, warm=True)
    for s in range(1, k4.K4_MAX_SWEEPS + 1):
        d = max(d, diff(p, s + 1, s))
d = max(d, diff(problem((1088, 1920), 2, warm=True), 8, 8))
out["max_abs_diff"] = d

def launch_ms(p, s):
    uo, vo = torch.empty_like(p[0]), torch.empty_like(p[0])
    k4.launch_sweeps(*p, uo, vo, s, 0.25)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        k4.launch_sweeps(*p, uo, vo, s, 0.25)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

p = problem((1088, 1920))
out["launch_ms_1088x1920"] = {s: launch_ms(p, s) for s in range(1, k4.K4_MAX_SWEEPS + 1)}
out["launch8_ms_8x1088x1920"] = launch_ms(problem((8, 1088, 1920)), 8)
print(json.dumps(out))
"""


def edit(tree: Path, rows: int, warps: int) -> None:
    """Set the candidate's block shape in the copy at `tree`."""
    pkg = tree / "opticalflowhs_tpu_torch"
    cu = pkg / "csrc" / "robust.cu"
    src = cu.read_text()
    for name, value in (("kRows", rows), ("kWarps", warps)):
        src, n = re.subn(rf"^constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src, flags=re.M)
        if n != 1:
            raise RuntimeError(f"csrc/robust.cu no longer sets {name}")
    cu.write_text(src)
    py = pkg / "kernels" / "solve_robust.py"
    src = py.read_text()
    for name, value in (("K4_THREAD_ROWS", rows), ("K4_THREADS", 32 * warps)):
        src, n = re.subn(rf"^{name} = \d+$", f"{name} = {value}", src, flags=re.M)
        if n != 1:
            raise RuntimeError(f"kernels/solve_robust.py no longer sets {name}")
    py.write_text(src)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--shapes", default="4:8,3:12,2:16")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("torch_k4_candidates: no CUDA device", file=sys.stderr)
        return 1
    out = {}
    for shape in args.shapes.split(","):
        rows, warps = (int(x) for x in shape.split(":"))
        tree = OUT / f"r{rows}w{warps}"
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(HERE / "opticalflowhs_tpu_torch", tree / "opticalflowhs_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        edit(tree, rows, warps)
        run = subprocess.run([sys.executable, "-c", _RUN, str(tree), str(args.reps)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            out[shape] = {"error": run.stderr[-2000:]}
        else:
            out[shape] = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"{rows} rows x {warps} warps: {out[shape]}", flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    print(chip_smoke.card_line())
    print(json.dumps({"k4_candidates": out, "reps": args.reps,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
