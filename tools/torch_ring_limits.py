#!/usr/bin/env python3
"""What a K11/K12 sweep block (csrc/ring.cu) spends beyond its sweeps, on
one CUDA card: the i100 solves of chip_smoke.py phase 15 (config 5,
2160x3840, 4 sweeps a block, K11 on a virtual 4 x 1 mesh, K12 on 2 x 2)
timed as they are and with parts of their work changed or cut out.

    python3 tools/torch_ring_limits.py [--reps N]

Each variant is a copy of opticalflowhs_tpu_torch/ under _chip/ring_limits/
(git-ignored) with csrc/ring.cu or csrc/k2_window.cuh edited, built by its
own copy of kernels/_build.py and timed in a process of its own:
  * full: the kernels as they are (interior tile rows first);
  * in_order: the tile rows walked in order, so that K11's tiles whose
    windows reach a halo row, which wait for its flag, come first;
  * no_waits: no flag is waited for (K11's waits before staging, K12's
    before phase C and before the sweeps);
  * no_exchange: no waits and no exchange either: the sweeps and the grid
    barriers alone.
Only full and in_order compute the solve, and each solve's max |diff|
against the plain version is printed (0.0 for those two), with the build's
registers a thread and spilled bytes. Each time is the device time a solve
from CUDA events over N solves after one warm-up.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "_chip" / "ring_limits"

_TILE_INDEX = ("static __device__ __forceinline__ void tile_index(const Args& a, int t, "
               "int& img, int& ty,\n                                                  int& tx) {\n")
_IN_ORDER = ("  img = t / (a.tiles_y * a.tiles_x);\n"
             "  ty = (t - img * a.tiles_y * a.tiles_x) / a.tiles_x;\n"
             "  tx = t - (img * a.tiles_y + ty) * a.tiles_x;\n"
             "  return;\n")
_WAIT = "  while (ld_acquire_sys(p) < epoch) __nanosleep(64);\n"
_EXCHANGE = "__device__ __forceinline__ void exchange(const RingArgs& r, int k) {\n"

_TIMER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
import chip_smoke
from opticalflowhs_tpu_torch.kernels import ring
reps = int(sys.argv[3])
dev = torch.device("cuda", 0)
h, w, hw = 2160, 3840, 4
g41 = chip_smoke._ring_inputs(dev, 4, 1, h // 4, w, hw, 190, h, w)
g22 = chip_smoke._ring_inputs(dev, 2, 2, h // 2, w // 2, hw, 191, h, w)
a41 = ([r[0] for r in g41[0]], [r[0] for r in g41[1]], [r[0] for r in g41[2]], 100, hw,
       [o[0][0] for o in g41[3]], h, w)
a22 = (*g22[:3], 100, hw, g22[3], h, w)
out = {}
for name, fn, plain, args in (
        ("k11_4x1_i100", ring.ring_fused_sweeps, ring.ring_fused_sweeps_plain, a41),
        ("k12_2x2_i100", ring.ring_fused_sweeps_2d, ring.ring_fused_sweeps_2d_plain, a22)):
    got, want = chip_smoke._tensors(fn(*args)), chip_smoke._tensors(plain(*args))
    diff = max(float((g - r).abs().max()) for g, r in zip(got, want))
    geo = ring.ring_geometry(dev, hw, two_d=fn is ring.ring_fused_sweeps_2d)
    out[name] = {"ms": chip_smoke.event_ms(lambda: fn(*args), reps=reps), "max_abs_diff": diff,
                 "registers": geo["registers"], "spill_bytes": geo["spill_bytes"]}
print(json.dumps(out))
"""


def edit(variant: str, ring_cu: str, window: str) -> tuple[str, str]:
    """csrc/ring.cu and csrc/k2_window.cuh with the variant's change."""
    def sub(s, a, b, name):
        if a not in s:
            raise RuntimeError(f"{variant}: {name} no longer holds {a[:50]!r}")
        return s.replace(a, b, 1)

    if variant == "in_order":
        window = sub(window, _TILE_INDEX, _TILE_INDEX + _IN_ORDER, "csrc/k2_window.cuh")
    if variant in ("no_waits", "no_exchange"):
        ring_cu = sub(ring_cu, _WAIT, "  (void)p;\n  (void)epoch;\n", "csrc/ring.cu")
    if variant == "no_exchange":
        ring_cu = sub(ring_cu, _EXCHANGE, _EXCHANGE + "  return;\n", "csrc/ring.cu")
    return ring_cu, window


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("torch_ring_limits: no CUDA device", file=sys.stderr)
        return 1
    csrc = HERE / "opticalflowhs_tpu_torch" / "csrc"
    ring_cu, window = (csrc / "ring.cu").read_text(), (csrc / "k2_window.cuh").read_text()
    out = {}
    for variant in ("full", "in_order", "no_waits", "no_exchange", "full"):
        tree = OUT / variant
        if not tree.exists():
            shutil.copytree(HERE / "opticalflowhs_tpu_torch", tree / "opticalflowhs_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            r, k = edit(variant, ring_cu, window)
            (tree / "opticalflowhs_tpu_torch" / "csrc" / "ring.cu").write_text(r)
            (tree / "opticalflowhs_tpu_torch" / "csrc" / "k2_window.cuh").write_text(k)
        run = subprocess.run([sys.executable, "-c", _TIMER, str(tree), str(HERE),
                              str(args.reps)], capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        res = json.loads(run.stdout.strip().splitlines()[-1])
        out.setdefault(variant, []).append(res)
        print(f"{variant}: {res}", flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    print(chip_smoke.card_line())
    print(json.dumps({"ring_solve": out, "reps": args.reps,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
