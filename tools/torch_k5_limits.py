#!/usr/bin/env python3
"""What limits K5 (csrc/tvl1.cu) on one CUDA card: a K5 call of 100
alternations timed as it is and with parts of its work cut out.

    python3 tools/torch_k5_limits.py [--reps N] [--block-iters S]

Each variant is a copy of opticalflowhs_tpu_torch/ under _chip/k5_limits/
(git-ignored) with csrc/tvl1.cu edited, built by its own copy of
kernels/_build.py and timed in a process of its own:
  * full: the kernel as it is;
  * no_fields: the five constant fields of a window filled with a fixed
    pattern in shared memory instead of copied from device memory (zeros
    would send the square roots and divisions down their slow paths);
  * no_staging: the six state fields filled likewise;
  * arithmetic: both cut, the alternations alone with the block's tile
    loop and barriers;
  * memory: no alternations (staging and field loads alone; nothing is
    stored).
Only "full" computes the inner loop; the others' outputs are not checked.
Each time is the device time per call of 100 alternations from CUDA events
over N calls after one warm-up, at block_iters S (0: the auto value), on
fields made as chip_smoke.py's K5 rows make them (TVL1Config(), a pair of
uniform noise on [0, 255] with a shifted copy, warm normal u) at 1088x1920,
544x960 and 272x480 (T1's three levels) and on an 8 x 1088x1920 stack.
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
OUT = HERE / "_chip" / "k5_limits"
SHAPES = ((1088, 1920), (544, 960), (272, 480), (8, 1088, 1920))

_FIELDS = ("a.f[k], a, t, ln);", "a.f[3], a, tile, ln);", "a.f[4], a, tile, ln);")
_STATE = "stage(smem + k * kArea, a.in[k], a, tile, ln);"
_ZERO = "make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n    return;"
# Cut-out arrays are filled with this pattern instead: zeros would send the
# square roots and divisions down their slow paths.
_PATTERN = ("make_float4(0.5f + 0.01f * ln.r, 0.25f + 0.002f * ln.c, 0.75f, 0.125f);\n"
            "    return;")
_ALTERNATIONS = "    for (int k = 1; k <= a.iters; ++k) {\n"

_TIMER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from opticalflowhs_tpu_torch import TVL1Config
from opticalflowhs_tpu_torch import tvl1 as tv
from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5
reps, s = int(sys.argv[2]), int(sys.argv[3])
shapes = json.loads(sys.argv[4])
dev = torch.device("cuda", 0)
out = {}
for shape in shapes:
    rng = np.random.default_rng(0)
    i1 = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).to(dev)
    i2 = 0.9 * torch.roll(i1, 1, -1) + 0.1 * torch.from_numpy(
        rng.uniform(0, 255, shape).astype(np.float32)).to(dev)
    u1, u2 = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(dev)
              for _ in range(2))
    f = tv.inner_fields(i1, i2, u1, u2, TVL1Config())
    sc = tv.inner_scalars(TVL1Config())
    call = lambda: k5.tvl1_inner(u1, u2, *f, 100, *sc, block_iters=s)
    call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        call()
    b.record()
    torch.cuda.synchronize()
    out["x".join(map(str, shape))] = a.elapsed_time(b) / reps
print(json.dumps(out))
"""


def edit(src: str, variant: str) -> str:
    """csrc/tvl1.cu with the variant's cut."""
    def sub(s, a, b):
        if a not in s:
            raise RuntimeError(f"{variant}: csrc/tvl1.cu no longer holds {a[:50]!r}")
        return s.replace(a, b, 1)

    if variant in ("no_fields", "no_staging", "arithmetic"):
        src = sub(src, _ZERO, _PATTERN)
    if variant in ("no_fields", "arithmetic"):
        for f in _FIELDS:
            src = sub(src, f, "nullptr" + f[f.index("]") + 1:])
    if variant in ("no_staging", "arithmetic"):
        src = sub(src, _STATE, _STATE.replace("a.in[k]", "nullptr"))
    if variant == "memory":
        src = sub(src, _ALTERNATIONS, "    for (int k = 1; k <= 0; ++k) {\n")
    return src


def time_tree(tree: Path, reps: int, block_iters: int, shapes=SHAPES) -> dict:
    """ms per call of 100 alternations at each shape, in a process of its
    own that imports the port from `tree`."""
    run = subprocess.run([sys.executable, "-c", _TIMER, str(tree), str(reps), str(block_iters),
                          json.dumps(shapes)], capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"{tree}: {run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def variant_tree(name: str, src: str) -> Path:
    """A copy of the port with csrc/tvl1.cu replaced by `src`."""
    tree = OUT / name
    if not tree.exists():
        shutil.copytree(HERE / "opticalflowhs_tpu_torch", tree / "opticalflowhs_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        (tree / "opticalflowhs_tpu_torch" / "csrc" / "tvl1.cu").write_text(src)
    return tree


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--block-iters", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("torch_k5_limits: no CUDA device", file=sys.stderr)
        return 1
    src = (HERE / "opticalflowhs_tpu_torch" / "csrc" / "tvl1.cu").read_text()
    out = {}
    try:
        for variant in ("full", "no_fields", "no_staging", "arithmetic", "memory", "full"):
            ms = time_tree(variant_tree(variant, edit(src, variant)), args.reps,
                           args.block_iters)
            out.setdefault(variant, []).append(ms)
            print(f"{variant}: {ms}", flush=True)
    finally:
        shutil.rmtree(OUT, ignore_errors=True)
    print(chip_smoke.card_line())
    print(json.dumps({"k5_call_100_ms": out, "reps": args.reps, "block_iters": args.block_iters,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
