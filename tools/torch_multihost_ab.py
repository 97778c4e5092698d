#!/usr/bin/env python3
"""A/B of the multi-process transport on one card: `chip_smoke.py` phase
24's gloo leg (config 5's D1, D2, D4, D5, bf16 D1 and the robust pair by
two processes on cuda:0, a (1, 4, 4) mesh of 8 shards a process) run from
this tree and, with `--repo DIR`, from another tree (a `git archive` under
`_chip/`), in the order DIR, this, this, DIR, so that drift shows.

    python3 tools/torch_multihost_ab.py [--repo DIR]

Each tree builds its kernels first (one process), then its two workers run
(`chip_smoke.py --mh-worker gloo RANK 2 HOST:PORT OUTDIR`). Prints, per run
and case, each process's median ms of 5 and, where the tree records it, a
warm call's host seconds in the exchanges, the gathers and the rest.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def run_tree(tree: Path) -> list[dict]:
    """The gloo leg's results of both workers of `tree`."""
    with tempfile.TemporaryDirectory() as tmp:
        addr = chip_smoke._free_addr()
        cmds = [[sys.executable, str(tree / "chip_smoke.py"), "--mh-worker", "gloo", str(r),
                 "2", addr, tmp] for r in range(2)]
        res = chip_smoke._spawn(cmds, [None, None], 300)
        for r, (rc, _, err) in enumerate(res):
            if rc != 0:
                raise RuntimeError(f"{tree} worker {r} exited {rc}: {err[-4000:]}")
        return [json.loads((Path(tmp) / f"gloo_r{r}.json").read_text()) for r in range(2)]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", help="another tree to run beside this one")
    args = p.parse_args()
    trees = [ROOT] if not args.repo else [Path(args.repo).resolve(), ROOT, ROOT,
                                          Path(args.repo).resolve()]
    print(chip_smoke.card_line())
    for tree in dict.fromkeys(trees):
        subprocess.run([sys.executable, "-c", "from opticalflowhs_tpu_torch.kernels import "
                        "_build; _build.library()"], cwd=tree, check=True, timeout=900)
    for k, tree in enumerate(trees):
        got = run_tree(tree)
        for tag in ("D1", "D2", "D4", "D5", "D1 bf16", "robust pair"):
            if tag not in got[0]:
                continue
            split = [chip_smoke.mh_split(w[tag]["warm"]) for w in got if "warm" in w[tag]]
            print(f"run {k} {tree.name or tree}: {tag}: ms {[round(w[tag]['ms'], 3) for w in got]}"
                  f"; equal {[w[tag]['equal'] for w in got]}"
                  + (f"; a warm call's host s {split}" if split else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
