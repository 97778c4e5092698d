#!/usr/bin/env python3
"""Config 5 on a real 2 x 2 mesh of four GPUs, one shard per card.

    python3 tools/torch_multi_gpu.py            # needs 4 CUDA devices
    python3 tools/torch_multi_gpu.py --k10      # K10 only, on the 4 cards
    python3 tools/torch_multi_gpu.py --cpu      # a small rehearsal on a CPU mesh

Runs `configs/c5_multihost_4k.json` (2160x3840, alpha 1, i100, halo_sweeps
4; noise frames from default_rng(5)) through `dist.hs_solve_tiled` on a
2 x 2 mesh of cuda:0-3: halo_impl="ppermute" (halo copies between the cards,
then K9 on each) and halo_impl="rdma" (K12: one launch a card, its edge
rows and columns stored into the halo of the neighbours' u/v pairs over
NVLink), and
`hs_pyramid_tiled` (L3). Each is held against the untiled solve on one card
(hs_solve / hs_pyramid on cuda:0) and timed (median of 10, host clock around
a synchronised call) beside the same mesh made virtual on cuda:0 (2 x 2 and
config 5's 4 x 4). K10 (the ring halo exchange) runs on config 5's frame
cut into a ring of four 540 x 3840 shards, one a card, halo 5: its edge
rows are peer stores over NVLink. It is held bitwise against
`ring_halo_exchange_plain` and timed: host clock around a call synchronised
on every card (median of 20), and each card's kernel by the profiler.
Prints the cards' names and power limits and one JSON object as its last
line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOL = 2e-6


def median_ms(fn, runs: int, sync) -> float:
    for _ in range(2):
        fn()
    sync()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def k10_ring(cards, frame, halo: int, sync) -> dict:
    """K10 on a ring of len(cards) row shards of `frame`, shard k on
    cards[k]: bitwise against the plain exchange, launches, host ms (median
    of 20), and on CUDA the mean device ms of one K10 kernel (profiler)."""
    from opticalflowhs_tpu_torch.kernels import ring
    n = len(cards)
    th = frame.shape[0] // n
    shards = [frame[k * th:(k + 1) * th].contiguous().to(cards[k]) for k in range(n)]
    ring.ring_halo_exchange.launches = 0
    got = ring.ring_halo_exchange(shards, halo)
    sync()
    out = {"shards": [n, th, frame.shape[1]], "halo": halo,
           "launches": ring.ring_halo_exchange.launches,
           "bitwise": all(bool(torch.equal(g, r)) for g, r in
                          zip(got, ring.ring_halo_exchange_plain(shards, halo))),
           "ms": median_ms(lambda: ring.ring_halo_exchange(shards, halo), 20, sync),
           "plain_ms": median_ms(lambda: ring.ring_halo_exchange_plain(shards, halo), 20,
                                 sync)}
    if cards[0].type == "cuda":
        from torch.profiler import ProfilerActivity
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                ring.ring_halo_exchange(shards, halo)
            sync()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "halo_kernel" in e.key]
        runs = sum(e.count for e in hits)
        out["kernel_runs"] = runs
        out["device_ms_per_kernel"] = (sum(float(e.self_device_time_total) for e in hits)
                                       / 1e3 / max(runs, 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on a CPU mesh at 216 x 384, i20 (no timing claims)")
    ap.add_argument("--k10", action="store_true", help="run K10's ring only")
    args = ap.parse_args()
    from opticalflowhs_tpu_torch import from_reference, hs_pyramid, hs_solve
    from opticalflowhs_tpu_torch.config import MeshConfig
    from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled, hs_solve_tiled, make_mesh
    from opticalflowhs_tpu_torch.kernels import ring
    from opticalflowhs_tpu_torch.kernels import tile as k9

    c5 = json.loads((ROOT / "configs" / "c5_multihost_4k.json").read_text())
    cfg, pyr = from_reference(c5["hs"]), from_reference(c5["pyramid"])
    s = from_reference(c5["mesh"]).halo_sweeps
    if args.cpu:
        import dataclasses
        cfg = dataclasses.replace(cfg, iters=20)
        h, w = 216, 384
        cards = [torch.device("cpu")] * 4
        one = torch.device("cpu")

        def sync():
            pass
        names = ["cpu"]
    else:
        if torch.cuda.device_count() < 4:
            print(f"torch_multi_gpu: needs 4 CUDA devices, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 1
        h, w = 2160, 3840
        cards = [torch.device("cuda", i) for i in range(4)]
        one = cards[0]

        def sync():
            for c in cards:
                torch.cuda.synchronize(c)
        names = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
        for line in names:
            print(line)
        for i in range(4):
            for j in range(4):
                if i != j and not torch.cuda.can_device_access_peer(i, j):
                    print(f"torch_multi_gpu: cuda:{i} cannot reach cuda:{j}", file=sys.stderr)
                    return 1
    rng = np.random.default_rng(5)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).to(one)
              for _ in range(2))
    k10 = k10_ring(cards, i1, s + 1, sync)
    if not k10["bitwise"] or (one.type == "cuda" and k10["launches"] != 4):
        print(f"torch_multi_gpu: K10 on the cards: {k10}", file=sys.stderr)
        return 1
    if args.k10:
        print(json.dumps({"cards": names, "k10": k10}))
        return 0
    real = make_mesh(MeshConfig(y=2, x=2), cards)
    virt22 = make_mesh(MeshConfig(y=2, x=2), [one] * 4)
    virt44 = make_mesh(MeshConfig(y=4, x=4), [one] * 16)

    untiled = hs_solve(i1, i2, cfg)
    untiled_pyr = hs_pyramid(i1, i2, cfg, pyr)
    runs = {
        "real 2x2 ppermute": lambda: hs_solve_tiled(i1, i2, cfg, real, halo_sweeps=s),
        "real 2x2 rdma": lambda: hs_solve_tiled(i1, i2, cfg, real, halo_sweeps=s,
                                                halo_impl="rdma"),
        "real 2x2 pyramid": lambda: hs_pyramid_tiled(i1, i2, cfg, pyr, real, halo_sweeps=s),
        "virtual 2x2 ppermute": lambda: hs_solve_tiled(i1, i2, cfg, virt22, halo_sweeps=s),
        "virtual 2x2 rdma": lambda: hs_solve_tiled(i1, i2, cfg, virt22, halo_sweeps=s,
                                                   halo_impl="rdma"),
        "virtual 4x4 ppermute": lambda: hs_solve_tiled(i1, i2, cfg, virt44, halo_sweeps=s),
        "virtual 2x2 pyramid": lambda: hs_pyramid_tiled(i1, i2, cfg, pyr, virt22,
                                                        halo_sweeps=s),
    }
    counters = {"K9": k9.tile_sweeps, "K12": ring.ring_fused_sweeps_2d}
    result = {"cards": names, "shape": [h, w], "iters": cfg.iters, "halo_sweeps": s,
              "k10": k10, "max_abs_diff_vs_untiled": {}, "launches": {}, "ms": {}}
    for tag, fn in runs.items():
        before = {n: c.launches for n, c in counters.items()}
        out = fn()
        sync()
        result["launches"][tag] = {n: c.launches - before[n] for n, c in counters.items()}
        want = untiled_pyr if "pyramid" in tag else untiled
        d = max(float((out.u - want.u).abs().max()), float((out.v - want.v).abs().max()))
        result["max_abs_diff_vs_untiled"][tag] = d
        if out.u.device != one or d > TOL:
            print(f"torch_multi_gpu: {tag} differs from the untiled solve by {d} "
                  f"(flow on {out.u.device})", file=sys.stderr)
            return 1
    result["ms"]["untiled hs_solve"] = median_ms(lambda: hs_solve(i1, i2, cfg), 10, sync)
    result["ms"]["untiled hs_pyramid"] = median_ms(lambda: hs_pyramid(i1, i2, cfg, pyr), 10, sync)
    for tag, fn in runs.items():
        result["ms"][tag] = median_ms(fn, 10, sync)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
