#!/usr/bin/env python3
"""Time the port's sweep kernels per launch and the solves built on them, on
one CUDA card: one K2 launch of 8 sweeps against a K6 (`hs_solve_fused`) and
a K7 (`hs_solve_skewed`) sweep block of 8 and launches of 96 sweeps on the
same fields (K7 at each m and band of its plan, and at bands forced to
other m); the K1 + K2 chain of a whole i100 solve
(`solve_resident.hs_solve_resident`, 1 K1 and 13 K2 launches); the whole
solves of chip_smoke.py's phase 13 through their entry points (L1
`hs_solve` 2160x3840, L2 4320x7680 and 1088x1920 `central`, L4 the batched
twins on 2 x 2160x3840, all i100; L3 `hs_pyramid` 3 levels at
2160x3840, alpha 1, on the same noise frames, K7 at level 0); a K2 launch
of 8 sweeps at 67x93 and on an 8 x 1088x1920 stack; K9
(`kernels.tile.tile_sweeps`) on config 5's 16
shards of 548x968 at 4 sweeps a launch; K11 and K12 (`kernels.ring`) as
whole i100 solves of config 5's 4 x 1 and 2 x 2 meshes, and as i52
solves (13 sweep blocks against 25: their difference is 12 blocks); and
the build each kernel reports (registers,
spills: K2 and K6 at 8 sweeps, K9, K11 and K12 at 4, K7 at its 4K plan),
where the tree has the report.

    python3 tools/torch_whole_solve_timing.py [--repo DIR] [--reps N] [--k3 | --k4 | --k10] [--scan]

With --k3 it times K3 (4-color SOR) instead: a launch of 4 sweeps at
1088x1920 and on an 8 x 1088x1920 stack, K9's SOR entry
(`kernels.tile.sor_tile_sweeps`) over D4's 16 shards of 572x992 for one
halo block of 4 sweeps (s by the tree's own rule), the K1 + K3 chain of
S1 (`solve_resident.hs_solve_resident_sor` 1088x1920 i50, omega
chip_smoke.OMEGA), beside a K2 launch of 8 sweeps at both shapes and a
K9 Jacobi launch over D1's 16 shards of 548x968, and S1 through K8
(`sor_planes.hs_solve_sor_planes`); with --scan, where the
tree's K3 has a plan (`sor.sweeps_per_launch` over shapes), a launch at every s up
to K3_MAX_SWEEPS at 1088x1920, 1088x1900, 8 x 1088x1920, 544x960 and
272x480, K9 SOR on D4's stack at s 1-4, and the chain of 50 sweeps at
each s at 1088x1920 and 544x960, beside the plan's s.

With --k4 it times K4 (IRLS) instead: a sweep launch of 8 sweeps and one
at the tree's plan for a refreeze block of 20 (R1's; 8 where the tree has
no plan) at 1088x1920, 8 x 1088x1920, 544x960 and 272x480, a freeze
launch at 1088x1920, R1 (`hs_solve` robust 1088x1920 alpha 0.25 i100,
refrozen every 20) and K1 at 1088x1920 and 8 x 1088x1920; the sweep and
freeze launches and K1 both by CUDA events over N calls and by the profiler's
device time of the kernel itself (`device_ms`: the mean of its launches
over N calls, so that a wrapper's host time does not count). With --scan,
where the tree's K4 has a plan (`solve_robust.sweeps_per_launch` over
shapes), a launch at every s up to K4_MAX_SWEEPS at 1088x1920, 1088x1900,
8 x 1088x1920, 544x960 and 272x480, and a refreeze block of 20 sweeps at
each s at 1088x1920 and 544x960, beside the plan's s.

With --k10 it times K10 (the ring halo exchange) instead, on config 5's
frame cut into a ring of 4 x 540x3840 shards on one card, halo 5, and at
halos 1 and 540: the kernel's device time (`device_ms`), the wrapper's by
CUDA events (its tables and host work included), and one `copy_` of the
same bytes (a (4, 540 + halo, 3840) tensor) by both.

Frames are chip_smoke.py's noise (default_rng(0)) at 4320x7680, 2160x3840
and 1088x1920, alpha 0.5, the fields computed once by K1; the sweeps start
from zero. A K6 or K7 launch of 8 sweeps is one sweep block with no grid
barrier between blocks, so it holds the kernel's per-tile code against K2's
launch; 96 sweeps is 12 blocks. K9, K11 and K12 take chip_smoke.py's
phase-15 inputs. Each time is the device time per call from CUDA events
over N calls after one warm-up call.

Imports opticalflowhs_tpu_torch from DIR (default: this checkout), so two
trees can be compared on one card in one run; a tree whose K7 has no plan
of m tiles a block (before K2's window loop) gets bands of one and two
rows of its 64 x 64 tiles. Prints the card's name and power limit, then
one JSON line.
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


def device_ms(fn, key: str, reps: int):
    """Mean device time in ms of the kernels whose name holds `key`, from
    torch.profiler over `reps` calls of fn after one warm-up; None where the
    trace holds no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key:
            us += float(e.self_device_time_total)
            n += e.count
    return us / n / 1e3 if n and us > 0 else None


def k10_times(dev, reps: int) -> dict:
    """--k10: K10 on config 5's 4 x 1 frame shards at halos 1, 5 and 540,
    by device time and by events, beside a copy_ of the same bytes."""
    import chip_smoke
    from opticalflowhs_tpu_torch.kernels import ring

    q1, _ = chip_smoke.c5_frames(dev)
    th, w = q1.shape[0] // 4, q1.shape[1]
    shards = [q1[k * th:(k + 1) * th].contiguous() for k in range(4)]
    out = {}
    for halo in (1, 5, th):
        got = ring.ring_halo_exchange(shards, halo)
        for g, r in zip(got, ring.ring_halo_exchange_plain(shards, halo)):
            if not torch.equal(g, r):
                raise RuntimeError(f"K10 differs from its plain version at halo {halo}")
        out[f"k10_halo{halo}_device"] = device_ms(
            lambda: ring.ring_halo_exchange(shards, halo), "halo_kernel", reps)
        out[f"k10_halo{halo}_events"] = event_ms(
            lambda: ring.ring_halo_exchange(shards, halo), reps)
        src = torch.zeros((4, th + halo, w), device=dev)
        dst = torch.empty_like(src)
        out[f"copy_halo{halo}_device"] = device_ms(lambda: dst.copy_(src), "", reps)
        out[f"copy_halo{halo}_events"] = event_ms(lambda: dst.copy_(src), reps)
    return out


def k4_times(dev, reps: int, scan: bool) -> dict:
    """--k4: K4 sweep and freeze launches, R1 and K1, by events and by the
    profiler's device time; with `scan`, where the tree has K4's plan,
    launches and refreeze blocks of 20 at every s."""
    import chip_smoke
    from opticalflowhs_tpu_torch import HSConfig, hs_solve
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import solve_robust as k4

    planned = hasattr(k4, "K4_MAX_SWEEPS")

    def problem(shape, seed=0):
        rng = np.random.default_rng(seed)
        i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
                  for _ in range(2))
        ex, ey, et, _ = k1.hs_derivatives(i1, i2, 0.25)
        z = torch.zeros_like(ex)
        wd, ws = k4.freeze_weights(z, z, ex, ey, et, 0.05, 0.05)
        return i1, i2, (z, z, ex, ey, et, wd, ws)

    def launch(p, s):
        """One sweep launch of s sweeps from p's zero flow."""
        if planned:
            uo, vo = torch.empty_like(p[0]), torch.empty_like(p[0])
            return lambda: k4.launch_sweeps(*p, uo, vo, s, 0.25)
        return lambda: k4.frozen_sweeps(*p, 0.25, s, block_sweeps=s)

    def plan(shape, m):
        return (k4.sweeps_per_launch(0, shape, m, k4.device_blocks(dev)) if planned
                else 8)

    out = {}
    for name, shape in (("1088x1920", (1088, 1920)), ("8x1088x1920", (8, 1088, 1920)),
                        ("544x960", (544, 960)), ("272x480", (272, 480))):
        i1, i2, p = problem(shape)
        row = {"plan_m20": plan(shape, 20)}
        for tag, s in (("s8", 8), ("plan", row["plan_m20"])):
            row[f"sweeps_{tag}_ms"] = event_ms(launch(p, s), reps)
            row[f"sweeps_{tag}_device_ms"] = device_ms(launch(p, s), "sweeps_kernel", reps)
        if name in ("1088x1920", "8x1088x1920"):
            row["k1_ms"] = event_ms(lambda: k1.hs_derivatives(i1, i2, 0.5, zero_sweep=True),
                                    reps)
            row["k1_device_ms"] = device_ms(
                lambda: k1.hs_derivatives(i1, i2, 0.5, zero_sweep=True), "derivatives", reps)
        if name == "1088x1920":
            row["freeze_ms"] = event_ms(lambda: k4.freeze_weights(*p[:5], 0.05, 0.05), reps)
            row["freeze_device_ms"] = device_ms(
                lambda: k4.freeze_weights(*p[:5], 0.05, 0.05), "freeze_kernel", reps)
        out[name] = row
        print(f"k4 {name}: {row}", flush=True)
    s1, s2 = chip_smoke.c1_frames(dev)
    cfg = HSConfig(alpha=0.25, iters=100, solver="robust", robust_update_every=20)
    out["r1_hs_solve_robust_i100_ms"] = event_ms(lambda: hs_solve(s1, s2, cfg), reps)
    print(f"k4 R1: {out['r1_hs_solve_robust_i100_ms']:.4f} ms", flush=True)
    if not scan or not planned:
        return out
    sc = {}
    for name, shape in (("1088x1920", (1088, 1920)), ("1088x1900", (1088, 1900)),
                        ("8x1088x1920", (8, 1088, 1920)), ("544x960", (544, 960)),
                        ("272x480", (272, 480))):
        _, _, p = problem(shape)
        row = {"plan_m20": plan(shape, 20)}
        for s in range(1, k4.K4_MAX_SWEEPS + 1):
            row[f"launch_s{s}"] = event_ms(launch(p, s), reps)
            if name in ("1088x1920", "544x960"):
                row[f"block20_s{s}"] = event_ms(
                    lambda: k4.frozen_sweeps(*p, 0.25, 20, block_sweeps=s), reps)
        sc[name] = row
        print(f"k4 scan {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
    out["scan"] = sc
    out["geometry"] = {s: k4.k4_geometry(dev, s) for s in (1, 8, k4.K4_MAX_SWEEPS)}
    return out


def k7_bands(k7, h: int, w: int) -> dict:
    """Band rows to time K7 at, by name: its own plan and one band a value
    of m (the K2-window tree), or one and two rows of 64 x 64 tiles."""
    if not hasattr(k7, "MAX_TILES"):
        return {"band64": 64, "band128": 128}
    out = {}
    plan = k7.geometry(h, w, 8, 132)
    out[f"plan_m{plan[2]}_bands{plan[4]}"] = 0
    th = plan[0]
    for m in range(1, k7.MAX_TILES + 1):
        rows = m * 132 // -(-w // plan[1])  # the most tile rows a band at m
        if rows >= 1:
            got = k7.geometry(h, w, 8, 132, rows * th)
            out[f"m{got[2]}_bands{got[4]}"] = rows * th
    return out


def k3_times(dev, reps: int, scan: bool) -> dict:
    """--k3: K3 and K9 SOR launches, the S1 chain, beside K2 and K9 Jacobi
    launches; with `scan`, where the tree has K3's plan, launches and chains
    at every s."""
    import chip_smoke
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import sor as k3
    from opticalflowhs_tpu_torch.kernels import sor_planes as k8
    from opticalflowhs_tpu_torch.kernels import tile as k9

    om = chip_smoke.OMEGA

    def problem(shape, seed=0):
        rng = np.random.default_rng(seed)
        i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
                  for _ in range(2))
        return i1, i2, k1.hs_derivatives(i1, i2, 0.5)

    out = {}
    for name, shape in (("1088x1920", (1088, 1920)), ("8x1088x1920", (8, 1088, 1920))):
        _, _, fields = problem(shape)
        z = torch.zeros_like(fields[0])
        uo, vo = torch.empty_like(z), torch.empty_like(z)
        out[f"k3_launch_s4_{name}"] = event_ms(
            lambda: k3.launch_sweeps(z, z, *fields, uo, vo, 4, om), reps)
        out[f"k2_launch_8_{name}"] = event_ms(
            lambda: k2.launch_sweeps(z, z, *fields, uo, vo, 8), reps)
    s1, s2 = chip_smoke.c1_frames(dev)
    out["s1_k1_k3_chain_i50"] = event_ms(
        lambda: sr.hs_solve_resident_sor(s1, s2, 0.5, 50, om), reps)
    out["s1_k1_k8_i50"] = event_ms(lambda: k8.hs_solve_sor_planes(s1, s2, 0.5, 50, om), reps)
    h, w = 2160, 3840
    for tag, hw, sor in (("k9_16x548x968_s4", 4, False), ("k9_sor_16x572x992_n4", 16, True)):
        th, tw = h // 4, w // 4
        rng = np.random.default_rng(180)
        su = torch.from_numpy(rng.normal(0, 0.5, (16, th + 2 * hw, tw + 2 * hw))
                              .astype(np.float32)).to(dev)
        sa, sb = (torch.from_numpy(rng.uniform(0, 1, su.shape).astype(np.float32)).to(dev)
                  for _ in range(2))
        sf = k1.derivatives_plain(sa, sb, 1.0)
        rows = [i * th - hw for i in range(4) for _ in range(4)]
        cols = [j * tw - hw for _ in range(4) for j in range(4)]
        org = k9.origin_table(su, rows, cols)
        if sor:
            out[tag] = event_ms(lambda: k9.sor_tile_sweeps(su, su, *sf, 4, om, org, h, w), reps)
            d4 = (su, sf, org)
        else:
            out[tag] = event_ms(lambda: k9.tile_sweeps(su, su, *sf, 4, org, h, w), reps)
    if not scan or not hasattr(k3, "K3_MAX_SWEEPS"):
        return out
    blocks = k3.device_blocks(dev)
    scan = {}
    for name, shape in (("1088x1920", (1088, 1920)), ("1088x1900", (1088, 1900)),
                        ("8x1088x1920", (8, 1088, 1920)), ("544x960", (544, 960)),
                        ("272x480", (272, 480))):
        _, _, fields = problem(shape)
        z = torch.zeros_like(fields[0])
        uo, vo = torch.empty_like(z), torch.empty_like(z)
        row = {"plan_n50": k3.sweeps_per_launch(0, shape, 50, blocks)}
        for s in range(1, k3.K3_MAX_SWEEPS + 1):
            row[f"launch_s{s}"] = event_ms(
                lambda: k3.launch_sweeps(z, z, *fields, uo, vo, s, om), reps)
            if name in ("1088x1920", "544x960"):
                row[f"chain50_s{s}"] = event_ms(
                    lambda: k3.sor_sweeps(z, z, *fields, 50, om, block_sweeps=s), reps)
        scan[name] = row
        print(f"k3 scan {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
    su, sf, org = d4
    row = {"plan_n4": k3.sweeps_per_launch(0, su.shape, 4, blocks)}
    for s in range(1, 5):
        row[f"n4_s{s}"] = event_ms(
            lambda: k9.sor_tile_sweeps(su, su, *sf, 4, om, org, h, w, block_sweeps=s), reps)
    scan["d4_16x572x992"] = row
    print("k3 scan d4: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    out["scan"] = scan
    out["geometry"] = {"k3_s4": k3.k3_geometry(dev, 4), "k9_sor_s4": k3.k3_geometry(dev, 4, True),
                       "k2_s8": k2.k2_geometry(dev, 8)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--k3", action="store_true")
    ap.add_argument("--k4", action="store_true")
    ap.add_argument("--k10", action="store_true")
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_whole_solve_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.repo).resolve()))
    sys.path.insert(1, str(HERE))
    import chip_smoke
    if args.k10:
        out = k10_times(torch.device("cuda", 0), args.reps)
        print("k10: " + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()), flush=True)
        print(chip_smoke.card_line())
        print(json.dumps({"k10_ms": out, "reps": args.reps, "repo": args.repo,
                          "device": torch.cuda.get_device_name(0)}))
        return 0
    if args.k4:
        out = k4_times(torch.device("cuda", 0), args.reps, args.scan)
        print(chip_smoke.card_line())
        print(json.dumps({"k4_ms": out, "reps": args.reps, "repo": args.repo,
                          "device": torch.cuda.get_device_name(0)}))
        return 0
    if args.k3:
        out = k3_times(torch.device("cuda", 0), args.reps, args.scan)
        print("k3: " + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()
                                 if isinstance(v, float)), flush=True)
        print(chip_smoke.card_line())
        print(json.dumps({"k3_ms": out, "reps": args.reps, "repo": args.repo,
                          "device": torch.cuda.get_device_name(0)}))
        return 0
    from opticalflowhs_tpu_torch import HSConfig, PyramidConfig, hs_pyramid, hs_solve
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import ring
    from opticalflowhs_tpu_torch.kernels import solve_fused as k6
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import solve_skewed as k7
    from opticalflowhs_tpu_torch.kernels import tile as k9

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
            lambda: k2.launch_sweeps(z, z, *fields, uo, vo, 8), args.reps),
               "k1_k2_chain_i100": event_ms(
            lambda: sr.hs_solve_resident(i1, i2, 0.5, 100), args.reps)}
        for n in (8, 96):
            row[f"k6_{n}"] = event_ms(lambda: k6.launch_fused(z, z, *fields, n, 8), args.reps)
            if h * w < 20_000_000:
                for tag, band in k7_bands(k7, h, w).items():
                    row[f"k7_{n}_{tag}"] = event_ms(
                        lambda: k7.launch_skewed(z, z, *fields, n, 8, band=band), args.reps)
        cfg = HSConfig(alpha=0.5, iters=100)
        if (h, w) == (2160, 3840):
            row["L1_hs_solve_i100"] = event_ms(lambda: hs_solve(i1, i2, cfg), args.reps)
            row["L3_hs_pyramid_l3_i100"] = event_ms(
                lambda: hs_pyramid(i1, i2, HSConfig(alpha=1.0, iters=100),
                                   PyramidConfig(levels=3)), args.reps)
            ba, bb = (torch.stack([a, a.flip(0)]) for a in (i1, i2))
            row["L4_fused_2x_i100"] = event_ms(
                lambda: k6.hs_solve_fused_batched(ba, bb, 0.5, 100), args.reps)
            row["L4_skewed_2x_i100"] = event_ms(
                lambda: k7.hs_solve_skewed_batched(ba, bb, 0.5, 100), args.reps)
            row["L4_chain_2x_i100"] = event_ms(
                lambda: sr.hs_solve_resident_batched(ba, bb, 0.5, 100), args.reps)
            del ba, bb
        elif (h, w) == (4320, 7680):
            row["L2_hs_solve_i100"] = event_ms(lambda: hs_solve(i1, i2, cfg), args.reps)
        else:
            cfg_c = HSConfig(alpha=0.5, iters=100, deriv_variant="central")
            row["L2_central_hs_solve_i100"] = event_ms(lambda: hs_solve(i1, i2, cfg_c),
                                                       args.reps)
            row["L2_central_chain_i100"] = event_ms(
                lambda: sr.hs_solve_resident(i1, i2, 0.5, 100, "central"), args.reps)
        out[f"{h}x{w}"] = row
        print(f"{h}x{w}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
        del fields, z, uo, vo, i1, i2
    for name, shape in (("67x93", (67, 93)), ("8x1088x1920", (8, 1088, 1920))):
        rng = np.random.default_rng(0)
        i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
                  for _ in range(2))
        fields = k1.hs_derivatives(i1, i2, 0.5)
        z = torch.zeros_like(i1)
        uo, vo = torch.empty_like(z), torch.empty_like(z)
        out[name] = {"k2_launch_8": event_ms(
            lambda: k2.launch_sweeps(z, z, *fields, uo, vo, 8), args.reps)}
        print(f"{name}: k2_launch_8 {out[name]['k2_launch_8']:.4f} ms", flush=True)

    # Config 5's shapes (chip_smoke.py phase 15): K9 on 16 shards of 548x968
    # at 4 sweeps, K11 and K12 whole i100 solves.
    h, w, hw = 2160, 3840, 4
    th, tw = h // 4, w // 4
    rng = np.random.default_rng(180)
    su = torch.from_numpy(rng.normal(0, 0.5, (16, th + 2 * hw, tw + 2 * hw))
                          .astype(np.float32)).to(dev)
    sa, sb = (torch.from_numpy(rng.uniform(0, 1, su.shape).astype(np.float32)).to(dev)
              for _ in range(2))
    sf = k1.derivatives_plain(sa, sb, 1.0)
    org = k9.origin_table(su, [i * th - hw for i in range(4) for _ in range(4)],
                          [j * tw - hw for _ in range(4) for j in range(4)])
    g41 = chip_smoke._ring_inputs(dev, 4, 1, th, w, hw, 190, h, w)
    g22 = chip_smoke._ring_inputs(dev, 2, 2, h // 2, w // 2, hw, 191, h, w)
    a41 = ([r[0] for r in g41[0]], [r[0] for r in g41[1]], [r[0] for r in g41[2]], 100, hw,
           [o[0][0] for o in g41[3]], h, w)
    a22 = (*g22[:3], 100, hw, g22[3], h, w)
    half41 = a41[:3] + (52,) + a41[4:]
    half22 = a22[:3] + (52,) + a22[4:]
    out["config5"] = {
        "k9_16x548x968_s4": event_ms(lambda: k9.tile_sweeps(su, su, *sf, hw, org, h, w),
                                     args.reps),
        "k11_4x1_i100": event_ms(lambda: ring.ring_fused_sweeps(*a41), args.reps),
        "k12_2x2_i100": event_ms(lambda: ring.ring_fused_sweeps_2d(*a22), args.reps),
        "k11_4x1_i52": event_ms(lambda: ring.ring_fused_sweeps(*half41), args.reps),
        "k12_2x2_i52": event_ms(lambda: ring.ring_fused_sweeps_2d(*half22), args.reps),
    }
    geometry = {"k2_s8": k2.k2_geometry(dev, 8), "k9_s4": k2.k2_geometry(dev, 4, shard=True),
                "k6_s8": k6.k6_geometry(dev, 8)}
    if hasattr(k7, "k7_geometry"):
        geometry["k7_4k_s8"] = k7.k7_geometry(dev, 2160, 3840, 8)
    if hasattr(ring, "ring_geometry"):
        geometry["k11_s4"] = ring.ring_geometry(dev, 4)
        geometry["k12_s4"] = ring.ring_geometry(dev, 4, two_d=True)
    print(f"geometry: {geometry}", flush=True)
    out["geometry"] = geometry
    print("config5: " + ", ".join(f"{k} {v:.4f} ms" for k, v in out["config5"].items()),
          flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"whole_solve_ms": out, "reps": args.reps, "repo": args.repo,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
