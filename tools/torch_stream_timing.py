#!/usr/bin/env python3
"""Time the PyTorch port's batched, streaming, TV-L1, color-plane SOR and
multigrid paths on one CUDA card.

    python3 tools/torch_stream_timing.py [--repo DIR] [--runs N] [--profile]
                                         [--tvl1 | --mg | --dist | --untiled]

Imports opticalflowhs_tpu_torch from DIR (default: this checkout), so two
trees can be compared in one session on one card (run them in turns:
A, B, B, A). The cells are chip_smoke.py's, taken from this checkout:
  * C2: hs_solve_batched on `c2_stack` (8 pairs of noise at 1088x1920),
    configs/c2_video_batch.json;
  * C4: `c4_video` (the 17-frame 1080x1920 pan) as host numpy frames,
    configs/c4_hd_streaming.json, chunk 8: staging the windows alone (host
    copies and H2D, no solve), flow_stream, and flow_stream_warm with the
    warp prior at 25 sweeps.
With --mg the cells are chip_smoke.py's phase 14 instead:
  * S1 through K8 (kernels.hs_solve_sor_planes) and through the K1 + K3
    chain (`c1_frames`, alpha 0.5, i50, omega chip_smoke.OMEGA);
  * M1: hs_solve with solver="multigrid", alpha 1, i1 and i2, on `m1_pair`.
With --dist the cells are chip_smoke.py's phase 15 instead (config 5 on
`c5_frames`, 2160x3840, `c5_configs`, virtual meshes of cuda:0):
  * D1: hs_solve_tiled on the 4 x 4 mesh, halo_sweeps 4; D2:
    hs_pyramid_tiled L3 on it; D3: halo_impl="rdma" on 4 x 1 (K11) and
    2 x 2 (K12); D4: SOR i50 omega chip_smoke.OMEGA on 4 x 4;
  * beside them the untiled hs_solve (K1 + K7), hs_pyramid and SOR solve.
With --untiled only those untiled solves of config 5, C1 (hs_solve
1088x1920 i100 on `c1_frames`, K1 + K2), C3 (hs_pyramid L3 on
`c3_frames`) and L2 (hs_solve 4320x7680 i100 on default_rng(0) noise, K1 +
K6): the whole-image paths whose kernels share their sweep code with the
tiled ones. They need no dist/, so a tree from before it can be compared.
With --tvl1 the cells are chip_smoke.py's phase 12 instead:
  * T1: tvl1_solve on `t1_pair` (1088x1920), 3 levels, TVL1Config();
  * T2: tvl1_solve on `t2_pair` (the 1080p two-motion seam), one level;
  * T3: tvl1_solve_batched on 4 pairs of `c4_video`, warps 2, iters 30;
  * K5 per call of 100 alternations at 1088x1920, 544x960, 272x480 and 8 x
    1088x1920 (device time, chip_smoke.event_ms over N calls).
Each other time is chip_smoke.median_ms over N runs.

With --profile it also traces one call of each with torch.profiler and
reports wall time, device time of kernels and of copies, the busy share
(kernel time over wall time), the device time of K5's kernels, and for
tvl1.median3 (a record_function range) the device time of the kernels it
launches and its span on the device timeline.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (the cells; it imports the port only when called)


def profile(fn) -> dict:
    """Wall ms of one traced call, and the device ms of its kernels and of
    its copies, from torch.profiler."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_us = copy_us = k5_us = minmax_us = 0.0
    median3 = {"kernels_ms": None, "span_ms": None}
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.key == "median3":
            # The range twice: on the host, with the device time of the
            # kernels launched inside it; on the device timeline, as the
            # span from its first to its last kernel, gaps included.
            on_device = e.device_type == torch.autograd.DeviceType.CUDA
            median3["span_ms" if on_device else "kernels_ms"] = float(
                e.self_device_time_total if on_device else e.device_time_total) / 1e3
            continue
        # Device-side entries only: a CPU op (aten::copy_, aten::add) also
        # carries the device time of what it launched.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(e.self_device_time_total)
        if us <= 0:
            continue
        if "memcpy" in e.key.lower() or "memset" in e.key.lower():
            copy_us += us
        else:
            kernel_us += us
        # K5's kernels: tvl1_kernel since its redesign, u_step_kernel and
        # p_step_kernel before it (so that an older tree is traced alike).
        if any(k in e.key for k in ("tvl1_kernel", "u_step_kernel", "p_step_kernel")):
            k5_us += us
        if "minimum" in e.key or "maximum" in e.key:
            minmax_us += us
        by_name[e.key] = us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall, "kernel_ms": kernel_us / 1e3, "copy_ms": copy_us / 1e3,
            "busy_share": kernel_us / 1e3 / wall, "k5_ms": k5_us / 1e3,
            "median3_kernels_ms": median3["kernels_ms"], "median3_span_ms": median3["span_ms"],
            "min_max_kernels_ms": minmax_us / 1e3,
            "top": [[k[:60], v / 1e3] for k, v in top]}


def tvl1_calls(p, dev) -> dict:
    """chip_smoke.py's phase-12 cells T1, T2 and T3, with tvl1.median3 in a
    record_function range so that a trace can attribute its kernels."""
    from opticalflowhs_tpu_torch import tvl1

    median3 = tvl1.median3

    def traced_median3(a):
        with torch.profiler.record_function("median3"):
            return median3(a)

    tvl1.median3 = traced_median3
    t1, t2, _ = chip_smoke.t1_pair(dev)
    m1, m2, _ = chip_smoke.t2_pair(dev)
    vid = torch.from_numpy(chip_smoke.c4_video()[0][:5]).to(dev)
    small = p.TVL1Config(warps=2, iters=30)
    return {
        "t1_tvl1_solve_L3": lambda: p.tvl1_solve(t1, t2, p.TVL1Config(), p.PyramidConfig(levels=3)),
        "t2_tvl1_seam": lambda: p.tvl1_solve(m1, m2, p.TVL1Config()),
        "t3_tvl1_batched_4": lambda: p.tvl1_solve_batched(vid[:4], vid[1:5], small),
    }


def k5_calls(dev) -> dict:
    """K5 per call of 100 alternations (kernels.tvl1_inner at its auto
    alternations a launch) at T1's three level sizes and on C2's 8 x
    1088x1920 stack, on fields made as chip_smoke.py's phase 12 makes them."""
    from opticalflowhs_tpu_torch import TVL1Config
    from opticalflowhs_tpu_torch import tvl1
    from opticalflowhs_tpu_torch.data.synthetic import translation_pair
    from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5

    cfg = TVL1Config()
    t1, t2, _ = chip_smoke.t1_pair(dev)
    c2a, c2b = chip_smoke.c2_stack(dev)
    frames = {"1088x1920": (t1, t2)}
    for h, w, key in ((544, 960, 44), (272, 480, 45)):
        a, b, _ = translation_pair(h, w, 0.7, -0.3, key=key)
        frames[f"{h}x{w}"] = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    frames["8x1088x1920"] = (c2a, c2b)
    calls = {}
    for tag, (i1, i2) in frames.items():
        i1, i2 = tvl1.rescale_pair(i1, i2)
        rng = np.random.default_rng(43)
        u1, u2 = (torch.from_numpy(rng.normal(0, 0.5, tuple(i1.shape)).astype(np.float32))
                  .to(dev) for _ in range(2))
        args = (u1, u2, *tvl1.inner_fields(i1, i2, u1, u2, cfg), 100, *tvl1.inner_scalars(cfg))
        calls[f"k5_call_100_{tag}"] = lambda args=args: k5.tvl1_inner(*args)
    return calls


def sor_planes_mg_calls(p, dev) -> dict:
    """chip_smoke.py's phase-14 cells: S1 through K8 and through the K1 + K3
    chain, and M1 multigrid at one and two V-cycles."""
    from opticalflowhs_tpu_torch.kernels import solve_resident, sor_planes

    s1, s2 = chip_smoke.c1_frames(dev)
    m1, m2, _ = chip_smoke.m1_pair(dev)
    om = chip_smoke.OMEGA
    mg = {n: p.HSConfig(alpha=1.0, iters=n, solver="multigrid") for n in (1, 2)}
    return {
        "s1_k8": lambda: sor_planes.hs_solve_sor_planes(s1, s2, 0.5, 50, om),
        "s1_k1_k3_chain": lambda: solve_resident.hs_solve_resident_sor(s1, s2, 0.5, 50, om),
        "m1_multigrid_i1": lambda: p.hs_solve(m1, m2, mg[1]),
        "m1_multigrid_i2": lambda: p.hs_solve(m1, m2, mg[2]),
    }


def dist_calls(p, dev) -> dict:
    """chip_smoke.py's phase-15 cells D1-D4 and the untiled solves beside
    them."""
    from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled, hs_solve_tiled, make_mesh

    q1, q2 = chip_smoke.c5_frames(dev)
    cfg, pyr, mcfg = chip_smoke.c5_configs()
    s = mcfg.halo_sweeps
    sor = dataclasses.replace(cfg, solver="sor", omega=chip_smoke.OMEGA, iters=50)
    m44 = make_mesh(mcfg, [dev] * 16)
    m41 = make_mesh(p.MeshConfig(y=4), [dev] * 4)
    m22 = make_mesh(p.MeshConfig(y=2, x=2), [dev] * 4)
    return {
        "d1_tiled_4x4": lambda: hs_solve_tiled(q1, q2, cfg, m44, halo_sweeps=s),
        "l1_untiled": lambda: p.hs_solve(q1, q2, cfg),
        "d2_pyramid_tiled_4x4": lambda: hs_pyramid_tiled(q1, q2, cfg, pyr, m44, halo_sweeps=s),
        "l3_pyramid_untiled": lambda: p.hs_pyramid(q1, q2, cfg, pyr),
        "d3_rdma_4x1": lambda: hs_solve_tiled(q1, q2, cfg, m41, halo_sweeps=s, halo_impl="rdma"),
        "d3_rdma_2x2": lambda: hs_solve_tiled(q1, q2, cfg, m22, halo_sweeps=s, halo_impl="rdma"),
        "d4_sor_tiled_4x4": lambda: hs_solve_tiled(q1, q2, sor, m44, halo_sweeps=s),
        "sor_untiled": lambda: p.hs_solve(q1, q2, sor),
    }


def untiled_calls(p, dev) -> dict:
    """The untiled cells beside D1-D4 (configs/c5_multihost_4k.json's hs
    and pyramid sections, read without its mesh), and C1."""
    c5 = json.loads((chip_smoke.ROOT / "configs" / "c5_multihost_4k.json").read_text())
    cfg, pyr = p.from_reference(c5["hs"]), p.from_reference(c5["pyramid"])
    sor = dataclasses.replace(cfg, solver="sor", omega=chip_smoke.OMEGA, iters=50)
    q1, q2 = chip_smoke.c5_frames(dev)
    s1, s2 = chip_smoke.c1_frames(dev)
    c1 = p.HSConfig(alpha=0.5, iters=100)
    p1, p2 = chip_smoke.c3_frames(dev)
    c3 = p.HSConfig(alpha=1.0, iters=100)
    rng = np.random.default_rng(0)
    e1, e2 = (torch.from_numpy(rng.uniform(0, 1, (4320, 7680)).astype(np.float32)).to(dev)
              for _ in range(2))
    return {
        "c1_hs_solve_1080p": lambda: p.hs_solve(s1, s2, c1),
        "c3_hs_pyramid_1080p": lambda: p.hs_pyramid(p1, p2, c3, p.PyramidConfig(levels=3)),
        "l2_hs_solve_8k": lambda: p.hs_solve(e1, e2, c1),
        "l1_untiled": lambda: p.hs_solve(q1, q2, cfg),
        "l3_pyramid_untiled": lambda: p.hs_pyramid(q1, q2, cfg, pyr),
        "sor_untiled": lambda: p.hs_solve(q1, q2, sor),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tvl1", action="store_true", help="time the TV-L1 cells T1-T3")
    ap.add_argument("--mg", action="store_true", help="time S1 through K8, and M1")
    ap.add_argument("--dist", action="store_true", help="time config 5's cells D1-D4")
    ap.add_argument("--untiled", action="store_true",
                    help="time config 5's untiled solves and C1 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stream_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import opticalflowhs_tpu_torch as p
    from opticalflowhs_tpu_torch import video

    dev = torch.device("cuda", 0)
    if args.tvl1:
        return report(args, tvl1_calls(p, dev), k5_calls(dev))
    if args.mg:
        return report(args, sor_planes_mg_calls(p, dev))
    if args.dist:
        return report(args, dist_calls(p, dev))
    if args.untiled:
        return report(args, untiled_calls(p, dev))
    cfg2 = chip_smoke.cell_config("c2_video_batch.json")
    cfg4 = chip_smoke.cell_config("c4_hd_streaming.json")
    cfg4w = dataclasses.replace(cfg4, iters=25)
    c2a, c2b = chip_smoke.c2_stack(dev)
    vid, _ = chip_smoke.c4_video()

    def c2():
        p.hs_solve_batched(c2a, c2b, cfg2)

    def stage():
        for _ in video._prefetched_windows(vid, 8):
            pass

    def stream():
        for _ in p.flow_stream(vid, cfg4, chunk=8):
            pass

    def warm():
        for _ in p.flow_stream_warm(vid, cfg4w, chunk=8, warp_prior=True):
            pass

    return report(args, {"c2_batched_8": c2, "c4_stage_windows": stage,
                         "c4_flow_stream": stream, "c4_flow_stream_warm": warm})


def report(args, calls: dict, kernels: dict | None = None) -> int:
    """Median ms of each call (and with --profile its trace), the device ms
    per call of each of `kernels` (CUDA events over N calls), then the
    card's name and power limit and one JSON line."""
    out = {"repo": args.repo, "runs": args.runs,
           "median_ms": {k: chip_smoke.median_ms(fn, args.runs) for k, fn in calls.items()}}
    if kernels:
        out["event_ms"] = {k: chip_smoke.event_ms(fn, args.runs) for k, fn in kernels.items()}
    if args.profile:
        out["profile"] = {k: profile(fn) for k, fn in calls.items()}
    print(chip_smoke.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
