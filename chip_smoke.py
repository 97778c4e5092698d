#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Builds the port's CUDA kernels from csrc/ (nvcc, a few seconds), holds each
against its plain PyTorch version on the card, then drives the port's
paths through the public entry points, with launch counters showing that
each ran through the kernels:
  phases 1-5: K1 and K2 against their plain versions (K2 also at the
              edge shapes of its own geometry, every s from 1 to 12, B 1
              and 3); hs_solve (1088x1920, alpha 0.5, 100 sweeps) and
              hs_pyramid (3 levels at 1080x1920), then an EPE gate;
  phase 6:    batched K1 and K2 against their plain versions and against
              the single-frame kernels, B in {1, 3};
  phase 7:    config 2 (configs/c2_video_batch.json): hs_solve_batched on
              8 pairs at 1088x1920, and the batched pyramid at 4 x 1080p;
  phase 8:    config 4 (configs/c4_hd_streaming.json) on a 17-frame 1080p
              video: flow_stream (8-image solves), flow_stream_warm with
              the warp prior, flow_stream_occlusion (a 16-image solve),
              each against the plain version;
  phase 9:    K3 (4-color SOR) and K4 (IRLS freeze and sweeps) against
              their plain versions, 67x93 and 1088x1920, B 1 and 3, K3 at s
              2, 5, 11 and its plan, K4 at s 2, 7, 14 and its plan; K3's
              and K4's geometry (no spills) and plans;
  phase 10:   SOR at full size: hs_solve 1088x1920 i50, tune_omega,
              hs_pyramid 1080p L3, SOR i50 against Jacobi i50 and i400 in
              EPE, hs_solve_batched 4 x 1080p;
  phase 11:   robust at full size: hs_solve 1088x1920 i100, and the 1080p
              two-motion seam against classic HS;
  phase 12:   K5 (the TV-L1 inner loop) against its plain version, 67x93,
              131x130 and 1088x1920, B 1 and 3, iters 1, 7, 30, 100, every
              s; its geometry, and its time at T1's level sizes; then
              TV-L1 at full size: tvl1_solve 1088x1920 L3 (T1), the 1080p
              seam against phase 11's classic HS (T2), tvl1_solve_batched
              on 4 x 1080p, flow_stream, flow_stream_occlusion and
              solve_bidirectional with tvl1= (T3);
  phase 13:   K6 and K7 (the whole Jacobi solve in one sweep launch, u/v
              ping-pong and in place) against their plain versions and the
              K1 + K2 chain, 67x93, 131x130 (small forced geometries) and
              1088x1920 central, B 1 and 3, n 7, 9, 100, zero and warm;
              their geometry (no spills) and a sweep block beside a K2
              launch at 4K and 8K; then frames past the resident class
              through the entry points: hs_solve 2160x3840 (L1, K7) and
              4320x7680 (L2, K6) i100, hs_pyramid 4K L3 (L3), the batched
              twins on 2 x 4K (L4) and hs_solve_checkpointed 4K i200 (L5);
  phase 14:   K8 (the whole SOR solve in one launch on K3's window walk)
              against the plain planes, the plain SOR sweeps and the K1 +
              K3 chain at every parity of h and w, n 1, 4, 7, zero and
              warm; its geometry (no spills); S1 through
              kernels.hs_solve_sor_planes (1088x1920 i50) against the chain
              and plain, K8's sweep block beside a K3 launch; None at
              2160x3840; M1 hs_solve with
              solver="multigrid" (K1, then plain V-cycles) at i1 and i2
              against all-plain and Jacobi i100/i1600 in EPE; a multigrid
              stack of 2 x 1080p and a 3-level multigrid pyramid;
  phase 15:   K9 (tile sweeps keyed to a global origin, Jacobi and SOR),
              K10 (the ring halo exchange), K11 and K12 (the fused ring
              solves) against their plain versions (K9 also with true
              image edges at K2's warp and lane boundaries) on virtual
              meshes of cuda:0 (1x1, 2x1, 4x1, 2x2, 1x4) and at config 5's
              shapes (where they are timed: K10 also by its device time
              beside a copy_ of its bytes; K11 and K12 also a sweep block
              beside a K9 launch, their geometry, and a block's time
              beyond the K9 launch: exchange, flag waits, barrier); then
              config 5
              (configs/c5_multihost_4k.json) through dist/ on virtual
              meshes: hs_solve_tiled 2160x3840 i100 halo_sweeps 4 on 4 x 4
              (D1), hs_pyramid_tiled L3 (D2), halo_impl="rdma" on 4 x 1
              and 2 x 2 (D3), SOR i50 (D4), each against the untiled solve;
  phase 16:   the Lucas-Kanade family (plain torch; no kernel launches):
              lk_solve on T1's pair (LK1) and C3's frames at 3 levels
              (LK3) against the CPU, lk_solve_batched on 8 of C4's pairs
              (LK-B, = singles), flow_stream(lk=) on C4's video (LK-S),
              flow_with_occlusion(lk=) against the CPU; ego-motion of
              LK-S's flows and of an exact model field; hs_energy of C1's
              and T1's solves at i25 and i100; a profile of one LK1 call.
  phase 17:   the command line (opticalflowhs_tpu_torch.cli, in process,
              its files in a temporary directory): run on C3's pair as
              PGM (= hs_pyramid bitwise, the same K1/K2 launches, timed
              beside the solve with its host stages; KITTI, --viz and
              --needle files read back), video on C4's frames as a PGM
              directory (= flow_stream bitwise, the same launches; an LK
              stream with --occlusion --egomotion), eval middlebury on four
              1088x1920 pairs (= evaluate on the entry points bitwise, hs
              and lk), bench at 1088x1920, selftest (kernel check 0.0), info.
  phase 18:   gradients (kernels/autodiff.py: the kernel forward, the plain
              twin's VJP backward): every entry (K1-K8, the whole-solve
              drivers) at 40x56 and 3 x 37x61, zero and warm, = its plain
              twin; K4's parts, K9-K12 and hs_solve_tiled refused, forward
              mode refused; G1 C1's hs_solve i100 and i400 (launches, ms,
              peak beside an un-checkpointed hand loop) and three descent
              steps on an offset to frame 2; G2 S1, R1, a stack of C2, C3's
              pyramid, L1 (K7) and L2 central (K6); G3 tvl1_solve one level
              (K5); each = the plain route bitwise.
  phase 19:   bfloat16 on the Jacobi path: K1, K2, K6 and K7's bfloat16
              builds = their plain bfloat16 twins; C1-C4, L1 and L2 in
              bfloat16 beside float32, counted; G1 in bfloat16.
  phase 20:   bfloat16 on SOR and IRLS: K3, K8 and K4's freeze and sweeps
              in bfloat16 = their plain twins at their edge shapes (s plan,
              2, 5, 11 and plan, 2, 7, 14, B 1 and 3, zero and warm), K8 at
              every parity, their geometry; B7 (S1), B8 (S2's EPE ordering),
              B9 (R1), B10 (R2's seam), B11 (S1 through K8) and B12 (C2's
              stack with SOR and robust, C3's pyramid with SOR, C4's stream
              with SOR, SOR to tol, omega = 0, B7's and B9's gradients), each
              beside float32, counted, = the plain route bitwise.
  phase 21:   bfloat16 on TV-L1, multigrid and LK: K5's bfloat16 build =
              its plain twin at phase 12's shapes (B 1 and 3, iters 1, 7,
              30, 100, zero and warm, every s), its geometry (= float32's
              s and launches, no spills); B13 (T1), B14 (T2's seam against
              classic HS), B15 (T3's stack and the tvl1= streams), B16 (M1
              i1 and i2 against Jacobi i100 and i1600 in EPE, the multigrid
              stack and pyramid), B17 (LK1, LK3, LK-B, LK-S) and B18 (G3's
              gradient), each beside float32, counted, = the plain route
              bitwise (LK: = the CPU); K5 a call of 100 by device time,
              bfloat16 beside float32.
  phase 22:   bfloat16 on dist/: K9 (Jacobi and SOR), K10, K11 and K12's
              bfloat16 builds = their plain twins (K9's shards at the
              corners of an image, stacks, true edges at K2's warp and
              lane boundaries, odd and 16-byte widths, s 1-8 and the
              plan; K10 rings of 1-4 shards; K11/K12 on virtual meshes
              1x1, 2x1, 4x1, 2x2, 1x4 at n 1, 7, 100, zero and warm), their
              geometry (float32's tile, no spills), the grad refusals;
              config 5's D1-D4 and a solve to tol in bfloat16 beside
              float32, each counted (= float32's launches) and = the
              untiled bfloat16 solve bitwise; each kernel at config 5's
              shapes beside float32.
  phase 23:   the rest of dist/ (dist/gspmd.py, dist/reshard.py; no new
              kernel), float32 then bfloat16, each route counted (K1, K4's
              freeze and sweeps, K5) beside its untiled counterpart's
              launches, = the untiled entry bitwise, timed beside it
              (median of 5, synced): config 5's 2160x3840 pair on its
              virtual 4 x 4 mesh through hs_solve_tiled robust (D6: a
              fixed count and to tol) and multigrid (D7), hs_pyramid_tiled
              L3 with robust and multigrid levels (D8); tvl1_solve_tiled
              and lk_solve_tiled L3 on 2 x 2 (D9); DP: C2's stack through
              hs_solve_batched(mesh=) on (4, 1, 1) (Jacobi, robust,
              multigrid), C4's streams with mesh= on (2, 1, 1),
              flow_with_occlusion on 2 x 2 (hs, lk, tvl1); C4's frames
              through time_to_space / space_to_time on (2, 2, 2) and
              timesharded_pairs on (4, 1, 1); estimate_egomotion and
              hs_energy over D1's 16 shards (axis_names) against the whole.
Every phase checks what it measures and any failure exits non-zero.
Imports torch, numpy and opticalflowhs_tpu_torch only, never JAX.

Output: one line of numbers per phase; then, on lines of their own, the
card's name and power limit as nvidia-smi gives them, and a JSON object
{"kernels": [...]} (per kernel: launches on the batched path for K1 and
K2, on the SOR and robust path for K3 and K4, on the TV-L1 path for K5,
on phase 13's path for K6 and K7, on phase 14's for K8, on phase 15's for
K9-K12, on phases 19's, 20's, 21's and 22's for the bfloat16 builds, max |diff| against
the plain version, ms per launch for the kernel and the plain version at
8 x 1088x1920 (for K5 per call of 100 alternations, with its 1088x1920,
544x960 and 272x480 numbers; for K6, K7 and K8 per
whole solve, K1 included, at 4320x7680, 2160x3840 i100 and 1088x1920 i50;
for K10 its device time by the profiler, its events and a copy_ beside),
and the least time the card could take; K2's row adds its single-frame
1088x1920 numbers, and K2's and K9's rows the geometry the built kernel
reports: tile, threads, shared bytes, registers, spills, resident blocks
an SM, K3's and K9 SOR's too, with their schedule's byte floor); the last
line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# The port's one roofline accounting (opticalflowhs_tpu_torch/bench.py).
from opticalflowhs_tpu_torch.bench import HBM_GBPS, VPU_TOPS

TOL = 2e-6  # the reference's kernel-vs-oracle bar; the kernels aim for 0.0
ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA's data sheet): device memory and float32 outside
# the tensor cores. A kernel's bound is the larger of bytes / memory rate
# and operations / float32 rate. The data sheet's float32 rate counts a
# fused multiply-add as two operations; the kernels are built with
# --fmad=false, so each multiply and add issues on its own and they can
# reach about half of it (33.5e12 operations/s). The bounds here use the
# data sheet's rate, the one bounds are stated against, so an ops bound
# can be up to 2x below what the unfused kernels could reach. The rates come
# from the port's bench.py tables, keyed by the card's name.
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_BYTES_PER_S = HBM_GBPS[H100_SXM] * 1e9   # 3.35e12
PEAK_FLOPS = VPU_TOPS[H100_SXM] * 1e12         # 67e12
# float32 operations per pixel, counted from the sources: K1 with the
# zero-start sweep (hs_cube: 16 for Ex/Ey, 2 scales, 8 for Et, 5 for invd,
# 5 for u1/v1); K2's window loop (k2_window.cuh: K2, K9, K6, K7, K11, K12)
# per sweep, each column sum once: 9 per neighbour average, 5 for frac, 4
# for the update, so 27.
K1_FLOPS_PER_PX = 36
K2_FLOPS_PER_PX_SWEEP = 27
# K3 per sweep (sor.cu, K9 SOR too): one SOR update a pixel (its color's
# stage): the column sums 4.5 a field (those of a lane's 4 columns, and of
# the 2 the first stage updated again), the neighbour average 6 a field,
# 5 for frac, 4 for the targets and the blend, 3 for each of u and v: 36.
# K4 freeze: 8 for wd, 14 for ws (an rsqrt counted as one). K4's sweep
# kernel (robust.cu) forms the launch's frozen coefficients once a pixel,
# K4_HOISTED_FLOPS_PER_PX: 8 for the four edge weights, 3 for their sum, 2
# for wd Ex and wd Ey, 3 each for a11 and a22, 1 for a12, 2 for c1 and c2,
# 3 for det and 1 for 1/det (an IEEE division counted as one); a sweep is
# then K4_FLOPS_PER_PX_SWEEP: 14 for the two neighbour sums, 4 for b1 and
# b2, 8 for u' and v'. A launch of s sweeps is 26 s + 26 a pixel: the
# hoisted set spread over the launch's sweeps is 26 + 26/s a pixel a sweep
# (52 at s = 1, what the plain sweep computes).
K3_FLOPS_PER_PX_SWEEP = 36
K4_FREEZE_FLOPS_PER_PX = 22
K4_FLOPS_PER_PX_SWEEP = 26
K4_HOISTED_FLOPS_PER_PX = 26
# K5 per alternation: the u-step 23 (rho 4, the three-case step 5 with its
# two compares, v 4, two divergences 6, u 4), the p-step 14 a field (two
# differences, the norm 4 with its sqrt, n 2, two updates 6): 51 float32
# operations, of which 4 are IEEE divisions and 2 square roots. Without fast
# math each is a sequence of instructions on its fast path, as cuobjdump
# shows the kernel's SASS: a division K5_DIV_INSTR (MUFU.RCP, FCHK, five
# FFMA and the range branch), a square root K5_SQRT_INSTR (the range test
# and its branch, MUFU.RSQ, two FMUL and two FFMA, the add of the bias), so
# the operations bound counts 51 - 6 + 4*K5_DIV_INSTR + 2*K5_SQRT_INSTR = 93
# a pixel an alternation. A call reads
# u1, u2 and the 5 constant fields once and writes u1, u2 once. The blocked
# schedule moves, per launch, the 11 arrays of its windows in (7 in the
# first launch, which starts from zero duals) and the 6 state arrays of its
# tiles out (2 in the last launch): `k5_schedule_bytes`.
K5_FLOPS_PER_PX_ITER = 51
K5_DIV_INSTR = 8
K5_SQRT_INSTR = 8
K5_OPS_PER_PX_ITER = K5_FLOPS_PER_PX_ITER - 6 + 4 * K5_DIV_INSTR + 2 * K5_SQRT_INSTR
K5_CALL_ARRAYS = 9
# A whole Jacobi solve from zero (K1 with its first sweep, then n - 1
# sweeps) reads two frames and writes two flows; a K6/K7 sweep block moves
# K2's 8 arrays.
SOLVE_ARRAYS = 4
SWEEP_BLOCK_ARRAYS = 8
OMEGA = 1.71  # the SOR workloads' omega, as tools/hw_sor_resident_ab.py
# K1 without the zero-start sweep (the SOR solves' derivatives): 31 float32
# operations a pixel.
K1_FIELDS_FLOPS_PER_PX = 31
# bfloat16 builds (phase 19): the same float32 arithmetic plus one rounding
# a stored array: K1 with its first sweep rounds 6 arrays, a K2 sweep u and
# v (29 a pixel a sweep in place of 27); every array 2 bytes.
K1_BF16_FLOPS_PER_PX = K1_FLOPS_PER_PX + 6
K2_BF16_FLOPS_PER_PX_SWEEP = K2_FLOPS_PER_PX_SWEEP + 2
# Phase 20: K3 a sweep and K4's sweeps a sweep round u and v (2 more a
# pixel), K4's freeze rounds wd and ws (2), K1 without the first sweep
# rounds its 4 arrays.
K3_BF16_FLOPS_PER_PX_SWEEP = K3_FLOPS_PER_PX_SWEEP + 2
K4_BF16_FLOPS_PER_PX_SWEEP = K4_FLOPS_PER_PX_SWEEP + 2
K4_FREEZE_BF16_FLOPS_PER_PX = K4_FREEZE_FLOPS_PER_PX + 2
K1_FIELDS_BF16_FLOPS_PER_PX = K1_FIELDS_FLOPS_PER_PX + 4
# Phase 21: K5's bfloat16 build rounds u1, u2 and the four duals an
# alternation (6 more a pixel than float32's 93); every array 2 bytes.
K5_BF16_OPS_PER_PX_ITER = K5_OPS_PER_PX_ITER + 6
BF16_REPLACES = {
    "K1": ["opticalflowhs_tpu/kernels/derivatives.py:40",
           "opticalflowhs_tpu/kernels/solve_resident.py:161",
           "opticalflowhs_tpu/kernels/solve_resident.py:394"],
    "K2": ["opticalflowhs_tpu/kernels/jacobi.py:184", "opticalflowhs_tpu/kernels/jacobi.py:241",
           "opticalflowhs_tpu/kernels/jacobi.py:375", "opticalflowhs_tpu/kernels/jacobi.py:631",
           "opticalflowhs_tpu/kernels/solve_resident.py:161",
           "opticalflowhs_tpu/kernels/solve_resident.py:394"],
    "K6": ["opticalflowhs_tpu/kernels/solve_fused.py:111",
           "opticalflowhs_tpu/kernels/solve_fused.py:375"],
    "K7": ["opticalflowhs_tpu/kernels/solve_skewed.py:219",
           "opticalflowhs_tpu/kernels/solve_skewed.py:229"],
    "K3": ["opticalflowhs_tpu/kernels/sor.py:59", "opticalflowhs_tpu/kernels/sor.py:113",
           "opticalflowhs_tpu/kernels/solve_resident.py:161"],
    "K4": ["opticalflowhs_tpu/kernels/solve_robust.py:92"],
    "K8": ["opticalflowhs_tpu/kernels/sor_planes.py:78"],
    "K5": ["opticalflowhs_tpu/kernels/tvl1_inner.py:99"],
    "K9": ["opticalflowhs_tpu/kernels/jacobi.py:855"],
    "K9 SOR": ["opticalflowhs_tpu/kernels/sor.py:59"],
    "K10": ["opticalflowhs_tpu/kernels/rdma_halo.py:49"],
    "K11": ["opticalflowhs_tpu/kernels/rdma_halo.py:135"],
    "K12": ["opticalflowhs_tpu/kernels/rdma_halo.py:398"],
}
# NVLink between the cards of one host: 900 GB/s all to all, 450 each way.
NVLINK_BYTES_PER_S = 450e9
# Frames at the edges of K2's geometry (48 x 128 windows, warps spanning 128
# columns, lanes of 4 columns, 3 rows a warp): narrower than a lane, a warp
# or a tile, 1-3 rows, a last tile of one column (w = 113 at s = 8), one
# column.
K2_EDGE_SHAPES = ((1, 1), (2, 7), (3, 31), (1, 32), (2, 33), (3, 63), (5, 65), (9, 129),
                  (33, 113), (40, 1))


def k3_schedule_bytes(geo: dict, px: int) -> float:
    """Bytes one K3 launch moves under its schedule: the 6 arrays of its
    windows in (the window's area over the tile's times the frame) and u and
    v of its tiles out."""
    from opticalflowhs_tpu_torch.kernels import sor as k3
    halo = k3.K3_WINDOW_H * k3.K3_WINDOW_W / (geo["tile_h"] * geo["tile_w"])
    return 4.0 * px * (6 * halo + 2)


def k3_plan_launches(dev, shape, n: int) -> int:
    """K3 launches of a chain of n sweeps over `shape` by K3's plan."""
    from opticalflowhs_tpu_torch.kernels import sor as k3
    return k3.launches(n, k3.sweeps_per_launch(0, shape, n, k3.device_blocks(dev)))


def k4_schedule_bytes(geo: dict, px: int) -> float:
    """Bytes one K4 sweep launch moves under its schedule: the 7 arrays of
    its windows in (the window's area over the tile's times the frame) and
    u and v of its tiles out."""
    halo = geo["window_h"] * 128 / (geo["tile_h"] * geo["tile_w"])
    return 4.0 * px * (7 * halo + 2)


def k4_plan(dev, shape, m: int) -> int:
    """K4's sweeps a launch in a refreeze block of m sweeps over `shape`."""
    from opticalflowhs_tpu_torch.kernels import solve_robust as k4
    return k4.sweeps_per_launch(0, shape, m, k4.device_blocks(dev))


def k4_plan_launches(dev, shape, iters: int, every: int) -> int:
    """K4 sweep launches of an IRLS run of `iters` sweeps refrozen every
    `every`, by K4's plan for each refreeze block."""
    from opticalflowhs_tpu_torch import robust
    from opticalflowhs_tpu_torch.kernels import solve_robust as k4
    return sum(k4.launches(m, k4_plan(dev, shape, m))
               for m in robust.refreeze_blocks(iters, every))


def k5_schedule_bytes(geo: dict, px: int, iters: int, itemsize: int = 4) -> float:
    """Bytes a K5 call of `iters` alternations moves under its blocked
    schedule: each launch reads the arrays of its windows (the window's area
    over the tile's times the frame) and writes those of its tiles, of
    `itemsize` bytes a value (2 for the bfloat16 build)."""
    s = geo["iters_per_launch"]
    halo = geo["window_h"] * 128 / (geo["tile_h"] * geo["tile_w"])
    launches = -(-iters // s)
    arrays = sum((7 if k == 0 else 11) * halo + (2 if k == launches - 1 else 6)
                 for k in range(launches))
    return float(itemsize) * px * arrays


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def event_ms(fn, reps: int = 20) -> float:
    """Device time per call from CUDA events around `reps` calls."""
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


def median_ms(fn, runs: int = 20) -> float:
    """Median host time per call over `runs` calls, each ended by a
    synchronize, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, match: str, reps: int = 20, tries: int = 3) -> tuple[float, int]:
    """Device time per call of the kernels whose name `match` (a regular
    expression) is found in, from torch.profiler over `reps` calls after a
    warm-up, and how many such kernel runs the profiler saw (0: it saw
    none, and the time means nothing). The profiler names a kernel by its
    demangled or its mangled symbol, so `match` must find either. It tries
    up to `tries` times: a profiler run may return no device activity, and
    each empty run is reported on stderr with the device names it saw."""
    import re

    from torch.profiler import ProfilerActivity
    pattern = re.compile(match)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        hits = [e for e in cuda if pattern.search(e.key)]
        if hits:
            return (sum(float(e.self_device_time_total) for e in hits) / 1e3 / reps,
                    sum(e.count for e in hits))
        print(f"device_ms: the profiler saw no kernel matching {match!r} in {reps} calls; "
              f"device names {sorted(e.key[:80] for e in cuda)[:8]}", file=sys.stderr)
    return 0.0, 0


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """Least time in ms the card could take, and what bounds it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_flow_diff(a, b) -> float:
    """Max |diff| over the two fields of two (u, v) pairs or Flows."""
    return max(max_diff(a[0], b[0]), max_diff(a[1], b[1]))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# The cells of configs 2 and 4, also timed by tools/torch_stream_timing.py.
def cell_config(name: str):
    """The HSConfig of configs/<name>; its "mesh" section stays with dist/."""
    from opticalflowhs_tpu_torch import from_reference
    return from_reference(json.loads((ROOT / "configs" / name).read_text())["hs"])


def c2_stack(dev, b: int = 8):
    """C2's frames: b pairs of uniform noise at 1088x1920 from
    default_rng(0), as bench.py; b = 8 as opticalflowhs_tpu/bench.py:182."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.uniform(0, 1, (b, 1088, 1920)).astype(np.float32)).to(dev)
                 for _ in range(2))


def c1_frames(dev):
    """C1's (and S1's) frames on the card: two 1088x1920 frames of uniform
    noise from default_rng(0), as bench.py."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.uniform(0, 1, (1088, 1920)).astype(np.float32)).to(dev)
                 for _ in range(2))


def c4_video():
    """C4's video as host numpy frames, and its flow: the 17-frame
    1080x1920 pan by (1, 0.5) px a frame."""
    from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence
    return synthetic_sequence(17, 1080, 1920, tx=1.0, ty=0.5)


def t1_pair(dev):
    """T1's frames on the card and their flow: translation_pair(1088, 1920,
    0.7, -0.3, key=5), as tools/hw_tvl1_ab.py's family row."""
    from opticalflowhs_tpu_torch.data.synthetic import translation_pair
    i1, i2, gt = translation_pair(1088, 1920, 0.7, -0.3, key=5)
    return torch.from_numpy(i1).to(dev), torch.from_numpy(i2).to(dev), gt


def t2_pair(dev):
    """T2's (and R2's) frames on the card and their flow: the 1080p
    two-motion pair, (1, 0) px left of the seam and (-1, 0) right of it."""
    from opticalflowhs_tpu_torch.data.synthetic import two_motion_pair
    i1, i2, gt = two_motion_pair(1088, 1920, (1.0, 0.0), (-1.0, 0.0), key=3)
    return torch.from_numpy(i1).to(dev), torch.from_numpy(i2).to(dev), gt


def c3_frames(dev):
    """C3's frames on the card: the 1080x1920 translation_pair (3, 1.5) px of
    configs/c3_pyramid.json's workload (key 0, max_freq 0.06)."""
    from opticalflowhs_tpu_torch.data.synthetic import translation_pair
    p1, p2, _ = translation_pair(1080, 1920, 3.0, 1.5, key=0, max_freq=0.06)
    return torch.from_numpy(p1).to(dev), torch.from_numpy(p2).to(dev)


def c5_frames(dev):
    """D1-D4's frames on the card: two 2160x3840 frames of uniform noise from
    default_rng(5), config 5's size."""
    rng = np.random.default_rng(5)
    return tuple(torch.from_numpy(rng.uniform(0, 1, (2160, 3840)).astype(np.float32)).to(dev)
                 for _ in range(2))


def c5_configs():
    """Config 5's (configs/c5_multihost_4k.json) HSConfig (alpha 1, i100),
    PyramidConfig (3 levels) and MeshConfig (1 x 4 x 4, halo_sweeps 4)."""
    from opticalflowhs_tpu_torch import from_reference
    c5 = json.loads((ROOT / "configs" / "c5_multihost_4k.json").read_text())
    return tuple(from_reference(c5[k]) for k in ("hs", "pyramid", "mesh"))


def m1_pair(dev):
    """M1's frames on the card and their flow: translation_pair(1088, 1920,
    1.0, 0.0, key=3), the reference's multigrid-against-Jacobi pair
    (tests/unit/test_multigrid.py) at full size."""
    from opticalflowhs_tpu_torch.data.synthetic import translation_pair
    i1, i2, gt = translation_pair(1088, 1920, 1.0, 0.0, key=3)
    return torch.from_numpy(i1).to(dev), torch.from_numpy(i2).to(dev), gt


def sor_and_robust(dev, s1, s2, p1, p2, pa, pb, stack) -> tuple[dict, dict]:
    """Phases 9-11: K3 and K4 against their plain versions, then the SOR
    and robust paths at full size, counted. Returns (max |diff| per kernel,
    launches per kernel on the counted path)."""
    from opticalflowhs_tpu_torch import (
        HSConfig,
        PyramidConfig,
        hs_pyramid,
        hs_solve,
        hs_solve_batched,
        robust,
    )
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import solve_robust as k4
    from opticalflowhs_tpu_torch.kernels import sor as k3
    from opticalflowhs_tpu_torch.metrics import epe, interior
    from opticalflowhs_tpu_torch.solver import tune_omega

    err = {"hs_sor_sweeps": 0.0, "hs_robust_freeze": 0.0, "hs_robust_sweeps": 0.0}

    def note(name, d, what):
        err[name] = max(err[name], d)
        require(d <= TOL, f"{what}: max|diff| {d}")

    # -- phase 9: K3 and K4 against their plain versions ----------------------
    for h, w in ((67, 93), (1088, 1920)):
        for b in (1, 3):
            i1, i2 = stack(b, h, w, seed=30)
            u0, v0 = stack(b, h, w, seed=31, normal=True)
            z = torch.zeros_like(u0)
            for variant in ("hs_cube", "central"):
                ex, ey, et, invd = k1.derivatives_plain(i1, i2, 0.5, variant)
                for start, uv in (("warm", (u0, v0)), ("zero", (z, z))):
                    d3 = 0.0
                    # n not a multiple of s; the plan's s, and s up to K3_MAX_SWEEPS
                    for n, s in ((7, 0), (9, 2), (13, 5), (23, k3.K3_MAX_SWEEPS)):
                        got = k3.sor_sweeps(*uv, ex, ey, et, invd, n, OMEGA, block_sweeps=s)
                        d3 = max(d3, max_flow_diff(got, k3.sor_sweeps_plain(
                            *uv, ex, ey, et, invd, n, OMEGA)))
                    note("hs_sor_sweeps", d3, f"K3 {b}x{h}x{w} {variant} {start}")
                    wd, ws = robust.charbonnier_weights(*uv, ex, ey, et, 0.05, 0.01)
                    dfz = max_flow_diff(k4.freeze_weights(*uv, ex, ey, et, 0.05, 0.01),
                                        (wd, ws))
                    note("hs_robust_freeze", dfz, f"K4 freeze {b}x{h}x{w} {variant} {start}")
                    # n not a multiple of s; the plan's s, and s up to K4_MAX_SWEEPS
                    d4s = 0.0
                    for n, s in ((13, 0), (9, 2), (15, 7), (29, k4.K4_MAX_SWEEPS)):
                        got = k4.frozen_sweeps(*uv, ex, ey, et, wd, ws, 0.3, n, block_sweeps=s)
                        want = uv
                        for _ in range(n):
                            want = robust.robust_step(*want, ex, ey, et, wd, ws, 0.3)
                        d4s = max(d4s, max_flow_diff(got, want))
                    note("hs_robust_sweeps", d4s, f"K4 sweeps {b}x{h}x{w} {variant} {start}")
                    d4 = 0.0
                    for k in (1, 5, 20):  # 13 sweeps: every sweep, odd k crossing, k > n
                        cfg = HSConfig(alpha=0.3, iters=13, solver="robust",
                                       robust_update_every=k)
                        d4 = max(d4, max_flow_diff(k4.robust_sweeps(*uv, ex, ey, et, 13, cfg),
                                                   robust.robust_sweeps(*uv, ex, ey, et, 13, cfg)))
                    note("hs_robust_sweeps", d4, f"K4 IRLS {b}x{h}x{w} {variant} {start}")
                    print(f"phase 9 B={b} {h}x{w} {variant} {start}: K3 n=7,9,13,23 "
                          f"s=plan,2,5,{k3.K3_MAX_SWEEPS} {d3:.3g}; "
                          f"K4 freeze {dfz:.3g}; K4 sweeps n=13,9,15,29 "
                          f"s=plan,2,7,{k4.K4_MAX_SWEEPS} {d4s:.3g}; "
                          f"K4 IRLS 13 sweeps k=1,5,20 {d4:.3g}")
            for start, init in (("zero", (None, None)), ("warm", (u0, v0))):
                d = max_flow_diff(sr.hs_solve_resident_sor(i1, i2, 0.5, 11, OMEGA, "hs_cube", *init),
                                  sr.hs_solve_resident_sor_plain(i1, i2, 0.5, 11, OMEGA,
                                                                 "hs_cube", *init))
                note("hs_sor_sweeps", d, f"SOR driver {b}x{h}x{w} {start}")
                cfg = HSConfig(alpha=0.3, iters=13, solver="robust", robust_update_every=5)
                dr = max_flow_diff(k4.hs_solve_robust_resident(i1, i2, cfg, *init),
                                   k4.hs_solve_robust_resident_plain(i1, i2, cfg, *init))
                note("hs_robust_sweeps", dr, f"IRLS driver {b}x{h}x{w} {start}")
                print(f"phase 9 drivers B={b} {h}x{w} {start}: SOR n=11 {d:.3g}; "
                      f"IRLS n=13 k=5 {dr:.3g}")

    for shard in (False, True):
        for s in (2, 4, k3.K3_MAX_SWEEPS):
            geo = k3.k3_geometry(dev, s, shard)
            require(geo["spill_bytes"] == 0 and geo["blocks_per_sm"] == 1
                    and 0 < geo["registers"] <= 65536 // geo["threads"],
                    f"K3 geometry {geo}: expected no spills and one block an SM")
            print(f"phase 9 K3 geometry ({'K9 SOR' if shard else 'K3'}) s={s}: {geo}")
    plan = {shape: k3.sweeps_per_launch(0, shape, n, k3.device_blocks(dev))
            for shape, n in (((1088, 1920), 50), ((4, 1080, 1920), 50), ((16, 572, 992), 4))}
    print(f"phase 9 K3 plan (s): {plan}, for i50, i50 and D4's halo block of 4")
    for s in (1, k4_plan(dev, (1088, 1920), 20), k4.K4_MAX_SWEEPS):
        geo = k4.k4_geometry(dev, s)
        require(geo["spill_bytes"] == 0 and geo["blocks_per_sm"] == 1
                and 0 < geo["registers"] <= min(255, 65536 // geo["threads"]),
                f"K4 geometry {geo}: expected no spills and one block an SM")
        print(f"phase 9 K4 geometry s={s}: {geo}")
    rcp = k4.rcp_check(dev)
    print(f"phase 9 K4 reciprocal against the IEEE division over every float it takes: {rcp}")
    require(rcp == {"mismatch_div": 0, "mismatch_double": 0, "checked": 2 * 252 * 2 ** 23},
            f"K4's reciprocal differs from the IEEE division: {rcp}")
    plan = {shape: k4_plan(dev, shape, 20) for shape in ((1088, 1920), (4, 1080, 1920))}
    print(f"phase 9 K4 plan (s) for a refreeze block of 20 (R1's): {plan}")

    # -- the SOR and robust path, counted ---------------------------------------
    cfg_sor = HSConfig(alpha=0.5, iters=50, solver="sor", omega=OMEGA)
    cfg_rob = HSConfig(alpha=0.25, iters=100, solver="robust", robust_update_every=20)
    pyr3 = PyramidConfig(levels=3)
    counters = {"hs_derivatives": k1.hs_derivatives, "hs_sor_sweeps": k3.sor_sweeps,
                "hs_robust_freeze": k4.freeze_weights, "hs_robust_sweeps": k4.frozen_sweeps}

    def zero_counts():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {n: c.launches for n, c in counters.items()}

    torch.cuda.synchronize()
    zero_counts()
    f_sor = hs_solve(s1, s2, cfg_sor)
    f_pyr = hs_pyramid(p1, p2, cfg_sor, pyr3)
    f_bat = hs_solve_batched(pa, pb, cfg_sor)
    f_rob = hs_solve(s1, s2, cfg_rob)
    torch.cuda.synchronize()
    launches = counts()
    print(f"SOR and robust path launches (hs_solve SOR, hs_pyramid SOR, "
          f"hs_solve_batched SOR, hs_solve robust): {launches}")
    require(all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}")

    def plain(cfg):
        return dataclasses.replace(cfg, backend="torch")

    # -- phase 10: SOR at full size ------------------------------------------------
    for f, shape in ((f_sor, (1088, 1920)), (f_pyr, (1080, 1920)), (f_bat, (4, 1080, 1920))):
        for a in f:
            require(tuple(a.shape) == shape and bool(torch.isfinite(a).all()),
                    f"SOR output shape/finite {shape}")
    d = max_flow_diff(f_sor, hs_solve(s1, s2, plain(cfg_sor)))
    note("hs_sor_sweeps", d, "hs_solve SOR kernel vs plain")
    zero_counts()
    hs_solve(s1, s2, cfg_sor)
    n_sor = counts()
    ms_k = median_ms(lambda: hs_solve(s1, s2, cfg_sor))
    ms_p = median_ms(lambda: hs_solve(s1, s2, plain(cfg_sor)), runs=5)
    print(f"phase 10 hs_solve SOR 1088x1920 a=0.5 i50 omega {OMEGA}: max|diff|={d:.3g} "
          f"launches K1={n_sor['hs_derivatives']} K3={n_sor['hs_sor_sweeps']} "
          f"kernel {ms_k:.3f} ms plain {ms_p:.3f} ms")
    require(n_sor["hs_derivatives"] == 1
            and n_sor["hs_sor_sweeps"] == k3_plan_launches(dev, (1088, 1920), 50),
            f"hs_solve SOR launches {n_sor}")

    t0 = time.perf_counter()
    om_k = tune_omega(s1, s2, HSConfig(alpha=0.5))
    ms_om = (time.perf_counter() - t0) * 1e3
    om_p = tune_omega(s1, s2, HSConfig(alpha=0.5, backend="torch"))
    print(f"phase 10 tune_omega 1088x1920 a=0.5: cuda {om_k} ({ms_om:.3f} ms) plain {om_p}")
    require(om_k == om_p, f"tune_omega differs: cuda {om_k} plain {om_p}")

    d = max_flow_diff(f_pyr, hs_pyramid(p1, p2, plain(cfg_sor), pyr3))
    note("hs_sor_sweeps", d, "hs_pyramid SOR kernel vs plain")
    ms_k = median_ms(lambda: hs_pyramid(p1, p2, cfg_sor, pyr3))
    ms_p = median_ms(lambda: hs_pyramid(p1, p2, plain(cfg_sor), pyr3), runs=5)
    print(f"phase 10 hs_pyramid SOR 1080x1920 L3 a=0.5 i50: max|diff|={d:.3g} "
          f"kernel {ms_k:.3f} ms plain {ms_p:.3f} ms")

    t1, t2, gt = t1_pair(dev)
    gtc = interior(gt, 16)
    tte = {}
    for tag, cfg in (("SOR i50", HSConfig(alpha=0.25, iters=50, solver="sor", omega=OMEGA)),
                     ("Jacobi i50", HSConfig(alpha=0.25, iters=50)),
                     ("Jacobi i400", HSConfig(alpha=0.25, iters=400))):
        f = hs_solve(t1, t2, cfg)
        fl = np.stack([f.u.cpu().numpy(), f.v.cpu().numpy()], axis=-1)
        tte[tag] = (epe(interior(fl, 16), gtc), median_ms(lambda: hs_solve(t1, t2, cfg), runs=10))
    print("phase 10 time to EPE, translation_pair 1088x1920 (0.7, -0.3) a=0.25: "
          + "; ".join(f"{t} EPE {e:.6f} {ms:.3f} ms" for t, (e, ms) in tte.items()))
    require(tte["SOR i50"][0] < tte["Jacobi i50"][0], f"SOR i50 EPE not below Jacobi i50: {tte}")

    d = max_flow_diff(f_bat, hs_solve_batched(pa, pb, plain(cfg_sor)))
    note("hs_sor_sweeps", d, "hs_solve_batched SOR kernel vs plain")
    zero_counts()
    hs_solve_batched(pa, pb, cfg_sor)
    n_bat = counts()
    ms_k = median_ms(lambda: hs_solve_batched(pa, pb, cfg_sor))
    print(f"phase 10 hs_solve_batched SOR 4 x 1080x1920 a=0.5 i50: max|diff|={d:.3g} "
          f"launches K1={n_bat['hs_derivatives']} K3={n_bat['hs_sor_sweeps']} "
          f"kernel {ms_k:.3f} ms ({4 / ms_k * 1e3:.1f} pairs/s)")
    require(n_bat["hs_derivatives"] == 1
            and n_bat["hs_sor_sweeps"] == k3_plan_launches(dev, tuple(pa.shape), 50),
            f"batched SOR launches per stack {n_bat}")

    # -- phase 11: robust at full size -----------------------------------------------
    for a in f_rob:
        require(tuple(a.shape) == (1088, 1920) and bool(torch.isfinite(a).all()),
                "robust output shape/finite")
    d = max_flow_diff(f_rob, hs_solve(s1, s2, plain(cfg_rob)))
    note("hs_robust_sweeps", d, "hs_solve robust kernel vs plain")
    zero_counts()
    hs_solve(s1, s2, cfg_rob)
    n_rob = counts()
    ms_k = median_ms(lambda: hs_solve(s1, s2, cfg_rob))
    ms_p = median_ms(lambda: hs_solve(s1, s2, plain(cfg_rob)), runs=5)
    blocks = robust.refreeze_blocks(100, 20)
    want = (1, len(blocks), k4_plan_launches(dev, (1088, 1920), 100, 20))
    got = (n_rob["hs_derivatives"], n_rob["hs_robust_freeze"], n_rob["hs_robust_sweeps"])
    print(f"phase 11 hs_solve robust 1088x1920 a=0.25 i100 k=20: max|diff|={d:.3g} "
          f"launches K1={got[0]} K4 freeze={got[1]} K4 sweeps={got[2]} "
          f"kernel {ms_k:.3f} ms plain {ms_p:.3f} ms")
    require(got == want, f"robust launches {got}, expected {want}")

    m1, m2, gt = t2_pair(dev)
    band = np.zeros((1088, 1920), bool)
    band[8:-8, 1920 // 2 - 8:1920 // 2 + 8] = True
    inner = np.zeros((1088, 1920), bool)
    inner[8:-8, 8:-8] = True
    seam = {}
    for tag, cfg in (("classic i400", HSConfig(alpha=0.1, iters=400)),
                     ("robust i400", HSConfig(alpha=0.1, iters=400, solver="robust",
                                              robust_eps_s=0.01))):
        f = hs_solve(m1, m2, cfg)
        dp = max_flow_diff(f, hs_solve(m1, m2, plain(cfg)))
        if cfg.solver == "robust":
            note("hs_robust_sweeps", dp, f"seam {tag} kernel vs plain")
        require(dp <= TOL, f"seam {tag} kernel vs plain max|diff| {dp}")
        fl = np.stack([f.u.cpu().numpy(), f.v.cpu().numpy()], axis=-1)
        e = np.sqrt(((fl - gt) ** 2).sum(-1))
        seam[tag] = (float(e[inner].mean()), float(e[band].mean()), dp,
                     median_ms(lambda: hs_solve(m1, m2, cfg), runs=5))
    print("phase 11 seam two_motion_pair 1088x1920 (1,0)|(-1,0) a=0.1: "
          + "; ".join(f"{t} EPE interior {a:.4f} seam band {b:.4f} vs plain {dp:.3g} {ms:.3f} ms"
                      for t, (a, b, dp, ms) in seam.items()))
    require(seam["robust i400"][1] < seam["classic i400"][1],
            f"robust seam-band EPE not below classic: {seam}")
    return err, launches, seam["classic i400"][1]


def tvl1_path(dev, vid, vid_dev, c2a, c2b, classic_band: float) -> dict:
    """Phase 12: K5 against its plain version, then the TV-L1 path at full
    size, counted: T1 tvl1_solve 1088x1920 L3 (beside it one level, warps
    2, iters 30), T2 the 1080p two-motion seam against classic HS's band
    EPE from phase 11, T3 a stack of C4's video, flow_stream,
    flow_stream_occlusion and solve_bidirectional with tvl1=. Returns K5's
    row of the kernels line."""
    from opticalflowhs_tpu_torch import (
        PyramidConfig,
        TVL1Config,
        flow_stream,
        tvl1_solve,
        tvl1_solve_batched,
    )
    from opticalflowhs_tpu_torch import tvl1 as tv
    from opticalflowhs_tpu_torch.consistency import solve_bidirectional
    from opticalflowhs_tpu_torch.data.synthetic import translation_pair
    from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5
    from opticalflowhs_tpu_torch.metrics import epe, interior
    from opticalflowhs_tpu_torch.pyramid import gaussian_pyramid
    from opticalflowhs_tpu_torch.video import flow_stream_occlusion

    err = 0.0

    def note(d, what):
        nonlocal err
        err = max(err, d)
        require(d <= TOL, f"{what}: max|diff| {d}")

    def plain(cfg):
        return dataclasses.replace(cfg, backend="torch")

    cfg0 = TVL1Config()
    scalars = tv.inner_scalars(cfg0)

    def inner_args(i1, i2, seed):
        """Warm (u1, u2) from a seeded normal and the fields of a real
        precompute on the pair scaled to [0, 255]."""
        i1, i2 = tv.rescale_pair(i1, i2)
        rng = np.random.default_rng(seed)
        u1, u2 = (torch.from_numpy(rng.normal(0, 0.5, tuple(i1.shape)).astype(np.float32)).to(dev)
                  for _ in range(2))
        return u1, u2, tv.inner_fields(i1, i2, u1, u2, cfg0)

    def pairs(b, h, w, key):
        """b translation pairs (0.7, -0.3 px), an (H, W) pair when b is 1."""
        made = [translation_pair(h, w, 0.7, -0.3, key=key + k) for k in range(b)]
        return tuple(torch.from_numpy(np.stack([m[j] for m in made])).to(dev).squeeze(0)
                     for j in (0, 1))

    # -- phase 12: K5 against its plain version ---------------------------------
    # Every s from 1 to K5_MAX_ITERS (and the auto value), iters that s does
    # not divide, at odd shapes, a stack and 1088x1920.
    t1, t2, gt_t = t1_pair(dev)
    geo = k5.k5_geometry(dev)
    print(f"phase 12 K5 geometry at 1088x1920 (auto s = {geo['iters_per_launch']}): {geo}")
    for shape in ((544, 960), (272, 480), (8, 1088, 1920)):
        print(f"phase 12 K5 geometry at {'x'.join(map(str, shape))}: "
              f"{k5.k5_geometry(dev, 0, shape)}")
    require(geo["spill_bytes"] == 0, f"K5 spills registers: {geo}")
    for b, h, w in ((1, 67, 93), (3, 67, 93), (1, 131, 130), (1, 1088, 1920)):
        i1, i2 = (t1, t2) if h == 1088 else pairs(b, h, w, 40)
        u1, u2, fields = inner_args(i1, i2, seed=41)
        rho0, gx, gy, _, th = fields
        rho = rho0 + u1 * gx + u2 * gy
        cases = [float((rho < -th).float().mean()), float((rho > th).float().mean()),
                 float((rho.abs() <= th).float().mean())]
        require(min(cases) > 0, f"K5 {b}x{h}x{w}: a case of the data term never fires {cases}")
        diffs = []
        for iters in (1, 7, 30, 100):
            want = k5.tvl1_inner_plain(u1, u2, *fields, iters, *scalars)
            d = 0.0
            for s in range(k5.K5_MAX_ITERS + 1):
                d = max(d, max_flow_diff(
                    k5.tvl1_inner(u1, u2, *fields, iters, *scalars, block_iters=s), want))
            note(d, f"K5 {b}x{h}x{w} iters {iters}")
            diffs.append(d)
        print(f"phase 12 K5 B={b} {h}x{w}: data-term cases rho<-th {cases[0]:.4f} "
              f"rho>th {cases[1]:.4f} |rho|<=th {cases[2]:.4f}; max|diff| vs plain "
              f"iters 1, 7, 30, 100 (s 1-{k5.K5_MAX_ITERS} and auto): "
              f"{' '.join(f'{d:.3g}' for d in diffs)}")

    # -- the TV-L1 path, counted ------------------------------------------------
    pyr3 = PyramidConfig(levels=3)
    small = TVL1Config(warps=2, iters=30)
    m1, m2, gt_m = t2_pair(dev)
    pa, pb = vid_dev[:4], vid_dev[1:5]
    occ = dict(a=0.0, b=1e-4)  # phase 8's thresholds, so that some pixels are flagged
    torch.cuda.synchronize()
    k5.tvl1_inner.launches = 0
    f_t1 = tvl1_solve(t1, t2, cfg0, pyr3)
    n_t1 = k5.tvl1_inner.launches
    f_small = tvl1_solve(t1, t2, small)
    f_t2 = tvl1_solve(m1, m2, cfg0)
    before_t3 = k5.tvl1_inner.launches
    f_t3 = tvl1_solve_batched(pa, pb, small)
    n_t3 = k5.tvl1_inner.launches - before_t3
    chunks = list(flow_stream(vid, tvl1=small, chunk=8))
    occ_flow, occ_mask = next(flow_stream_occlusion(vid[:9], tvl1=small, chunk=8, **occ))
    bidi = solve_bidirectional(t1, t2, tvl1=small)
    torch.cuda.synchronize()
    launches = k5.tvl1_inner.launches
    print(f"TV-L1 path launches (T1, its small leg, T2, T3 stack, flow_stream, "
          f"flow_stream_occlusion, solve_bidirectional): hs_tvl1_inner {launches}")
    require(launches > 0, "K5 never ran on the TV-L1 path")
    # ceil(iters/s) a call, s the kernel's choice at each level's size.
    levels = [tuple(a.shape) for a in gaussian_pyramid(t1, pyr3.levels)]
    want_t1 = cfg0.warps * sum(k5.k5_geometry(dev, 0, hw, cfg0.iters)["launches"]
                               for hw in levels)
    require(n_t1 == want_t1, f"T1 K5 launches {n_t1}, expected {want_t1}")
    want_t3 = small.warps * k5.k5_geometry(dev, 0, tuple(pa.shape), small.iters)["launches"]
    require(n_t3 == want_t3, f"T3 K5 launches per stack {n_t3}, expected {want_t3}")

    def flow_np(f):
        return np.stack([f.u.cpu().numpy(), f.v.cpu().numpy()], axis=-1)

    # -- T1: tvl1_solve 1088x1920 L3, and the small leg -----------------------------
    for f in (f_t1, f_small, f_t2, bidi[0], bidi[1]):
        for a in f:
            require(tuple(a.shape) == (1088, 1920) and bool(torch.isfinite(a).all()),
                    "TV-L1 output shape/finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_t1 = tvl1_solve(t1, t2, plain(cfg0), pyr3)
    torch.cuda.synchronize()
    ms_t1p = (time.perf_counter() - t0) * 1e3
    d = max_flow_diff(f_t1, p_t1)
    note(d, "T1 kernel vs plain")
    ms_t1 = median_ms(lambda: tvl1_solve(t1, t2, cfg0, pyr3), runs=10)
    e_t1 = epe(interior(flow_np(f_t1), 16), interior(gt_t, 16))
    print(f"phase 12 T1 tvl1_solve 1088x1920 L3 warps 5 iters 100 median checked: "
          f"max|diff| vs plain {d:.3g}; K5 launches {n_t1}; kernel {ms_t1:.3f} ms "
          f"(median of 10) plain {ms_t1p:.3f} ms (once); interior EPE {e_t1:.6f}")
    require(e_t1 < 0.1, f"T1 EPE {e_t1}")
    d = max_flow_diff(f_small, tvl1_solve(t1, t2, plain(small)))
    note(d, "T1 small leg kernel vs plain")
    ms_s = median_ms(lambda: tvl1_solve(t1, t2, small), runs=10)
    e_s = epe(interior(flow_np(f_small), 16), interior(gt_t, 16))
    print(f"phase 12 T1 small leg 1 level warps 2 iters 30: max|diff| vs plain {d:.3g}; "
          f"kernel {ms_s:.3f} ms; interior EPE {e_s:.6f}")

    # median3's share of T1, by CUDA events on each level's fields: 2 fields
    # a warp, 5 warps a level.
    ms_med = []
    for h, w in ((1088, 1920), (544, 960), (272, 480)):
        a = torch.from_numpy(np.random.default_rng(42).normal(0, 1, (h, w))
                             .astype(np.float32)).to(dev)
        ms_med.append(event_ms(lambda: tv.median3(a)))
    med_t1 = 2 * cfg0.warps * sum(ms_med)
    print(f"phase 12 median3 per field 1088x1920 {ms_med[0]:.4f} ms, 544x960 "
          f"{ms_med[1]:.4f} ms, 272x480 {ms_med[2]:.4f} ms; in T1 (30 calls) "
          f"{med_t1:.3f} ms = {med_t1 / ms_t1:.3f} of T1's {ms_t1:.3f} ms")

    # -- T2: the seam ----------------------------------------------------------------
    d = max_flow_diff(f_t2, tvl1_solve(m1, m2, plain(cfg0)))
    note(d, "T2 kernel vs plain")
    ms_t2 = median_ms(lambda: tvl1_solve(m1, m2, cfg0), runs=5)
    e = np.sqrt(((flow_np(f_t2) - gt_m) ** 2).sum(-1))
    band = e[8:-8, 1920 // 2 - 8:1920 // 2 + 8].mean()
    print(f"phase 12 T2 seam two_motion_pair 1088x1920 (1,0)|(-1,0) TV-L1 warps 5 "
          f"iters 100: max|diff| vs plain {d:.3g}; EPE interior {e[8:-8, 8:-8].mean():.4f} "
          f"seam band {band:.4f} (classic HS i400 {classic_band:.4f}); kernel {ms_t2:.3f} ms")
    require(band < classic_band, f"TV-L1 seam-band EPE {band} not below classic {classic_band}")

    # -- T3: stacks and streams ----------------------------------------------------------
    for k in range(4):
        one = tvl1_solve(pa[k], pb[k], small)
        require(bool(torch.equal(f_t3.u[k], one.u) and torch.equal(f_t3.v[k], one.v)),
                f"T3 stack image {k} differs from tvl1_solve")
    d = max_flow_diff(f_t3, tvl1_solve_batched(pa, pb, plain(small)))
    note(d, "T3 stack kernel vs plain")
    ms_t3 = median_ms(lambda: tvl1_solve_batched(pa, pb, small), runs=5)
    print(f"phase 12 T3 tvl1_solve_batched 4 x 1080x1920 warps 2 iters 30: bitwise = "
          f"tvl1_solve on each pair; max|diff| vs plain {d:.3g}; K5 launches per stack "
          f"{n_t3}; kernel {ms_t3:.3f} ms ({4 / ms_t3 * 1e3:.1f} pairs/s)")
    require([c.u.shape[0] for c in chunks] == [8, 8], "TV-L1 flow_stream chunk sizes")
    for k, c in enumerate(chunks):
        ref = tvl1_solve_batched(vid_dev[8 * k:8 * k + 8], vid_dev[8 * k + 1:8 * k + 9], small)
        require(bool(torch.equal(c.u, ref.u) and torch.equal(c.v, ref.v)),
                f"TV-L1 flow_stream chunk {k} differs from tvl1_solve_batched")

    def stream_all():
        for c in flow_stream(vid, tvl1=small, chunk=8):
            pass

    ms_st = median_ms(stream_all, runs=3)
    plain_flow, plain_mask = next(flow_stream_occlusion(vid[:9], tvl1=plain(small), chunk=8,
                                                        **occ))
    d_o = max_flow_diff(occ_flow, plain_flow)
    note(d_o, "TV-L1 flow_stream_occlusion kernel vs plain")
    require(bool(torch.equal(occ_mask, plain_mask)), "TV-L1 occlusion mask differs from plain")
    pb_f, pb_b = solve_bidirectional(t1, t2, tvl1=plain(small))
    d_b = max(max_flow_diff(bidi[0], pb_f), max_flow_diff(bidi[1], pb_b))
    note(d_b, "TV-L1 solve_bidirectional kernel vs plain")
    print(f"phase 12 T3 flow_stream tvl1 16 pairs 1080x1920 chunk 8: chunks bitwise = "
          f"tvl1_solve_batched; {ms_st:.3f} ms end to end from host frames "
          f"({16 / ms_st * 1e3:.1f} pairs/s); flow_stream_occlusion one window (16 images) "
          f"max|diff| vs plain {d_o:.3g}, masks equal, occluded share "
          f"{float(occ_mask.float().mean()):.5f}; solve_bidirectional max|diff| vs plain {d_b:.3g}")

    # -- K5 per call (100 alternations): T1's three levels and the C2 stack ----------
    row = {}
    for tag, (i1, i2), reps_plain in (("1088x1920", (t1, t2), 3),
                                      ("544x960", pairs(1, 544, 960, 44), 3),
                                      ("272x480", pairs(1, 272, 480, 45), 3),
                                      ("c2_stack", (c2a, c2b), 1)):
        u1, u2, fields = inner_args(i1, i2, seed=43)
        px = u1.numel()
        g = k5.k5_geometry(dev, 0, tuple(u1.shape), 100)
        t_k = event_ms(lambda: k5.tvl1_inner(u1, u2, *fields, 100, *scalars), reps=5)
        t_p = event_ms(lambda: k5.tvl1_inner_plain(u1, u2, *fields, 100, *scalars),
                       reps=reps_plain)
        b_ms, b_by = bound_ms(K5_CALL_ARRAYS * 4 * px, K5_OPS_PER_PX_ITER * 100 * px)
        sched_ms = k5_schedule_bytes(g, px, 100) / PEAK_BYTES_PER_S * 1e3
        print(f"kernel hs_tvl1_inner {tuple(u1.shape)}: {t_k:.4f} ms per call of 100 "
              f"alternations ({g['launches']} launches of {g['iters_per_launch']}), plain {t_p:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; {K5_OPS_PER_PX_ITER} operations a pixel an alternation); the "
              f"blocked schedule's own byte bound {sched_ms:.4f} ms")
        row[tag] = (t_k, t_p, b_ms, b_by, sched_ms)
    t_k, t_p, b_ms, b_by, _ = row["c2_stack"]
    return {"name": "hs_tvl1_inner", "route": "cuda",
            "source": "opticalflowhs_tpu_torch/csrc/tvl1.cu",
            "replaces": ["opticalflowhs_tpu/kernels/tvl1_inner.py:99"],
            "launches": launches, "launches_t1_solve": n_t1, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "iters_per_launch": geo["iters_per_launch"],
            "geometry": geo,
            **{f"{k}_{tag}": v for tag, vals in row.items() if tag != "c2_stack"
               for k, v in zip(("ms", "plain_ms", "bound_ms", "bound_by", "schedule_bound_ms"),
                               vals)},
            "schedule_bound_ms": row["c2_stack"][4], "t1_ms": ms_t1, "t1_plain_ms": ms_t1p}


def peak_bytes(fn) -> int:
    """Peak device memory that `fn` allocates beyond what was allocated
    before it (torch.cuda.max_memory_allocated)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def beyond_resident(dev, frames, stack, s1, s2) -> list:
    """Phase 13: K6 and K7 against their plain versions and the K1 + K2
    chain, then frames past the resident class through the entry points,
    counted: L1 hs_solve 2160x3840 i100 (K7), L2 4320x7680 i100 and 1088x1920
    central i100 (K6), L3 hs_pyramid 4K L3, L4 the batched twins on 2 x 4K,
    L5 hs_solve_checkpointed 4K i200; C1 beside them keeps its K1 + K2
    chain. Returns the K6 and K7 rows of the kernels line."""
    import tempfile

    from opticalflowhs_tpu_torch import (
        HSConfig,
        PyramidConfig,
        hs_pyramid,
        hs_solve,
        hs_solve_checkpointed,
    )
    from opticalflowhs_tpu_torch.checkpoint import frames_hash, save_state
    from opticalflowhs_tpu_torch.data.synthetic import translation_pair
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import solve_fused as k6
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import solve_skewed as k7
    from opticalflowhs_tpu_torch.metrics import epe, interior

    err = {"hs_solve_fused": 0.0, "hs_solve_skewed": 0.0}

    def note(name, got, want, what):
        d = max_flow_diff(got, want)
        err[name] = max(err[name], d)
        require(d <= TOL, f"{what}: max|diff| {d}")
        return d

    def same(a, b, what):
        require(bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])),
                f"{what}: not bitwise equal")

    # -- phase 13: K6 and K7 against plain and the K1 + K2 chain ----------------
    # Small frames with small forced geometries (K6 on 2 blocks, so that
    # each loops over several tiles; K7 in 16-row bands), and 1088x1920
    # central at the kernels' own geometry.
    for b, h, w in ((1, 67, 93), (3, 67, 93), (1, 131, 130), (3, 131, 130), (1, 1088, 1920)):
        small = h < 1000
        variant = "hs_cube" if small else "central"
        i1, i2 = (a.squeeze(0) for a in stack(b, h, w, seed=50))
        u0, v0 = (a.squeeze(0) for a in stack(b, h, w, seed=51, normal=True))
        geo6 = dict(blocks=2) if small else {}
        geo7 = dict(band=16) if small else {}
        d6 = d7 = 0.0
        for n in (7, 9, 100):
            for init in ((None, None), (u0, v0)):
                want = k6.hs_solve_fused_plain(i1, i2, 0.5, n, variant, *init)
                chain = sr.hs_solve_resident(i1, i2, 0.5, n, variant, *init)
                got6 = k6.hs_solve_fused(i1, i2, 0.5, n, variant, *init, **geo6)
                got7 = k7.hs_solve_skewed(i1, i2, 0.5, n, variant, *init, **geo7)
                start = "zero" if init[0] is None else "warm"
                what = f"{b}x{h}x{w} {variant} n={n} {start}"
                d6 = max(d6, note("hs_solve_fused", got6, want, f"K6 {what}"))
                d7 = max(d7, note("hs_solve_skewed", got7, want, f"K7 {what}"))
                same(got6, chain, f"K6 vs the K1 + K2 chain {what}")
                same(got7, chain, f"K7 vs the K1 + K2 chain {what}")
                if b > 1 and init[0] is None:
                    for k in range(b):
                        one = k6.hs_solve_fused(i1[k], i2[k], 0.5, n, variant)
                        same((got6[0][k], got6[1][k]), one, f"K6 stack image {k} {what}")
                        same((got7[0][k], got7[1][k]), one, f"K7 stack image {k} {what}")
        print(f"phase 13 K6/K7 B={b} {h}x{w} {variant} n=7,9,100 zero+warm "
              f"{'(K6 on 2 blocks, K7 in 16-row bands)' if small else '(own geometry)'}: "
              f"max|diff| vs plain K6 {d6:.3g} K7 {d7:.3g}; = the K1 + K2 chain bitwise"
              + ("; stack = singles" if b > 1 else ""))

    # -- the beyond-resident path, counted --------------------------------------
    cfg = HSConfig(alpha=0.5, iters=100)
    cfg_c = HSConfig(alpha=0.5, iters=100, deriv_variant="central")
    cfg3 = HSConfig(alpha=1.0, iters=100)
    pyr3 = PyramidConfig(levels=3)
    cfg_ck = HSConfig(alpha=0.5, iters=200, checkpoint_every=100)
    q1, q2 = frames(2160, 3840, seed=0)
    e1, e2 = frames(4320, 7680, seed=0)
    t0 = time.perf_counter()
    p1, p2, gt = translation_pair(2160, 3840, 3.0, 1.5, key=0, max_freq=0.06)
    print(f"phase 13 pyramid pair 2160x3840 made in {time.perf_counter() - t0:.3f} s (host)")
    p1, p2 = torch.from_numpy(p1).to(dev), torch.from_numpy(p2).to(dev)
    ba, bb = stack(2, 2160, 3840, seed=0)
    ckdir = tempfile.mkdtemp(prefix="hsflow_ck_")
    ck = str(Path(ckdir) / "l5.npz")
    counters = {"K1": k1.hs_derivatives, "K2": k2.jacobi_sweeps,
                "K6": k6.hs_solve_fused, "K7": k7.hs_solve_skewed}
    per_call = {}

    def counted(tag, fn):
        before = {n: c.launches for n, c in counters.items()}
        out = fn()
        per_call[tag] = {n: c.launches - before[n] for n, c in counters.items()}
        return out

    # -- K6/K7 geometry, and a sweep block of 8 beside a K2 launch of 8 ----------------
    # (before the counted run: these launches are not the path's)
    geo = {"K6": k6.k6_geometry(dev, 8), "K7 4K": k7.k7_geometry(dev, 2160, 3840, 8),
           "K7 8K": k7.k7_geometry(dev, 4320, 7680, 8)}
    for tag, g in geo.items():
        require(g["spill_bytes"] == 0 and g["blocks_per_sm"] >= 1, f"{tag} geometry {g}")
        print(f"phase 13 {tag} geometry at s 8: {g}")
    blocks = {}
    for tag, (a, b) in (("2160x3840", (q1, q2)), ("4320x7680", (e1, e2))):
        fields = k1.hs_derivatives(a, b, 0.5)
        z = torch.zeros_like(a)
        uo, vo = torch.empty_like(z), torch.empty_like(z)
        blocks[tag] = {
            "k2_launch": event_ms(lambda: k2.launch_sweeps(z, z, *fields, uo, vo, 8), 10),
            "k6_block": event_ms(lambda: k6.launch_fused(z, z, *fields, 8, 8), 10),
            "k7_block": event_ms(lambda: k7.launch_skewed(z, z, *fields, 8, 8), 10)}
        print(f"phase 13 a sweep block of 8 at {tag}: K6 {blocks[tag]['k6_block']:.4f} ms, "
              f"K7 {blocks[tag]['k7_block']:.4f} ms, a K2 launch of 8 "
              f"{blocks[tag]['k2_launch']:.4f} ms (CUDA events, 10 calls)")
        del fields, z, uo, vo

    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    f_l1 = counted("L1", lambda: hs_solve(q1, q2, cfg))
    f_l2 = counted("L2", lambda: hs_solve(e1, e2, cfg))
    f_l2c = counted("L2 central", lambda: hs_solve(s1, s2, cfg_c))
    f_c1 = counted("C1", lambda: hs_solve(s1, s2, cfg))
    f_l3 = counted("L3", lambda: hs_pyramid(p1, p2, cfg3, pyr3))
    f_l4f = counted("L4 fused", lambda: k6.hs_solve_fused_batched(ba, bb, 0.5, 100))
    f_l4s = counted("L4 skewed", lambda: k7.hs_solve_skewed_batched(ba, bb, 0.5, 100))
    f_l5 = counted("L5", lambda: hs_solve_checkpointed(q1, q2, cfg_ck, ck))
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"beyond-resident path launches (L1, L2, L2 central, C1, L3, L4, L5): {launches}; "
          f"per call {per_call}")
    want = {"L1": (1, 0, 0, 1), "L2": (1, 0, 1, 0), "L2 central": (1, 0, 1, 0),
            "C1": (1, 13, 0, 0), "L4 fused": (1, 0, 1, 0), "L4 skewed": (1, 0, 0, 1),
            "L5": (2, 0, 0, 2)}
    for tag, counts in want.items():
        require(tuple(per_call[tag].values()) == counts,
                f"{tag} launches {per_call[tag]}, expected K1, K2, K6, K7 = {counts}")
    require(per_call["L3"]["K7"] == 1 and per_call["L3"]["K1"] == 3
            and per_call["L3"]["K6"] == 0 and per_call["L3"]["K2"] > 0,
            f"L3 launches {per_call['L3']}")

    def plain(c):
        return dataclasses.replace(c, backend="torch")

    # -- L1: hs_solve 2160x3840 i100 through K7 ----------------------------------
    for f, shape in ((f_l1, (2160, 3840)), (f_l2, (4320, 7680)), (f_l3, (2160, 3840)),
                     (f_l4f, (2, 2160, 3840)), (f_l4s, (2, 2160, 3840)), (f_l5, (2160, 3840))):
        for a in f:
            require(tuple(a.shape) == shape and bool(torch.isfinite(a).all()),
                    f"phase 13 output shape/finite {shape}")
    same(f_c1, sr.hs_solve_resident(s1, s2, 0.5, 100), "C1 vs the K1 + K2 chain")
    rows = {}
    for tag, name, (a, b), f in (("L1", "hs_solve_skewed", (q1, q2), f_l1),
                                 ("L2", "hs_solve_fused", (e1, e2), f_l2)):
        h, w = a.shape
        px = a.numel()
        d = note(name, f, hs_solve(a, b, plain(cfg)), f"{tag} kernel vs plain")
        same(f, sr.hs_solve_resident(a, b, 0.5, 100), f"{tag} vs the K1 + K2 chain")
        ms_k = median_ms(lambda: hs_solve(a, b, cfg))
        ms_c = median_ms(lambda: sr.hs_solve_resident(a, b, 0.5, 100))
        ms_p = median_ms(lambda: hs_solve(a, b, plain(cfg)), runs=3)
        mem_k = peak_bytes(lambda: hs_solve(a, b, cfg))
        mem_c = peak_bytes(lambda: sr.hs_solve_resident(a, b, 0.5, 100))
        b_ms, b_by = bound_ms(SOLVE_ARRAYS * 4 * px,
                              (K1_FLOPS_PER_PX + 99 * K2_FLOPS_PER_PX_SWEEP) * px)
        block_ms = SWEEP_BLOCK_ARRAYS * 4 * px / PEAK_BYTES_PER_S * 1e3
        print(f"phase 13 {tag} hs_solve {h}x{w} a=0.5 i100 ({name}): max|diff| vs plain {d:.3g}, "
              f"= the K1 + K2 chain bitwise; launches {per_call[tag]}; kernel {ms_k:.3f} ms, "
              f"K1 + K2 chain {ms_c:.3f} ms, plain {ms_p:.3f} ms (median of 20, 20, 3); "
              f"peak memory {mem_k / 2**20:.1f} MiB, chain {mem_c / 2**20:.1f} MiB; "
              f"bound {b_ms:.4f} ms ({b_by}), {block_ms:.4f} ms of bytes a sweep block")
        rows[name] = dict(ms=ms_k, plain_ms=ms_p, chain_ms=ms_c, bound_ms=b_ms, bound_by=b_by,
                          block_bytes_ms=block_ms, peak_mib=mem_k / 2**20,
                          chain_peak_mib=mem_c / 2**20, shape=[h, w],
                          geometry=geo["K6" if name == "hs_solve_fused" else "K7 4K"],
                          sweep_block_ms={t: b["k6_block" if name == "hs_solve_fused"
                                               else "k7_block"] for t, b in blocks.items()},
                          k2_launch_ms={t: b["k2_launch"] for t, b in blocks.items()})
        if name == "hs_solve_skewed":
            pencils = 2 * 2 * k2.sweeps_per_launch(0) * w * 4
            require(mem_c - mem_k >= 2 * px * 4 - pencils,
                    f"K7 peak {mem_k} not one u/v pair below the chain's {mem_c}")

    # -- L2: also 1088x1920 central through K6 -------------------------------------
    d = note("hs_solve_fused", f_l2c, hs_solve(s1, s2, plain(cfg_c)), "L2 central kernel vs plain")
    same(f_l2c, sr.hs_solve_resident(s1, s2, 0.5, 100, "central"), "L2 central vs the chain")
    ms_k = median_ms(lambda: hs_solve(s1, s2, cfg_c))
    ms_c = median_ms(lambda: sr.hs_solve_resident(s1, s2, 0.5, 100, "central"))
    print(f"phase 13 L2 hs_solve 1088x1920 central a=0.5 i100 (hs_solve_fused): max|diff| vs plain "
          f"{d:.3g}; launches {per_call['L2 central']}; kernel {ms_k:.3f} ms, K1 + K2 chain "
          f"{ms_c:.3f} ms (median of 20)")
    rows["hs_solve_fused"].update(ms_1088x1920_central=ms_k, chain_ms_1088x1920_central=ms_c)

    # -- L3: hs_pyramid 4K L3 --------------------------------------------------------
    d = max_flow_diff(f_l3, hs_pyramid(p1, p2, plain(cfg3), pyr3))
    require(d <= TOL, f"L3 kernel vs plain max|diff| {d}")
    err["hs_solve_skewed"] = max(err["hs_solve_skewed"], d)
    ms_k = median_ms(lambda: hs_pyramid(p1, p2, cfg3, pyr3))
    fl = np.stack([f_l3.u.cpu().numpy(), f_l3.v.cpu().numpy()], axis=-1)
    e = epe(interior(fl, 16), interior(gt, 16))
    rows["hs_solve_skewed"].update(pyramid_ms_2160x3840_l3=ms_k)
    print(f"phase 13 L3 hs_pyramid 2160x3840 L3 a=1 i100 (3, 1.5) px: max|diff| vs plain {d:.3g}; "
          f"launches {per_call['L3']}; kernel {ms_k:.3f} ms (median of 20); interior EPE {e:.6f}")

    # -- L4: the batched twins on 2 x 4K ------------------------------------------------
    want = sr.hs_solve_resident_batched_plain(ba, bb, 0.5, 100)
    chain = sr.hs_solve_resident_batched(ba, bb, 0.5, 100)
    d4 = {}
    for name, f, single in (("hs_solve_fused", f_l4f, k6.hs_solve_fused),
                            ("hs_solve_skewed", f_l4s, k7.hs_solve_skewed)):
        d4[name] = note(name, f, want, f"L4 {name} vs plain")
        same(f, chain, f"L4 {name} vs the batched K1 + K2 chain")
        for k in range(2):
            same((f[0][k], f[1][k]), single(ba[k], bb[k], 0.5, 100), f"L4 {name} image {k}")
    ms_f = median_ms(lambda: k6.hs_solve_fused_batched(ba, bb, 0.5, 100), runs=10)
    ms_s = median_ms(lambda: k7.hs_solve_skewed_batched(ba, bb, 0.5, 100), runs=10)
    ms_c = median_ms(lambda: sr.hs_solve_resident_batched(ba, bb, 0.5, 100), runs=10)
    rows["hs_solve_fused"].update(ms_2x2160x3840=ms_f, chain_ms_2x2160x3840=ms_c)
    rows["hs_solve_skewed"].update(ms_2x2160x3840=ms_s, chain_ms_2x2160x3840=ms_c)
    print(f"phase 13 L4 2 x 2160x3840 a=0.5 i100: max|diff| vs plain fused_batched "
          f"{d4['hs_solve_fused']:.3g}, skewed_batched {d4['hs_solve_skewed']:.3g}; both = the "
          f"batched K1 + K2 chain and = singles "
          f"bitwise; launches {per_call['L4 fused']} {per_call['L4 skewed']}; fused "
          f"{ms_f:.3f} ms, skewed {ms_s:.3f} ms, chain {ms_c:.3f} ms (median of 10)")

    # -- L5: hs_solve_checkpointed 4K i200, every 100 --------------------------------------
    whole = hs_solve(q1, q2, dataclasses.replace(cfg_ck, checkpoint_every=0))
    same(f_l5, whole, "L5 checkpointed vs uninterrupted")
    # A stop after the first segment: its state on disk, then a resume.
    ck2 = str(Path(ckdir) / "l5_stop.npz")
    save_state(ck2, hs_solve(q1, q2, dataclasses.replace(cfg_ck, iters=100)), 100, cfg_ck,
               input_hash=frames_hash(q1, q2))
    before = k7.hs_solve_skewed.launches
    resumed = hs_solve_checkpointed(q1, q2, cfg_ck, ck2)
    same(resumed, whole, "L5 resumed vs uninterrupted")
    require(k7.hs_solve_skewed.launches - before == 1, "L5 resume runs one K7 segment")
    print(f"phase 13 L5 hs_solve_checkpointed 2160x3840 i200 every 100: launches "
          f"{per_call['L5']}; = the uninterrupted solve bitwise; resumed after a stop at "
          f"sweep 100 (one warm K7 segment) = uninterrupted bitwise")

    replaces = {"hs_solve_fused": ["opticalflowhs_tpu/kernels/solve_fused.py:111",
                                   "opticalflowhs_tpu/kernels/solve_fused.py:375"],
                "hs_solve_skewed": ["opticalflowhs_tpu/kernels/solve_skewed.py:219",
                                    "opticalflowhs_tpu/kernels/solve_skewed.py:229"]}
    return [{"name": name, "route": "cuda",
             "source": f"opticalflowhs_tpu_torch/csrc/{name[3:]}.cu",
             "replaces": replaces[name],
             "launches": launches["K6" if name == "hs_solve_fused" else "K7"],
             "max_abs_err": err[name], **rows[name], "library_ms": None}
            for name in ("hs_solve_fused", "hs_solve_skewed")]


def sor_planes_and_multigrid(dev, stack, s1, s2) -> dict:
    """Phase 14: K8 (the whole SOR solve on parity planes) against the plain
    plane schedule, the plain SOR sweeps and the K1 + K3 chain at every
    parity of h and w, then the path counted: S1 through
    `kernels.hs_solve_sor_planes`, M1 `hs_solve` with solver="multigrid"
    (K1, then the plain V-cycles) at i1 and i2, a multigrid stack and
    pyramid. Returns K8's row of the kernels line."""
    from opticalflowhs_tpu_torch import (
        HSConfig,
        PyramidConfig,
        hs_pyramid,
        hs_solve,
        hs_solve_batched,
    )
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import solve_fused as k6
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import sor as k3
    from opticalflowhs_tpu_torch.kernels import sor_planes as k8
    from opticalflowhs_tpu_torch.metrics import epe, interior

    err = 0.0

    def note(got, want, what):
        nonlocal err
        d = max_flow_diff(got, want)
        err = max(err, d)
        require(d <= TOL, f"{what}: max|diff| {d}")
        return d

    def same(a, b, what):
        require(bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])),
                f"{what}: not bitwise equal")

    # -- phase 14: K8 against its plain versions, every parity of h and w -----------
    for h, w in ((192, 128), (131, 130), (96, 255), (97, 253), (67, 93)):
        i1, i2 = (a[0] for a in stack(1, h, w, seed=60))
        u0, v0 = (a[0] for a in stack(1, h, w, seed=61, normal=True))
        fields = k1.derivatives_plain(i1, i2, 0.5)
        z = torch.zeros_like(i1)
        d = 0.0
        for n in (1, 4, 7):
            for init in ((None, None), (u0, v0)):
                what = f"K8 {h}x{w} n={n} {'zero' if init[0] is None else 'warm'}"
                got = k8.sor_planes(*init, *fields, n, OMEGA)
                d = max(d, note(got, k8.sor_planes_plain(*init, *fields, n, OMEGA), what))
                same(got, k3.sor_sweeps_plain(*(init if init[0] is not None else (z, z)),
                                              *fields, n, OMEGA), f"{what} vs plain SOR")
                whole = k8.hs_solve_sor_planes(i1, i2, 0.5, n, OMEGA, "hs_cube", *init)
                same(whole, got, f"{what} whole solve vs sor_planes")
                same(whole, sr.hs_solve_resident_sor(i1, i2, 0.5, n, OMEGA, "hs_cube", *init),
                     f"{what} vs the K1 + K3 chain")
        print(f"phase 14 K8 {h}x{w} (h {'odd' if h % 2 else 'even'}, w "
              f"{'odd' if w % 2 else 'even'}) n=1,4,7 zero+warm omega {OMEGA}: max|diff| vs "
              f"the plain planes {d:.3g}; = plain SOR and = the K1 + K3 chain bitwise")
    for s in range(1, k3.K3_MAX_SWEEPS + 1):
        geo = k8.k8_geometry(dev, s)
        require(geo["spill_bytes"] == 0 and (geo["tile_h"], geo["tile_w"]) == k3.k3_tile(s)[:2],
                f"K8 geometry at s {s}: {geo}")
    print(f"phase 14 K8 geometry (s 1-{k3.K3_MAX_SWEEPS}, no spills), at s 4: "
          f"{k8.k8_geometry(dev, 4)}")
    big = torch.zeros(2160, 3840, device=dev)
    require(k8.hs_solve_sor_planes(big, big, 0.5, 50, OMEGA) is None,
            "K8 must return None outside the reference's plane class (2160x3840)")
    del big

    # -- the path, counted -------------------------------------------------------------
    m1, m2, gt = m1_pair(dev)
    mg = {n: HSConfig(alpha=1.0, iters=n, solver="multigrid") for n in (1, 2)}
    pa, pb = stack(2, 1080, 1920, seed=62)
    pyr3 = PyramidConfig(levels=3)
    counters = {"K1": k1.hs_derivatives, "K2": k2.jacobi_sweeps, "K3": k3.sor_sweeps,
                "K8": k8.sor_planes}
    per_call = {}

    def counted(tag, fn):
        before = {n: c.launches for n, c in counters.items()}
        out = fn()
        per_call[tag] = {n: c.launches - before[n] for n, c in counters.items()}
        return out

    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    f_s1 = counted("S1 K8", lambda: k8.hs_solve_sor_planes(s1, s2, 0.5, 50, OMEGA))
    f_mg1 = counted("M1 i1", lambda: hs_solve(m1, m2, mg[1]))
    f_mg2 = counted("M1 i2", lambda: hs_solve(m1, m2, mg[2]))
    f_bat = counted("multigrid stack", lambda: hs_solve_batched(pa, pb, mg[2]))
    f_pyr = counted("multigrid pyramid", lambda: hs_pyramid(m1, m2, mg[2], pyr3))
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"phase 14 path launches (S1 K8, M1 i1, M1 i2, multigrid stack, multigrid pyramid): "
          f"{launches}; per call {per_call}")
    want = {"S1 K8": (1, 0, 0, 1), "M1 i1": (1, 0, 0, 0), "M1 i2": (1, 0, 0, 0),
            "multigrid stack": (1, 0, 0, 0), "multigrid pyramid": (3, 0, 0, 0)}
    for tag, counts in want.items():
        require(tuple(per_call[tag].values()) == counts,
                f"{tag} launches {per_call[tag]}, expected K1, K2, K3, K8 = {counts}")
    for f, shape in ((f_s1, (1088, 1920)), (f_mg1, (1088, 1920)), (f_mg2, (1088, 1920)),
                     (f_bat, (2, 1080, 1920)), (f_pyr, (1088, 1920))):
        for a in f:
            require(tuple(a.shape) == shape and bool(torch.isfinite(a).all()),
                    f"phase 14 output shape/finite {shape}")

    def plain(c):
        return dataclasses.replace(c, backend="torch")

    # -- S1 through K8 -------------------------------------------------------------------
    fields = k1.derivatives_plain(s1, s2, 0.5)
    plain_s1 = sr.hs_solve_resident_sor_plain(s1, s2, 0.5, 50, OMEGA)
    d = note(f_s1, plain_s1, "S1 K8 vs plain SOR")
    same(f_s1, k8.sor_planes_plain(None, None, *fields, 50, OMEGA), "S1 K8 vs the plain planes")
    same(f_s1, sr.hs_solve_resident_sor(s1, s2, 0.5, 50, OMEGA), "S1 K8 vs the K1 + K3 chain")
    u0, v0 = (a[0] for a in stack(1, 1088, 1920, seed=63, normal=True))
    for n in (1, 7):
        note(k8.hs_solve_sor_planes(s1, s2, 0.5, n, OMEGA, "hs_cube", u0, v0),
             sr.hs_solve_resident_sor_plain(s1, s2, 0.5, n, OMEGA, "hs_cube", u0, v0),
             f"S1 K8 warm n={n} vs plain SOR")
    ms_k8 = median_ms(lambda: k8.hs_solve_sor_planes(s1, s2, 0.5, 50, OMEGA))
    ms_chain = median_ms(lambda: sr.hs_solve_resident_sor(s1, s2, 0.5, 50, OMEGA))
    ms_plain = median_ms(lambda: sr.hs_solve_resident_sor_plain(s1, s2, 0.5, 50, OMEGA))
    # A sweep block: K8 at n = 50 (13 blocks of the rule's s = 4, the last
    # the remainder) less K8 at n = 26 (7), beside a K3 launch of s sweeps,
    # by events.
    s50 = k3.sweeps_per_launch(0, s1.shape, 50, k6.resident_blocks("hs_sor_planes_blocks", 0))
    n_half = 50 - 6 * s50
    t50 = event_ms(lambda: k8.sor_planes(None, None, *fields, 50, OMEGA), reps=20)
    t_half = event_ms(lambda: k8.sor_planes(None, None, *fields, n_half, OMEGA,
                                            block_sweeps=s50), reps=20)
    block_ms = (t50 - t_half) / 6
    z = torch.zeros_like(s1)
    uo, vo = torch.empty_like(s1), torch.empty_like(s1)
    k3_ms = event_ms(lambda: k3.launch_sweeps(z, z, *fields, uo, vo, s50, OMEGA), reps=20)
    chain_k3_ms = event_ms(lambda: k3.sor_sweeps(z, z, *fields, 50, OMEGA), reps=20)
    px = s1.numel()
    b_ms, b_by = bound_ms(SOLVE_ARRAYS * 4 * px,
                          (K1_FIELDS_FLOPS_PER_PX + 50 * K3_FLOPS_PER_PX_SWEEP) * px)
    geo = k8.k8_geometry(dev, s50)
    print(f"phase 14 S1 hs_solve_sor_planes 1088x1920 a=0.5 i50 omega {OMEGA}: max|diff| vs "
          f"plain SOR {d:.3g}, = the plain planes and = the K1 + K3 chain bitwise; launches "
          f"{per_call['S1 K8']}; K8 solve {ms_k8:.4f} ms, K1 + K3 chain {ms_chain:.4f} ms "
          f"({ms_k8 / ms_chain:.3f}x), plain {ms_plain:.3f} ms (median of 20 each); by events: "
          f"K8 alone {t50:.4f} ms, the chain's 13 K3 launches {chain_k3_ms:.4f} ms; a sweep "
          f"block of {s50} {block_ms:.4f} ms (n 50 less n {n_half}, over 6), a K3 launch of "
          f"{s50} {k3_ms:.4f} ms; whole-solve bound {b_ms:.4f} ms ({b_by}); geometry {geo}")

    # -- M1: multigrid at 1080p ------------------------------------------------------------
    def flow_epe(f):
        fl = np.stack([f.u.cpu().numpy(), f.v.cpu().numpy()], axis=-1)
        return epe(interior(fl, 8), interior(gt, 8))

    ms_mg = {}
    for n, f in ((1, f_mg1), (2, f_mg2)):
        same(f, hs_solve(m1, m2, plain(mg[n])), f"M1 i{n} cuda vs all-plain")
        ms_mg[n] = median_ms(lambda: hs_solve(m1, m2, mg[n]), runs=10)
    e_mg = {n: flow_epe(f) for n, f in ((1, f_mg1), (2, f_mg2))}
    e_j = {}
    for n in (100, 1600):
        cfg = HSConfig(alpha=1.0, iters=n)
        e_j[n] = (flow_epe(hs_solve(m1, m2, cfg)), median_ms(lambda: hs_solve(m1, m2, cfg), runs=5))
    print(f"phase 14 M1 hs_solve multigrid 1088x1920 a=1 translation (1, 0) key 3: i1 "
          f"{ms_mg[1]:.3f} ms, i2 {ms_mg[2]:.3f} ms (median of 10), = all-plain bitwise, "
          f"K1 = 1 a solve; interior EPE i1 "
          f"{e_mg[1]:.6f} i2 {e_mg[2]:.6f}; Jacobi i100 {e_j[100][0]:.6f} ({e_j[100][1]:.3f} ms), "
          f"i1600 {e_j[1600][0]:.6f} ({e_j[1600][1]:.3f} ms)")
    require(e_mg[2] < e_j[100][0], f"multigrid i2 EPE {e_mg[2]} not below Jacobi i100's {e_j}")

    # -- multigrid beyond single solves -----------------------------------------------------
    for k in range(2):
        same((f_bat.u[k], f_bat.v[k]), hs_solve(pa[k], pb[k], mg[2]), f"multigrid stack image {k}")
    same(f_bat, hs_solve_batched(pa, pb, plain(mg[2])), "multigrid stack vs plain")
    same(f_pyr, hs_pyramid(m1, m2, plain(mg[2]), pyr3), "multigrid pyramid vs plain")
    ms_bat = median_ms(lambda: hs_solve_batched(pa, pb, mg[2]), runs=3)
    ms_pyr = median_ms(lambda: hs_pyramid(m1, m2, mg[2], pyr3), runs=3)
    print(f"phase 14 multigrid i2: hs_solve_batched 2 x 1080x1920 = singles and = plain bitwise, "
          f"{ms_bat:.3f} ms; hs_pyramid L3 = plain bitwise, {ms_pyr:.3f} ms, interior EPE "
          f"{flow_epe(f_pyr):.6f} (median of 3)")
    return {"name": "hs_sor_planes", "route": "cuda",
            "source": "opticalflowhs_tpu_torch/csrc/sor_planes.cu",
            "replaces": ["opticalflowhs_tpu/kernels/sor_planes.py:78"],
            "launches": launches["K8"], "max_abs_err": err, "ms": ms_k8, "plain_ms": ms_plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "chain_ms": ms_chain,
            "k8_alone_ms": t50, "chain_k3_ms": chain_k3_ms, "sweeps_per_block": s50,
            "block_ms": block_ms, "k3_launch_ms": k3_ms, "geometry": geo,
            "m1_i1_ms": ms_mg[1], "m1_i2_ms": ms_mg[2]}


def _tensors(x) -> list:
    """The tensors of a kernel's output (a tensor or nested tuples and
    lists of them), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _tensors(y)]


def _ring_inputs(dev, my, mx, th, tw, sg, seed, h, w):
    """A (y, x) grid of shards for K11/K12: owned (th, tw) starts, fields of
    the shards extended by sg rows (and sg columns on a 2-D mesh) from
    random frames, global origins; the true image is h x w."""
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    rng = np.random.default_rng(seed)
    sx = sg if mx > 1 else 0

    def rand(shape, normal=False):
        a = rng.normal(0, 0.5, shape) if normal else rng.uniform(0, 1, shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    gu = [[rand((th, tw), True) for _ in range(mx)] for _ in range(my)]
    gv = [[rand((th, tw), True) for _ in range(mx)] for _ in range(my)]
    gf = [[tuple(k1.derivatives_plain(rand((th + 2 * sg, tw + 2 * sx)),
                                      rand((th + 2 * sg, tw + 2 * sx)), 0.5))
           for _ in range(mx)] for _ in range(my)]
    origins = [[(i * th, j * tw) for j in range(mx)] for i in range(my)]
    return gu, gv, gf, origins


def tiled_path(dev, pair, stack) -> list:
    """Phase 15: K9 (tile sweeps with a global origin, Jacobi and SOR), K10
    (the ring halo exchange), K11 and K12 (the fused ring solves) against
    their plain versions on virtual meshes of cuda:0, then config 5
    (configs/c5_multihost_4k.json) through dist/: hs_solve_tiled 2160x3840
    i100 halo_sweeps 4 on a virtual 4 x 4 mesh (D1), hs_pyramid_tiled (D2),
    halo_impl="rdma" on 4 x 1 (K11) and 2 x 2 (K12) (D3), SOR tiled i50
    (D4) and K10 on the 4 x 1 frame shards, counted, each against the
    untiled solve, and timed; last, each kernel timed at config 5's shapes
    and held against its plain version there. Returns the K9-K12 rows of
    the kernels line."""
    from opticalflowhs_tpu_torch import hs_pyramid, hs_solve
    from opticalflowhs_tpu_torch.config import MeshConfig
    from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled, hs_solve_tiled, make_mesh
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import ring
    from opticalflowhs_tpu_torch.kernels import sor as k3
    from opticalflowhs_tpu_torch.kernels import tile as k9

    names = ("hs_tile_sweeps", "hs_sor_tile_sweeps", "hs_ring_halo_exchange",
             "hs_ring_fused_sweeps", "hs_ring_fused_sweeps_2d")
    err = {n: 0.0 for n in names}

    def same(name, a, b, what):
        d = max(max_diff(x, y) for x, y in zip(a, b))
        err[name] = max(err[name], d)
        require(d == 0.0, f"{what}: max|diff| {d}, expected bitwise equality")

    # -- phase 15: K9 against its plain versions, origins at the four corners --
    # Padded shards of a 300 x 400 image at negative, odd origins (every
    # corner of the image, and an odd interior origin), single and stacked.
    for ph, pw in ((67, 93), (131, 130)):
        corners = [(-4, -3), (-3, 400 - pw + 5), (300 - ph + 3, -5),
                   (300 - ph + 4, 400 - pw + 3), (117, 33)]
        u0, v0 = (a[0] for a in stack(1, ph, pw, seed=150, normal=True))
        i1, i2 = (a[0] for a in stack(1, ph, pw, seed=151))
        fields = k1.derivatives_plain(i1, i2, 0.5)
        for r0, c0 in corners:
            org = k9.origin_table(u0, r0, c0)
            for n in (7, 13):
                same("hs_tile_sweeps", k9.tile_sweeps(u0, v0, *fields, n, org, 300, 400),
                     k9.tile_sweeps_plain(u0, v0, *fields, n, r0, c0, 300, 400),
                     f"K9 {ph}x{pw} origin ({r0}, {c0}) n={n}")
                same("hs_sor_tile_sweeps",
                     k9.sor_tile_sweeps(u0, v0, *fields, n, OMEGA, org, 300, 400),
                     k9.sor_tile_sweeps_plain(u0, v0, *fields, n, OMEGA, r0, c0, 300, 400),
                     f"K9 SOR {ph}x{pw} origin ({r0}, {c0}) n={n}")
        su, sv = stack(5, ph, pw, seed=152, normal=True)
        sa, sb = stack(5, ph, pw, seed=153)
        sf = k1.derivatives_plain(sa, sb, 0.5)
        rows, cols = [c[0] for c in corners], [c[1] for c in corners]
        org = k9.origin_table(su, rows, cols)
        same("hs_tile_sweeps", k9.tile_sweeps(su, sv, *sf, 7, org, 300, 400),
             k9.tile_sweeps_plain(su, sv, *sf, 7, rows, cols, 300, 400),
             f"K9 stack of 5 {ph}x{pw}")
        same("hs_sor_tile_sweeps", k9.sor_tile_sweeps(su, sv, *sf, 7, OMEGA, org, 300, 400),
             k9.sor_tile_sweeps_plain(su, sv, *sf, 7, OMEGA, rows, cols, 300, 400),
             f"K9 SOR stack of 5 {ph}x{pw}")
        print(f"phase 15 K9 {ph}x{pw} (Jacobi and SOR) at the four corners of a 300x400 image "
              f"and (117, 33), n 7 and 13, single and a stack of 5: = plain bitwise "
              f"(every element of the padded shard)")

    # K9 with the true top (left) edge of its first windows at a warp's first
    # row and inside a warp's rows (at a lane's first column, inside a lane,
    # at its last column), and the bottom and right edges inside the shards.
    for s in (1, 3, 4, 8):
        _, _, lh = k2.k2_tile(s)
        rows = [-(k2.K2_WARP_ROWS * m - s) for m in (3, 4)]
        rows += [r - 1 for r in rows] + [r - 2 for r in rows] + [70 - 37 + 2, 70 - 37 + 5]
        cols = [-(k2.K2_LANE_COLS * m - lh) for m in (3, 4)]
        cols += [c - 1 for c in cols] + [c - 3 for c in cols] + [150 - 45 + 3, 150 - 45 + 4]
        su, sv = stack(len(rows), 37, 45, seed=154, normal=True)
        sa, sb = stack(len(rows), 37, 45, seed=155)
        sf = k1.derivatives_plain(sa, sb, 0.5)
        org = k9.origin_table(su, rows, cols)
        same("hs_tile_sweeps",
             k9.tile_sweeps(su, sv, *sf, 2 * s + 1, org, 70, 150, block_sweeps=s),
             k9.tile_sweeps_plain(su, sv, *sf, 2 * s + 1, rows, cols, 70, 150),
             f"K9 s={s} edges at warp and lane boundaries")
    print("phase 15 K9 37x45 shards of a 70x150 image, true edges at K2's warp and lane "
          "boundaries, s 1, 3, 4, 8: = plain bitwise")

    # -- phase 15: K10, K11 and K12 against their plain versions -------------------
    for my, mx in ((1, 1), (2, 1), (4, 1), (2, 2), (1, 4)):
        th, tw = 40, 93 if mx == 1 else 50
        h, w = my * th - 3, mx * tw - (0 if mx == 1 else 5)
        for halo in (4, 8):
            tiles = [u[0] for u in _ring_inputs(dev, my, 1, th, tw, 8, 160 + my, h, w)[0]]
            for g, r in zip(ring.ring_halo_exchange(tiles, halo),
                            ring.ring_halo_exchange_plain(tiles, halo)):
                same("hs_ring_halo_exchange", (g,), (r,), f"K10 ring of {my} halo {halo}")
        for n in (7, 12, 13):
            for s in (1, 3, 4, 8):
                gu, gv, gf, go = _ring_inputs(dev, my, mx, th, tw, 8, 170 + n + s, h, w)
                if mx == 1:
                    args = ([r[0] for r in gu], [r[0] for r in gv], [r[0] for r in gf], n, s,
                            [o[0][0] for o in go], h, w)
                    got, want = ring.ring_fused_sweeps(*args), ring.ring_fused_sweeps_plain(*args)
                    name = "hs_ring_fused_sweeps"
                else:
                    args = (gu, gv, gf, n, s, go, h, w)
                    got = ring.ring_fused_sweeps_2d(*args)
                    want = ring.ring_fused_sweeps_2d_plain(*args)
                    got = ([a for row in got[0] for a in row], [a for row in got[1] for a in row])
                    want = ([a for row in want[0] for a in row], [a for row in want[1] for a in row])
                same(name, got[0] + got[1], want[0] + want[1],
                     f"{'K11' if mx == 1 else 'K12'} {my}x{mx} n={n} s={s}")
        print(f"phase 15 mesh {my}x{mx} (virtual, cuda:0): K10 halo 4, 8 and "
              f"{'K11' if mx == 1 else 'K12'} n 7, 12, 13 with s 1, 3, 4, 8 = plain bitwise")

    # -- config 5 through dist/, counted ------------------------------------------
    cfg5, pyr5, mcfg = c5_configs()
    s5 = mcfg.halo_sweeps
    sor5 = dataclasses.replace(cfg5, solver="sor", omega=OMEGA, iters=50)
    q1, q2 = pair
    H, W = q1.shape
    m44 = make_mesh(mcfg, [dev] * 16)
    m41 = make_mesh(MeshConfig(y=4, x=1), [dev] * 4)
    m22 = make_mesh(MeshConfig(y=2, x=2), [dev] * 4)
    counters = {"K9": k9.tile_sweeps, "K9 SOR": k9.sor_tile_sweeps,
                "K10": ring.ring_halo_exchange, "K11": ring.ring_fused_sweeps,
                "K12": ring.ring_fused_sweeps_2d}
    per_call = {}

    def counted(tag, fn):
        before = {n: c.launches for n, c in counters.items()}
        out = fn()
        per_call[tag] = {n: c.launches - before[n] for n, c in counters.items()}
        return out

    shards41 = [q1[i * (H // 4):(i + 1) * (H // 4)].contiguous() for i in range(4)]
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t1 = counted("D1", lambda: hs_solve_tiled(q1, q2, cfg5, m44, halo_sweeps=s5))
    t2 = counted("D2", lambda: hs_pyramid_tiled(q1, q2, cfg5, pyr5, m44, halo_sweeps=s5))
    t3a = counted("D3 4x1", lambda: hs_solve_tiled(q1, q2, cfg5, m41, halo_sweeps=s5,
                                                   halo_impl="rdma"))
    t3b = counted("D3 2x2", lambda: hs_solve_tiled(q1, q2, cfg5, m22, halo_sweeps=s5,
                                                   halo_impl="rdma"))
    t4 = counted("D4", lambda: hs_solve_tiled(q1, q2, sor5, m44, halo_sweeps=s5))
    x10 = counted("K10", lambda: ring.ring_halo_exchange(shards41, s5 + 1))
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"tiled path launches (D1, D2, D3, D4, K10): {launches}; per call {per_call}")
    # D4: ceil(50/4) halo blocks, each K3's plan over the device's 16 shards
    # of (540 + 2*16) x (960 + 2*16): one launch a block.
    d4_shards = (16, H // 4 + 8 * s5, W // 4 + 8 * s5)
    d4 = sum(k3_plan_launches(dev, d4_shards, min(s5, 50 - k)) for k in range(0, 50, s5))
    want = {"D1": (25, 0, 0, 0, 0), "D3 4x1": (0, 0, 0, 1, 0), "D3 2x2": (0, 0, 0, 0, 1),
            "D4": (0, d4, 0, 0, 0), "K10": (0, 0, 1, 0, 0)}
    for tag, counts in want.items():
        require(tuple(per_call[tag].values()) == counts,
                f"{tag} launches {per_call[tag]}, expected K9, K9 SOR, K10, K11, K12 = {counts}")
    require(per_call["D2"]["K9"] > 0 and sum(per_call["D2"].values()) == per_call["D2"]["K9"],
            f"D2 launches {per_call['D2']}")
    require(all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}")
    for f in (t1, t2, t3a, t3b, t4):
        for a in f:
            require(tuple(a.shape) == (H, W) and bool(torch.isfinite(a).all())
                    and a.device == dev, "phase 15 output shape/finite/device")

    l1 = hs_solve(q1, q2, cfg5)                           # untiled: K1 + K7
    l3 = hs_pyramid(q1, q2, cfg5, pyr5)
    s4 = hs_solve(q1, q2, sor5)                           # untiled: K1 + K3
    diffs = {"D1": max_flow_diff(t1, l1), "D2": max_flow_diff(t2, l3),
             "D3 4x1": max_flow_diff(t3a, l1), "D3 2x2": max_flow_diff(t3b, l1),
             "D4": max_flow_diff(t4, s4)}
    for g, r in zip(x10, ring.ring_halo_exchange_plain(shards41, s5 + 1)):
        same("hs_ring_halo_exchange", (g,), (r,), "K10 on config 5's 4 x 1 frame shards")
    for tag, d in diffs.items():
        require(d <= TOL, f"{tag} tiled vs untiled max|diff| {d}")
    err["hs_tile_sweeps"] = max(err["hs_tile_sweeps"], diffs["D1"], diffs["D2"])
    err["hs_sor_tile_sweeps"] = max(err["hs_sor_tile_sweeps"], diffs["D4"])
    err["hs_ring_fused_sweeps"] = max(err["hs_ring_fused_sweeps"], diffs["D3 4x1"])
    err["hs_ring_fused_sweeps_2d"] = max(err["hs_ring_fused_sweeps_2d"], diffs["D3 2x2"])

    ms = {
        "D1": median_ms(lambda: hs_solve_tiled(q1, q2, cfg5, m44, halo_sweeps=s5), runs=10),
        "L1": median_ms(lambda: hs_solve(q1, q2, cfg5), runs=10),
        "D2": median_ms(lambda: hs_pyramid_tiled(q1, q2, cfg5, pyr5, m44, halo_sweeps=s5),
                        runs=10),
        "L3": median_ms(lambda: hs_pyramid(q1, q2, cfg5, pyr5), runs=10),
        "D3 4x1": median_ms(lambda: hs_solve_tiled(q1, q2, cfg5, m41, halo_sweeps=s5,
                                                   halo_impl="rdma"), runs=10),
        "D3 2x2": median_ms(lambda: hs_solve_tiled(q1, q2, cfg5, m22, halo_sweeps=s5,
                                                   halo_impl="rdma"), runs=10),
        "D4": median_ms(lambda: hs_solve_tiled(q1, q2, sor5, m44, halo_sweeps=s5), runs=10),
        "S4K": median_ms(lambda: hs_solve(q1, q2, sor5), runs=10),
    }
    print(f"phase 15 config 5 {H}x{W} a=1 (noise, seed 5), halo_sweeps {s5}, virtual meshes "
          f"on cuda:0: max|diff| tiled vs untiled {diffs}; ms (median of 10): {ms}")

    # -- per-kernel times at config 5's shapes, each kernel = plain bitwise there --------
    hw = s5
    th, tw = H // 4, W // 4
    ph, pw = th + 2 * hw, tw + 2 * hw
    su, sv = stack(16, ph, pw, seed=180, normal=True)
    sa, sb = stack(16, ph, pw, seed=181)
    sf = k1.derivatives_plain(sa, sb, 1.0)
    rows = [i * th - hw for i in range(4) for _ in range(4)]
    cols = [j * tw - hw for _ in range(4) for j in range(4)]
    org = k9.origin_table(su, rows, cols)
    ph_s, pw_s = th + 8 * hw, tw + 8 * hw
    tu, tv = stack(16, ph_s, pw_s, seed=182, normal=True)
    ta, tb = stack(16, ph_s, pw_s, seed=183)
    tf = k1.derivatives_plain(ta, tb, 1.0)
    rows_s, cols_s = [r - 3 * hw for r in rows], [c - 3 * hw for c in cols]
    org_s = k9.origin_table(tu, rows_s, cols_s)
    g41 = _ring_inputs(dev, 4, 1, th, W, hw, 190, H, W)
    g22 = _ring_inputs(dev, 2, 2, H // 2, W // 2, hw, 191, H, W)
    a41 = ([r[0] for r in g41[0]], [r[0] for r in g41[1]], [r[0] for r in g41[2]], 100, hw,
           [o[0][0] for o in g41[3]], H, W)
    a22 = (*g22[:3], 100, hw, g22[3], H, W)
    kept = {}

    def keep(key, fn):
        # Time fn and keep its last output, to hold the kernel against its
        # plain version on the same inputs at these shapes.
        def run():
            kept[key] = fn()
        return run

    calls = {
        "hs_tile_sweeps": (
            lambda: k9.tile_sweeps(su, sv, *sf, hw, org, H, W), 20,
            lambda: k9.tile_sweeps_plain(su, sv, *sf, hw, rows, cols, H, W), 3),
        "hs_sor_tile_sweeps": (
            lambda: k9.sor_tile_sweeps(tu, tv, *tf, hw, OMEGA, org_s, H, W), 20,
            lambda: k9.sor_tile_sweeps_plain(tu, tv, *tf, hw, OMEGA, rows_s, cols_s, H, W), 3),
        "hs_ring_halo_exchange": (
            lambda: ring.ring_halo_exchange(shards41, hw + 1), 20,
            lambda: ring.ring_halo_exchange_plain(shards41, hw + 1), 20),
        "hs_ring_fused_sweeps": (
            lambda: ring.ring_fused_sweeps(*a41), 10,
            lambda: ring.ring_fused_sweeps_plain(*a41), 2),
        "hs_ring_fused_sweeps_2d": (
            lambda: ring.ring_fused_sweeps_2d(*a22), 10,
            lambda: ring.ring_fused_sweeps_2d_plain(*a22), 2),
    }
    timing = {name: (event_ms(keep((name, "cuda"), fk), reps=rk),
                     event_ms(keep((name, "plain"), fp), reps=rp))
              for name, (fk, rk, fp, rp) in calls.items()}
    for name in calls:
        same(name, _tensors(kept[name, "cuda"]), _tensors(kept[name, "plain"]),
             f"{name} at config 5's shapes")
    kept.clear()
    print("phase 15 K9 (16 x 548x968 and SOR 16 x 572x992, 4 sweeps), K10 (4 x 540x3840, "
          "halo 5), K11 (4 x 1, n 100) and K12 (2 x 2, n 100) at config 5's shapes: "
          "= plain bitwise")
    # -- K10 by its device time (the profiler; the events above hold the
    # wrapper's host work too: its tables and the barriers), beside one copy_
    # of the same bytes: a (4, th + halo, W) tensor read and written moves
    # what K10 reads (4 shards) and writes (4 shards and their halos).
    k10_event_ms = timing["hs_ring_halo_exchange"][0]
    k10_ms, k10_runs = device_ms(lambda: ring.ring_halo_exchange(shards41, hw + 1), "halo_kernel")
    require(k10_runs >= 20, f"the profiler saw {k10_runs} K10 kernels in 20 calls")
    timing["hs_ring_halo_exchange"] = (k10_ms, timing["hs_ring_halo_exchange"][1])
    yard_src = torch.zeros((4, th + hw + 1, W), device=dev)
    yard_dst = torch.empty_like(yard_src)
    copy_ms = event_ms(lambda: yard_dst.copy_(yard_src))
    copy_dev_ms, _ = device_ms(lambda: yard_dst.copy_(yard_src), "")
    # -- K11 and K12: their geometry, a sweep block beside a K9 launch of
    # the same sweeps, and the tile order of the flag waits --------------------
    n_blk = -(-100 // hw)
    for tag, two in (("K11", False), ("K12", True)):
        g = ring.ring_geometry(dev, hw, two_d=two)
        require(g["spill_bytes"] == 0 and 0 < g["registers"] <= 128 and g["blocks_per_sm"] == 1,
                f"{tag} geometry {g}: expected at most 128 registers, no spills, 1 block an SM")
        print(f"phase 15 {tag} geometry at s {hw}: {g}")
    # A sweep block: a solve of n_blk blocks less one of half as many, both
    # long enough that the card, not the host, sets their pace.
    half = n_blk // 2
    half41 = a41[:3] + (half * hw,) + a41[4:]
    half22 = a22[:3] + (half * hw,) + a22[4:]
    half_ms = {"hs_ring_fused_sweeps": event_ms(lambda: ring.ring_fused_sweeps(*half41), reps=10),
               "hs_ring_fused_sweeps_2d": event_ms(lambda: ring.ring_fused_sweeps_2d(*half22),
                                                   reps=10)}
    block_of = {n: (timing[n][0] - half_ms[n]) / (n_blk - half) for n in half_ms}
    print(f"phase 15 a sweep block of {hw} at config 5's shapes (a solve of {n_blk} blocks "
          f"less a solve of {half}, over {n_blk - half}): K11 4 x 1 "
          f"{block_of['hs_ring_fused_sweeps']:.4f} ms, K12 2 x 2 "
          f"{block_of['hs_ring_fused_sweeps_2d']:.4f} ms; a K9 launch of {hw} over D1's "
          f"16 x {ph}x{pw} {timing['hs_tile_sweeps'][0]:.4f} ms; solves of {half} blocks "
          f"{half_ms}")
    # K11 walks its tiles in one order: the interior tile rows first, the
    # edge rows, whose windows reach a halo and may wait for its flag, last.
    # What a sweep block takes beyond a K9 launch of the same sweeps over
    # nearly as many pixels is its exchange, its flag waits and its grid
    # barrier; tools/torch_ring_limits.py cuts them out one at a time.
    beyond = {n: block_of[n] - timing["hs_tile_sweeps"][0] for n in block_of}
    print(f"phase 15 K11 tile order: interior tile rows first, edge rows (the flag waits) "
          f"last; a sweep block beyond a K9 launch of {hw} (exchange, flag waits, grid "
          f"barrier): K11 4 x 1 {beyond['hs_ring_fused_sweeps']:.4f} ms, K12 2 x 2 "
          f"{beyond['hs_ring_fused_sweeps_2d']:.4f} ms")

    px9, px9s = 16 * ph * pw, 16 * ph_s * pw_s
    owned = H * W
    ext41 = 4 * (th + 2 * hw) * W
    ext22 = 4 * (H // 2 + 2 * hw) * (W // 2 + 2 * hw)
    halo41 = 2 * 2 * 4 * hw * W * 4           # u and v, both sides, 4 shards
    halo22 = 2 * 2 * 4 * (hw * (W // 2) + (H // 2 + 2 * hw) * hw) * 4
    bounds = {
        "hs_tile_sweeps": bound_ms(SWEEP_BLOCK_ARRAYS * 4 * px9, K2_FLOPS_PER_PX_SWEEP * hw * px9),
        "hs_sor_tile_sweeps": bound_ms(SWEEP_BLOCK_ARRAYS * 4 * px9s,
                                       K3_FLOPS_PER_PX_SWEEP * hw * px9s),
        "hs_ring_halo_exchange": bound_ms(4 * (2 * owned + 4 * 2 * (hw + 1) * W), 0),
        # The four fields of the extended shards and the start in, u and v
        # out, once a solve; 27 operations a pixel a sweep.
        "hs_ring_fused_sweeps": bound_ms(4 * (4 * ext41 + 4 * owned),
                                         K2_FLOPS_PER_PX_SWEEP * 100 * owned),
        "hs_ring_fused_sweeps_2d": bound_ms(4 * (4 * ext22 + 4 * owned),
                                            K2_FLOPS_PER_PX_SWEEP * 100 * owned),
    }
    # The byte floor of the kernels' schedule: a sweep block moves K2's 8
    # arrays of the extended shards, ceil(n/s) times a solve.
    schedule_ms = {n: n_blk * SWEEP_BLOCK_ARRAYS * 4 * ext / PEAK_BYTES_PER_S * 1e3
                   for n, ext in (("hs_ring_fused_sweeps", ext41),
                                  ("hs_ring_fused_sweeps_2d", ext22))}
    # Bounds of the work across cards, from the data sheet's NVLink rate: on
    # the text lines only, since the kernels line holds what this run measured.
    block_ms = SWEEP_BLOCK_ARRAYS * 4 * owned / PEAK_BYTES_PER_S * 1e3
    nvlink = {"hs_ring_halo_exchange": {"halo_nvlink_ms": 4 * 2 * (hw + 1) * W * 4
                                        / NVLINK_BYTES_PER_S * 1e3},
              "hs_ring_fused_sweeps": {"block_bound_ms": block_ms + halo41
                                       / NVLINK_BYTES_PER_S * 1e3},
              "hs_ring_fused_sweeps_2d": {"block_bound_ms": block_ms + halo22
                                          / NVLINK_BYTES_PER_S * 1e3}}
    extra = {
        "hs_tile_sweeps": {"launches_per_D1_solve": per_call["D1"]["K9"],
                           "shape": [16, ph, pw], "sweeps_per_launch": hw,
                           "geometry": k2.k2_geometry(dev, hw, shard=True)},
        "hs_sor_tile_sweeps": {"launches_per_D4_solve": per_call["D4"]["K9 SOR"],
                               "shape": [16, ph_s, pw_s], "sweeps_per_launch": hw,
                               "schedule_bound_ms": k3_schedule_bytes(
                                   k3.k3_geometry(dev, hw, shard=True), px9s)
                               / PEAK_BYTES_PER_S * 1e3,
                               "geometry": k3.k3_geometry(dev, hw, shard=True)},
        "hs_ring_halo_exchange": {"shards": [4, th, W], "halo": hw + 1,
                                  "ms_is": "device time (profiler)", "event_ms": k10_event_ms,
                                  "copy_ms": copy_ms, "copy_device_ms": copy_dev_ms},
        "hs_ring_fused_sweeps": {"mesh": [4, 1], "n": 100, "s": hw,
                                 "solve_ms_D3": ms["D3 4x1"],
                                 "block_ms": block_of["hs_ring_fused_sweeps"],
                                 "schedule_bound_ms": schedule_ms["hs_ring_fused_sweeps"],
                                 "geometry": ring.ring_geometry(dev, hw)},
        "hs_ring_fused_sweeps_2d": {"mesh": [2, 2], "n": 100, "s": hw,
                                    "solve_ms_D3": ms["D3 2x2"],
                                    "block_ms": block_of["hs_ring_fused_sweeps_2d"],
                                    "schedule_bound_ms": schedule_ms["hs_ring_fused_sweeps_2d"],
                                    "geometry": ring.ring_geometry(dev, hw, two_d=True)},
    }
    for name, (t_k, t_p) in timing.items():
        print(f"kernel {name}: {t_k:.4f} ms per call, plain {t_p:.4f} ms, bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]}) {extra[name]} "
              f"{nvlink.get(name, {})}")
    source = {"hs_tile_sweeps": "opticalflowhs_tpu_torch/csrc/jacobi.cu",
              "hs_sor_tile_sweeps": "opticalflowhs_tpu_torch/csrc/sor.cu",
              "hs_ring_halo_exchange": "opticalflowhs_tpu_torch/csrc/ring.cu",
              "hs_ring_fused_sweeps": "opticalflowhs_tpu_torch/csrc/ring.cu",
              "hs_ring_fused_sweeps_2d": "opticalflowhs_tpu_torch/csrc/ring.cu"}
    replaces = {"hs_tile_sweeps": ["opticalflowhs_tpu/kernels/jacobi.py:855"],
                "hs_sor_tile_sweeps": ["opticalflowhs_tpu/kernels/sor.py:59"],
                "hs_ring_halo_exchange": ["opticalflowhs_tpu/kernels/rdma_halo.py:49"],
                "hs_ring_fused_sweeps": ["opticalflowhs_tpu/kernels/rdma_halo.py:135"],
                "hs_ring_fused_sweeps_2d": ["opticalflowhs_tpu/kernels/rdma_halo.py:398"]}
    key = dict(zip(names, ("K9", "K9 SOR", "K10", "K11", "K12")))
    return [{"name": n, "route": "cuda", "source": source[n], "replaces": replaces[n],
             "launches": launches[key[n]], "max_abs_err": err[n], "ms": timing[n][0],
             "plain_ms": timing[n][1], "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
             "library_ms": None, **extra[n]} for n in names]


def lk_path(dev, vid, vid_dev, s1, s2) -> None:
    """Phase 16: the Lucas-Kanade family, ego-motion and hs_energy at full
    size through the public entry points. Plain PyTorch on the card, as the
    reference runs LK as XLA ops outside any kernel: K1-K12 must not launch.
    LK1 lk_solve on T1's pair, LK3 on C3's (3 levels), LK-B
    lk_solve_batched on the first 8 pairs of C4's video (= singles
    bitwise), LK-S flow_stream(lk=) on its 17 host frames (= LK-B on each
    window bitwise), flow_with_occlusion(lk=) against the CPU, ego-motion
    of LK-S's flows and of an exact model field, hs_energy of C1's and T1's
    solves at i25 and i100 (falling on T1's); and one LK1 call under
    torch.profiler."""
    from opticalflowhs_tpu_torch import (
        HSConfig,
        LKConfig,
        PyramidConfig,
        flow_stream,
        flow_with_occlusion,
        hs_solve,
        lk_solve,
        lk_solve_batched,
    )
    from opticalflowhs_tpu_torch.egomotion import estimate_egomotion
    from opticalflowhs_tpu_torch.kernels import counted_wrappers
    from opticalflowhs_tpu_torch.metrics import epe, hs_energy, interior
    from opticalflowhs_tpu_torch.solver import Flow

    def flow_epe(f, gt, crop=16):
        fl = np.stack([f.u.cpu().numpy(), f.v.cpu().numpy()], axis=-1)
        return epe(interior(fl, crop), interior(np.broadcast_to(gt, fl.shape), crop))

    print(f"phase 16 card: {card_line()}")
    cfg = LKConfig()
    t1, t2, gt_t1 = t1_pair(dev)
    p1, p2 = c3_frames(dev)
    gt_c3 = np.array([3.0, 1.5], np.float32)  # C3's translation
    pyr3 = PyramidConfig(levels=3)
    # hs_energy's flows come from K1 and K2, before the counters are read:
    # C1's noise pair and T1's textured pair, at i25 and i100.
    energy_cells = {tag: (a, b, {n: hs_solve(a, b, HSConfig(alpha=0.5, iters=n))
                                 for n in (25, 100)})
                    for tag, (a, b) in (("C1", (s1, s2)), ("T1", (t1, t2)))}
    torch.cuda.synchronize()
    wrappers = counted_wrappers()
    before = {n: w.launches for n, w in wrappers.items()}

    # -- LK1 and LK3: single pairs, against the CPU ----------------------------------
    lk1 = lk_solve(t1, t2, cfg)
    for a in lk1:
        require(a.shape == (1088, 1920) and bool(torch.isfinite(a).all()), "LK1 shape/finite")
    d1 = max_flow_diff(lk1, [a.to(dev) for a in lk_solve(t1.cpu(), t2.cpu(), cfg)])
    e1 = flow_epe(lk1, gt_t1)
    ms1 = median_ms(lambda: lk_solve(t1, t2, cfg))
    print(f"phase 16 LK1 lk_solve 1088x1920 (0.7, -0.3) LKConfig() 1 level: {ms1:.3f} ms "
          f"(median of 20), interior EPE (crop 16) {e1:.4f}, max|diff| vs the CPU {d1:.3g}")
    require(d1 <= TOL, f"LK1 card vs CPU max|diff| {d1}")
    require(e1 < 0.05, f"LK1 EPE {e1}")
    lk3 = lk_solve(p1, p2, cfg, pyr3)
    d3 = max_flow_diff(lk3, [a.to(dev) for a in lk_solve(p1.cpu(), p2.cpu(), cfg, pyr3)])
    e3 = flow_epe(lk3, gt_c3)
    ms3 = median_ms(lambda: lk_solve(p1, p2, cfg, pyr3))
    print(f"phase 16 LK3 lk_solve 1080x1920 (3, 1.5) LKConfig() 3 levels: {ms3:.3f} ms "
          f"(median of 20), interior EPE (crop 16) {e3:.4f}, max|diff| vs the CPU {d3:.3g}")
    require(d3 <= TOL, f"LK3 card vs CPU max|diff| {d3}")
    require(e3 < 0.1, f"LK3 EPE {e3}")

    # -- LK-B and LK-S: a stack of C4's pairs, and the lk= stream --------------------
    a, b = vid_dev[:8], vid_dev[1:9]
    lkb = lk_solve_batched(a, b, cfg)
    for k in range(8):
        one = lk_solve(a[k], b[k], cfg)
        require(bool(torch.equal(lkb.u[k], one.u) and torch.equal(lkb.v[k], one.v)),
                f"LK-B pair {k} differs from lk_solve")
    msb = median_ms(lambda: lk_solve_batched(a, b, cfg))
    print(f"phase 16 LK-B lk_solve_batched 8 x 1080x1920 (C4's pairs 0-7): bitwise = 8 "
          f"lk_solve; {msb:.3f} ms a stack (median of 20, {8 / msb * 1e3:.1f} pairs/s)")
    chunks = list(flow_stream(vid, lk=cfg, chunk=8))
    require([c.u.shape[0] for c in chunks] == [8, 8], "LK-S chunk sizes")
    for k, c in enumerate(chunks):
        win = vid_dev[8 * k:8 * k + 9]
        ref = lk_solve_batched(win[:-1], win[1:], cfg)
        require(bool(torch.equal(c.u, ref.u) and torch.equal(c.v, ref.v)),
                f"LK-S chunk {k} differs from lk_solve_batched")

    def stream_all():
        for _ in flow_stream(vid, lk=cfg, chunk=8):
            pass

    mss = median_ms(stream_all, runs=5)
    print(f"phase 16 LK-S flow_stream(lk=LKConfig(), chunk=8) 16 pairs 1080x1920 from host "
          f"frames: chunks bitwise = lk_solve_batched; {mss:.3f} ms end to end (median of 5, "
          f"{16 / mss * 1e3:.1f} pairs/s)")

    # -- the occlusion test with lk=, against the CPU ----------------------------------
    occ_f, occ_m = flow_with_occlusion(t1, t2, lk=cfg)
    cpu_f, cpu_m = flow_with_occlusion(t1.cpu(), t2.cpu(), lk=cfg)
    d_o = max_flow_diff(occ_f, [x.to(dev) for x in cpu_f])
    print(f"phase 16 flow_with_occlusion(lk=) on T1's pair: max|diff| vs the CPU {d_o:.3g}, "
          f"masks equal {bool(torch.equal(occ_m.cpu(), cpu_m))}, occluded share "
          f"{float(occ_m.float().mean()):.5f}")
    require(d_o <= TOL and bool(torch.equal(occ_m.cpu(), cpu_m)), "LK occlusion card vs CPU")

    # -- ego-motion: LK-S's flows, and an exact model field against the CPU ------------
    stream = Flow(torch.cat([c.u for c in chunks]), torch.cat([c.v for c in chunks]))
    em = estimate_egomotion(stream)
    err_t = max(float((em.tx - 1.0).abs().max()), float((em.ty - 0.5).abs().max()))
    print(f"phase 16 ego-motion of LK-S's 16 flows (pan (1, 0.5)): tx {float(em.tx.min()):.5f}"
          f"-{float(em.tx.max()):.5f}, ty {float(em.ty.min()):.5f}-{float(em.ty.max()):.5f}, "
          f"max |error| {err_t:.3g} px (bar 0.01), residual <= {float(em.residual.max()):.4f}")
    require(err_t <= 0.01, f"ego-motion translation error {err_t}")
    yy = torch.arange(1080, dtype=torch.float32, device=dev)[:, None] - 539.5
    xx = torch.arange(1920, dtype=torch.float32, device=dev)[None, :] - 959.5
    model = Flow(0.3 + 0.002 * xx + 0.001 * yy, -0.2 + 0.002 * yy - 0.001 * xx)
    em_k = estimate_egomotion(model)
    em_c = estimate_egomotion(Flow(model.u.cpu(), model.v.cpu()))
    d_e = max(abs(float(x) - float(y)) for x, y in zip(em_k, em_c))
    truth = (0.3, -0.2, -0.001, 0.002)
    d_t = max(abs(float(x) - t) for x, t in zip(em_k, truth))
    print(f"phase 16 ego-motion of an exact model field 1080x1920 (tx 0.3, ty -0.2, omega "
          f"-0.001, scale 0.002): max|diff| vs the CPU {d_e:.3g} (bar 1e-5), vs the model "
          f"{d_t:.3g} (bar 1e-4), residual {float(em_k.residual):.3g}")
    require(d_e <= 1e-5, f"ego-motion of the model, card vs CPU max|diff| {d_e}")
    require(d_t <= 1e-4, f"ego-motion of the model, max|error| {d_t}")

    # -- hs_energy of C1's and T1's solves ------------------------------------------------
    # Its forward-difference smoothness term is not the one the Jacobi sweep's
    # 8-neighbour average minimises: on C1's white noise it rises with the
    # sweeps, in the reference too (tests/port/test_torch_egomotion.py), so
    # the energy must fall on the textured pair, and is only reported on C1.
    for tag, (a, b, flows) in energy_cells.items():
        en = {n: float(hs_energy(a, b, f, alpha=0.5)) for n, f in flows.items()}
        en_c = {n: float(hs_energy(a.cpu(), b.cpu(), Flow(f.u.cpu(), f.v.cpu()), alpha=0.5))
                for n, f in flows.items()}
        rel = max(abs(en[n] - en_c[n]) / abs(en_c[n]) for n in en)
        print(f"phase 16 hs_energy of {tag}'s hs_solve (a=0.5): i25 {en[25]:.8f}, i100 "
              f"{en[100]:.8f}; relative |diff| vs the CPU {rel:.3g} (bar 1e-5)")
        require(rel <= 1e-5, f"hs_energy of {tag} card vs CPU relative diff {rel}")
        if tag != "C1":
            require(en[100] <= en[25], f"hs_energy of {tag} rose from i25 to i100")

    torch.cuda.synchronize()
    moved = {n: w.launches - before[n] for n, w in wrappers.items() if w.launches != before[n]}
    print(f"phase 16 K1-K12 launches across phase 16: {moved or 'none'}")
    require(not moved, f"a kernel launched on the LK path: {moved}")

    # -- one LK1 call under the profiler -------------------------------------------------
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lk_solve(t1, t2, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    dev_ms = sum(float(e.self_device_time_total) for e in on_dev) / 1e3
    n_kernels = sum(e.count for e in on_dev)
    n_ops = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::"))
    top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:4]
    print(f"phase 16 profiler LK1 (one call): wall {wall:.3f} ms, device {dev_ms:.3f} ms, busy "
          f"share {dev_ms / wall:.3f}, {n_kernels} device kernels, {n_ops} aten ops; top: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in top))
    require(n_kernels > 0, "the profiler saw no device kernel of LK1")


def cli_path(dev, vid, c1_ms: float, c3_ms: float) -> None:
    """Phase 17: the command line on the card at full width, in process
    through cli.main, with its files in a temporary directory. `run` on C3's
    pair saved as PGM (= hs_pyramid on the load_gray-ed frames bitwise, the
    same K1/K2 launches, timed beside the solve, and the host stages timed
    one by one; renders and a KITTI file written and read back); `video` on
    C4's 17 frames as a PGM directory (= flow_stream bitwise, the same
    launches; --occlusion --egomotion with --method lk); `eval middlebury`
    on four 1088x1920 translation pairs (= evaluate on the entry points
    bitwise, hs and lk); `bench` at 1088x1920 beside phase 4's C1 time;
    `selftest` (its kernel check at 0.0); `info`."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    from opticalflowhs_tpu_torch import (
        LKConfig,
        flow_stream,
        hs_pyramid,
        lk_solve,
    )
    from opticalflowhs_tpu_torch import cli
    from opticalflowhs_tpu_torch.config import load_config
    from opticalflowhs_tpu_torch.data.datasets import MiddleburyDataset, evaluate
    from opticalflowhs_tpu_torch.data.synthetic import translation_pair
    from opticalflowhs_tpu_torch.io import kitti, native, read_flow
    from opticalflowhs_tpu_torch.io.flo import read_flo, write_flo
    from opticalflowhs_tpu_torch.io.images import load_gray, save_image
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.viz import flow_to_color, needle_plot

    def quiet(argv) -> tuple[int, str]:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        return rc, out.getvalue()

    def counted(fn):
        """fn's K1 and K2 launches, counted from 0."""
        torch.cuda.synchronize()
        k1.hs_derivatives.launches = 0
        k2.jacobi_sweeps.launches = 0
        fn()
        torch.cuda.synchronize()
        return k1.hs_derivatives.launches, k2.jacobi_sweeps.launches

    def host_ms(fn, runs: int = 5) -> float:
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def flow_np(f):
        return np.stack([f.u.cpu().numpy(), f.v.cpu().numpy()], axis=-1)

    t_phase = time.perf_counter()
    has = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2")}
    built = native.build()
    print(f"phase 17 card: {card_line()}; Pillow importable: {has['PIL']}, OpenCV (cv2) "
          f"importable: {has['cv2']}, so PNGs go through "
          f"{'Pillow' if has['PIL'] else 'OpenCV' if has['cv2'] else 'io.png16'}; libhsio "
          f"built: {built}, loaded: {native.available()}, codecs {native.codecs()} "
          f"(PNM {bool(native.codecs() & native.CODEC_PNM)}, OpenCV "
          f"{bool(native.codecs() & native.CODEC_OPENCV)}, video {native.video_available()})")

    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        c3 = str(ROOT / "configs" / "c3_pyramid.json")
        c4 = str(ROOT / "configs" / "c4_hd_streaming.json")
        rc3 = load_config(c3)

        # -- run: C3's pair as PGM ------------------------------------------------
        p1, p2, _ = translation_pair(1080, 1920, 3.0, 1.5, key=0, max_freq=0.06)
        f1, f2 = str(d / "c3_1.pgm"), str(d / "c3_2.pgm")
        save_image(f1, p1)
        save_image(f2, p2)
        run = ["--config", c3, "run", f1, f2, "-o", str(d / "c3.flo")]
        i1 = torch.from_numpy(load_gray(f1)).to(dev)
        i2 = torch.from_numpy(load_gray(f2)).to(dev)
        n_cli = counted(lambda: quiet(run))
        want = hs_pyramid(i1, i2, rc3.hs, rc3.pyramid)
        n_in = counted(lambda: hs_pyramid(i1, i2, rc3.hs, rc3.pyramid))
        got = read_flo(d / "c3.flo")
        require(got.shape == (1080, 1920, 2) and bool(np.isfinite(got).all()),
                "CLI run output shape/finite")
        require(np.array_equal(got, flow_np(want)), "CLI run .flo differs from hs_pyramid")
        require(n_cli == n_in and min(n_cli) > 0,
                f"CLI run launches K1/K2 {n_cli}, in-process {n_in}")
        ms_cli = median_ms(lambda: quiet(run), runs=5)
        ms_in = median_ms(lambda: hs_pyramid(i1, i2, rc3.hs, rc3.pyramid), runs=5)
        print(f"phase 17 CLI run C3 (1080x1920 PGM pair, L3 a=1 i100): .flo = in-process "
              f"hs_pyramid bitwise; launches K1/K2 {n_cli} = in-process {n_in}; median of 5 "
              f"warm calls {ms_cli:.3f} ms (host clock, whole command) beside the in-process "
              f"solve {ms_in:.3f} ms (phase 5: {c3_ms:.3f} ms on the float frames)")

        # The host stages of a run, one by one (host clock, median of 5).
        host = np.ascontiguousarray(got)
        h1, h2 = load_gray(f1), load_gray(f2)
        stages = {
            "load_gray x2 (PGM, Python)": host_ms(lambda: (load_gray(f1), load_gray(f2))),
            "H2D x2": host_ms(lambda: (torch.from_numpy(h1).to(dev), torch.from_numpy(h2).to(dev),
                                       torch.cuda.synchronize())),
            "solve (hs_pyramid, synced)": ms_in,
            "D2H + stack": host_ms(lambda: flow_np(want)),
            "write_flo": host_ms(lambda: write_flo(d / "t.flo", host)),
            "flow_to_color": host_ms(lambda: flow_to_color(host)),
            "save_image PNG (render)": host_ms(
                lambda: save_image(d / "t.png", flow_to_color(host)), runs=3),
            "needle_plot": host_ms(lambda: needle_plot(host, background=p1), runs=3),
            "write KITTI PNG": host_ms(lambda: kitti.write_flow_png(d / "t_k.png", host),
                                       runs=3),
        }
        if built and native.available() and native.can_decode(f1):
            stages["load_gray x2 (PGM, libhsio)"] = host_ms(
                lambda: (native.load_gray(f1), native.load_gray(f2)))
        print("phase 17 CLI run host stages at 1080x1920 (ms, median): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

        k_png, v_png, n_png = (str(d / n) for n in ("c3_k.png", "c3_v.png", "c3_n.png"))
        rc, out = quiet(["--config", c3, "run", f1, f2, "-o", k_png, "--viz", v_png,
                         "--needle", n_png])
        require(rc == 0, "CLI run with renders")
        back, valid = kitti.read_flow_png(k_png)
        # KITTI's 1/64 px steps: half a step, plus half a float32 ulp of the
        # 2^15-offset value the encoder rounds.
        require(bool(valid.all()) and np.abs(back - got).max() <= (0.5 + 2**-9) / 64
                and np.array_equal(read_flow(k_png), back), "CLI KITTI output read back")
        v = load_gray(v_png)
        n = load_gray(n_png)
        require(v.shape == n.shape == (1080, 1920) and float(v.std()) > 0,
                "CLI renders read back")
        print(f"phase 17 CLI run -o KITTI .png --viz --needle: written and read back "
              f"(KITTI max |diff| {np.abs(back - got).max():.3g} px, render std {v.std():.4f})")

        # -- video: C4's 17 frames as a PGM directory -------------------------------
        vd = d / "c4"
        vd.mkdir()
        for k, f in enumerate(vid):
            save_image(vd / f"frame_{k:03d}.pgm", f)
        loader = ("libhsio (native.stream_frames)"
                  if built and native.available() and native.can_decode(str(vd / "frame_000.pgm"))
                  else "Python (io.images.load_gray)")
        frames = np.stack([load_gray(vd / f"frame_{k:03d}.pgm") for k in range(len(vid))])
        rc4 = load_config(c4)
        video = ["--config", c4, "video", str(vd), "-o", str(d / "c4_out"), "--chunk", "8"]
        n_cli = counted(lambda: quiet(video))
        n_in = counted(lambda: list(flow_stream(frames, rc4.hs, chunk=8, device=dev)))
        chunks = list(flow_stream(frames, rc4.hs, chunk=8, device=dev))
        want = np.concatenate([np.stack([c.u.cpu().numpy(), c.v.cpu().numpy()], -1)
                               for c in chunks])
        got = np.stack([read_flo(d / "c4_out" / f"flow_{k:05d}.flo") for k in range(16)])
        require(np.array_equal(got, want), "CLI video flows differ from flow_stream")
        require(n_cli == n_in and min(n_cli) > 0,
                f"CLI video launches K1/K2 {n_cli}, in-process {n_in}")
        ms_v = median_ms(lambda: quiet(video), runs=3)
        print(f"phase 17 CLI video C4 (17 x 1080x1920 PGM, a=1 i100 s=8, chunk 8) loader "
              f"{loader}: 16 flows = in-process flow_stream bitwise; launches K1/K2 {n_cli} "
              f"= in-process {n_in}; {ms_v:.3f} ms a command (median of 3; "
              f"{16 / ms_v * 1e3:.1f} fps from files to .flo files)")
        rc, out = quiet(["video", str(vd), "-o", str(d / "c4_lk"), "--chunk", "8",
                         "--method", "lk", "--pyramid.levels", "1", "--occlusion",
                         "--egomotion"])
        require(rc == 0, "CLI video --occlusion --egomotion")
        ems = [json.loads(x) for x in (d / "c4_lk" / "egomotion.jsonl").read_text().splitlines()]
        tx = [e["tx"] for e in ems]
        ty = [e["ty"] for e in ems]
        occ_share = float(np.mean([load_gray(d / "c4_lk" / f"occ_{k:05d}.png").mean()
                                   for k in range(16)]))
        require(len(ems) == 16 and max(abs(t - 1.0) for t in tx) <= 0.01
                and max(abs(t - 0.5) for t in ty) <= 0.01,
                f"CLI video ego-motion off the pan (1, 0.5): tx {tx}, ty {ty}")
        print(f"phase 17 CLI video --method lk --occlusion --egomotion: {len(ems)} fits, tx "
              f"{min(tx):.5f}-{max(tx):.5f}, ty {min(ty):.5f}-{max(ty):.5f} (pan (1, 0.5)); "
              f"flagged share {occ_share:.5f}; {out.strip().splitlines()[-1]}")

        # -- eval middlebury: four 1088x1920 translation pairs ----------------------
        mb = d / "mb"
        for k, (tx_, ty_) in enumerate(((1.0, 0.5), (-0.5, 0.25), (0.75, -1.0), (0.3, 0.6))):
            a, b, gt = translation_pair(1088, 1920, tx_, ty_, key=20 + k)
            seq = mb / "other-data" / f"seq{k}"
            seq.mkdir(parents=True)
            save_image(seq / "frame10.png", a)
            save_image(seq / "frame11.png", b)
            g = mb / "other-gt-flow" / f"seq{k}"
            g.mkdir(parents=True)
            write_flo(g / "flow10.flo", np.broadcast_to(gt, (1088, 1920, 2)).astype(np.float32))
        # The png16 branch of load_gray (what runs where neither Pillow nor
        # OpenCV imports) against the decode this machine took, on the first
        # sequence's two frames.
        pngs = sorted(mb.glob("other-data/seq0/frame1*.png"))
        t0 = time.perf_counter()
        took = [load_gray(p) for p in pngs]
        ms_took = (time.perf_counter() - t0) * 1e3 / len(pngs)
        saved = {m: sys.modules.get(m) for m in ("PIL", "PIL.Image", "cv2")}
        try:
            for m in saved:
                sys.modules[m] = None
            t0 = time.perf_counter()
            forced = [load_gray(p) for p in pngs]
            ms_forced = (time.perf_counter() - t0) * 1e3 / len(pngs)
        finally:
            for m, mod in saved.items():
                if mod is None:
                    sys.modules.pop(m, None)
                else:
                    sys.modules[m] = mod
        require(all(np.array_equal(a, b) for a, b in zip(took, forced)),
                "load_gray's png16 branch differs from this machine's decode")
        print(f"phase 17 load_gray of seq0's 2 PNGs (1088x1920, 8-bit grey): png16 branch "
              f"(Pillow and cv2 hidden) = this machine's decode bitwise; {ms_took:.3f} ms a "
              f"frame as taken, {ms_forced:.3f} ms through png16")
        rc0 = load_config(None)
        for method in ("hs", "lk"):
            out_json = d / f"eval_{method}.json"
            argv = ["eval", "middlebury", str(mb), "--out", str(out_json), "--method", method]
            t0 = time.perf_counter()
            rc, out = quiet(argv)
            dt = time.perf_counter() - t0
            require(rc == 0, f"CLI eval {method}")

            def solve(f1_, f2_, method=method):
                a_ = torch.from_numpy(f1_).to(dev)
                b_ = torch.from_numpy(f2_).to(dev)
                if method == "lk":
                    return flow_np(lk_solve(a_, b_, LKConfig(), rc0.pyramid))
                return flow_np(hs_pyramid(a_, b_, rc0.hs, rc0.pyramid))

            want = evaluate(MiddleburyDataset(str(mb)), solve)
            got = json.loads(out_json.read_text())
            require(got == want, f"CLI eval {method} table differs: {got} vs {want}")
            print(f"phase 17 CLI eval middlebury 4 x 1088x1920 PNG, {method} L3: table = "
                  f"in-process bitwise; ALL EPE {got['ALL']['epe']:.4f} AE "
                  f"{got['ALL']['ae']:.3f}; {dt * 1e3:.1f} ms a command")

        # -- bench, selftest, info ----------------------------------------------------
        rc, out = quiet(["bench", "--shape", "1088x1920", "--cfg.alpha", "0.5"])
        require(rc == 0, "CLI bench")
        res = json.loads(out)
        st = res["sweep_throughput"]
        require(res["device"] == torch.cuda.get_device_name(0) and st["ms_per_solve"] > 0,
                "CLI bench device/time")
        print(f"phase 17 CLI bench --shape 1088x1920 a=0.5 i100 (C1's shape; mean of 10 "
              f"chained calls): {json.dumps(res)}; beside phase 4's C1 {c1_ms:.3f} ms "
              f"(median of 20 synced)")

        rc, out = quiet(["selftest"])
        diff = [ln for ln in out.splitlines() if "cuda == torch oracle" in ln]
        require(rc == 0 and len(diff) == 1 and "[PASS]" in diff[0]
                and diff[0].endswith("(max diff 0.00e+00)"),
                f"CLI selftest: {out}")
        print(f"phase 17 CLI selftest: exit 0; {diff[0].strip()}")
        rc, out = quiet(["info"])
        require(rc == 0 and torch.cuda.get_device_name(0) in out, f"CLI info: {out}")
        print("phase 17 CLI info: " + " | ".join(ln.strip() for ln in out.splitlines()))
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")


def _grad_entries(dev, shape) -> dict:
    """{name: (inputs, kernel-route call, plain call)}: every entry of the
    autograd scheme (kernels/autodiff.py) at `shape`, zero and warm starts,
    K8's only for a 2-D frame (as tests/port/test_torch_cuda.py)."""
    from opticalflowhs_tpu_torch import HSConfig, hs_solve, robust
    from opticalflowhs_tpu_torch import tvl1 as tv
    from opticalflowhs_tpu_torch.config import TVL1Config
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import solve_fused as k6
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import solve_robust as k4
    from opticalflowhs_tpu_torch.kernels import solve_skewed as k7
    from opticalflowhs_tpu_torch.kernels import sor as k3
    from opticalflowhs_tpu_torch.kernels import sor_planes as k8
    from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5
    rng = np.random.default_rng(180)

    def rand(normal=False):
        a = rng.normal(0, 0.5, shape) if normal else rng.uniform(0, 1, shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    i1, i2 = rand(), rand()
    u, v = rand(True), rand(True)
    f = tuple(k1.derivatives_plain(i1, i2, 0.5))
    u1, u2 = rand(True), rand(True)
    tcfg = TVL1Config()
    tf = tv.inner_fields(255.0 * i1, 255.0 * i2, u1, u2, tcfg)
    sc = tv.inner_scalars(tcfg)
    cfg_r = HSConfig(alpha=0.3, iters=5, solver="robust", robust_update_every=2)
    pair = (i1[0], i2[0]) if len(shape) == 3 else (i1, i2)
    out = {
        "K1": ((i1, i2), lambda a, b: k1.hs_derivatives(a, b, 0.5, zero_sweep=True),
               lambda a, b: k1.derivatives_plain(a, b, 0.5, zero_sweep=True)),
        "K2": ((u, v) + f, lambda *t: k2.jacobi_sweeps(*t, 9),
               lambda *t: k2.jacobi_sweeps_plain(*t, 9)),
        "K3": ((u, v) + f, lambda *t: k3.sor_sweeps(*t, 5, OMEGA),
               lambda *t: k3.sor_sweeps_plain(*t, 5, OMEGA)),
        "K4 robust_sweeps": ((u, v) + f[:3], lambda *t: k4.robust_sweeps(*t, 5, cfg_r),
                             lambda *t: robust.robust_sweeps(*t, 5, cfg_r)),
        "K5": ((u1, u2) + tuple(tf), lambda *t: k5.tvl1_inner(*t, 7, *sc),
               lambda *t: k5.tvl1_inner_plain(*t, 7, *sc)),
        "hs_solve multigrid": (
            pair, lambda a, b: hs_solve(a, b, HSConfig(iters=1, solver="multigrid")),
            lambda a, b: hs_solve(a, b, HSConfig(iters=1, solver="multigrid",
                                                 backend="torch"))),
    }
    solves = {
        "K1 + K2": (lambda a, b, c, d: sr.hs_solve_resident(a, b, 0.5, 9, u0=c, v0=d),
                    lambda a, b, c, d: sr.hs_solve_resident_plain(a, b, 0.5, 9, u0=c, v0=d)),
        "K1 + K3": (lambda a, b, c, d: sr.hs_solve_resident_sor(a, b, 0.5, 5, OMEGA,
                                                                u0=c, v0=d),
                    lambda a, b, c, d: sr.hs_solve_resident_sor_plain(a, b, 0.5, 5, OMEGA,
                                                                      u0=c, v0=d)),
        "K1 + K4": (lambda a, b, c, d: k4.hs_solve_robust_resident(a, b, cfg_r, c, d),
                    lambda a, b, c, d: k4.hs_solve_robust_resident_plain(a, b, cfg_r, c, d)),
        "K1 + K6": (lambda a, b, c, d: k6.hs_solve_fused(a, b, 0.5, 9, u0=c, v0=d),
                    lambda a, b, c, d: k6.hs_solve_fused_plain(a, b, 0.5, 9, u0=c, v0=d)),
        "K1 + K7": (lambda a, b, c, d: k7.hs_solve_skewed(a, b, 0.5, 9, u0=c, v0=d),
                    lambda a, b, c, d: k7.hs_solve_skewed_plain(a, b, 0.5, 9, u0=c, v0=d)),
    }
    if len(shape) == 2:
        out["K8"] = ((u, v) + f, lambda *t: k8.sor_planes(*t, 5, OMEGA),
                     lambda *t: k8.sor_planes_plain(*t, 5, OMEGA))
        solves["K1 + K8"] = (
            lambda a, b, c, d: k8.hs_solve_sor_planes(a, b, 0.5, 5, OMEGA, u0=c, v0=d),
            lambda a, b, c, d: k8.sor_planes_plain(c, d, *k1.derivatives_plain(a, b, 0.5),
                                                   5, OMEGA))
    for name, (call, twin) in solves.items():
        out[name + " zero"] = ((i1, i2), lambda a, b, call=call: call(a, b, None, None),
                               lambda a, b, twin=twin: twin(a, b, None, None))
        out[name + " warm"] = ((i1, i2, u, v), call, twin)
    return out


def gradient_path(dev, frames, s1, s2, c2a, c2b, p1, p2) -> None:
    """Phase 18: gradients on the card. Every entry of the autograd scheme
    (kernels/autodiff.py: the kernel forward, the plain twin's VJP
    backward) at small shapes = its plain twin bitwise, the parts without a
    scheme refused, forward mode refused; then G1 (C1's hs_solve, i100 and
    i400, and three steps of descent on an offset to frame 2), G2 (S1, R1,
    a stack of C2, C3's pyramid, L1 through K7 and L2 central through K6)
    and G3 (tvl1_solve one level on S2's pair through K5), each = the plain
    route bitwise, with its launches, times and peak memory."""
    import torch.autograd.forward_ad as fwad

    from opticalflowhs_tpu_torch import (
        HSConfig,
        PyramidConfig,
        TVL1Config,
        hs_pyramid,
        hs_solve,
        hs_solve_batched,
        robust,
        tvl1_solve,
    )
    from opticalflowhs_tpu_torch.config import MeshConfig
    from opticalflowhs_tpu_torch.dist import hs_solve_tiled, make_mesh
    from opticalflowhs_tpu_torch.kernels import counted_wrappers, ring
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import solve_robust as k4
    from opticalflowhs_tpu_torch.kernels import tile as k9
    from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5
    from opticalflowhs_tpu_torch.ops import stencils

    t_phase = time.perf_counter()
    wrappers = counted_wrappers()

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts() -> dict:
        """Launches since zero_counts() by kernel (K4's freeze and sweeps
        together)."""
        out = {}
        for k, w in wrappers.items():
            if w.launches:
                out[k.split()[0]] = out.get(k.split()[0], 0) + w.launches
        return out

    def worst(got, want) -> float:
        """Max |diff| over pairs of tensors, relative to the largest |want|."""
        d = max(max_diff(g.detach(), w.detach()) for g, w in zip(got, want))
        return d / max(1.0, max(float(w.detach().abs().max()) for w in want))

    # -- every entry at small shapes -------------------------------------------------
    n_cases, err = 0, 0.0
    for shape in ((40, 56), (3, 37, 61)):
        for name, (inputs, call, twin) in _grad_entries(dev, shape).items():
            for wrt in ("all", "first"):
                ins = [t.clone().requires_grad_(wrt == "all" or i == 0)
                       for i, t in enumerate(inputs)]
                gen = torch.Generator().manual_seed(n_cases)
                zero_counts()
                outs = call(*ins)
                fwd = counts()
                weights = [torch.randn(o.shape, generator=gen).to(dev) for o in outs]
                wanted = [t for t in ins if t.requires_grad]

                def grads(o):
                    loss = sum((a * w).sum() for a, w in zip(o, weights))
                    return torch.autograd.grad(loss, wanted, allow_unused=True,
                                               materialize_grads=True)
                g = grads(outs)
                require(counts() == fwd and fwd, f"{name} {shape}: launches {fwd} then "
                        f"{counts()} (the backward must launch none)")
                want_outs = twin(*ins)
                d = worst(list(outs) + list(g), list(want_outs) + list(grads(want_outs)))
                require(d <= TOL, f"{name} {shape} wrt {wrt}: gradients vs plain {d}")
                err = max(err, d)
                n_cases += 1
    print(f"phase 18 every entry of the scheme (K1-K8, the whole-solve drivers, hs_solve "
          f"multigrid) at 40x56 and 3 x 37x61, zero and warm, all inputs and the first "
          f"requiring grad: {n_cases} cases, outputs and gradients vs the plain twin max "
          f"rel |diff| {err:.3g}; launches in the forward only")

    # -- what refuses ------------------------------------------------------------------
    rng = np.random.default_rng(181)

    def rand(shape, normal=False):
        a = rng.normal(0, 0.5, shape) if normal else rng.uniform(0, 1, shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    u, v = rand((40, 56), True), rand((40, 56), True)
    i1, i2 = rand((40, 56)), rand((40, 56))
    f = k1.derivatives_plain(i1, i2, 0.5)
    wd, ws = robust.charbonnier_weights(u, v, *f[:3], 0.05, 0.05)
    org = k9.origin_table(u, -3, -3)
    gu, gv, gf, go = _ring_inputs(dev, 2, 1, 20, 56, 4, 182, 40, 56)
    hu, hv, hf, ho = _ring_inputs(dev, 2, 2, 20, 28, 4, 183, 40, 56)
    mesh = make_mesh(MeshConfig(y=2, x=2), [dev] * 4)
    refused = {
        "K4 freeze": lambda a: k4.freeze_weights(a, v, *f[:3], 0.05, 0.05),
        "K4 sweeps": lambda a: k4.frozen_sweeps(a, v, *f[:3], wd, ws, 0.3, 3),
        "K9": lambda a: k9.tile_sweeps(a, v, *f, 3, org, 40, 56),
        "K9 SOR": lambda a: k9.sor_tile_sweeps(a, v, *f, 3, OMEGA, org, 40, 56),
        "K10": lambda a: ring.ring_halo_exchange([a, v], 2),
        "K11": lambda a: ring.ring_fused_sweeps(
            [a[:20], gu[1][0]], [gv[0][0], gv[1][0]], [gf[0][0], gf[1][0]], 4, 4,
            [0, 20], 40, 56),
        "K12": lambda a: ring.ring_fused_sweeps_2d(
            [[a[:20, :28].contiguous(), hu[0][1]], hu[1]], hv, hf, 4, 4, ho, 40, 56),
        "hs_solve_tiled": lambda a: hs_solve_tiled(a, i2, HSConfig(iters=3), mesh),
    }
    for name, call in refused.items():
        a = (i1 if name == "hs_solve_tiled" else u).clone().requires_grad_()
        try:
            call(a)
        except RuntimeError as e:
            require("does not differentiate" in str(e) and "no_grad" in str(e),
                    f"{name} refused with another message: {e}")
        else:
            raise RuntimeError(f"check failed: {name} took a CUDA input that requires grad")
    with fwad.dual_level():
        dual = fwad.make_dual(i1, torch.ones_like(i1))
        for name, call in (("K1", lambda: k1.hs_derivatives(dual, i2, 0.5)),
                           ("K1 + K2", lambda: sr.hs_solve_resident(dual, i2, 0.5, 3))):
            try:
                call()
            except NotImplementedError as e:
                require("jvp" in str(e), f"forward mode refused with another message: {e}")
            else:
                raise RuntimeError(f"check failed: forward mode passed through {name}")
        tangent = fwad.unpack_dual(hs_solve(dual, i2, HSConfig(iters=3, backend="torch")).u)
        require(tangent.tangent is not None, "the plain backend dropped the tangent")
    print(f"phase 18 refused with the new message: {', '.join(refused)}; forward mode "
          "through K1's and the K1 + K2 driver's entries raises (the plain backend carries "
          "the tangent)")

    # -- G1-G3: the routes at full width -----------------------------------------------
    def loss_of(flow):
        """mean(u^2) + mean(v^2), the loss of the reference's autodiff test,
        of a Flow or a (u, v) pair."""
        return flow[0].square().mean() + flow[1].square().mean()

    def route(solve, a, b):
        """Gradients of loss_of(solve(a, b)) with respect to both frames."""
        a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
        return torch.autograd.grad(loss_of(solve(a, b)), (a, b))

    def g_check(tag, solve, plain_solve, a, b, want_counts, runs=3, plain_runs=3):
        """The kernel route: its forward's launches (= want_counts, none in the
        backward), its gradients = the plain route's bitwise, forward +
        backward ms (median of `runs` after two warm-up calls, synced; for 0
        the one warm run that measures the peak) beside the other route's
        (median of `plain_runs`, or for 0 the one run of the check), and the
        gradient's peak above the inputs."""
        aa, bb = a.clone().requires_grad_(), b.clone().requires_grad_()
        zero_counts()
        flow = solve(aa, bb)
        torch.cuda.synchronize()
        fwd = counts()
        g = torch.autograd.grad(loss_of(flow), (aa, bb))
        torch.cuda.synchronize()
        require(fwd == want_counts and counts() == fwd,
                f"{tag}: launches {fwd} then {counts()}, expected {want_counts} then none")
        del flow
        t0 = time.perf_counter()
        want = route(plain_solve, a, b)
        torch.cuda.synchronize()
        ms_once = (time.perf_counter() - t0) * 1e3
        d = max(max_diff(x, y) for x, y in zip(g, want))
        require(d == 0.0 or d <= TOL * float(max(w.abs().max() for w in want)),
                f"{tag}: gradients vs plain {d}")
        t0 = time.perf_counter()
        peak = peak_bytes(lambda: route(solve, a, b)) / 2**20
        ms = median_ms(lambda: route(solve, a, b), runs=runs) if runs \
            else (time.perf_counter() - t0) * 1e3
        ms_p = median_ms(lambda: route(plain_solve, a, b), runs=plain_runs) \
            if plain_runs else ms_once
        scale = float(max(w.abs().max() for w in want))
        print(f"phase 18 {tag}: launches {fwd} forward, 0 backward; gradients vs the "
              f"other route max|diff| {d:.3g} (max |grad| {scale:.3g}); forward + backward "
              f"{ms:.3f} ms ({f'median of {runs}' if runs else 'one run'}), other route "
              f"{ms_p:.3f} ms "
              f"({f'median of {plain_runs}' if plain_runs else 'one run'}); the gradient's "
              f"peak {peak:.1f} MiB above the inputs")

    plain = lambda c: dataclasses.replace(c, backend="torch")  # noqa: E731
    cfg1 = HSConfig(alpha=0.5, iters=100)
    g_check("G1 hs_solve 1088x1920 a=0.5 i100", lambda a, b: hs_solve(a, b, cfg1),
            lambda a, b: hs_solve(a, b, plain(cfg1)), s1, s2,
            {"K1": 1, "K2": 13}, runs=5, plain_runs=5)

    def hand_loop(a, b):
        """i100 plain Jacobi sweeps from zero, no checkpointing: every sweep
        on the tape."""
        a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
        ex, ey, et, invd = k1.derivatives_plain(a, b, 0.5)
        u, v = torch.zeros_like(a), torch.zeros_like(a)
        for _ in range(100):
            u, v = stencils.jacobi_step(u, v, ex, ey, et, invd)
        return torch.autograd.grad(u.square().mean() + v.square().mean(), (a, b))

    hand = peak_bytes(lambda: hand_loop(s1, s2)) / 2**20
    print(f"phase 18 G1 hand loop of 100 stencils.jacobi_step, no checkpoint: peak "
          f"{hand:.1f} MiB above the inputs")
    cfg4 = HSConfig(alpha=0.5, iters=400)
    g_check("G1 hs_solve 1088x1920 a=0.5 i400", lambda a, b: hs_solve(a, b, cfg4),
            lambda a, b: hs_solve(a, b, plain(cfg4)), s1, s2,
            {"K1": 1, "K2": 50}, runs=0, plain_runs=0)

    off = {r: torch.zeros_like(s2) for r in ("auto", "torch")}  # auto: the kernel route
    losses = []
    for step in range(3):
        got = {}
        for r in off:
            o = off[r].clone().requires_grad_()
            loss = loss_of(hs_solve(s1, s2 + o, dataclasses.replace(cfg1, backend=r)))
            got[r] = (loss.detach(), torch.autograd.grad(loss, o)[0])
        require(torch.equal(got["auto"][0], got["torch"][0])
                and torch.equal(got["auto"][1], got["torch"][1]),
                f"G1 descent step {step}: kernel route vs plain")
        g = got["auto"][1]
        eta = 0.01 / g.abs().max()
        for r in off:
            off[r] = off[r] - eta * got[r][1]
        losses.append(float(got["auto"][0]))
    require(losses[0] > losses[1] > losses[2], f"G1 descent: the loss did not fall {losses}")
    print(f"phase 18 G1 descent on a per-pixel offset to frame 2 (steps of 0.01 / max|grad|): "
          f"loss {losses[0]:.6g} -> {losses[1]:.6g} -> {losses[2]:.6g}; kernel route = plain "
          "route bitwise at every step")

    k3_n = k3_plan_launches(dev, tuple(s1.shape), 50)
    cfg_s = HSConfig(alpha=0.5, iters=50, solver="sor", omega=OMEGA)
    g_check(f"G2 S1 SOR 1088x1920 i50 omega {OMEGA}", lambda a, b: hs_solve(a, b, cfg_s),
            lambda a, b: hs_solve(a, b, plain(cfg_s)), s1, s2, {"K1": 1, "K3": k3_n})
    cfg_r = HSConfig(alpha=0.25, iters=100, solver="robust", robust_update_every=20)
    g_check("G2 R1 robust 1088x1920 i100 k 20", lambda a, b: hs_solve(a, b, cfg_r),
            lambda a, b: hs_solve(a, b, plain(cfg_r)), s1, s2,
            {"K1": 1, "K4": 5 + k4_plan_launches(dev, tuple(s1.shape), 100, 20)})
    cfg_b = HSConfig(alpha=1.0, iters=100)
    g_check("G2 hs_solve_batched 4 x 1088x1920 (C2's first 4) a=1 i100",
            lambda a, b: hs_solve_batched(a, b, cfg_b),
            lambda a, b: hs_solve_batched(a, b, plain(cfg_b)), c2a[:4], c2b[:4],
            {"K1": 1, "K2": 13})
    pyr3 = PyramidConfig(levels=3)
    torch.use_deterministic_algorithms(True)
    try:
        g_check("G2 hs_pyramid 1080x1920 (C3) L3 a=1 i100, deterministic algorithms",
                lambda a, b: hs_pyramid(a, b, cfg_b, pyr3),
                lambda a, b: hs_pyramid(a, b, plain(cfg_b), pyr3), p1, p2,
                {"K1": 3, "K2": 39})
    finally:
        torch.use_deterministic_algorithms(False)
    q1, q2 = frames(2160, 3840, seed=0)
    g_check("G2 L1 hs_solve 2160x3840 a=0.5 i100 (K7) against the K1 + K2 chain",
            lambda a, b: hs_solve(a, b, cfg1),
            lambda a, b: sr.hs_solve_resident(a, b, 0.5, 100), q1, q2,
            {"K1": 1, "K7": 1})
    del q1, q2
    cfg_c = HSConfig(alpha=0.5, iters=100, deriv_variant="central")
    g_check("G2 L2 hs_solve 1088x1920 central a=0.5 i100 (K6) against the K1 + K2 chain",
            lambda a, b: hs_solve(a, b, cfg_c),
            lambda a, b: sr.hs_solve_resident(a, b, 0.5, 100, "central"), s1, s2,
            {"K1": 1, "K6": 1})

    t1, t2, _ = t1_pair(dev)
    tcfg, tpyr = TVL1Config(), PyramidConfig(levels=1)
    k5_n = tcfg.warps * k5.k5_geometry(dev, 0, tuple(t1.shape), tcfg.iters)["launches"]
    g_check("G3 tvl1_solve 1088x1920 (S2's pair) 1 level TVL1Config()",
            lambda a, b: tvl1_solve(a, b, tcfg, tpyr),
            lambda a, b: tvl1_solve(a, b, plain(tcfg), tpyr), t1, t2,
            {"K5": k5_n}, runs=0, plain_runs=0)
    print(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")


def bf16_path(dev, frames, stack, s1, s2, c2a, c2b, p1, p2, vid) -> list:
    """Phase 19: the bfloat16 builds of K1, K2, K6 and K7 (bfloat16 storage,
    float32 arithmetic, u and v rounded every sweep) against their plain
    bfloat16 versions at phases 2, 3 and 13's shapes, max |diff| 0.0; then
    the Jacobi path in bfloat16 through the entry points, counted: C1, C2,
    C3, C4's two streams, L1 (K7) and L2 (K6), each = the plain route
    bitwise with the float32 plan's launches, timed beside float32 in the
    same run (and L1/L2's peak memory); G1 in bfloat16 = the plain route
    bitwise. Returns the bfloat16 rows of the kernels line."""
    from opticalflowhs_tpu_torch import (
        HSConfig,
        PyramidConfig,
        flow_stream,
        flow_stream_warm,
        hs_pyramid,
        hs_solve,
        hs_solve_batched,
    )
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import solve_fused as k6
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import solve_skewed as k7
    from opticalflowhs_tpu_torch.metrics import epe, interior

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    names = ("hs_derivatives_bf16", "hs_jacobi_sweeps_bf16", "hs_solve_fused_bf16",
             "hs_solve_skewed_bf16")
    err = dict.fromkeys(names, 0.0)

    def exact(name, got, want, what):
        for g in got:
            require(g.dtype == bf, f"{what}: dtype {g.dtype}")
        d = max(max_diff(g.float(), w.float()) for g, w in zip(got, want))
        err[name] = max(err[name], d)
        require(d == 0.0, f"{what}: max|diff| {d} (bfloat16 builds equal plain bitwise)")

    def b16(*a):
        return tuple(x.to(bf) for x in a)

    # -- the four builds against their plain versions ------------------------------
    for h, w in ((67, 93), (1080, 1920), (1088, 1920)):
        for b in ((1, 3) if h != 1080 else (1,)):
            i1, i2 = b16(*(a.squeeze(0) for a in stack(b, h, w, seed=190)))
            for variant in ("hs_cube", "central"):
                for zero_sweep in (False, True):
                    exact(names[0], k1.hs_derivatives(i1, i2, 0.5, variant, zero_sweep),
                          k1.derivatives_plain(i1, i2, 0.5, variant, zero_sweep),
                          f"K1 bf16 B={b} {h}x{w} {variant} {zero_sweep}")
    print(f"phase 19 K1 bf16 67x93, 1080x1920, 1088x1920, B 1 and 3, both variants, with "
          f"and without the first sweep: max|diff| vs plain {err[names[0]]:.3g}")
    for h, w in ((67, 93), (1088, 1920)):
        i1, i2 = b16(*frames(h, w, seed=191))
        fields = k1.derivatives_plain(i1, i2, 0.5)
        u0, v0 = b16(*(a.squeeze(0) for a in stack(1, h, w, seed=192, normal=True)))
        for n in (1, 7, 100):
            want = k2.jacobi_sweeps_plain(u0, v0, *fields, n)
            for s in (1, 4, 0):
                before = k2.jacobi_sweeps.launches
                exact(names[1], k2.jacobi_sweeps(u0, v0, *fields, n, block_sweeps=s), want,
                      f"K2 bf16 {h}x{w} n={n} s={s}")
                require(k2.jacobi_sweeps.launches - before == -(-n // k2.sweeps_per_launch(s)),
                        "K2 bf16 launches = the float32 plan's")
        for init in ((u0, v0), (None, None)):
            exact(names[1], sr.hs_solve_resident(i1, i2, 0.5, 23, "hs_cube", *init),
                  sr.hs_solve_resident_plain(i1, i2, 0.5, 23, "hs_cube", *init),
                  f"K1 + K2 bf16 {h}x{w} n=23")
    for shape in K2_EDGE_SHAPES:
        for b in (1, 3):
            rng = np.random.default_rng(193)
            full = shape if b == 1 else (b,) + shape
            i1, i2, u0, v0 = (torch.from_numpy(rng.uniform(-1, 1, full).astype(np.float32))
                              .to(dev).to(bf) for _ in range(4))
            fields = k1.derivatives_plain(i1, i2, 0.5)
            for s in range(1, 13):
                n = 2 * k2.sweeps_per_launch(s) + 1
                exact(names[1], k2.jacobi_sweeps(u0, v0, *fields, n, block_sweeps=s),
                      k2.jacobi_sweeps_plain(u0, v0, *fields, n), f"K2 bf16 edge {full} s={s}")
    print(f"phase 19 K2 bf16 67x93 and 1088x1920 n 1, 7, 100 at s 1, 4, auto, the K1 + K2 "
          f"driver n=23 zero and warm, and the edge shapes {K2_EDGE_SHAPES} B 1 and 3 s 1-12: "
          f"max|diff| vs plain {err[names[1]]:.3g}; launches = the float32 plan's")
    for b, h, w in ((1, 67, 93), (3, 67, 93), (1, 131, 130), (3, 131, 130), (3, 70, 248),
                    (1, 1088, 1920)):
        small = h < 1000
        variant = "hs_cube" if small else "central"
        i1, i2 = b16(*(a.squeeze(0) for a in stack(b, h, w, seed=194)))
        u0, v0 = b16(*(a.squeeze(0) for a in stack(b, h, w, seed=195, normal=True)))
        for n in (7, 9, 100):
            for init in ((None, None), (u0, v0)):
                want = k6.hs_solve_fused_plain(i1, i2, 0.5, n, variant, *init)
                what = f"{b}x{h}x{w} {variant} n={n} {'zero' if init[0] is None else 'warm'}"
                exact(names[2], k6.hs_solve_fused(i1, i2, 0.5, n, variant, *init,
                                                  **(dict(blocks=2) if small else {})),
                      want, f"K6 bf16 {what}")
                exact(names[3], k7.hs_solve_skewed(i1, i2, 0.5, n, variant, *init,
                                                   **(dict(band=16) if small else {})),
                      want, f"K7 bf16 {what}")
    geo = {"K2": k2.k2_geometry(dev, 8, dtype=bf), "K6": k6.k6_geometry(dev, 8, bf),
           "K7 4K": k7.k7_geometry(dev, 2160, 3840, 8, dtype=bf),
           "K7 8K": k7.k7_geometry(dev, 4320, 7680, 8, dtype=bf)}
    for tag, g in geo.items():
        require(g["spill_bytes"] == 0 and g["blocks_per_sm"] >= 1, f"{tag} bf16 geometry {g}")
    print(f"phase 19 K6/K7 bf16 B 1 and 3 at 67x93, 131x130 and 70x248 (K6 on 2 blocks, K7 in "
          f"16-row bands), 1088x1920 central, n 7, 9, 100, zero and warm: max|diff| vs plain "
          f"K6 {err[names[2]]:.3g} K7 {err[names[3]]:.3g}; geometry at s 8: {geo}")

    # -- the Jacobi path in bfloat16, counted -----------------------------------------
    def in_bf16(c):
        return dataclasses.replace(c, dtype="bfloat16")

    def plain(c):
        return dataclasses.replace(c, backend="torch")

    cfg1 = HSConfig(alpha=0.5, iters=100)
    cfg2 = cell_config("c2_video_batch.json")
    cfg3 = HSConfig(alpha=1.0, iters=100)
    cfg4 = cell_config("c4_hd_streaming.json")
    cfg4w = dataclasses.replace(cfg4, iters=25)
    pyr3 = PyramidConfig(levels=3)
    q1, q2 = frames(2160, 3840, seed=0)
    e1, e2 = frames(4320, 7680, seed=0)
    counters = {"K1": k1.hs_derivatives, "K2": k2.jacobi_sweeps,
                "K6": k6.hs_solve_fused, "K7": k7.hs_solve_skewed}
    per_call = {}

    def counted(tag, fn):
        before = {n: c.launches for n, c in counters.items()}
        out = fn()
        torch.cuda.synchronize()
        per_call[tag] = tuple(c.launches - before[n] for n, c in counters.items())
        return out

    runs = {
        "C1": lambda c=cfg1: hs_solve(s1, s2, c),
        "C2": lambda c=cfg2: hs_solve_batched(c2a, c2b, c),
        "C3": lambda c=cfg3: hs_pyramid(p1, p2, c, pyr3),
        "C4": lambda c=cfg4: list(flow_stream(vid, c, chunk=8)),
        "C4 warm": lambda c=cfg4w: list(flow_stream_warm(vid, c, chunk=8, warp_prior=True)),
        "L1": lambda c=cfg1: hs_solve(q1, q2, c),
        "L2": lambda c=cfg1: hs_solve(e1, e2, c),
    }
    cfgs = {"C1": cfg1, "C2": cfg2, "C3": cfg3, "C4": cfg4, "C4 warm": cfg4w, "L1": cfg1,
            "L2": cfg1}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out16 = {tag: counted(tag, lambda fn=fn, tag=tag: fn(in_bf16(cfgs[tag])))
             for tag, fn in runs.items()}
    launches = {n: c.launches for n, c in counters.items()}
    print(f"phase 19 path launches (bfloat16: C1, C2, C3, C4, C4 warm, L1, L2): {launches}; "
          f"per call (K1, K2, K6, K7) {per_call}")
    require(all(v > 0 for v in launches.values()), f"a bf16 build never ran: {launches}")
    counts16 = dict(per_call)
    out32 = {tag: counted(tag, lambda fn=fn, tag=tag: fn(cfgs[tag])) for tag, fn in runs.items()}
    require(counts16 == per_call, f"bf16 launches {counts16} != float32's {per_call}")

    def flows(x):
        return x if isinstance(x, list) else [x]

    for tag, got in out16.items():
        for f in flows(got):
            for a in f:
                require(a.dtype == bf and bool(torch.isfinite(a.float()).all()),
                        f"{tag} bf16 output dtype/finite")
        want = flows(runs[tag](plain(in_bf16(cfgs[tag]))))
        for g, w in zip(flows(got), want):
            require(bool(torch.equal(g.u, w.u) and torch.equal(g.v, w.v)),
                    f"{tag} bf16 differs from the plain route")
    require(all(bool(torch.equal(a.u, b.u)) for a, b in
                zip(out16["C4"], [hs_solve_batched(torch.from_numpy(vid[8 * k:8 * k + 8]).to(dev),
                                                   torch.from_numpy(vid[8 * k + 1:8 * k + 9]).to(dev),
                                                   in_bf16(cfg4)) for k in range(2)])),
            "C4 bf16 chunks differ from hs_solve_batched")

    def mean_abs(a, b):
        """Interior (8 px in) mean |a - b| over u and v, in px."""
        return float(sum((x.float() - y.float()).abs()[..., 8:-8, 8:-8].mean()
                         for x, y in zip(a, b)) / 2)

    ms = {}
    for tag in ("C1", "C2", "C3", "L1", "L2"):
        reps = 20 if tag in ("C1", "C3", "L1") else 10
        ms[tag] = (median_ms(lambda: runs[tag](in_bf16(cfgs[tag])), runs=reps),
                   median_ms(lambda: runs[tag](cfgs[tag]), runs=reps))
    for tag in ("C4", "C4 warm"):
        ms[tag] = (median_ms(lambda: runs[tag](in_bf16(cfgs[tag])), runs=5),
                   median_ms(lambda: runs[tag](cfgs[tag]), runs=5))
    peak = {tag: (peak_bytes(lambda: runs[tag](in_bf16(cfgs[tag]))) / 2**20,
                  peak_bytes(lambda: runs[tag](cfgs[tag])) / 2**20) for tag in ("L1", "L2")}
    gt3 = np.broadcast_to(np.array([3.0, 1.5], np.float32), (1080, 1920, 2))
    e3 = [epe(interior(np.stack([f.u.float().cpu().numpy(), f.v.float().cpu().numpy()], -1), 16),
              interior(gt3, 16)) for f in (out16["C3"], out32["C3"])]
    for tag in ("C1", "C2", "C3", "L1", "L2"):
        print(f"phase 19 {tag} bf16: = the plain route bitwise; launches {per_call[tag]} "
              f"(= float32's); bf16 {ms[tag][0]:.3f} ms, float32 {ms[tag][1]:.3f} ms "
              f"(median of {20 if tag in ('C1', 'C3', 'L1') else 10}); interior mean |bf16 - "
              f"float32| {mean_abs(out16[tag], out32[tag]):.5f} px"
              + (f"; peak {peak[tag][0]:.1f} MiB, float32 {peak[tag][1]:.1f} MiB"
                 if tag in peak else "")
              + (f"; interior EPE bf16 {e3[0]:.6f}, float32 {e3[1]:.6f}" if tag == "C3" else ""))
    for tag in ("C4", "C4 warm"):
        print(f"phase 19 {tag} bf16 (16 pairs): = the plain route bitwise, chunks = "
              f"hs_solve_batched; bf16 {ms[tag][0]:.3f} ms, float32 {ms[tag][1]:.3f} ms "
              f"(median of 5); interior mean |bf16 - float32| of the last pair "
              f"{mean_abs(out16[tag][-1], out32[tag][-1]):.5f} px")
    require(peak["L1"][0] < peak["L1"][1], "L1 bf16 peak memory not below float32's")

    # -- G1 in bfloat16: C1's gradient = the plain route bitwise ----------------------
    a, b = s1.clone().requires_grad_(), s2.clone().requires_grad_()
    for c in counters.values():
        c.launches = 0

    def g1(cfg):
        f = hs_solve(a, b, cfg)
        loss = torch.mean(f.u.float() ** 2) + torch.mean(f.v.float() ** 2)
        return f, torch.autograd.grad(loss, (a, b))

    f_g, grads = g1(in_bf16(cfg1))
    g_launches = tuple(c.launches for c in counters.values())
    f_p, grads_p = g1(plain(in_bf16(cfg1)))
    require(all(bool(torch.equal(x, y)) for x, y in zip(list(f_g) + list(grads),
                                                         list(f_p) + list(grads_p))),
            "G1 bf16 gradient differs from the plain route")
    require(g_launches == (1, 13, 0, 0), f"G1 bf16 launches {g_launches}")
    ms_g1 = median_ms(lambda: g1(in_bf16(cfg1)), runs=3)
    print(f"phase 19 G1 bf16 hs_solve 1088x1920 a=0.5 i100, d(mean u^2 + mean v^2)/d frames: "
          f"= the plain route bitwise; launches {g_launches} forward; {ms_g1:.1f} ms "
          f"(median of 3)")
    del a, b, grads, grads_p, f_g, f_p

    # -- per-kernel times, bf16 beside float32 ----------------------------------------
    def k1_call(x, y):
        return lambda: k1.hs_derivatives(x, y, 0.5, zero_sweep=True)

    def k2_call(x, y):
        f = k1.derivatives_plain(x, y, 0.5)
        zu, zv = torch.zeros_like(x), torch.zeros_like(x)
        uo, vo = torch.empty_like(x), torch.empty_like(x)
        return (lambda: k2.launch_sweeps(zu, zv, *f, uo, vo, 8),
                lambda: k2.jacobi_sweeps_plain(zu, zv, *f, 8))

    def per_launch(fn, match):
        """Ms of one launch and what measured it: the profiler's device
        time over the kernel runs it saw (one a call), by their count; CUDA
        events around the calls where the profiler saw none."""
        total, runs = device_ms(fn, match)
        if runs == 0:
            return event_ms(fn), "events"
        return total * 20 / runs, "device"

    # The float32 kernels' names are prefixes of the bf16 ones', and K2's
    # float32 kernel is jacobi_kernel<false> (mangled ...ILb0E...), not the
    # shard variant <true>.
    t = {}
    for tag, (x, y) in (("1088x1920", (s1, s2)), ("8x1088x1920", (c2a, c2b))):
        for dt, k1m, k2m in ((bf, r"derivatives_kernel_bf16", r"jacobi_kernel_bf16"),
                             (torch.float32, r"derivatives_kernel(?!_bf16)",
                              r"jacobi_kernel(<false>|ILb0E)")):
            xx, yy = x.to(dt), y.to(dt)
            k2_fn, k2_plain = k2_call(xx, yy)
            t[tag, dt, "K1"] = (*per_launch(k1_call(xx, yy), k1m), event_ms(k1_call(xx, yy)),
                                event_ms(lambda: k1.derivatives_plain(xx, yy, 0.5, zero_sweep=True),
                                         reps=5))
            t[tag, dt, "K2"] = (*per_launch(k2_fn, k2m), event_ms(k2_fn),
                                event_ms(k2_plain, reps=5))
            del xx, yy, k2_fn, k2_plain
    for (tag, dt, k), (dev_ms, by, ev_ms, pl_ms) in t.items():
        print(f"phase 19 {k} {'bf16' if dt == bf else 'float32'} {tag}: {by} {dev_ms:.4f} ms, "
              f"events {ev_ms:.4f} ms, plain {pl_ms:.4f} ms"
              + (" (a launch of 8 sweeps)" if k == "K2" else " (with the first sweep)"))
    print(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")

    def bound2(arrays, flops, px):
        return bound_ms(arrays * 2 * px, flops * px)

    px1, px8 = s1.numel(), c2a.numel()
    rows = []
    for name, k, per_px, arrays in ((names[0], "K1", K1_BF16_FLOPS_PER_PX, 8),
                                    (names[1], "K2", 8 * K2_BF16_FLOPS_PER_PX_SWEEP, 8)):
        b8, by8 = bound2(arrays, per_px, px8)
        rows.append({"name": name, "route": "cuda",
                     "source": f"opticalflowhs_tpu_torch/csrc/"
                               f"{'derivatives' if k == 'K1' else 'jacobi'}.cu",
                     "replaces": BF16_REPLACES[k],
                     "launches": launches[k], "max_abs_err": err[name],
                     "ms": t["8x1088x1920", bf, k][0], "ms_by": t["8x1088x1920", bf, k][1],
                     "event_ms": t["8x1088x1920", bf, k][2],
                     "plain_ms": t["8x1088x1920", bf, k][3],
                     "float32_ms": t["8x1088x1920", torch.float32, k][0],
                     "float32_ms_by": t["8x1088x1920", torch.float32, k][1],
                     "ms_1088x1920": t["1088x1920", bf, k][0],
                     "event_ms_1088x1920": t["1088x1920", bf, k][2],
                     "plain_ms_1088x1920": t["1088x1920", bf, k][3],
                     "float32_ms_1088x1920": t["1088x1920", torch.float32, k][0],
                     "bound_ms_1088x1920": bound2(arrays, per_px, px1)[0],
                     "bound_ms": b8, "bound_by": by8, "library_ms": None,
                     **({"geometry": geo["K2"]} if k == "K2" else {})})
    for name, k, tag in ((names[2], "K6", "L2"), (names[3], "K7", "L1")):
        px = (e1 if tag == "L2" else q1).numel()
        b, by = bound_ms(SOLVE_ARRAYS * 2 * px,
                         (K1_BF16_FLOPS_PER_PX + 99 * K2_BF16_FLOPS_PER_PX_SWEEP) * px)
        plain_ms = median_ms(lambda: runs[tag](plain(in_bf16(cfgs[tag]))), runs=3)
        rows.append({"name": name, "route": "cuda",
                     "source": f"opticalflowhs_tpu_torch/csrc/"
                               f"{'solve_fused' if k == 'K6' else 'solve_skewed'}.cu",
                     "replaces": BF16_REPLACES[k], "launches": launches[k],
                     "max_abs_err": err[name], "ms": ms[tag][0], "plain_ms": plain_ms,
                     "float32_ms": ms[tag][1], "peak_mib": peak[tag][0],
                     "float32_peak_mib": peak[tag][1], "shape": list((e1 if tag == "L2" else q1).shape),
                     "bound_ms": b, "bound_by": by, "library_ms": None,
                     "geometry": geo["K6" if k == "K6" else "K7 4K"]})
    return rows


def bf16_sor_robust_path(dev, frames, stack, s1, s2, c2a, c2b, p1, p2, vid) -> list:
    """Phase 20: bfloat16 on the SOR and IRLS solvers. The bfloat16 builds of
    K3, K8 and K4 (freeze and sweeps) against their plain bfloat16 versions,
    max |diff| 0.0, at K3's and K4's tile-edge shapes and at 67x93 and
    1088x1920, s plan, 2, 5, 11 (K3) and plan, 2, 7, 14 (K4), B 1 and 3,
    zero and warm, with the float32 plan's launches; K8 = the plain planes =
    the bfloat16 K1 + K3 chain at every parity; the builds' geometry (no
    spills). Then the cells, each beside float32 on the same frames and
    counted: B7 (S1), B8 (S2's EPE ordering), B9 (R1), B10 (R2's seam),
    B11 (S1 through K8) and B12 (C2's stack with SOR and robust, C3's
    pyramid with SOR, C4's stream with SOR, SOR to tol, omega = 0, the
    gradients of B7 and B9). Returns the bfloat16 rows of the kernels line."""
    from opticalflowhs_tpu_torch import (
        HSConfig,
        PyramidConfig,
        flow_stream,
        hs_pyramid,
        hs_solve,
        hs_solve_batched,
        robust,
    )
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import solve_robust as k4
    from opticalflowhs_tpu_torch.kernels import sor as k3
    from opticalflowhs_tpu_torch.kernels import sor_planes as k8
    from opticalflowhs_tpu_torch.metrics import epe, interior
    from opticalflowhs_tpu_torch.solver import tune_omega

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    names = ("hs_sor_sweeps_bf16", "hs_sor_planes_bf16", "hs_robust_freeze_bf16",
             "hs_robust_sweeps_bf16")
    err = dict.fromkeys(names, 0.0)

    def exact(name, got, want, what):
        for g in got:
            require(g.dtype == bf, f"{what}: dtype {g.dtype}")
        d = max(max_diff(g.float(), w.float()) for g, w in zip(got, want))
        err[name] = max(err[name], d)
        require(d == 0.0, f"{what}: max|diff| {d} (bfloat16 builds equal plain bitwise)")

    def b16(*a):
        return tuple(x.to(bf) for x in a)

    def edge(tile, kind):
        th, tw = tile
        return {"one+": (th + 1, tw + 1), "two-": (2 * th - 1, 2 * tw - 1),
                "wide": (2 * th + 1, 2 * tw + 8)}[kind]

    # -- the builds against their plain versions ---------------------------------------
    blocks3, blocks4 = k3.device_blocks(dev), k4.device_blocks(dev)
    n_cases = 0
    for s in (0, 2, 5, k3.K3_MAX_SWEEPS):
        s_ = s or 4
        shapes = [(67, 93), (1088, 1920)] + [edge(k3.k3_tile(s_)[:2], k) for k in
                                             ("one+", "two-", "wide")]
        for shape in shapes:
            for b in ((1, 3) if shape[0] < 1000 else (1,)):
                i1, i2 = b16(*(a.squeeze(0) for a in stack(b, *shape, seed=200)))
                f = k1.derivatives_plain(i1, i2, 0.5)
                u0, v0 = b16(*(a.squeeze(0) for a in stack(b, *shape, seed=201, normal=True)))
                for uv in ((u0, v0), (torch.zeros_like(u0),) * 2):
                    n = 2 * s_ + 1
                    before = k3.sor_sweeps.launches
                    exact(names[0], k3.sor_sweeps(*uv, *f, n, OMEGA, block_sweeps=s),
                          k3.sor_sweeps_plain(*uv, *f, n, OMEGA), f"K3 bf16 {b}x{shape} s={s}")
                    require(k3.sor_sweeps.launches - before == k3.launches(
                        n, k3.sweeps_per_launch(s, u0.shape, n, blocks3)),
                        "K3 bf16 launches = the float32 plan's")
                    n_cases += 1
    for s in (0, 2, 7, k4.K4_MAX_SWEEPS):
        s_ = s or 5
        shapes = [(67, 93), (1088, 1920)] + [edge(k4.k4_tile(s_)[:2], k) for k in
                                             ("one+", "two-", "wide")]
        for shape in shapes:
            for b in ((1, 3) if shape[0] < 1000 else (1,)):
                i1, i2 = b16(*(a.squeeze(0) for a in stack(b, *shape, seed=202)))
                ex, ey, et, _ = k1.derivatives_plain(i1, i2, 0.4)
                u0, v0 = b16(*(a.squeeze(0) for a in stack(b, *shape, seed=203, normal=True)))
                for uv in ((u0, v0), (torch.zeros_like(u0),) * 2):
                    wd, ws = robust.charbonnier_weights(*uv, ex, ey, et, 0.05, 0.05)
                    exact(names[2], k4.freeze_weights(*uv, ex, ey, et, 0.05, 0.05), (wd, ws),
                          f"K4 freeze bf16 {b}x{shape}")
                    n = 2 * s_ + 1
                    want = uv
                    for _ in range(n):
                        want = robust.robust_step(*want, ex, ey, et, wd, ws, 0.3)
                    before = k4.frozen_sweeps.launches
                    exact(names[3], k4.frozen_sweeps(*uv, ex, ey, et, wd, ws, 0.3, n,
                                                     block_sweeps=s),
                          want, f"K4 sweeps bf16 {b}x{shape} s={s}")
                    require(k4.frozen_sweeps.launches - before == k4.launches(
                        n, k4.sweeps_per_launch(s, u0.shape, n, blocks4)),
                        "K4 bf16 launches = the float32 plan's")
                    n_cases += 1
        cfg = HSConfig(alpha=0.3, iters=13, solver="robust", robust_update_every=5)
        for init in ((None, None), (u0, v0)):
            exact(names[3], k4.hs_solve_robust_resident(i1, i2, cfg, *init),
                  k4.hs_solve_robust_resident_plain(i1, i2, cfg, *init), "IRLS driver bf16")
    for shape in ((192, 128), (131, 130), (96, 255), (97, 253), (67, 93)):
        i1, i2 = b16(*frames(*shape, seed=204))
        f = k1.derivatives_plain(i1, i2, 0.5)
        u0, v0 = b16(*(a.squeeze(0) for a in stack(1, *shape, seed=205, normal=True)))
        for n in (1, 4, 7):
            for init in ((None, None), (u0, v0)):
                want = k8.sor_planes_plain(*init, *f, n, OMEGA)
                exact(names[1], k8.sor_planes(*init, *f, n, OMEGA), want, f"K8 bf16 {shape}")
                exact(names[1], want, sr.hs_solve_resident_sor(i1, i2, 0.5, n, OMEGA, "hs_cube",
                                                               *init), f"K8 plain = chain {shape}")
    geo = {"K3": [k3.k3_geometry(dev, s, dtype=bf) for s in (2, 4, k3.K3_MAX_SWEEPS)],
           "K4": [k4.k4_geometry(dev, s, bf) for s in (1, 5, k4.K4_MAX_SWEEPS)],
           "K8": [k8.k8_geometry(dev, 4, bf)]}
    for tag, gs in geo.items():
        for g in gs:
            require(g["spill_bytes"] == 0 and g["blocks_per_sm"] == 1, f"{tag} bf16 geometry {g}")
    print(f"phase 20 K3 bf16 ({n_cases} K3 and K4 cases), K4 freeze and sweeps bf16, the IRLS "
          f"driver and K8 bf16 (5 shapes of every parity, n 1/4/7, zero and warm): max|diff| vs "
          f"plain {err}; launches = the float32 plan's; geometry (registers, spills): "
          + "; ".join(f"{t} " + ", ".join(f"s{g.get('sweeps', 4)} {g['registers']}/{g['spill_bytes']}"
                                          for g in gs) for t, gs in geo.items()))

    # -- the cells, bf16 beside float32, counted ---------------------------------------
    def in_bf16(c):
        return dataclasses.replace(c, dtype="bfloat16")

    def plain(c):
        return dataclasses.replace(c, backend="torch")

    def mean_abs(a, b):
        return float(sum((x.float() - y.float()).abs()[..., 8:-8, 8:-8].mean()
                         for x, y in zip(a, b)) / 2)

    counters = {"K1": k1.hs_derivatives, "K2": k2.jacobi_sweeps, "K3": k3.sor_sweeps,
                "K4 freeze": k4.freeze_weights, "K4 sweeps": k4.frozen_sweeps,
                "K8": k8.sor_planes}

    def counted(fn):
        before = {n: c.launches for n, c in counters.items()}
        out = fn()
        torch.cuda.synchronize()
        return out, tuple(c.launches - before[n] for n, c in counters.items())

    cfg_s1 = HSConfig(alpha=0.5, iters=50, solver="sor", omega=OMEGA)
    cfg_r1 = HSConfig(alpha=0.25, iters=100, solver="robust", robust_update_every=20)
    cfg3 = dataclasses.replace(cfg_s1, alpha=1.0, iters=100)
    cfg4 = dataclasses.replace(cell_config("c4_hd_streaming.json"), solver="sor", omega=OMEGA)
    runs = {
        "B7 S1": (lambda c: hs_solve(s1, s2, c), cfg_s1),
        "B9 R1": (lambda c: hs_solve(s1, s2, c), cfg_r1),
        "B12 C2 SOR": (lambda c: hs_solve_batched(c2a, c2b, c),
                       dataclasses.replace(cfg_s1, alpha=1.0)),
        "B12 C2 robust": (lambda c: hs_solve_batched(c2a, c2b, c),
                          dataclasses.replace(cfg_r1, alpha=1.0)),
        "B12 C3 SOR": (lambda c: hs_pyramid(p1, p2, c, PyramidConfig(levels=3)), cfg3),
        "B12 C4 SOR": (lambda c: list(flow_stream(vid, c, chunk=8)), cfg4),
        "B12 SOR tol": (lambda c: hs_solve(s1, s2, c),
                        dataclasses.replace(cfg_s1, iters=64, tol=1e-3, block_sweeps=8)),
        "B12 omega 0": (lambda c: hs_solve(s1, s2, c), dataclasses.replace(cfg_s1, omega=0.0)),
    }
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out16, per16 = {}, {}
    for tag, (run, c) in runs.items():
        out16[tag], per16[tag] = counted(lambda: run(in_bf16(c)))
    b1, b2 = b16(s1, s2)
    f8, per_k8 = counted(lambda: k8.hs_solve_sor_planes(b1, b2, 0.5, 50, OMEGA))  # B11
    launches = {n: c.launches for n, c in counters.items()}
    print(f"phase 20 path launches (bfloat16: B7, B9, B12, B11): {launches}; per call "
          f"(K1, K2, K3, K4 freeze, K4 sweeps, K8) {per16}, B11 {per_k8}")
    require(per_k8 == (1, 0, 0, 0, 0, 1), f"B11 launches {per_k8}")
    for k in ("K1", "K3", "K4 freeze", "K4 sweeps", "K8"):
        require(launches[k] > 0, f"a bf16 build never ran on phase 20's path: {launches}")
    out32, per32 = {}, {}
    for tag, (run, c) in runs.items():
        out32[tag], per32[tag] = counted(lambda: run(c))
    # To tol the blocks taken follow the updates, which bf16 rounds (an update
    # below a bf16 ulp of the flow is 0 or at least that ulp): held to the plain
    # route's blocks below, not to float32's.
    require({t: n for t, n in per16.items() if t != "B12 SOR tol"}
            == {t: n for t, n in per32.items() if t != "B12 SOR tol"},
            f"bf16 launches {per16} != float32's {per32}")
    require(per16["B12 SOR tol"][2] % k3.launches(8, k3.sweeps_per_launch(8, s1.shape, 8,
                                                                           blocks3)) == 0,
            f"SOR tol launches {per16['B12 SOR tol']}: whole check blocks")
    require(per16["B7 S1"][:3] == (1, 0, k3_plan_launches(dev, (1088, 1920), 50)),
            f"B7 launches {per16['B7 S1']}")
    require(per16["B9 R1"][3:5] == (5, k4_plan_launches(dev, (1088, 1920), 100, 20)),
            f"B9 launches {per16['B9 R1']}")

    def flows(x):
        return x if isinstance(x, list) else [x]

    for tag, (run, c) in runs.items():
        want = flows(run(plain(in_bf16(c))))
        for g, w in zip(flows(out16[tag]), want):
            for a in g:
                require(a.dtype == bf and bool(torch.isfinite(a.float()).all()),
                        f"{tag} bf16 dtype/finite")
            require(bool(torch.equal(g.u, w.u) and torch.equal(g.v, w.v)),
                    f"{tag} bf16 differs from the plain route")
    ms = {}
    for tag in ("B7 S1", "B9 R1", "B12 C2 SOR", "B12 C2 robust", "B12 C3 SOR"):
        run, c = runs[tag]
        reps = 20 if tag in ("B7 S1", "B9 R1") else 10
        ms[tag] = (median_ms(lambda: run(in_bf16(c)), runs=reps),
                   median_ms(lambda: run(c), runs=reps))
    for tag in runs:
        g, w = flows(out16[tag])[-1], flows(out32[tag])[-1]
        print(f"phase 20 {tag} bf16: = the plain route bitwise; launches {per16[tag]} "
              + (f"(float32 {per32[tag]})" if per16[tag] != per32[tag] else "(= float32's)") + (f"; bf16 {ms[tag][0]:.3f} ms, float32 {ms[tag][1]:.3f} ms "
                                  f"({ms[tag][0] / ms[tag][1]:.3f}x)" if tag in ms else "")
              + f"; interior mean |bf16 - float32| {mean_abs(g, w):.5f} px")
    om16 = tune_omega(s1, s2, in_bf16(cfg_s1))
    om32 = tune_omega(s1, s2, cfg_s1)
    require(om16 == tune_omega(s1, s2, plain(in_bf16(cfg_s1))), "tune_omega bf16 cuda != plain")
    print(f"phase 20 tune_omega 1088x1920 a=0.5: bf16 {om16} (= plain), float32 {om32}")

    # -- B8 (S2): SOR i50 below Jacobi i50 in EPE, in bf16 -------------------------------
    t1, t2, gt = t1_pair(dev)
    gtc = interior(gt, 16)

    def flow_epe(f):
        fl = np.stack([f.u.float().cpu().numpy(), f.v.float().cpu().numpy()], axis=-1)
        return epe(interior(fl, 16), gtc)

    s2e = {}
    for tag, c in (("SOR i50", HSConfig(alpha=0.25, iters=50, solver="sor", omega=OMEGA)),
                   ("Jacobi i50", HSConfig(alpha=0.25, iters=50))):
        s2e[tag] = (flow_epe(hs_solve(t1, t2, in_bf16(c))), flow_epe(hs_solve(t1, t2, c)))
    print("phase 20 B8 S2 translation_pair 1088x1920 (0.7, -0.3) a=0.25 interior EPE (bf16, "
          "float32): " + "; ".join(f"{t} {a:.6f}, {b:.6f}" for t, (a, b) in s2e.items()))
    require(s2e["SOR i50"][0] < s2e["Jacobi i50"][0], f"B8: bf16 SOR EPE not below Jacobi: {s2e}")

    # -- B10 (R2): robust's seam band below classic's, in bf16 ---------------------------
    m1, m2, gt2 = t2_pair(dev)
    band = np.zeros((1088, 1920), bool)
    band[8:-8, 1920 // 2 - 8:1920 // 2 + 8] = True
    seam = {}
    for tag, c in (("classic i400", HSConfig(alpha=0.1, iters=400)),
                   ("robust i400", HSConfig(alpha=0.1, iters=400, solver="robust",
                                            robust_eps_s=0.01))):
        fs = [hs_solve(m1, m2, x) for x in (in_bf16(c), c)]
        e = [np.sqrt(((np.stack([f.u.float().cpu().numpy(), f.v.float().cpu().numpy()], -1)
                       - gt2) ** 2).sum(-1))[band].mean() for f in fs]
        seam[tag] = (float(e[0]), float(e[1]))
        if c.solver == "robust":
            exact(names[3], fs[0], hs_solve(m1, m2, plain(in_bf16(c))), "B10 robust vs plain")
    print("phase 20 B10 R2 two_motion_pair 1088x1920 a=0.1 seam-band EPE (bf16, float32): "
          + "; ".join(f"{t} {a:.4f}, {b:.4f}" for t, (a, b) in seam.items()))
    require(seam["robust i400"][0] < seam["classic i400"][0],
            f"B10: bf16 robust seam band not below classic: {seam}")

    # -- B11: S1 through K8 in bf16 = the bf16 K1 + K3 chain ------------------------------
    exact(names[1], f8, sr.hs_solve_resident_sor(b1, b2, 0.5, 50, OMEGA), "B11 K8 vs the chain")
    ms_k8 = (median_ms(lambda: k8.hs_solve_sor_planes(b1, b2, 0.5, 50, OMEGA)),
             median_ms(lambda: k8.hs_solve_sor_planes(s1, s2, 0.5, 50, OMEGA)))
    ms_k8_chain = median_ms(lambda: sr.hs_solve_resident_sor(b1, b2, 0.5, 50, OMEGA))
    ms_k8_plain = median_ms(lambda: sr.hs_solve_resident_sor_plain(b1, b2, 0.5, 50, OMEGA),
                            runs=5)
    print(f"phase 20 B11 S1 through K8 bf16: = the bf16 K1 + K3 chain bitwise; {ms_k8[0]:.4f} ms "
          f"(float32 {ms_k8[1]:.4f}), bf16 chain {ms_k8_chain:.4f} ms, plain {ms_k8_plain:.3f} ms")

    # -- B12: gradients of B7 and B9 = the plain route bitwise ---------------------------
    a, b = s1.clone().requires_grad_(), s2.clone().requires_grad_()
    for tag, c in (("B7", cfg_s1), ("B9", cfg_r1)):
        def g(cfg):
            f = hs_solve(a, b, cfg)
            loss = torch.mean(f.u.float() ** 2) + torch.mean(f.v.float() ** 2)
            return f, torch.autograd.grad(loss, (a, b))

        for k in counters.values():
            k.launches = 0
        f_g, grads = g(in_bf16(c))
        fwd = tuple(k.launches for k in counters.values())
        f_p, grads_p = g(plain(in_bf16(c)))
        require(all(bool(torch.equal(x, y)) for x, y in zip(list(f_g) + list(grads),
                                                             list(f_p) + list(grads_p))),
                f"{tag} bf16 gradient differs from the plain route")
        require(fwd == per16["B7 S1" if tag == "B7" else "B9 R1"],
                f"{tag} bf16 gradient launches {fwd}: the forward's only")
        print(f"phase 20 B12 gradient of {tag} bf16 (d(mean u^2 + mean v^2)/d frames): = the "
              f"plain route bitwise; launches {fwd} (the forward's)")
    del a, b, grads, grads_p, f_g, f_p

    # -- per-kernel times at 1088x1920 and 8 x 1088x1920, bf16 beside float32 ------------
    s3 = k3.sweeps_per_launch(0, tuple(s1.shape), 50, blocks3)
    s4 = k4_plan(dev, tuple(s1.shape), 20)
    t = {}
    for tag, (x, y) in (("1088x1920", (s1, s2)), ("8x1088x1920", (c2a, c2b))):
        for dt in (bf, torch.float32):
            xx, yy = x.to(dt), y.to(dt)
            ex, ey, et, invd = k1.derivatives_plain(xx, yy, 0.5)
            u, v = torch.zeros_like(xx), torch.zeros_like(xx)
            uo, vo = torch.empty_like(xx), torch.empty_like(xx)
            wd, ws = robust.charbonnier_weights(u, v, ex, ey, et, 0.05, 0.05)
            reps = 5 if tag == "1088x1920" else 3

            def plain_k4(uv=(u, v)):
                for _ in range(s4):
                    uv = robust.robust_step(*uv, ex, ey, et, wd, ws, 0.25)
                return uv

            t[tag, dt] = {
                names[0]: (event_ms(lambda: k3.launch_sweeps(u, v, ex, ey, et, invd, uo, vo,
                                                             s3, OMEGA)),
                           event_ms(lambda: k3.sor_sweeps_plain(u, v, ex, ey, et, invd, s3,
                                                                OMEGA), reps=reps)),
                names[2]: (event_ms(lambda: k4.freeze_weights(u, v, ex, ey, et, 0.05, 0.05)),
                           event_ms(lambda: robust.charbonnier_weights(u, v, ex, ey, et, 0.05,
                                                                       0.05), reps=reps)),
                names[3]: (event_ms(lambda: k4.launch_sweeps(u, v, ex, ey, et, wd, ws, uo, vo,
                                                             s4, 0.25)),
                           event_ms(plain_k4, reps=reps)),
            }
    for (tag, dt), d in t.items():
        print(f"phase 20 {tag} {'bf16' if dt == bf else 'float32'} per launch (events): "
              + ", ".join(f"{n} {k:.4f} ms (plain {p:.4f})" for n, (k, p) in d.items())
              + f" (K3 {s3}, K4 {s4} sweeps a launch)")
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")

    def bound2(arrays, flops, px):
        return bound_ms(arrays * 2 * px, flops * px)

    px1, px8 = s1.numel(), c2a.numel()
    per_px = {names[0]: (8, K3_BF16_FLOPS_PER_PX_SWEEP * s3),
              names[2]: (7, K4_FREEZE_BF16_FLOPS_PER_PX),
              names[3]: (9, K4_BF16_FLOPS_PER_PX_SWEEP * s4 + K4_HOISTED_FLOPS_PER_PX)}
    rows = []
    for name, (arrays, flops) in per_px.items():
        b8, by8 = bound2(arrays, flops, px8)
        k = "K3" if name == names[0] else "K4"
        rows.append({"name": name, "route": "cuda",
                     "source": f"opticalflowhs_tpu_torch/csrc/{'sor' if k == 'K3' else 'robust'}.cu",
                     "replaces": BF16_REPLACES[k], "launches": launches[
                         {names[0]: "K3", names[2]: "K4 freeze", names[3]: "K4 sweeps"}[name]],
                     "max_abs_err": err[name],
                     "ms": t["8x1088x1920", bf][name][0], "plain_ms": t["8x1088x1920", bf][name][1],
                     "float32_ms": t["8x1088x1920", torch.float32][name][0],
                     "ms_1088x1920": t["1088x1920", bf][name][0],
                     "plain_ms_1088x1920": t["1088x1920", bf][name][1],
                     "float32_ms_1088x1920": t["1088x1920", torch.float32][name][0],
                     "bound_ms_1088x1920": bound2(arrays, flops, px1)[0],
                     "bound_ms": b8, "bound_by": by8, "library_ms": None,
                     **({"sweeps_per_launch": s3, "geometry": geo["K3"][1]} if k == "K3" and
                        name == names[0] else {}),
                     **({"sweeps_per_launch": s4, "geometry": geo["K4"][1]}
                        if name == names[3] else {})})
    b, by = bound_ms(SOLVE_ARRAYS * 2 * px1,
                     (K1_FIELDS_BF16_FLOPS_PER_PX + 50 * K3_BF16_FLOPS_PER_PX_SWEEP) * px1)
    rows.append({"name": names[1], "route": "cuda",
                 "source": "opticalflowhs_tpu_torch/csrc/sor_planes.cu",
                 "replaces": BF16_REPLACES["K8"], "launches": launches["K8"],
                 "max_abs_err": err[names[1]], "ms": ms_k8[0], "plain_ms": ms_k8_plain,
                 "float32_ms": ms_k8[1], "chain_ms": ms_k8_chain, "shape": [1088, 1920],
                 "bound_ms": b, "bound_by": by, "library_ms": None, "geometry": geo["K8"][0]})
    return rows


def bf16_tvl1_mg_lk_path(dev, c2a, c2b, p1, p2, vid, vid_dev) -> dict:
    """Phase 21: bfloat16 on TV-L1, multigrid and Lucas-Kanade. K5's
    bfloat16 build against its plain bfloat16 twin, max |diff| 0.0, at phase
    12's shapes (67x93, 131x130, 1088x1920; B 1 and 3; iters 1, 7, 30, 100;
    zero and warm; every s and the plan) with the float32 plan's launches,
    and its geometry (float32's s and launches, no spills). Then the cells,
    each beside float32 on the same frames and counted: B13 (T1), B14 (T2's
    seam against classic HS), B15 (T3's stack, flow_stream,
    flow_stream_occlusion and solve_bidirectional with tvl1=), B16 (M1 i1
    and i2 against Jacobi i100 and i1600 in EPE, the multigrid stack and
    pyramid), B17 (LK1, LK3, LK-B, LK-S) and B18 (G3's gradient), each =
    the plain bfloat16 route bitwise (LK, plain torch on both: = the CPU).
    Last, K5 a call of 100 alternations by device time at T1's level
    sizes and 8 x 1080p, bfloat16 beside float32. Returns K5's bfloat16 row
    of the kernels line."""
    from opticalflowhs_tpu_torch import (
        HSConfig,
        LKConfig,
        PyramidConfig,
        TVL1Config,
        flow_stream,
        hs_pyramid,
        hs_solve,
        hs_solve_batched,
        lk_solve,
        lk_solve_batched,
        tvl1_solve,
        tvl1_solve_batched,
    )
    from opticalflowhs_tpu_torch import tvl1 as tv
    from opticalflowhs_tpu_torch.consistency import solve_bidirectional
    from opticalflowhs_tpu_torch.data.synthetic import translation_pair
    from opticalflowhs_tpu_torch.kernels import counted_wrappers
    from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5
    from opticalflowhs_tpu_torch.metrics import epe, interior
    from opticalflowhs_tpu_torch.pyramid import gaussian_pyramid
    from opticalflowhs_tpu_torch.video import flow_stream_occlusion

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    name = "hs_tvl1_inner_bf16"
    err = 0.0

    def exact(got, want, what) -> float:
        got, want = _tensors(got), _tensors(want)
        require(len(got) == len(want), f"{what}: {len(got)} outputs, {len(want)} expected")
        for g in got:
            require(g.dtype in (bf, torch.bool), f"{what}: dtype {g.dtype}")
        d = max(max_diff(g.float(), w.float()) for g, w in zip(got, want))
        require(d == 0.0, f"{what}: max|diff| {d} (bfloat16 equals the plain route bitwise)")
        return d

    cfg0 = TVL1Config(dtype="bfloat16")
    scalars = tv.inner_scalars(cfg0)

    def inner_args(i1, i2, seed):
        """bfloat16 warm (u1, u2) from a seeded normal and the fields of a
        bfloat16 precompute on the pair scaled to [0, 255]."""
        i1, i2 = tv.rescale_pair(i1.to(bf), i2.to(bf))
        rng = np.random.default_rng(seed)
        u1, u2 = (torch.from_numpy(rng.normal(0, 0.5, tuple(i1.shape)).astype(np.float32))
                  .to(dev).to(bf) for _ in range(2))
        return u1, u2, tv.inner_fields(i1, i2, u1, u2, cfg0)

    def pairs(b, h, w, key):
        made = [translation_pair(h, w, 0.7, -0.3, key=key + k) for k in range(b)]
        return tuple(torch.from_numpy(np.stack([m[j] for m in made])).to(dev).squeeze(0)
                     for j in (0, 1))

    # -- K5's bfloat16 build against its plain twin, and its geometry ------------------
    t1, t2, gt_t = t1_pair(dev)
    n_cases = 0
    for b, h, w in ((1, 67, 93), (3, 67, 93), (1, 131, 130), (3, 131, 130), (1, 0, 0)):
        i1, i2 = (t1, t2) if h == 0 else pairs(b, h, w, 60)  # 0: T1's 1088x1920
        u1, u2, fields = inner_args(i1, i2, seed=61)
        for uv in ((u1, u2), (torch.zeros_like(u1),) * 2):
            for iters in (1, 7, 30, 100):
                want = k5.tvl1_inner_plain(*uv, *fields, iters, *scalars)
                for s in range(k5.K5_MAX_ITERS + 1):
                    before = k5.tvl1_inner.launches
                    err = max(err, exact(k5.tvl1_inner(*uv, *fields, iters, *scalars,
                                                       block_iters=s), want,
                                         f"K5 bf16 {tuple(u1.shape)} iters {iters} s {s}"))
                    n = k5.tvl1_inner.launches - before
                    require(n == k5.k5_geometry(dev, s, tuple(u1.shape), iters)["launches"],
                            f"K5 bf16 launches {n}: the float32 plan's")
                    n_cases += 1
    geo = {}
    for shape in ((1088, 1920), (544, 960), (272, 480), (8, 1088, 1920)):
        for s in range(k5.K5_MAX_ITERS + 1):
            g16 = k5.k5_geometry(dev, s, shape, 100, bf)
            g32 = k5.k5_geometry(dev, s, shape, 100)
            require(g16["spill_bytes"] == 0 and g16["blocks_per_sm"] == 1
                    and all(g16[k] == g32[k] for k in g32 if k != "registers"),
                    f"K5 bf16 geometry {g16} against float32's {g32}")
        geo[shape] = k5.k5_geometry(dev, 0, shape, 100, bf)
    g0 = geo[(1088, 1920)]
    print(f"phase 21 K5 bf16 = plain bitwise in {n_cases} calls (67x93, 131x130, 1088x1920; "
          f"B 1 and 3; iters 1/7/30/100; zero and warm; s 0-{k5.K5_MAX_ITERS}), launches = the "
          f"float32 plan's; geometry = float32's s and launches, {g0['registers']} registers, "
          f"{g0['spill_bytes']} spilled bytes; auto s at 1088x1920, 544x960, 272x480, 8x: "
          + ", ".join(str(g["iters_per_launch"]) for g in geo.values()))

    # -- the cells, bf16 beside float32, counted ------------------------------------------
    def in_bf16(c):
        return dataclasses.replace(c, dtype="bfloat16")

    def plain(c):
        return dataclasses.replace(c, backend="torch")

    def mean_abs(a, b):
        fa, fb = _tensors(a), _tensors(b)
        return float(sum((x.float() - y.float()).abs()[..., 8:-8, 8:-8].mean()
                         for x, y in zip(fa[:2], fb[:2])) / 2)

    counters = counted_wrappers()

    def counted(fn):
        before = {n: c.launches for n, c in counters.items()}
        out = fn()
        torch.cuda.synchronize()
        return out, {n: c.launches - before[n] for n, c in counters.items()
                     if c.launches != before[n]}

    pyr3 = PyramidConfig(levels=3)
    small = TVL1Config(warps=2, iters=30)
    m1, m2, gt_m = t2_pair(dev)
    q1, q2, gt_q = m1_pair(dev)
    pa, pb = vid_dev[:4], vid_dev[1:5]
    occ = dict(a=0.0, b=1e-4)
    mg = {n: HSConfig(alpha=1.0, iters=n, solver="multigrid") for n in (1, 2)}
    lk_cfg = LKConfig()
    runs = {
        "B13 T1": (lambda c: tvl1_solve(t1, t2, c, pyr3), TVL1Config()),
        "B14 T2": (lambda c: tvl1_solve(m1, m2, c), TVL1Config()),
        "B15 T3 stack": (lambda c: tvl1_solve_batched(pa, pb, c), small),
        "B15 flow_stream": (lambda c: list(flow_stream(vid, tvl1=c, chunk=8)), small),
        "B15 occlusion": (lambda c: next(flow_stream_occlusion(vid[:9], tvl1=c, chunk=8, **occ)),
                          small),
        "B15 bidirectional": (lambda c: solve_bidirectional(t1, t2, tvl1=c), small),
        "B16 M1 i1": (lambda c: hs_solve(q1, q2, c), mg[1]),
        "B16 M1 i2": (lambda c: hs_solve(q1, q2, c), mg[2]),
        "B16 stack": (lambda c: hs_solve_batched(pa[:2], pb[:2], c), mg[2]),
        "B16 pyramid": (lambda c: hs_pyramid(q1, q2, c, pyr3), mg[2]),
        "B17 LK1": (lambda c: lk_solve(t1, t2, c), lk_cfg),
        "B17 LK3": (lambda c: lk_solve(p1, p2, c, PyramidConfig(levels=3, iters_per_level=())),
                    lk_cfg),
        "B17 LK-B": (lambda c: lk_solve_batched(vid_dev[:8], vid_dev[1:9], c), lk_cfg),
        "B17 LK-S": (lambda c: list(flow_stream(vid, lk=c, chunk=8)), lk_cfg),
    }
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out16, per16 = {}, {}
    for tag, (run, c) in runs.items():
        out16[tag], per16[tag] = counted(lambda: run(in_bf16(c)))
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    print(f"phase 21 path launches (bfloat16: B13-B17): {launches}; per cell {per16}")
    require(launches.get("K5 hs_tvl1_inner", 0) > 0, f"K5's bf16 build never ran: {launches}")
    out32, per32 = {}, {}
    for tag, (run, c) in runs.items():
        out32[tag], per32[tag] = counted(lambda: run(c))
    require(per16 == per32, f"bf16 launches {per16} != float32's {per32}")
    levels = [tuple(a.shape) for a in gaussian_pyramid(t1, pyr3.levels)]
    want_t1 = cfg0.warps * sum(k5.k5_geometry(dev, 0, hw, cfg0.iters)["launches"]
                               for hw in levels)
    require(per16["B13 T1"] == {"K5 hs_tvl1_inner": want_t1},
            f"B13 launches {per16['B13 T1']}, expected K5 {want_t1}")
    for tag in ("B16 M1 i1", "B16 M1 i2", "B16 stack"):
        require(per16[tag] == {"K1 hs_derivatives": 1}, f"{tag} launches {per16[tag]}")
    for tag in ("B17 LK1", "B17 LK3", "B17 LK-B", "B17 LK-S"):
        require(per16[tag] == {}, f"{tag} launched kernels: {per16[tag]}")

    for tag, (run, c) in runs.items():
        for a in _tensors(out16[tag]):
            require(a.dtype in (bf, torch.bool) and bool(torch.isfinite(a.float()).all()),
                    f"{tag} bf16 dtype/finite")
        if tag.startswith("B17"):
            continue
        exact(out16[tag], run(plain(in_bf16(c))), f"{tag} bf16 vs the plain route")
    # LK: plain torch on both devices; LK-B = singles, LK-S = LK-B on each window.
    d_lk = {}
    for tag, args in (("B17 LK1", (t1, t2, in_bf16(lk_cfg))),
                      ("B17 LK3", (p1, p2, in_bf16(lk_cfg),
                                   PyramidConfig(levels=3, iters_per_level=())))):
        cpu = lk_solve(args[0].cpu(), args[1].cpu(), *args[2:])
        d_lk[tag] = max_flow_diff([a.float().cpu() for a in out16[tag]],
                                  [a.float() for a in cpu])
        require(d_lk[tag] <= TOL, f"{tag} bf16 card vs CPU max|diff| {d_lk[tag]}")
    lkb = out16["B17 LK-B"]
    for k in range(8):
        one = lk_solve(vid_dev[k], vid_dev[k + 1], in_bf16(lk_cfg))
        exact((lkb.u[k], lkb.v[k]), one, f"B17 LK-B pair {k} vs lk_solve")
    for k, ch in enumerate(out16["B17 LK-S"]):
        exact(ch, lk_solve_batched(vid_dev[8 * k:8 * k + 8], vid_dev[8 * k + 1:8 * k + 9],
                                   in_bf16(lk_cfg)), f"B17 LK-S chunk {k} vs LK-B")
    for k in range(4):
        exact((out16["B15 T3 stack"].u[k], out16["B15 T3 stack"].v[k]),
              tvl1_solve(pa[k], pb[k], in_bf16(small)), f"B15 stack image {k} vs tvl1_solve")

    ms = {}
    for tag, reps in (("B13 T1", 10), ("B14 T2", 5), ("B15 T3 stack", 5), ("B16 M1 i2", 5),
                      ("B17 LK1", 10)):
        run, c = runs[tag]
        ms[tag] = (median_ms(lambda: run(in_bf16(c)), runs=reps), median_ms(lambda: run(c),
                                                                            runs=reps))
    for tag in runs:
        print(f"phase 21 {tag} bf16: = the {'CPU' if tag in d_lk else 'plain route'} "
              f"{'within ' + format(d_lk[tag], '.3g') if tag in d_lk else 'bitwise'}; "
              f"launches {per16[tag]} (= float32's)"
              + (f"; bf16 {ms[tag][0]:.3f} ms, float32 {ms[tag][1]:.3f} ms "
                 f"({ms[tag][0] / ms[tag][1]:.3f}x)" if tag in ms else "")
              + f"; interior mean |bf16 - float32| {mean_abs(out16[tag], out32[tag]):.5f} px")

    def flow_np(f):
        return np.stack([f.u.float().cpu().numpy(), f.v.float().cpu().numpy()], axis=-1)

    # -- B13 EPE, B14 the seam's ordering, B16 multigrid against Jacobi ------------------
    e_t1 = [epe(interior(flow_np(f), 16), interior(gt_t, 16))
            for f in (out16["B13 T1"], out32["B13 T1"])]
    require(e_t1[0] < 0.1, f"B13 bf16 EPE {e_t1}")
    hm, wm = gt_m.shape[:2]
    band = np.zeros((hm, wm), bool)
    band[8:-8, wm // 2 - 8:wm // 2 + 8] = True

    def band_epe(f):
        return float(np.sqrt(((flow_np(f) - gt_m) ** 2).sum(-1))[band].mean())

    classic = HSConfig(alpha=0.1, iters=400)
    seam = {"TV-L1": (band_epe(out16["B14 T2"]), band_epe(out32["B14 T2"])),
            "classic i400": (band_epe(hs_solve(m1, m2, in_bf16(classic))),
                             band_epe(hs_solve(m1, m2, classic)))}
    require(seam["TV-L1"][0] < seam["classic i400"][0],
            f"B14: bf16 TV-L1 seam band not below classic HS's: {seam}")
    e_mg = {}
    for tag, f16, f32 in (("multigrid i1", out16["B16 M1 i1"], out32["B16 M1 i1"]),
                          ("multigrid i2", out16["B16 M1 i2"], out32["B16 M1 i2"])):
        e_mg[tag] = (epe(interior(flow_np(f16), 16), interior(gt_q, 16)),
                     epe(interior(flow_np(f32), 16), interior(gt_q, 16)))
    for n in (100, 1600):
        c = HSConfig(alpha=1.0, iters=n)
        e_mg[f"Jacobi i{n}"] = tuple(epe(interior(flow_np(hs_solve(q1, q2, x)), 16),
                                         interior(gt_q, 16)) for x in (in_bf16(c), c))
    require(e_mg["multigrid i2"][0] < e_mg["Jacobi i100"][0],
            f"B16: bf16 multigrid i2 EPE not below Jacobi i100's: {e_mg}")
    e_lk = [epe(interior(flow_np(f), 16), interior(gt_t, 16))
            for f in (out16["B17 LK1"], out32["B17 LK1"])]
    print(f"phase 21 EPE (bf16, float32): B13 T1 {e_t1[0]:.6f}, {e_t1[1]:.6f}; B14 seam band "
          + "; ".join(f"{t} {a:.4f}, {b:.4f}" for t, (a, b) in seam.items())
          + "; B16 M1 " + "; ".join(f"{t} {a:.6f}, {b:.6f}" for t, (a, b) in e_mg.items())
          + f"; B17 LK1 {e_lk[0]:.6f}, {e_lk[1]:.6f}")
    del out16, out32

    # -- B18: G3's gradient in bf16 = the plain route bitwise -----------------------------
    a, b = t1.clone().requires_grad_(), t2.clone().requires_grad_()
    tpyr = PyramidConfig(levels=1)

    def g3(cfg):
        f = tvl1_solve(a, b, cfg, tpyr)
        loss = torch.mean(f.u.float() ** 2) + torch.mean(f.v.float() ** 2)
        return f, torch.autograd.grad(loss, (a, b))

    for c in counters.values():
        c.launches = 0
    f_g, grads = g3(cfg0)
    fwd = {n: c.launches for n, c in counters.items() if c.launches}
    f_p, grads_p = g3(plain(cfg0))
    exact([x.detach() for x in f_g], f_p, "B18 G3 bf16 flow vs the plain route")
    require(all(bool(torch.equal(x, y)) for x, y in zip(grads, grads_p)),
            "B18 G3 bf16 gradient differs from the plain route")
    k5_fwd = cfg0.warps * k5.k5_geometry(dev, 0, tuple(t1.shape), cfg0.iters)["launches"]
    require(fwd == {"K5 hs_tvl1_inner": k5_fwd}, f"B18 launches {fwd}: the forward's only")
    print(f"phase 21 B18 G3 bf16 tvl1_solve 1088x1920 1 level, d(mean u^2 + mean v^2)/d frames: "
          f"= the plain route bitwise; launches {fwd} (the forward's)")
    del a, b, grads, grads_p, f_g, f_p

    # -- K5 a call of 100 alternations, bf16 beside float32 ------------------------------
    def per_call(fn, match, launches_per_call):
        """Ms of one call and what measured it: the profiler's device time
        where it saw every launch of the calls, else CUDA events."""
        total, kruns = device_ms(fn, match, reps=5)
        if kruns != 5 * launches_per_call:
            return event_ms(fn, reps=5), "events"
        return total, "device"

    t = {}
    for tag, (i1, i2) in (("1088x1920", (t1, t2)), ("544x960", pairs(1, 544, 960, 44)),
                          ("272x480", pairs(1, 272, 480, 45)), ("8x1088x1920", (c2a, c2b))):
        u1, u2, fields = inner_args(i1, i2, seed=43)
        n_l = k5.k5_geometry(dev, 0, tuple(u1.shape), 100)["launches"]
        w1, w2 = u1.float(), u2.float()
        f32 = [f.float() for f in fields]
        t[tag] = {
            "bf16": per_call(lambda: k5.tvl1_inner(u1, u2, *fields, 100, *scalars),
                             r"tvl1_kernel_bf16", n_l),
            "float32": per_call(lambda: k5.tvl1_inner(w1, w2, *f32, 100, *scalars),
                                r"tvl1_kernel(?!_bf16)", n_l),
            "bf16 events": (event_ms(lambda: k5.tvl1_inner(u1, u2, *fields, 100, *scalars),
                                     reps=5), "events"),
            "plain": (event_ms(lambda: k5.tvl1_inner_plain(u1, u2, *fields, 100, *scalars),
                               reps=1), "events"),
        }
        px = u1.numel()
        b_ms, b_by = bound_ms(K5_CALL_ARRAYS * 2 * px, K5_BF16_OPS_PER_PX_ITER * 100 * px)
        sched = k5_schedule_bytes(k5.k5_geometry(dev, 0, tuple(u1.shape), 100, bf), px, 100,
                                  itemsize=2)
        t[tag]["bound"] = (b_ms, b_by, sched / PEAK_BYTES_PER_S * 1e3)
        print(f"phase 21 K5 {tag} a call of 100 ({n_l} launches): bf16 "
              f"{t[tag]['bf16'][0]:.4f} ms ({t[tag]['bf16'][1]}), float32 "
              f"{t[tag]['float32'][0]:.4f} ms ({t[tag]['float32'][1]}), ratio "
              f"{t[tag]['bf16'][0] / t[tag]['float32'][0]:.3f}; bf16 events "
              f"{t[tag]['bf16 events'][0]:.4f} ms; plain bf16 {t[tag]['plain'][0]:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}), the schedule's bf16 bytes {t[tag]['bound'][2]:.4f} ms")
        del u1, u2, fields, w1, w2, f32
    print(f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    r8, r1 = t["8x1088x1920"], t["1088x1920"]
    return {"name": name, "route": "cuda", "source": "opticalflowhs_tpu_torch/csrc/tvl1.cu",
            "replaces": BF16_REPLACES["K5"], "launches": launches["K5 hs_tvl1_inner"],
            "launches_t1_solve": per16["B13 T1"]["K5 hs_tvl1_inner"], "max_abs_err": err,
            "ms": r8["bf16"][0], "ms_by": r8["bf16"][1], "event_ms": r8["bf16 events"][0],
            "plain_ms": r8["plain"][0], "float32_ms": r8["float32"][0],
            "float32_ms_by": r8["float32"][1], "bound_ms": r8["bound"][0],
            "bound_by": r8["bound"][1], "schedule_bound_ms": r8["bound"][2],
            "library_ms": None, "iters_per_launch": g0["iters_per_launch"], "geometry": g0,
            **{f"{k}_{tag}": v for tag in ("1088x1920", "544x960", "272x480")
               for k, v in (("ms", t[tag]["bf16"][0]), ("float32_ms", t[tag]["float32"][0]),
                            ("plain_ms", t[tag]["plain"][0]), ("bound_ms", t[tag]["bound"][0]),
                            ("schedule_bound_ms", t[tag]["bound"][2]))},
            "t1_ms": ms["B13 T1"][0], "t1_float32_ms": ms["B13 T1"][1]}


def bf16_dist_path(dev, pair, stack) -> list:
    """Phase 22: bfloat16 on the tiled solver (dist/). The bfloat16 builds of
    K9 (Jacobi and SOR), K10, K11 and K12 against their plain bfloat16
    twins, max |diff| 0.0: K9 at phase 15's shapes and a 16-byte one
    (origins at the four corners of a 300x400 image and inside it, single
    and a stack, true edges at K2's warp and lane boundaries, odd widths,
    every s to the plan), K10 on rings of 1-4 shards and at config 5's 4 x
    540x3840, halo 5, K11 and K12 on virtual meshes of cuda:0 (1x1, 2x1,
    4x1, 2x2, 1x4) at n 1, 7 and 100, zero and warm, s 1-8; their geometry
    (float32's tile and s, no spills); the refusal of frames that require
    grad. Then config 5 at 2160x3840 through the entry points, in bfloat16
    beside float32, each counted with the counts set to 0 just before it
    and read just after (equal to float32's) and = the untiled bfloat16
    solve bitwise: D1 (hs_solve_tiled i100, halo_sweeps 4, 4 x 4), D2
    (hs_pyramid_tiled L3), D3 (rdma on 4 x 1 and 2 x 2), D4 (SOR i50) and
    D5 (to tol 1e-3, checked every 4 sweeps). Last, each kernel at config
    5's shapes, bfloat16 beside float32, held against its plain twin there.
    Returns the bfloat16 rows of K9-K12 for the kernels line."""
    from opticalflowhs_tpu_torch import hs_pyramid, hs_solve
    from opticalflowhs_tpu_torch.config import MeshConfig
    from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled, hs_solve_tiled, make_mesh
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import ring
    from opticalflowhs_tpu_torch.kernels import sor as k3
    from opticalflowhs_tpu_torch.kernels import tile as k9

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    names = ("hs_tile_sweeps_bf16", "hs_sor_tile_sweeps_bf16", "hs_ring_halo_exchange_bf16",
             "hs_ring_fused_sweeps_bf16", "hs_ring_fused_sweeps_2d_bf16")
    err = dict.fromkeys(names, 0.0)

    def exact(name, got, want, what):
        for g in got:
            require(g.dtype == bf, f"{what}: dtype {g.dtype}")
        d = max(max_diff(g.float(), w.float()) for g, w in zip(got, want))
        err[name] = max(err[name], d)
        require(d == 0.0, f"{what}: max|diff| {d} (bfloat16 builds equal plain bitwise)")

    def b16(*a):
        return tuple(x.to(bf) for x in a)

    def k9_pair(sor, u0, v0, f, n, rows, cols, h, w, s=0):
        org = k9.origin_table(u0, rows, cols)
        if sor:
            return (k9.sor_tile_sweeps(u0, v0, *f, n, OMEGA, org, h, w, block_sweeps=s),
                    k9.sor_tile_sweeps_plain(u0, v0, *f, n, OMEGA, rows, cols, h, w))
        return (k9.tile_sweeps(u0, v0, *f, n, org, h, w, block_sweeps=s),
                k9.tile_sweeps_plain(u0, v0, *f, n, rows, cols, h, w))

    # -- K9 against its plain twins ----------------------------------------------------
    n_k9 = 0
    for ph, pw in ((67, 93), (131, 130), (70, 248)):
        corners = [(-4, -3), (-3, 400 - pw + 5), (300 - ph + 3, -5),
                   (300 - ph + 4, 400 - pw + 3), (117, 33)]
        su, sv = b16(*stack(5, ph, pw, seed=450, normal=True))
        sf = k1.derivatives_plain(*b16(*stack(5, ph, pw, seed=451)), 0.5)
        rows, cols = [c[0] for c in corners], [c[1] for c in corners]
        for k, (r0, c0) in enumerate(corners):
            for sor in (False, True):
                got, want = k9_pair(sor, su[k], sv[k], [f[k] for f in sf], 7, r0, c0, 300, 400)
                exact(names[sor], got, want, f"K9 bf16 {'SOR ' * sor}{ph}x{pw} ({r0}, {c0})")
                n_k9 += 1
        for sor in (False, True):
            for s in ((0, 1, 3, 4, 8) if not sor else (0, 1, 2, 4)):
                got, want = k9_pair(sor, su, sv, sf, 13, rows, cols, 300, 400, s)
                exact(names[sor], got, want, f"K9 bf16 {'SOR ' * sor}stack of 5 {ph}x{pw} s={s}")
                n_k9 += 1
    for s in (1, 3, 4, 8):
        _, _, lh = k2.k2_tile(s)
        for pw in (45, 136):
            rows = [-(k2.K2_WARP_ROWS * m - s) for m in (3, 4)]
            rows += [r - 1 for r in rows] + [r - 2 for r in rows] + [70 - 37 + 2, 70 - 37 + 5]
            cols = [-(k2.K2_LANE_COLS * m - lh) for m in (3, 4)]
            cols += [c - 1 for c in cols] + [c - 3 for c in cols] + [150 - pw + 3, 150 - pw + 4]
            su, sv = b16(*stack(len(rows), 37, pw, seed=454, normal=True))
            sf = k1.derivatives_plain(*b16(*stack(len(rows), 37, pw, seed=455)), 0.5)
            before = k9.tile_sweeps.launches
            got, want = k9_pair(False, su, sv, sf, 2 * s + 1, rows, cols, 70, 150, s)
            require(k9.tile_sweeps.launches - before == 3, "K9 bf16 launches = float32's")
            exact(names[0], got, want, f"K9 bf16 s={s} edges at warp and lane boundaries")
            n_k9 += 1
    print(f"phase 22 K9 bf16 (Jacobi and SOR) = plain bitwise in {n_k9} calls: 67x93, 131x130, "
          "70x248 at the four corners of a 300x400 image and (117, 33), single and a stack "
          "of 5, s 1-8 and the plan (SOR 1, 2, 4 and the plan); 37x45 and 37x136 shards with "
          "true edges at K2's warp and lane boundaries, s 1, 3, 4, 8")

    # -- K10, K11 and K12 against their plain twins ---------------------------------
    for my in (1, 2, 4):
        for w in (40, 37):
            tiles = [b16(t)[0] for t in
                     stack(my, 12, w, seed=460 + my, normal=True)[0].unbind(0)]
            for halo in (1, 5, 12):
                before = ring.ring_halo_exchange.launches
                got = ring.ring_halo_exchange(tiles, halo)
                require(ring.ring_halo_exchange.launches - before == 1, "K10 bf16 one launch")
                exact(names[2], got, ring.ring_halo_exchange_plain(tiles, halo),
                      f"K10 bf16 ring of {my} w={w} halo {halo}")
    n_ring = 0
    for my, mx in ((1, 1), (2, 1), (4, 1), (2, 2), (1, 4)):
        th, tw = 40, 93 if mx == 1 else 50
        h, w = my * th - 3, mx * tw - (0 if mx == 1 else 5)
        for n, ss in ((1, (1,)), (7, range(1, 9)), (100, (4, 8))):
            for s in ss:
                gu, gv, gf, go = _ring_inputs(dev, my, mx, th, tw, 8, 470 + n + s, h, w)
                gf = [[b16(*f) for f in row] for row in gf]
                for warm in (True, False):
                    gu = [[b16(a)[0] if warm else torch.zeros_like(a, dtype=bf) for a in row]
                          for row in gu]
                    gv = [[b16(a)[0] if warm else torch.zeros_like(a, dtype=bf) for a in row]
                          for row in gv]
                    if mx == 1:
                        args = ([r[0] for r in gu], [r[0] for r in gv], [r[0] for r in gf], n,
                                s, [o[0][0] for o in go], h, w)
                        got, want = ring.ring_fused_sweeps(*args), ring.ring_fused_sweeps_plain(*args)
                        name = names[3]
                    else:
                        args = (gu, gv, gf, n, s, go, h, w)
                        got = ring.ring_fused_sweeps_2d(*args)
                        want = ring.ring_fused_sweeps_2d_plain(*args)
                        got = ([a for row in got[0] for a in row], [a for row in got[1] for a in row])
                        want = ([a for row in want[0] for a in row],
                                [a for row in want[1] for a in row])
                        name = names[4]
                    exact(name, got[0] + got[1], want[0] + want[1],
                          f"{'K11' if mx == 1 else 'K12'} bf16 {my}x{mx} n={n} s={s} warm={warm}")
                    n_ring += 1
    print(f"phase 22 K10 bf16 rings of 1, 2, 4 (w 40 and 37, halo 1, 5, 12) and K11/K12 bf16 "
          f"on virtual meshes 1x1, 2x1, 4x1, 2x2, 1x4 (n 1; 7 at s 1-8; 100 at s 4 and 8; "
          f"zero and warm; {n_ring} solves) = plain bitwise")

    # -- geometry: float32's tile and s, no spills ---------------------------------
    geo = {}
    for s in (1, 4, 8):
        for tag, f32, g16 in (
                ("K9", k2.k2_geometry(dev, s, shard=True), k2.k2_geometry(dev, s, True, bf)),
                ("K11", ring.ring_geometry(dev, s), ring.ring_geometry(dev, s, dtype=bf)),
                ("K12", ring.ring_geometry(dev, s, True), ring.ring_geometry(dev, s, True, bf))):
            require((g16["tile_h"], g16["tile_w"]) == (f32["tile_h"], f32["tile_w"])
                    and g16["spill_bytes"] == 0 and g16["smem_bytes"] == f32["smem_bytes"] // 2,
                    f"{tag} bf16 geometry {g16} against float32's {f32}")
            geo[tag, s] = g16
        g16, f32 = k3.k3_geometry(dev, s, True, bf), k3.k3_geometry(dev, s, True)
        require((g16["tile_h"], g16["tile_w"]) == (f32["tile_h"], f32["tile_w"])
                and g16["spill_bytes"] == 0, f"K9 SOR bf16 geometry {g16} against {f32}")
        geo["K9 SOR", s] = g16
    print("phase 22 bf16 geometry (float32's tile, no spills) at s 4: "
          + "; ".join(f"{t} {geo[t, 4]}" for t in ("K9", "K9 SOR", "K11", "K12")))

    # -- frames that require grad are refused, in bfloat16 too --------------------------
    su, sv = b16(*stack(2, 40, 56, seed=480, normal=True))
    sf = k1.derivatives_plain(*b16(*stack(2, 40, 56, seed=481)), 0.5)
    org = k9.origin_table(su, [-3, 20], [-3, 0])
    rings = {}
    for mx, seed in ((1, 482), (2, 483)):
        gu, gv, gf, go = _ring_inputs(dev, 2, mx, 20, 56 // mx, 4, seed, 40, 56)
        rings[mx] = ([[b16(a)[0] for a in row] for row in gu],
                     [[b16(a)[0] for a in row] for row in gv],
                     [[b16(*f) for f in row] for row in gf], go)
    (u1, v1, f1, _), (u2, v2, f2, o2) = rings[1], rings[2]
    refusals = {
        "K9": (su, lambda a: k9.tile_sweeps(a, sv, *sf, 3, org, 60, 56)),
        "K9 SOR": (su, lambda a: k9.sor_tile_sweeps(a, sv, *sf, 3, OMEGA, org, 60, 56)),
        "K10": (sv[0], lambda a: ring.ring_halo_exchange([a, sv[1]], 2)),
        "K11": (u1[0][0], lambda a: ring.ring_fused_sweeps(
            [a, u1[1][0]], [r[0] for r in v1], [r[0] for r in f1], 4, 4, [0, 20], 40, 56)),
        "K12": (u2[0][0], lambda a: ring.ring_fused_sweeps_2d(
            [[a, u2[0][1]], u2[1]], v2, f2, 4, 4, o2, 40, 56))}
    for tag, (base, call) in refusals.items():
        try:
            call(base.clone().requires_grad_())
        except RuntimeError as e:
            require("does not differentiate" in str(e), f"{tag} grad refusal: {e}")
        else:
            require(False, f"{tag} bf16 on frames that require grad was not refused")
    print("phase 22 K9, K9 SOR, K10, K11 and K12 in bf16 refuse frames that require grad")

    # -- config 5 in bfloat16 through dist/, counted -----------------------------------
    cfg5, pyr5, mcfg = c5_configs()
    s5 = mcfg.halo_sweeps
    q1, q2 = pair
    H, W = q1.shape
    m44 = make_mesh(mcfg, [dev] * 16)
    m41 = make_mesh(MeshConfig(y=4, x=1), [dev] * 4)
    m22 = make_mesh(MeshConfig(y=2, x=2), [dev] * 4)
    counters = {"K9": k9.tile_sweeps, "K9 SOR": k9.sor_tile_sweeps,
                "K10": ring.ring_halo_exchange, "K11": ring.ring_fused_sweeps,
                "K12": ring.ring_fused_sweeps_2d}

    def cfgs(dtype):
        c = dataclasses.replace(cfg5, dtype=dtype)
        return {"D1": c, "D2": c, "D3 4x1": c, "D3 2x2": c,
                "D4": dataclasses.replace(c, solver="sor", omega=OMEGA, iters=50),
                "D5": dataclasses.replace(c, tol=1e-3, block_sweeps=s5)}

    def tiled(tag, c):
        if tag == "D2":
            return hs_pyramid_tiled(q1, q2, c, pyr5, m44, halo_sweeps=s5)
        mesh, impl = {"D3 4x1": (m41, "rdma"), "D3 2x2": (m22, "rdma")}.get(tag, (m44, "ppermute"))
        return hs_solve_tiled(q1, q2, c, mesh, halo_sweeps=s5, halo_impl=impl)

    def untiled(tag, c):
        return hs_pyramid(q1, q2, c, pyr5) if tag == "D2" else hs_solve(q1, q2, c)

    per_call, out, launches = {}, {}, dict.fromkeys(counters, 0)
    for dtype in ("float32", "bfloat16"):
        for tag, c in cfgs(dtype).items():
            torch.cuda.synchronize()
            for k in counters.values():
                k.launches = 0
            out[tag, dtype] = tiled(tag, c)
            torch.cuda.synchronize()
            per_call[tag, dtype] = {n: k.launches for n, k in counters.items()}
            if dtype == "bfloat16":
                for n in counters:
                    launches[n] += per_call[tag, dtype][n]
    for tag, c in cfgs("bfloat16").items():
        f16, f32 = out[tag, "bfloat16"], out[tag, "float32"]
        require(all(a.dtype == bf and tuple(a.shape) == (H, W) and bool(torch.isfinite(a).all())
                    for a in f16), f"{tag} bf16 output dtype/shape/finite")
        require(per_call[tag, "bfloat16"] == per_call[tag, "float32"]
                and sum(per_call[tag, "bfloat16"].values()) > 0,
                f"{tag} launches bf16 {per_call[tag, 'bfloat16']} float32 "
                f"{per_call[tag, 'float32']}")
        want = untiled(tag, c)
        name = {"D3 4x1": names[3], "D3 2x2": names[4], "D4": names[1]}.get(tag, names[0])
        exact(name, f16, want, f"{tag} bf16 tiled vs the untiled bf16 solve")
    require(all(v > 0 for n, v in launches.items() if n != "K10"),
            f"a bf16 kernel of the tiled path never ran: {launches}")
    shards41 = [b16(q1[i * (H // 4):(i + 1) * (H // 4)].contiguous())[0] for i in range(4)]
    ring.ring_halo_exchange.launches = 0
    x10 = ring.ring_halo_exchange(shards41, s5 + 1)
    launches["K10"] = ring.ring_halo_exchange.launches
    exact(names[2], x10, ring.ring_halo_exchange_plain(shards41, s5 + 1),
          "K10 bf16 on config 5's 4 x 1 frame shards")
    d32 = {tag: max(float((a.float() - b).abs().max()) for a, b in
                    zip(out[tag, "bfloat16"], out[tag, "float32"])) for tag in cfgs("float32")}
    mean32 = {tag: max(float((a.float() - b).abs().mean()) for a, b in
                       zip(out[tag, "bfloat16"], out[tag, "float32"])) for tag in cfgs("float32")}
    ms = {(tag, dtype): median_ms(lambda: tiled(tag, c), runs=5)
          for dtype in ("float32", "bfloat16") for tag, c in cfgs(dtype).items()}
    out.clear()
    print(f"phase 22 config 5 {H}x{W} bf16 through dist/ (virtual meshes on cuda:0): D1-D5 = "
          f"the untiled bf16 solve bitwise; launches = float32's "
          f"{ {t: per_call[t, 'bfloat16'] for t in cfgs('float32')} }; |bf16 - float32| max px "
          f"{d32}, mean px {mean32}; ms (median of 5, bf16 / float32) "
          f"{ {t: (round(ms[t, 'bfloat16'], 3), round(ms[t, 'float32'], 3)) for t in cfgs('float32')} }")

    # -- per-kernel times at config 5's shapes, bf16 beside float32, = plain --------------
    hw = s5
    th, tw = H // 4, W // 4
    ph, pw = th + 2 * hw, tw + 2 * hw
    su, sv = b16(*stack(16, ph, pw, seed=490, normal=True))
    sf = k1.derivatives_plain(*b16(*stack(16, ph, pw, seed=491)), 1.0)
    rows = [i * th - hw for i in range(4) for _ in range(4)]
    cols = [j * tw - hw for _ in range(4) for j in range(4)]
    org = k9.origin_table(su, rows, cols)
    ph_s, pw_s = th + 8 * hw, tw + 8 * hw
    tu, tv = b16(*stack(16, ph_s, pw_s, seed=492, normal=True))
    tf = k1.derivatives_plain(*b16(*stack(16, ph_s, pw_s, seed=493)), 1.0)
    rows_s, cols_s = [r - 3 * hw for r in rows], [c - 3 * hw for c in cols]
    org_s = k9.origin_table(tu, rows_s, cols_s)

    def ring16(g):
        return ([[b16(a)[0] for a in row] for row in g[0]],
                [[b16(a)[0] for a in row] for row in g[1]],
                [[b16(*f) for f in row] for row in g[2]], g[3])

    g41 = ring16(_ring_inputs(dev, 4, 1, th, W, hw, 494, H, W))
    g22 = ring16(_ring_inputs(dev, 2, 2, H // 2, W // 2, hw, 495, H, W))
    a41 = ([r[0] for r in g41[0]], [r[0] for r in g41[1]], [r[0] for r in g41[2]], 100, hw,
           [o[0][0] for o in g41[3]], H, W)
    a22 = (*g22[:3], 100, hw, g22[3], H, W)

    def wide(args):
        """The same call on the float32 values of its bfloat16 arrays."""
        def f(x):
            if torch.is_tensor(x):
                return x.float()
            if isinstance(x, (list, tuple)):
                return type(x)(f(y) for y in x)
            return x
        return f(args)

    kept = {}

    def keep(key, fn):
        def run():
            kept[key] = fn()
        return run

    w9, w9s, w41, w22 = wide((su, sv, sf)), wide((tu, tv, tf)), wide(a41), wide(a22)
    calls = {
        names[0]: (lambda: k9.tile_sweeps(su, sv, *sf, hw, org, H, W),
                   lambda: k9.tile_sweeps(w9[0], w9[1], *w9[2], hw, org, H, W), 20,
                   lambda: k9.tile_sweeps_plain(su, sv, *sf, hw, rows, cols, H, W), 2),
        names[1]: (lambda: k9.sor_tile_sweeps(tu, tv, *tf, hw, OMEGA, org_s, H, W),
                   lambda: k9.sor_tile_sweeps(w9s[0], w9s[1], *w9s[2], hw, OMEGA, org_s, H, W),
                   20,
                   lambda: k9.sor_tile_sweeps_plain(tu, tv, *tf, hw, OMEGA, rows_s, cols_s, H, W),
                   2),
        names[3]: (lambda: ring.ring_fused_sweeps(*a41),
                   lambda: ring.ring_fused_sweeps(*w41), 5,
                   lambda: ring.ring_fused_sweeps_plain(*a41), 1),
        names[4]: (lambda: ring.ring_fused_sweeps_2d(*a22),
                   lambda: ring.ring_fused_sweeps_2d(*w22), 5,
                   lambda: ring.ring_fused_sweeps_2d_plain(*a22), 1),
    }
    timing = {}
    for name, (fk, f32, rk, fp, rp) in calls.items():
        timing[name] = (event_ms(keep((name, "cuda"), fk), reps=rk), event_ms(f32, reps=rk),
                        event_ms(keep((name, "plain"), fp), reps=rp))
        exact(name, _tensors(kept[name, "cuda"]), _tensors(kept[name, "plain"]),
              f"{name} at config 5's shapes")
        kept.clear()
    # K10 by its device time beside float32's and a copy_ of the same bytes.
    def one_kernel_ms(fn, match):
        """Device time a call of fn, which launches one kernel matching
        `match` (the profiler over 20 calls), asked again while the
        profiler misses some of them; CUDA events over the calls (the
        wrapper's host time too), so labelled, if it keeps missing them."""
        for _ in range(3):
            t, runs = device_ms(fn, match)
            if runs == 20:
                return t, "device time (profiler)"
        return event_ms(fn), "events (the profiler missed launches)"

    shards32 = [s.float() for s in shards41]
    k10_ms, k10_by = one_kernel_ms(lambda: ring.ring_halo_exchange(shards41, hw + 1),
                                   "halo_kernel_bf16")
    k10_32, k10_32_by = one_kernel_ms(lambda: ring.ring_halo_exchange(shards32, hw + 1),
                                      r"halo_kernel(?!_bf16)")
    k10_plain = event_ms(lambda: ring.ring_halo_exchange_plain(shards41, hw + 1))
    yard_src = torch.zeros((4, th + hw + 1, W), device=dev, dtype=bf)
    yard_dst = torch.empty_like(yard_src)
    copy_dev_ms, copy_by = one_kernel_ms(lambda: yard_dst.copy_(yard_src), "")
    timing[names[2]] = (k10_ms, k10_32, k10_plain)
    # A sweep block of K11 and K12 beside a bf16 K9 launch of the same sweeps.
    n_blk = -(-100 // hw)
    half = n_blk // 2
    half41 = a41[:3] + (half * hw,) + a41[4:]
    half22 = a22[:3] + (half * hw,) + a22[4:]
    block_of = {names[3]: (timing[names[3]][0] - event_ms(
                    lambda: ring.ring_fused_sweeps(*half41), reps=5)) / (n_blk - half),
                names[4]: (timing[names[4]][0] - event_ms(
                    lambda: ring.ring_fused_sweeps_2d(*half22), reps=5)) / (n_blk - half)}
    px9, px9s = 16 * ph * pw, 16 * ph_s * pw_s
    owned = H * W
    ext41 = 4 * (th + 2 * hw) * W
    ext22 = 4 * (H // 2 + 2 * hw) * (W // 2 + 2 * hw)
    bounds = {
        names[0]: bound_ms(SWEEP_BLOCK_ARRAYS * 2 * px9, K2_BF16_FLOPS_PER_PX_SWEEP * hw * px9),
        names[1]: bound_ms(SWEEP_BLOCK_ARRAYS * 2 * px9s, K3_BF16_FLOPS_PER_PX_SWEEP * hw * px9s),
        names[2]: bound_ms(2 * (2 * owned + 4 * 2 * (hw + 1) * W), 0),
        names[3]: bound_ms(2 * (4 * ext41 + 4 * owned), K2_BF16_FLOPS_PER_PX_SWEEP * 100 * owned),
        names[4]: bound_ms(2 * (4 * ext22 + 4 * owned), K2_BF16_FLOPS_PER_PX_SWEEP * 100 * owned),
    }
    schedule_ms = {n: n_blk * SWEEP_BLOCK_ARRAYS * 2 * ext / PEAK_BYTES_PER_S * 1e3
                   for n, ext in ((names[3], ext41), (names[4], ext22))}
    extra = {
        names[0]: {"shape": [16, ph, pw], "sweeps_per_launch": hw,
                   "launches_per_D1_solve": per_call["D1", "bfloat16"]["K9"],
                   "geometry": geo["K9", hw]},
        names[1]: {"shape": [16, ph_s, pw_s], "sweeps_per_launch": hw,
                   "launches_per_D4_solve": per_call["D4", "bfloat16"]["K9 SOR"],
                   "geometry": geo["K9 SOR", hw]},
        names[2]: {"shards": [4, th, W], "halo": hw + 1, "ms_is": k10_by,
                   "float32_ms_is": k10_32_by, "copy_ms": copy_dev_ms, "copy_ms_is": copy_by},
        names[3]: {"mesh": [4, 1], "n": 100, "s": hw, "block_ms": block_of[names[3]],
                   "schedule_bound_ms": schedule_ms[names[3]], "geometry": geo["K11", hw]},
        names[4]: {"mesh": [2, 2], "n": 100, "s": hw, "block_ms": block_of[names[4]],
                   "schedule_bound_ms": schedule_ms[names[4]], "geometry": geo["K12", hw]},
    }
    for name in names:
        t16, t32, tp = timing[name]
        print(f"kernel {name}: {t16:.4f} ms per call, float32 {t32:.4f} ms (ratio "
              f"{t16 / t32:.3f}), plain {tp:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}) {extra[name]}")
    print(f"phase 22 a bf16 sweep block of {hw} at config 5's shapes: K11 4 x 1 "
          f"{block_of[names[3]]:.4f} ms, K12 2 x 2 {block_of[names[4]]:.4f} ms; a bf16 K9 "
          f"launch of {hw} over 16 x {ph}x{pw} {timing[names[0]][0]:.4f} ms")
    print(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    source = dict(zip(names, ("jacobi.cu", "sor.cu", "ring.cu", "ring.cu", "ring.cu")))
    key = dict(zip(names, ("K9", "K9 SOR", "K10", "K11", "K12")))
    return [{"name": n, "route": "cuda", "source": f"opticalflowhs_tpu_torch/csrc/{source[n]}",
             "replaces": BF16_REPLACES[key[n]], "launches": launches[key[n]],
             "max_abs_err": err[n], "ms": timing[n][0], "float32_ms": timing[n][1],
             "plain_ms": timing[n][2], "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
             "library_ms": None, **extra[n]} for n in names]


def dist_gspmd_path(dev, pair, c2a, c2b, vid) -> dict:
    """Phase 23: the rest of dist/, which adds no kernel. The reference's
    GSPMD routes run as data parallelism over the mesh's batch axis, each
    group through the untiled entry on its first device (dist/gspmd.py),
    and dist/reshard.py moves frames between layouts. Each route, in
    float32 and then bfloat16, is counted (every counter set to 0 just
    before it and read just after), held bitwise against its untiled
    counterpart with that counterpart's K1, K4 and K5 launches (for a stack
    split into groups: the untiled entry on each group's pairs; for the
    spatial consistency of LK and TV-L1: the untiled entry once a
    direction), and timed beside it (median of 5, synced). Returns the
    route's K1, K4 and K5 launch totals."""
    from opticalflowhs_tpu_torch import (
        HSConfig,
        LKConfig,
        PyramidConfig,
        TVL1Config,
        flow_stream,
        flow_with_occlusion,
        hs_pyramid,
        hs_solve,
        hs_solve_batched,
        lk_solve,
        tvl1_solve,
    )
    from opticalflowhs_tpu_torch.config import MeshConfig
    import opticalflowhs_tpu_torch.dist.reshard as rs
    from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled, hs_solve_tiled, make_mesh
    from opticalflowhs_tpu_torch.egomotion import estimate_egomotion
    from opticalflowhs_tpu_torch.kernels import counted_wrappers
    from opticalflowhs_tpu_torch.lucas_kanade import lk_solve_tiled
    from opticalflowhs_tpu_torch.metrics import hs_energy
    from opticalflowhs_tpu_torch.solver import Flow
    from opticalflowhs_tpu_torch.tvl1 import tvl1_solve_tiled
    from opticalflowhs_tpu_torch.video import flow_stream_occlusion

    t_phase = time.perf_counter()
    hs5, pyr5, mcfg = c5_configs()
    i1, i2 = pair
    m44 = make_mesh(mcfg, [dev] * 16)
    m22 = make_mesh(MeshConfig(y=2, x=2), [dev] * 4)
    m411 = make_mesh(MeshConfig(batch=4), [dev] * 4)
    m211 = make_mesh(MeshConfig(batch=2), [dev] * 2)
    m222 = make_mesh(MeshConfig(batch=2, y=2, x=2), [dev] * 8)
    wrappers = counted_wrappers()
    names = ("K1 hs_derivatives", "K4 hs_robust_freeze", "K4 hs_robust_sweeps", "K5 hs_tvl1_inner")
    totals = dict.fromkeys(names, 0)

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, tuple(wrappers[n].launches for n in names), {
            n: w.launches for n, w in wrappers.items() if w.launches}

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for item in x for t in tensors(item)]

    def route(tag, fn, untiled, count_ref=None, expect=None, compare=True):
        """Run, count and time one route beside its untiled counterpart:
        equal bitwise, its K1/K4/K5 launches = the counterpart's (or
        count_ref's) unless compare is False, and `expect` of all its
        launches true."""
        got, n_got, all_got = counted(fn)
        want, n_want, _ = counted(untiled)
        if count_ref is not None:
            _, n_want, _ = counted(count_ref)
        a, b = tensors(got), tensors(want)
        require(len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                         for x, y in zip(a, b)),
                f"{tag}: the route differs from its untiled entry")
        require(all(bool(torch.isfinite(x).all()) for x in a if x.is_floating_point()),
                f"{tag}: non-finite flow")
        if compare:
            require(n_got == n_want, f"{tag}: launches {n_got}, untiled {n_want}")
        if expect is not None:
            require(expect(all_got), f"{tag}: launches {all_got}")
        for n, k in zip(names, n_got):
            totals[n] += k
        ms_r = median_ms(fn, runs=5)
        ms_u = median_ms(untiled, runs=5)
        print(f"phase 23 {tag}: = untiled bitwise; launches K1/K4 freeze/K4 sweeps/K5 "
              f"{n_got} (untiled {n_want}; all {all_got}); {ms_r:.3f} ms, untiled "
              f"{ms_u:.3f} ms ({ms_r / ms_u:.3f}x)")
        return got

    robust5 = dict(solver="robust", alpha=1.0, iters=100, robust_update_every=20)
    mg5 = dict(solver="multigrid", alpha=1.0, iters=2)
    occ_pair = (torch.from_numpy(vid[0]).to(dev), torch.from_numpy(vid[1]).to(dev))
    for dtype in ("float32", "bfloat16"):
        bf = f" {dtype}"
        # D6, D7: config 5's pair on its virtual 4 x 4 mesh.
        for tag, kw in (("D6 robust i100 k20", robust5),
                        ("D6 robust to tol 1e-3", dict(robust5, tol=1e-3)),
                        ("D7 multigrid i2", mg5)):
            cfg = HSConfig(dtype=dtype, **kw)
            route(f"{tag} 2160x3840 4x4{bf}",
                  lambda: hs_solve_tiled(i1, i2, cfg, m44, halo_sweeps=mcfg.halo_sweeps),
                  lambda: hs_solve(i1, i2, cfg), expect=lambda c: c.get("K1 hs_derivatives") == 1)
        # D8: the tiled pyramid with robust and multigrid levels.
        for tag, kw in (("robust", robust5), ("multigrid", mg5)):
            cfg = HSConfig(dtype=dtype, **kw)
            route(f"D8 hs_pyramid_tiled L3 {tag} 2160x3840 4x4{bf}",
                  lambda: hs_pyramid_tiled(i1, i2, cfg, pyr5, m44, mcfg.halo_sweeps),
                  lambda: hs_pyramid(i1, i2, cfg, pyr5), expect=lambda c: c.get(
                      "K1 hs_derivatives") == pyr5.levels)
        # D9: TV-L1 and LK, L3, on a 2 x 2 mesh.
        p3 = PyramidConfig(levels=3, iters_per_level=())
        tcfg, lcfg = TVL1Config(dtype=dtype), LKConfig(dtype=dtype)
        route(f"D9 tvl1_solve_tiled L3 2160x3840 2x2{bf}",
              lambda: tvl1_solve_tiled(i1, i2, tcfg, p3, mesh=m22),
              lambda: tvl1_solve(i1, i2, tcfg, p3), expect=lambda c: c.get("K5 hs_tvl1_inner", 0) > 0)
        route(f"D9 lk_solve_tiled L3 2160x3840 2x2{bf}",
              lambda: lk_solve_tiled(i1, i2, lcfg, p3, mesh=m22),
              lambda: lk_solve(i1, i2, lcfg, p3), expect=lambda c: not c)
        # DP: C2's stack split over a (4, 1, 1) mesh; counts against the
        # untiled entry on each group's two pairs.
        for tag, kw in (("Jacobi i100", dict(alpha=1.0, iters=100)), ("robust i100 k20", robust5),
                        ("multigrid i2", mg5)):
            cfg = HSConfig(dtype=dtype, **kw)
            route(f"DP hs_solve_batched(mesh=) 8x1088x1920 {tag} (4,1,1){bf}",
                  lambda: hs_solve_batched(c2a, c2b, cfg, mesh=m411),
                  lambda: hs_solve_batched(c2a, c2b, cfg),
                  count_ref=lambda: [hs_solve_batched(c2a[g:g + 2], c2b[g:g + 2], cfg)
                                     for g in range(0, 8, 2)],
                  expect=lambda c: c.get("K1 hs_derivatives") == 4)
        cfg4 = dataclasses.replace(cell_config("c4_hd_streaming.json"), dtype=dtype)

        def stream_groups(fn):
            """The untiled entry on each group's pairs of each window."""
            def run():
                out = []
                for s in range(0, vid.shape[0] - 1, 8):
                    cur = torch.from_numpy(vid[s:s + 9]).to(dev)
                    a, b = fn(cur)
                    k = a.shape[0] // 2
                    out += [hs_solve_batched(a[g * k:(g + 1) * k], b[g * k:(g + 1) * k], cfg4)
                            for g in range(2)]
                return out
            return run

        route(f"DP flow_stream(mesh=) C4 17 frames chunk 8 (2,1,1){bf}",
              lambda: list(flow_stream(vid, cfg4, chunk=8, mesh=m211)),
              lambda: list(flow_stream(vid, cfg4, chunk=8)),
              count_ref=stream_groups(lambda c: (c[:-1], c[1:])))
        route(f"DP flow_stream_occlusion(mesh=) C4 17 frames chunk 8 (2,1,1){bf}",
              lambda: list(flow_stream_occlusion(vid, cfg4, chunk=8, mesh=m211)),
              lambda: list(flow_stream_occlusion(vid, cfg4, chunk=8)),
              count_ref=stream_groups(lambda c: (torch.cat([c[:-1], c[1:]]),
                                                 torch.cat([c[1:], c[:-1]]))))
        # flow_with_occlusion on a 2 x 2 mesh: HS through one batch-2 tiled
        # solve (K9, the derivatives in plain torch: its launches are K9's,
        # not the untiled K1 + K2's), LK and TV-L1 through their tiled
        # entries once a direction.
        route(f"DP flow_with_occlusion hs 1080x1920 2x2{bf}",
              lambda: flow_with_occlusion(*occ_pair, cfg4, mesh=m22, halo_sweeps=4),
              lambda: flow_with_occlusion(*occ_pair, cfg4), compare=False,
              expect=lambda c: c.get("K9 hs_tile_sweeps", 0) > 0 and "K2 hs_jacobi_sweeps" not in c)
        for fam, fcfg, untiled in (("lk", lcfg, lk_solve), ("tvl1", tcfg, tvl1_solve)):
            one = PyramidConfig(levels=1, iters_per_level=())
            route(f"DP flow_with_occlusion {fam} 1080x1920 2x2{bf}",
                  lambda: flow_with_occlusion(*occ_pair, mesh=m22, **{fam: fcfg}),
                  lambda: flow_with_occlusion(*occ_pair, **{fam: fcfg}),
                  count_ref=lambda: (untiled(*occ_pair, fcfg, one),
                                     untiled(occ_pair[1], occ_pair[0], fcfg, one)))

    # Reshard: C4's 17 frames (host numpy) on (2, 2, 2) and (4, 1, 1).
    frames = torch.from_numpy(vid)
    t_tim = rs.shard(frames, m222, rs.TIME)
    torch.cuda.synchronize()
    sp = rs.time_to_space(t_tim, m222)
    back = rs.space_to_time(sp, m222)
    require(torch.equal(sp.gather().cpu(), frames) and torch.equal(back.gather().cpu(), frames),
            "time_to_space / space_to_time round trip")
    require(all(b.device == dev for b in sp.blocks.values()), "reshard blocks on the card")
    ms_ts = median_ms(lambda: rs.time_to_space(t_tim, m222), runs=5)
    ms_st = median_ms(lambda: rs.space_to_time(sp, m222), runs=5)
    ms_g = median_ms(lambda: sp.gather(), runs=5)
    tp = rs.shard(frames, m411, rs.TIME)
    a, b, ok = rs.timesharded_pairs(tp)
    ok = ok.gather()
    whole = frames.to(dev)
    require(int(ok.sum()) == 16 and torch.equal(a.gather()[ok], whole[:-1])
            and torch.equal(b.gather()[ok], whole[1:]), "timesharded_pairs covers the 16 pairs")
    ms_tp = median_ms(lambda: rs.timesharded_pairs(tp), runs=5)
    gb = frames.numel() * 4 / 1e9
    print(f"phase 23 reshard C4 17x1080x1920 on (2,2,2): time_to_space {ms_ts:.3f} ms "
          f"({gb / ms_ts * 1e3:.1f} GB/s), space_to_time {ms_st:.3f} ms, gather {ms_g:.3f} ms; "
          f"round trip = the frames bitwise; timesharded_pairs on (4,1,1) {ms_tp:.3f} ms, "
          f"16 valid pairs = the video's")

    # The sharded sums over D1's 16 shards.
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(hs5, dtype=dtype)
        flow = hs_solve_tiled(i1, i2, cfg, m44, halo_sweeps=mcfg.halo_sweeps)
        spec = ("y", "x")
        su, sv = rs.shard(flow.u, m44, spec), rs.shard(flow.v, m44, spec)
        f1, f2 = rs.shard(i1, m44, spec), rs.shard(i2, m44, spec)
        got = estimate_egomotion(Flow(su, sv), axis_names=spec)
        want = estimate_egomotion(flow)
        d_em = max(abs(float(g) - float(w)) / max(1.0, abs(float(w))) for g, w in zip(got, want))
        require(all(g.dtype == w.dtype for g, w in zip(got, want)), "sharded ego-motion dtypes")
        e_got = hs_energy(f1, f2, Flow(su, sv), alpha=cfg.alpha, axis_names=spec)
        e_want = hs_energy(i1, i2, flow, alpha=cfg.alpha)
        d_e = abs(float(e_got) - float(e_want)) / max(1.0, abs(float(e_want)))
        ms_em = median_ms(lambda: estimate_egomotion(Flow(su, sv), axis_names=spec), runs=5)
        ms_em1 = median_ms(lambda: estimate_egomotion(flow), runs=5)
        ms_e = median_ms(lambda: hs_energy(f1, f2, Flow(su, sv), alpha=cfg.alpha,
                                           axis_names=spec), runs=5)
        ms_e1 = median_ms(lambda: hs_energy(i1, i2, flow, alpha=cfg.alpha), runs=5)
        print(f"phase 23 sums over D1's 16 shards {dtype}: ego-motion max rel diff {d_em:.3g} "
              f"(tx {float(got.tx):.6g} vs {float(want.tx):.6g}), {ms_em:.3f} ms (whole "
              f"{ms_em1:.3f}); hs_energy {float(e_got):.7g} vs {float(e_want):.7g} rel "
              f"{d_e:.3g}, {ms_e:.3f} ms (whole {ms_e1:.3f})")
        require(d_em <= 1e-5 and d_e <= 1e-5, f"sharded sums {dtype}: {d_em} {d_e}")
    print(f"phase 23 launches on its routes: {totals}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from opticalflowhs_tpu_torch import (
        HSConfig,
        PyramidConfig,
        flow_stream,
        flow_stream_warm,
        hs_pyramid,
        hs_solve,
        hs_solve_batched,
    )
    from opticalflowhs_tpu_torch.data.synthetic import WarpSpec, synthetic_pair
    from opticalflowhs_tpu_torch.video import flow_stream_occlusion
    from opticalflowhs_tpu_torch.kernels import _build
    from opticalflowhs_tpu_torch.kernels import derivatives as k1
    from opticalflowhs_tpu_torch.kernels import jacobi as k2
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.metrics import epe, interior

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # -- phase 1: device and build ------------------------------------------
    print(f"phase 1 device: {kind}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(card)
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1 build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(s.name for s in _build.sources())})")

    def frames(h, w, seed):
        rng = np.random.default_rng(seed)
        return tuple(torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32)).to(dev)
                     for _ in range(2))

    err = {"hs_derivatives": 0.0, "hs_jacobi_sweeps": 0.0}

    # -- phase 2: K1 against its plain version --------------------------------
    names = ("ex", "ey", "et", "invd", "u1", "v1")
    for h, w in ((67, 93), (1080, 1920), (1088, 1920)):
        i1, i2 = frames(h, w, seed=1)
        for variant in ("hs_cube", "central"):
            for zero_sweep in (False, True):
                got = k1.hs_derivatives(i1, i2, 0.5, variant, zero_sweep)
                want = k1.derivatives_plain(i1, i2, 0.5, variant, zero_sweep)
                diffs = {n: max_diff(g, r) for n, g, r in zip(names, got, want)}
                worst = max(diffs.values())
                err["hs_derivatives"] = max(err["hs_derivatives"], worst)
                print(f"phase 2 K1 {h}x{w} {variant} zero_sweep={zero_sweep}: "
                      + " ".join(f"{n}={d:.3g}" for n, d in diffs.items()))
                require(worst <= TOL, f"K1 {h}x{w} {variant} max|diff| {worst}")

    # -- phase 3: K2 against its plain version ---------------------------------
    auto = k2.sweeps_per_launch(0)
    for h, w in ((67, 93), (1088, 1920)):
        i1, i2 = frames(h, w, seed=2)
        fields = k1.derivatives_plain(i1, i2, 0.5)
        rng = np.random.default_rng(3)
        u0, v0 = (torch.from_numpy(rng.normal(0, 0.5, (h, w)).astype(np.float32)).to(dev)
                  for _ in range(2))
        for n in (1, 7, 100):
            want = k2.jacobi_sweeps_plain(u0, v0, *fields, n)
            for s in (1, 4, 0):
                got = k2.jacobi_sweeps(u0, v0, *fields, n, block_sweeps=s)
                d = max(max_diff(got[0], want[0]), max_diff(got[1], want[1]))
                err["hs_jacobi_sweeps"] = max(err["hs_jacobi_sweeps"], d)
                print(f"phase 3 K2 {h}x{w} n={n} s={k2.sweeps_per_launch(s)}: "
                      f"max|diff|={d:.3g}")
                require(d <= TOL, f"K2 {h}x{w} n={n} s={s} max|diff| {d}")
        # The whole-solve driver from a warm start and from zero.
        for init in ((u0, v0), (None, None)):
            got = sr.hs_solve_resident(i1, i2, 0.5, 23, "hs_cube", *init)
            want = sr.hs_solve_resident_plain(i1, i2, 0.5, 23, "hs_cube", *init)
            d = max(max_diff(got[0], want[0]), max_diff(got[1], want[1]))
            err["hs_jacobi_sweeps"] = max(err["hs_jacobi_sweeps"], d)
            start = "warm" if init[0] is not None else "zero"
            print(f"phase 3 driver {h}x{w} n=23 {start} start: max|diff|={d:.3g}")
            require(d <= TOL, f"driver {h}x{w} {start} max|diff| {d}")
    # K2 at the edges of its geometry, every sweeps per launch, single frames
    # and stacks of 3, n not divisible by s.
    d_edge = 0.0
    for shape in K2_EDGE_SHAPES:
        for b in (1, 3):
            rng = np.random.default_rng(4)
            full = shape if b == 1 else (b,) + shape
            i1, i2, u0, v0 = (torch.from_numpy(rng.uniform(-1, 1, full).astype(np.float32)).to(dev)
                              for _ in range(4))
            fields = k1.derivatives_plain(i1, i2, 0.5)
            for s in range(1, 13):
                n = 2 * k2.sweeps_per_launch(s) + 1
                got = k2.jacobi_sweeps(u0, v0, *fields, n, block_sweeps=s)
                want = k2.jacobi_sweeps_plain(u0, v0, *fields, n)
                d_edge = max(d_edge, max_diff(got[0], want[0]), max_diff(got[1], want[1]))
    err["hs_jacobi_sweeps"] = max(err["hs_jacobi_sweeps"], d_edge)
    print(f"phase 3 K2 edge shapes {K2_EDGE_SHAPES}, B 1 and 3, s 1-12: max|diff|={d_edge:.3g}")
    require(d_edge <= TOL, f"K2 edge shapes max|diff| {d_edge}")

    # -- the main path, counted -----------------------------------------------
    cfg1 = HSConfig(alpha=0.5, iters=100)               # bench.py headline
    cfg3 = HSConfig(alpha=1.0, iters=100)               # configs/c3_pyramid.json
    pyr3 = PyramidConfig(levels=3)
    s1, s2 = c1_frames(dev)                             # bench.py's frames
    p1, p2 = c3_frames(dev)
    torch.cuda.synchronize()

    k1.hs_derivatives.launches = 0
    k2.jacobi_sweeps.launches = 0
    flow1 = hs_solve(s1, s2, cfg1)
    flow3 = hs_pyramid(p1, p2, cfg3, pyr3)
    torch.cuda.synchronize()
    launches = {"hs_derivatives": k1.hs_derivatives.launches,
                "hs_jacobi_sweeps": k2.jacobi_sweeps.launches}
    print(f"main path launches (hs_solve + hs_pyramid): {launches}")
    require(all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}")

    # -- phase 4: hs_solve at the headline shape ----------------------------
    plain1 = hs_solve(s1, s2, HSConfig(alpha=0.5, iters=100, backend="torch"))
    for a in flow1:
        require(a.shape == (1088, 1920) and bool(torch.isfinite(a).all()),
                "hs_solve output shape/finite")
    du, dv = max_diff(flow1.u, plain1.u), max_diff(flow1.v, plain1.v)
    k1.hs_derivatives.launches = 0
    k2.jacobi_sweeps.launches = 0
    hs_solve(s1, s2, cfg1)
    n1, n2 = k1.hs_derivatives.launches, k2.jacobi_sweeps.launches
    ms_k = median_ms(lambda: hs_solve(s1, s2, cfg1))
    ms_p = median_ms(lambda: hs_solve(s1, s2, HSConfig(alpha=0.5, iters=100,
                                                       backend="torch")))
    print(f"phase 4 hs_solve 1088x1920 a=0.5 i100: max|du|={du:.3g} "
          f"max|dv|={dv:.3g} launches K1={n1} K2={n2} "
          f"kernel {ms_k:.3f} ms plain {ms_p:.3f} ms "
          f"({1088 * 1920 * 100 / ms_k / 1e6:.1f} Gpx*sweeps/s kernel)")
    require(max(du, dv) <= TOL, "hs_solve kernel vs plain")
    require(n1 > 0 and n2 > 0, "hs_solve launch counts")

    # -- phase 5: hs_pyramid at 1080p, then the EPE gate ------------------------
    plain3 = hs_pyramid(p1, p2, HSConfig(alpha=1.0, iters=100, backend="torch"), pyr3)
    for a in flow3:
        require(a.shape == (1080, 1920) and bool(torch.isfinite(a).all()),
                "hs_pyramid output shape/finite")
    du, dv = max_diff(flow3.u, plain3.u), max_diff(flow3.v, plain3.v)
    k1.hs_derivatives.launches = 0
    k2.jacobi_sweeps.launches = 0
    hs_pyramid(p1, p2, cfg3, pyr3)
    n1, n2 = k1.hs_derivatives.launches, k2.jacobi_sweeps.launches
    ms_k3 = median_ms(lambda: hs_pyramid(p1, p2, cfg3, pyr3))
    ms_p3 = median_ms(lambda: hs_pyramid(
        p1, p2, HSConfig(alpha=1.0, iters=100, backend="torch"), pyr3))
    print(f"phase 5 hs_pyramid 1080x1920 levels=3 a=1 i100: max|du|={du:.3g} "
          f"max|dv|={dv:.3g} launches K1={n1} K2={n2} "
          f"kernel {ms_k3:.3f} ms plain {ms_p3:.3f} ms")
    require(max(du, dv) <= TOL, "hs_pyramid kernel vs plain")
    require(n1 > 0 and n2 > 0, "hs_pyramid launch counts")

    g1, g2, gt = synthetic_pair(96, 128, WarpSpec.translation(4.0, 0.0), key=13,
                                max_freq=0.06)
    g1 = torch.from_numpy(g1).to(dev)
    g2 = torch.from_numpy(g2).to(dev)
    cfg = HSConfig(alpha=0.5, iters=300)

    def flow_np(f):
        return np.stack([f.u.cpu().numpy(), f.v.cpu().numpy()], axis=-1)

    e_single = epe(interior(flow_np(hs_solve(g1, g2, cfg)), 10), interior(gt, 10))
    e_pyr = epe(interior(flow_np(hs_pyramid(g1, g2, cfg, PyramidConfig(levels=3))), 10),
                interior(gt, 10))
    print(f"phase 5 EPE gate 96x128 4 px shift: pyramid {e_pyr:.4f} "
          f"single-level {e_single:.4f}")
    require(e_pyr < 0.6 and e_pyr < e_single, "pyramid EPE gate")

    # -- phase 6: batched K1 and K2 against plain and the 2-D kernels -------
    def stack(b, h, w, seed, normal=False):
        rng = np.random.default_rng(seed)
        make = (lambda: rng.normal(0, 0.5, (b, h, w))) if normal else (
            lambda: rng.uniform(0, 1, (b, h, w)))
        return tuple(torch.from_numpy(make().astype(np.float32)).to(dev) for _ in range(2))

    for h, w in ((67, 93), (1088, 1920)):
        for b in (1, 3):
            i1, i2 = stack(b, h, w, seed=20)
            got = k1.hs_derivatives(i1, i2, 1.0, zero_sweep=True)
            want = k1.derivatives_plain(i1, i2, 1.0, zero_sweep=True)
            d1 = max(max_diff(g, r) for g, r in zip(got, want))
            d1s = max(max_diff(g[k], r) for k in range(b)
                      for g, r in zip(got, k1.hs_derivatives(i1[k], i2[k], 1.0,
                                                             zero_sweep=True)))
            fields = got[:4]
            u0, v0 = stack(b, h, w, seed=21, normal=True)
            d2 = d2s = 0.0
            for start in ("warm", "zero"):
                uv = (u0, v0) if start == "warm" else (torch.zeros_like(u0),) * 2
                got2 = k2.jacobi_sweeps_batched(*uv, *fields, 13)
                want2 = k2.jacobi_sweeps_batched_plain(*uv, *fields, 13)
                d2 = max(d2, max_diff(got2[0], want2[0]), max_diff(got2[1], want2[1]))
                for k in range(b):
                    one = k2.jacobi_sweeps(uv[0][k], uv[1][k], *(f[k] for f in fields), 13)
                    d2s = max(d2s, max_diff(got2[0][k], one[0]),
                              max_diff(got2[1][k], one[1]))
            got3 = sr.hs_solve_resident_batched(i1, i2, 1.0, 23)
            want3 = sr.hs_solve_resident_batched_plain(i1, i2, 1.0, 23)
            d3 = max(max_diff(got3[0], want3[0]), max_diff(got3[1], want3[1]))
            err["hs_derivatives"] = max(err["hs_derivatives"], d1, d1s)
            err["hs_jacobi_sweeps"] = max(err["hs_jacobi_sweeps"], d2, d2s, d3)
            print(f"phase 6 batched B={b} {h}x{w}: K1 vs plain {d1:.3g}, vs 2-D {d1s:.3g}; "
                  f"K2 n=13 warm+zero vs plain {d2:.3g}, vs 2-D {d2s:.3g}; "
                  f"whole solve n=23 vs plain {d3:.3g}")
            require(max(d1, d1s, d2, d2s, d3) <= TOL, f"batched kernels B={b} {h}x{w}")

    # -- the batched path (configs 2 and 4), counted ---------------------------
    cfg2 = cell_config("c2_video_batch.json")           # alpha 1, i100
    cfg4 = cell_config("c4_hd_streaming.json")          # alpha 1, i100, s = 8
    cfg4w = dataclasses.replace(cfg4, iters=25)         # the warm stream's budget
    # The default thresholds (a 0.01, b 0.5) flag no pixel of this pan, whose
    # forward-backward error stays below 0.04 px; a 0 and b 1e-4 flag the
    # pixels above 0.01 px (13% at 270x480 and 540x960 on the CPU), so the
    # mask carries information.
    occ = dict(a=0.0, b=1e-4)
    c2a, c2b = c2_stack(dev)
    bsz = c2a.shape[0]
    t0 = time.perf_counter()
    vid, gt_c4 = c4_video()
    print(f"phase 8 video: 17 x 1080x1920 made in {time.perf_counter() - t0:.3f} s (host)")
    vid_dev = torch.from_numpy(vid).to(dev)
    pa, pb = vid_dev[:4], vid_dev[1:5]
    torch.cuda.synchronize()

    k1.hs_derivatives.launches = 0
    k2.jacobi_sweeps.launches = 0
    flow_c2 = hs_solve_batched(c2a, c2b, cfg2)
    n_c2 = (k1.hs_derivatives.launches, k2.jacobi_sweeps.launches)
    flow_p2 = hs_solve_batched(pa, pb, cfg2, pyr3)
    chunks = list(flow_stream(vid, cfg4, chunk=8))
    warm = list(flow_stream_warm(vid, cfg4w, chunk=8, warp_prior=True))
    occ_flow, occ_mask = next(flow_stream_occlusion(vid[:9], cfg4, chunk=8, **occ))
    torch.cuda.synchronize()
    launches_b = {"hs_derivatives": k1.hs_derivatives.launches,
                  "hs_jacobi_sweeps": k2.jacobi_sweeps.launches}
    print(f"batched path launches (C2 + batched pyramid + C4 streams): {launches_b}")
    require(all(n > 0 for n in launches_b.values()), f"a kernel never ran: {launches_b}")

    # -- phase 7: config 2, batched solve and batched pyramid -----------------
    plain2 = dataclasses.replace(cfg2, backend="torch")
    for a in flow_c2:
        require(a.shape == (bsz, 1088, 1920) and bool(torch.isfinite(a).all()),
                "hs_solve_batched output shape/finite")
    d_c2 = max_flow_diff(flow_c2, hs_solve_batched(c2a, c2b, plain2))
    ms_c2 = median_ms(lambda: hs_solve_batched(c2a, c2b, cfg2))
    ms_c2p = median_ms(lambda: hs_solve_batched(c2a, c2b, plain2), runs=3)
    print(f"phase 7 C2 hs_solve_batched B={bsz} 1088x1920 a=1 i100: max|diff|={d_c2:.3g} "
          f"launches per stack K1={n_c2[0]} K2={n_c2[1]} "
          f"kernel {ms_c2:.3f} ms ({bsz / ms_c2 * 1e3:.1f} pairs/s) "
          f"plain {ms_c2p:.3f} ms ({bsz / ms_c2p * 1e3:.2f} pairs/s)")
    require(d_c2 <= TOL, "C2 kernel vs plain")
    require(n_c2 == (1, 13), f"C2 launches per stack {n_c2}, expected K1=1 K2=13")

    for a in flow_p2:
        require(a.shape == (4, 1080, 1920) and bool(torch.isfinite(a).all()),
                "batched pyramid output shape/finite")
    d_p2 = max_flow_diff(flow_p2, hs_solve_batched(pa, pb, plain2, pyr3))
    ms_p2 = median_ms(lambda: hs_solve_batched(pa, pb, cfg2, pyr3))
    print(f"phase 7 batched pyramid B=4 1080x1920 L3 a=1 i100: max|diff|={d_p2:.3g} "
          f"kernel {ms_p2:.3f} ms ({4 / ms_p2 * 1e3:.1f} pairs/s)")
    require(d_p2 <= TOL, "batched pyramid kernel vs plain")

    # -- phase 8: config 4, streaming -------------------------------------------
    # Each chunk equals hs_solve_batched on its pairs bitwise (the stream adds
    # no arithmetic), and the plain version within TOL (the kernels at
    # 8 x 1080x1920).
    plain4 = dataclasses.replace(cfg4, backend="torch")
    require([c.u.shape[0] for c in chunks] == [8, 8], "flow_stream chunk sizes")
    d_s = 0.0
    for k, c in enumerate(chunks):
        pairs = (vid_dev[8 * k:8 * k + 8], vid_dev[8 * k + 1:8 * k + 9])
        ref = hs_solve_batched(*pairs, cfg4)
        require(bool(torch.equal(c.u, ref.u) and torch.equal(c.v, ref.v)),
                f"flow_stream chunk {k} differs from hs_solve_batched")
        d_s = max(d_s, max_flow_diff(c, hs_solve_batched(*pairs, plain4)))
    require(d_s <= TOL, f"flow_stream kernel vs plain max|diff| {d_s}")

    def stream_all():
        for c in flow_stream(vid, cfg4, chunk=8):
            pass

    ms_s = median_ms(stream_all, runs=5)
    print(f"phase 8 C4 flow_stream 16 pairs 1080x1920 a=1 i100 s=8 chunk 8: chunks bitwise = "
          f"hs_solve_batched, max|diff| vs plain {d_s:.3g}; {ms_s:.3f} ms end to end from host frames "
          f"({16 / ms_s * 1e3:.1f} pairs/s)")

    require(len(warm) == 16, "flow_stream_warm pair count")
    gt = np.broadcast_to(gt_c4, (1080, 1920, 2))
    epes = [epe(interior(flow_np(f), 10), interior(gt, 10)) for f in warm]
    plain_warm = list(flow_stream_warm(vid, dataclasses.replace(cfg4w, backend="torch"),
                                       chunk=8, warp_prior=True))
    d_w = max(max_flow_diff(a, b) for a, b in zip(warm, plain_warm))

    def warm_all():
        for f in flow_stream_warm(vid, cfg4w, chunk=8, warp_prior=True):
            pass

    ms_w = median_ms(warm_all, runs=5)
    print(f"phase 8 C4 flow_stream_warm warp prior i25: max|diff| vs plain {d_w:.3g}; "
          f"{ms_w:.3f} ms for 16 pairs ({16 / ms_w * 1e3:.1f} pairs/s); interior EPE "
          f"first {epes[0]:.4f} mean {float(np.mean(epes)):.4f} last {epes[-1]:.4f}")
    require(d_w <= TOL, "warm stream kernel vs plain")
    require(bool(np.isfinite(epes).all()) and epes[-1] < epes[0],
            f"warm stream EPE does not fall along the stream: {epes}")

    # One window is one 16-image solve (both directions of 8 pairs): held
    # against the plain version, flow within TOL and the mask equal.
    require(tuple(occ_mask.shape) == (8, 1080, 1920) and occ_mask.dtype == torch.bool
            and occ_flow.u.shape == (8, 1080, 1920), "flow_stream_occlusion shapes")
    plain_flow, plain_mask = next(flow_stream_occlusion(vid[:9], plain4, chunk=8, **occ))
    d_o = max_flow_diff(occ_flow, plain_flow)
    share = float(occ_mask.float().mean())
    print(f"phase 8 C4 flow_stream_occlusion one window (16-image solve), {occ}: "
          f"max|diff| vs plain {d_o:.3g}, mask {tuple(occ_mask.shape)} equal to plain's: "
          f"{bool(torch.equal(occ_mask, plain_mask))}, occluded share {share:.5f}")
    require(d_o <= TOL, f"flow_stream_occlusion kernel vs plain max|diff| {d_o}")
    require(bool(torch.equal(occ_mask, plain_mask)), "occlusion mask differs from plain")
    require(0.0 < share < 1.0, f"occlusion mask flags all or nothing: {share}")

    # -- phases 9-11: SOR and robust -----------------------------------------------
    err_sr, launches_sr, classic_band = sor_and_robust(dev, s1, s2, p1, p2, pa, pb, stack)
    err.update(err_sr)

    # -- phase 12: TV-L1 ------------------------------------------------------------------
    k5_row = tvl1_path(dev, vid, vid_dev, c2a, c2b, classic_band)

    # -- phase 13: frames past the resident class (K6, K7, checkpoints) -------------------
    k67_rows = beyond_resident(dev, frames, stack, s1, s2)

    # -- phase 14: K8 (the SOR solve on parity planes) and multigrid ----------------------
    k8_row = sor_planes_and_multigrid(dev, stack, s1, s2)

    # -- phase 15: the tiled solver (K9-K12) and config 5 ---------------------------------
    k9_12_rows = tiled_path(dev, c5_frames(dev), stack)

    # -- phase 16: Lucas-Kanade, ego-motion, hs_energy (plain torch, no kernel) -----------
    lk_path(dev, vid, vid_dev, s1, s2)

    # -- phase 17: the command line (hsflow-torch) on the card ----------------------------
    cli_path(dev, vid, ms_k, ms_k3)

    # -- phase 18: gradients through the kernel entries -----------------------------------
    gradient_path(dev, frames, s1, s2, c2a, c2b, p1, p2)

    # -- phase 19: bfloat16 on the Jacobi path (K1, K2, K6, K7's bfloat16 builds) ---------
    bf16_rows = bf16_path(dev, frames, stack, s1, s2, c2a, c2b, p1, p2, vid)

    # -- phase 20: bfloat16 on SOR and IRLS (K3, K8, K4's bfloat16 builds) ---------------
    bf16_rows += bf16_sor_robust_path(dev, frames, stack, s1, s2, c2a, c2b, p1, p2, vid)

    # -- phase 21: bfloat16 on TV-L1 (K5's bfloat16 build), multigrid and LK -------------
    bf16_rows.append(bf16_tvl1_mg_lk_path(dev, c2a, c2b, p1, p2, vid, vid_dev))

    # -- phase 22: bfloat16 on dist/ (K9, K10, K11 and K12's bfloat16 builds) -------------
    bf16_rows += bf16_dist_path(dev, c5_frames(dev), stack)

    # -- phase 23: the rest of dist/ (the GSPMD routes, mesh=, reshard, sharded sums) -----
    dist_gspmd_path(dev, c5_frames(dev), c2a, c2b, vid)

    # -- per-kernel times at the headline shape -------------------------------
    i1, i2 = s1, s2
    fields = k1.derivatives_plain(i1, i2, 0.5)
    # Two buffers, so that u and v are read from distinct memory as on the
    # solve path.
    zu, zv = torch.zeros_like(i1), torch.zeros_like(i1)
    ms2d = {
        "hs_derivatives": (
            event_ms(lambda: k1.hs_derivatives(i1, i2, 0.5, zero_sweep=True)),
            event_ms(lambda: k1.derivatives_plain(i1, i2, 0.5, zero_sweep=True)),
        ),
        "hs_jacobi_sweeps": (
            event_ms(lambda: k2.jacobi_sweeps(zu, zv, *fields, auto)),
            event_ms(lambda: k2.jacobi_sweeps_plain(zu, zv, *fields, auto)),
        ),
    }
    from opticalflowhs_tpu_torch import robust
    from opticalflowhs_tpu_torch.kernels import solve_robust as k4
    from opticalflowhs_tpu_torch.kernels import sor as k3
    s3 = k3.sweeps_per_launch(0, tuple(s1.shape), 50, k3.device_blocks(dev))  # S1's launches
    s4 = k4_plan(dev, tuple(s1.shape), 20)  # R1's launches

    def sor_robust_timing(a, b, reps_plain):
        """ms per launch of K3 (s3 sweeps), K4 freeze and K4 sweeps (s4
        sweeps), kernel and plain, on the frames (a, b)."""
        ex, ey, et, invd = k1.derivatives_plain(a, b, 0.5)
        u, v = torch.zeros_like(a), torch.zeros_like(a)
        uo, vo = torch.empty_like(a), torch.empty_like(a)
        wd, ws = robust.charbonnier_weights(u, v, ex, ey, et, 0.05, 0.05)

        def plain_sweeps():
            uv = (u, v)
            for _ in range(s4):
                uv = robust.robust_step(*uv, ex, ey, et, wd, ws, 0.25)
            return uv

        return {
            "hs_sor_sweeps": (
                event_ms(lambda: k3.sor_sweeps(u, v, ex, ey, et, invd, s3, OMEGA,
                                               block_sweeps=s3)),
                event_ms(lambda: k3.sor_sweeps_plain(u, v, ex, ey, et, invd, s3, OMEGA),
                         reps=reps_plain)),
            "hs_robust_freeze": (
                event_ms(lambda: k4.freeze_weights(u, v, ex, ey, et, 0.05, 0.05)),
                event_ms(lambda: robust.charbonnier_weights(u, v, ex, ey, et, 0.05, 0.05),
                         reps=reps_plain)),
            "hs_robust_sweeps": (
                event_ms(lambda: k4.launch_sweeps(u, v, ex, ey, et, wd, ws, uo, vo, s4, 0.25)),
                event_ms(plain_sweeps, reps=reps_plain)),
        }

    def sor_robust_bounds(px):
        return {
            "hs_sor_sweeps": bound_ms(8 * 4 * px, K3_FLOPS_PER_PX_SWEEP * s3 * px),
            "hs_robust_freeze": bound_ms(7 * 4 * px, K4_FREEZE_FLOPS_PER_PX * px),
            "hs_robust_sweeps": bound_ms(
                9 * 4 * px, (K4_FLOPS_PER_PX_SWEEP * s4 + K4_HOISTED_FLOPS_PER_PX) * px),
        }

    ms2d.update(sor_robust_timing(i1, i2, 20))
    bounds2d = sor_robust_bounds(i1.numel())
    per_launch = {"hs_jacobi_sweeps": auto, "hs_sor_sweeps": s3, "hs_robust_sweeps": s4}
    geo3 = k3.k3_geometry(dev, s3)
    # K3's own schedule: its windows' 6 arrays in, u and v of its tiles out.
    k3_floor = {px: k3_schedule_bytes(geo3, px) / PEAK_BYTES_PER_S * 1e3
                for px in (i1.numel(), c2a.numel())}
    geo4 = k4.k4_geometry(dev, s4)
    # K4's own schedule: its windows' 7 arrays in, u and v of its tiles out.
    k4_floor = {px: k4_schedule_bytes(geo4, px) / PEAK_BYTES_PER_S * 1e3
                for px in (i1.numel(), c2a.numel())}
    floor = {"hs_sor_sweeps": k3_floor, "hs_robust_sweeps": k4_floor}
    for name, (t_k, t_p) in ms2d.items():
        print(f"kernel {name} 1088x1920: {t_k:.4f} ms per launch, plain {t_p:.4f} ms"
              + (f", bound {bounds2d[name][0]:.4f} ms ({bounds2d[name][1]})"
                 if name in bounds2d else "")
              + (f" ({per_launch[name]} sweeps per launch)" if name in per_launch else "")
              + (f", schedule's byte floor {floor[name][i1.numel()]:.4f} ms"
                 if name in floor else ""))

    # -- per-kernel times on the C2 stack, 8 x 1088x1920 ------------------------
    px = c2a.numel()
    fields = k1.derivatives_plain(c2a, c2b, 1.0)
    zu, zv = torch.zeros_like(c2a), torch.zeros_like(c2a)
    ms = {
        "hs_derivatives": (
            event_ms(lambda: k1.hs_derivatives(c2a, c2b, 1.0, zero_sweep=True)),
            event_ms(lambda: k1.derivatives_plain(c2a, c2b, 1.0, zero_sweep=True)),
        ),
        "hs_jacobi_sweeps": (
            event_ms(lambda: k2.jacobi_sweeps_batched(zu, zv, *fields, auto)),
            event_ms(lambda: k2.jacobi_sweeps_batched_plain(zu, zv, *fields, auto), reps=5),
        ),
    }
    ms.update(sor_robust_timing(c2a, c2b, 3))
    bounds = {
        "hs_derivatives": bound_ms(8 * 4 * px, K1_FLOPS_PER_PX * px),
        "hs_jacobi_sweeps": bound_ms(8 * 4 * px, K2_FLOPS_PER_PX_SWEEP * auto * px),
        **sor_robust_bounds(px),
    }
    for name, (t_k, t_p) in ms.items():
        print(f"kernel {name} {bsz}x1088x1920: {t_k:.4f} ms per launch, plain {t_p:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})"
              + (f" ({per_launch[name]} sweeps per launch)" if name in per_launch else "")
              + (f", schedule's byte floor {floor[name][px]:.4f} ms"
                 if name in floor else ""))

    source = {"hs_derivatives": "opticalflowhs_tpu_torch/csrc/derivatives.cu",
              "hs_jacobi_sweeps": "opticalflowhs_tpu_torch/csrc/jacobi.cu",
              "hs_sor_sweeps": "opticalflowhs_tpu_torch/csrc/sor.cu",
              "hs_robust_freeze": "opticalflowhs_tpu_torch/csrc/robust.cu",
              "hs_robust_sweeps": "opticalflowhs_tpu_torch/csrc/robust.cu"}
    replaces = {
        "hs_derivatives": ["opticalflowhs_tpu/kernels/derivatives.py:40",
                           "opticalflowhs_tpu/kernels/solve_resident.py:161",
                           "opticalflowhs_tpu/kernels/solve_resident.py:394"],
        "hs_jacobi_sweeps": ["opticalflowhs_tpu/kernels/jacobi.py:184",
                             "opticalflowhs_tpu/kernels/jacobi.py:241",
                             "opticalflowhs_tpu/kernels/jacobi.py:375",
                             "opticalflowhs_tpu/kernels/jacobi.py:631",
                             "opticalflowhs_tpu/kernels/solve_resident.py:161",
                             "opticalflowhs_tpu/kernels/solve_resident.py:394"],
        "hs_sor_sweeps": ["opticalflowhs_tpu/kernels/sor.py:59",
                          "opticalflowhs_tpu/kernels/sor.py:113",
                          "opticalflowhs_tpu/kernels/solve_resident.py:161"],
        "hs_robust_freeze": ["opticalflowhs_tpu/kernels/solve_robust.py:92"],
        "hs_robust_sweeps": ["opticalflowhs_tpu/kernels/solve_robust.py:92"],
    }
    # `launches`: K1 and K2 on the batched path (C2, its pyramid, the C4
    # streams), K3 and K4 on the SOR and robust path; K1 and K2 also on the
    # main path (C1 + C3) and K1 on the SOR and robust path.
    launches_b.update({n: launches_sr[n] for n in launches_sr if n != "hs_derivatives"})
    extra = {"hs_derivatives": {"launches_main_path": launches["hs_derivatives"],
                                "launches_sor_robust_path": launches_sr["hs_derivatives"]},
             "hs_jacobi_sweeps": {"launches_main_path": launches["hs_jacobi_sweeps"],
                                  "ms_1088x1920": ms2d["hs_jacobi_sweeps"][0],
                                  "plain_ms_1088x1920": ms2d["hs_jacobi_sweeps"][1],
                                  "bound_ms_1088x1920": bound_ms(
                                      8 * 4 * s1.numel(),
                                      K2_FLOPS_PER_PX_SWEEP * auto * s1.numel())[0],
                                  "geometry": k2.k2_geometry(dev, auto)},
             "hs_sor_sweeps": {"sweeps_per_launch": s3,
                               "ms_1088x1920": ms2d["hs_sor_sweeps"][0],
                               "plain_ms_1088x1920": ms2d["hs_sor_sweeps"][1],
                               "bound_ms_1088x1920": bounds2d["hs_sor_sweeps"][0],
                               "schedule_bound_ms": k3_floor[px],
                               "schedule_bound_ms_1088x1920": k3_floor[i1.numel()],
                               "geometry": geo3},
             "hs_robust_sweeps": {"sweeps_per_launch": s4,
                                  "ms_1088x1920": ms2d["hs_robust_sweeps"][0],
                                  "plain_ms_1088x1920": ms2d["hs_robust_sweeps"][1],
                                  "bound_ms_1088x1920": bounds2d["hs_robust_sweeps"][0],
                                  "schedule_bound_ms": k4_floor[px],
                                  "schedule_bound_ms_1088x1920": k4_floor[i1.numel()],
                                  "geometry": geo4}}
    kernels = [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": launches_b[name],
         **extra.get(name, {}),
         "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name in source
    ] + [k5_row] + k67_rows + [k8_row] + k9_12_rows + bf16_rows
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
