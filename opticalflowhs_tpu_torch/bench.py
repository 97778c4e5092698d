"""Benchmark harness, mirroring opticalflowhs_tpu/bench.py: what
`hsflow-torch bench` runs. It reports; it is not the repository's
benchmark and writes no BENCHMARK.json.

Emits the metric triplet: Jacobi sweep throughput (Mpx/s a card), solve
latency / frames per second, and achieved bytes against the card's
memory rate. Timing: one warm-up call, ended by `torch.cuda.synchronize`
(the first call builds the kernels with nvcc and launches them first),
then `repeats` chained calls and one synchronize; the mean a call.
`profile_dir` writes a `torch.profiler` trace of the timed calls.

The denominators are the card's, keyed by `torch.cuda.get_device_name()`.
A device without an entry (the CPU, other cards) gets null roofline
fields: no default stands in for a rate that was not looked up.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

# THE roofline accounting of the port: `chip_smoke.py` takes its memory
# and float32 rates from these tables.
#
# STREAMING roofline: one Jacobi sweep that streams its operands moves 8
# arrays a pixel: read u, v, Ex, Ey, Et, inv_den + write u, v = 32 B/px in
# float32. It applies only to paths that stream (one launch a sweep); the
# temporally blocked kernels legitimately exceed it.
SWEEP_BYTES_PER_PX = 32
# Device memory rate in GB/s (NVIDIA's data sheet, H100 SXM: 3.35 TB/s).
HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}

# OPERATIONS roofline: float32 operations of one sweep a pixel in K2's
# window loop (csrc/k2_window.cuh): 9 a neighbour average for each of u
# and v, 5 for the common fraction, 4 for the update.
SWEEP_OPS_PER_PX = 27
# float32 rate outside the tensor cores in T-ops/s (NVIDIA's data sheet,
# H100 SXM: 67 TFLOP/s, a fused multiply-add counted as two). The name is
# the reference's, whose table holds its vector unit's rate.
VPU_TOPS = {"NVIDIA H100 80GB HBM3": 67.0}


def roofline_gpx_sweeps(device_kind: str = "NVIDIA H100 80GB HBM3",
                        dtype_bytes: int = 4) -> Optional[float]:
    """Streaming (non-temporally-blocked) sweep speed-of-light,
    Gpx*sweeps/s; None for a device without a memory rate."""
    peak = HBM_GBPS.get(device_kind)
    if peak is None:
        return None
    return peak / (SWEEP_BYTES_PER_PX * dtype_bytes / 4)


def compute_roofline_gpx_sweeps(
        device_kind: str = "NVIDIA H100 80GB HBM3") -> Optional[float]:
    """Operations-bound sweep speed-of-light, Gpx*sweeps/s: the float32
    rate divided by the sweep's operations a pixel; None for a device
    without a rate."""
    tops = VPU_TOPS.get(device_kind)
    if tops is None:
        return None
    return tops * 1e3 / SWEEP_OPS_PER_PX


def _device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn, args, repeats: int, dev: torch.device) -> float:
    """Seconds a call: a synchronized warm-up call (kernel build, first
    launch), then `repeats` chained calls and one synchronize."""
    fn(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(*args)
    _sync(dev)
    return (time.perf_counter() - t0) / repeats


def _noise(rng, shape, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)


def _profiled(profile_dir: Optional[str], dev: torch.device):
    """A torch.profiler context whose trace lands in profile_dir, or a
    null context."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def save(prof):
        prof.export_chrome_trace(os.path.join(profile_dir, "bench_trace.json"))

    return profile(activities=activities, on_trace_ready=save)


def run_bench(
    rc=None,
    shape=(1024, 1280),
    profile_dir: Optional[str] = None,
    repeats: int = 50,
    device=None,
) -> dict:
    """Time `hs_solve` (and `hs_pyramid` when rc.pyramid.levels > 1) on
    uniform noise from default_rng(0) at `shape`, on `device` (cuda:0 by
    default; RuntimeError without CUDA)."""
    from opticalflowhs_tpu_torch.config import RunConfig
    from opticalflowhs_tpu_torch.pyramid import hs_pyramid
    from opticalflowhs_tpu_torch.solver import hs_solve, target_device

    rc = rc or RunConfig()
    dev = target_device(device)
    h, w = shape
    rng = np.random.default_rng(0)
    i1 = _noise(rng, (h, w), dev)
    i2 = _noise(rng, (h, w), dev)

    with _profiled(profile_dir, dev):
        dt_solve = _timeit(lambda a, b: hs_solve(a, b, rc.hs), (i1, i2),
                           repeats, dev)
        results_pyr = None
        if rc.pyramid.levels > 1:
            dt_pyr = _timeit(
                lambda a, b: hs_pyramid(a, b, rc.hs, rc.pyramid), (i1, i2),
                repeats, dev,
            )
            results_pyr = {
                "ms_per_frame": round(dt_pyr * 1e3, 3),
                "fps": round(1.0 / dt_pyr, 2),
            }

    kind = _device_kind(dev)
    px_sweeps = h * w * rc.hs.iters
    gpx_s = px_sweeps / dt_solve / 1e9
    hbm_peak = HBM_GBPS.get(kind)
    sol_gpx = roofline_gpx_sweeps(kind)
    return {
        "device": kind,
        "backend": rc.hs.backend,
        "shape": [h, w],
        "iters": rc.hs.iters,
        "sweep_throughput": {
            "mpx_per_s_per_chip": round(gpx_s * 1e3, 1),
            "gpx_sweeps_per_s": round(gpx_s, 3),
            "ms_per_solve": round(dt_solve * 1e3, 3),
            "fps_single_level": round(1.0 / dt_solve, 2),
            "achieved_GBps_lower_bound": round(gpx_s * SWEEP_BYTES_PER_PX, 1),
            "roofline_GBps": hbm_peak,
            "roofline_gpx_sweeps_per_s": (None if sol_gpx is None
                                          else round(sol_gpx, 1)),
            "fraction_of_roofline": (None if sol_gpx is None
                                     else round(gpx_s / sol_gpx, 4)),
        },
        "pyramid": results_pyr,
        "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
    }


def run_scaling_bench(rc=None, shape=(512, 640), repeats: int = 30,
                      device=None) -> dict:
    """Frames/s at 1 card, and with several cards the tiled weak scaling.

    1 card: batched video fps (B = 8, config 2's stack). N cards: image
    area scaled with the card count, efficiency = T(1 tile alone) / T(N
    tiles together) through `dist.hs_solve_tiled`; then the data-parallel
    leg, `hs_solve_batched(..., mesh=)` with the stack split over every
    card (dist/gspmd.py)."""
    from opticalflowhs_tpu_torch.batch import hs_solve_batched
    from opticalflowhs_tpu_torch.config import MeshConfig, RunConfig
    from opticalflowhs_tpu_torch.dist import hs_solve_tiled, make_mesh
    from opticalflowhs_tpu_torch.dist.mesh import mesh_for_devices
    from opticalflowhs_tpu_torch.solver import hs_solve, target_device

    rc = rc or RunConfig()
    dev = target_device(device)
    h, w = shape
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    rng = np.random.default_rng(0)
    out: dict = {"device": _device_kind(dev), "n_devices": n_dev,
                 "shape": [h, w], "iters": rc.hs.iters}

    # fps at 1 card: batched pairs (config 2's stack)
    batch = 8
    v1 = _noise(rng, (batch, h, w), dev)
    v2 = _noise(rng, (batch, h, w), dev)
    dt = _timeit(lambda a, b: hs_solve_batched(a, b, rc.hs), (v1, v2),
                 repeats, dev)
    out["fps_1chip_batched"] = round(batch / dt, 2)

    if n_dev > 1:
        mesh_cfg = mesh_for_devices(n_dev)
        mesh = make_mesh(mesh_cfg)
        # Weak scaling: one tile-sized image alone vs N tiles tiled
        th, tw = h, w
        big1 = _noise(rng, (th * mesh_cfg.y, tw * mesh_cfg.x), dev)
        big2 = _noise(rng, tuple(big1.shape), dev)
        i1 = _noise(rng, (th, tw), dev)
        i2 = _noise(rng, (th, tw), dev)
        dt_one = _timeit(lambda a, b: hs_solve(a, b, rc.hs), (i1, i2),
                         repeats, dev)
        dt_tiled = _timeit(
            lambda a, b: hs_solve_tiled(
                a, b, rc.hs, mesh=mesh, halo_sweeps=rc.mesh.halo_sweeps
            ),
            (big1, big2),
            repeats,
            dev,
        )
        out["weak_scaling"] = {
            "mesh": list(mesh_cfg.shape),
            "tile": [th, tw],
            "ms_single_tile": round(dt_one * 1e3, 3),
            "ms_tiled_full": round(dt_tiled * 1e3, 3),
            "efficiency": round(dt_one / dt_tiled, 4),
        }
        # DP scaling: batch split over every card
        vb1 = _noise(rng, (n_dev * 4, h, w), dev)
        vb2 = _noise(rng, (n_dev * 4, h, w), dev)
        bmesh = make_mesh(MeshConfig(batch=n_dev, y=1, x=1))
        dt_n = _timeit(
            lambda a, b: hs_solve_batched(a, b, rc.hs, mesh=bmesh), (vb1, vb2),
            repeats, dev,
        )
        out[f"fps_{n_dev}chip_batched"] = round(vb1.shape[0] / dt_n, 2)
    return out
