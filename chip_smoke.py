#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Builds the port's CUDA kernels from csrc/ (nvcc, a few seconds), holds each
against its plain PyTorch version on the card, then drives the main path
through the public entry points, hs_solve (1088x1920, alpha 0.5, 100
sweeps) and hs_pyramid (3 levels at 1080x1920), with launch counters
showing that both ran through the kernels. Every phase checks what it
measures and any failure exits non-zero. Imports torch, numpy and
opticalflowhs_tpu_torch only, never JAX.

Output: one line of numbers per phase; then, on lines of their own, the
card's name and power limit as nvidia-smi gives them, and a JSON object
{"kernels": [...]} (per kernel: launches on the main path, max |diff|
against the plain version, ms per launch for the kernel and the plain
version); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 2e-6  # the reference's kernel-vs-oracle bar; the kernels aim for 0.0


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from opticalflowhs_tpu_torch import HSConfig, PyramidConfig, hs_pyramid, hs_solve
    from opticalflowhs_tpu_torch.data.synthetic import WarpSpec, synthetic_pair, translation_pair
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

    # -- the main path, counted -----------------------------------------------
    cfg1 = HSConfig(alpha=0.5, iters=100)               # bench.py headline
    cfg3 = HSConfig(alpha=1.0, iters=100)               # configs/c3_pyramid.json
    pyr3 = PyramidConfig(levels=3)
    s1, s2 = frames(1088, 1920, seed=0)                 # bench.py's frames
    p1, p2, _ = translation_pair(1080, 1920, 3.0, 1.5, key=0, max_freq=0.06)
    p1 = torch.from_numpy(p1).to(dev)
    p2 = torch.from_numpy(p2).to(dev)
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

    # -- per-kernel times at the headline shape -------------------------------
    i1, i2 = s1, s2
    fields = k1.derivatives_plain(i1, i2, 0.5)
    z = torch.zeros_like(i1)
    ms = {
        "hs_derivatives": (
            event_ms(lambda: k1.hs_derivatives(i1, i2, 0.5, zero_sweep=True)),
            event_ms(lambda: k1.derivatives_plain(i1, i2, 0.5, zero_sweep=True)),
        ),
        "hs_jacobi_sweeps": (
            event_ms(lambda: k2.jacobi_sweeps(z, z, *fields, auto)),
            event_ms(lambda: k2.jacobi_sweeps_plain(z, z, *fields, auto)),
        ),
    }
    for name, (t_k, t_p) in ms.items():
        print(f"kernel {name} 1088x1920: {t_k:.4f} ms per launch, plain {t_p:.4f} ms"
              + (f" ({auto} sweeps per launch)" if name == "hs_jacobi_sweeps" else ""))

    source = {"hs_derivatives": "opticalflowhs_tpu_torch/csrc/derivatives.cu",
              "hs_jacobi_sweeps": "opticalflowhs_tpu_torch/csrc/jacobi.cu"}
    replaces = {"hs_derivatives": "opticalflowhs_tpu/kernels/derivatives.py:40",
                "hs_jacobi_sweeps": "opticalflowhs_tpu/kernels/jacobi.py:184"}
    kernels = [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name in ("hs_derivatives", "hs_jacobi_sweeps")
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
