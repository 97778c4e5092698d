#!/usr/bin/env python3
"""Time the PyTorch port's batched and streaming paths on one CUDA card.

    python3 tools/torch_stream_timing.py [--repo DIR] [--runs N] [--profile]

Imports opticalflowhs_tpu_torch from DIR (default: this checkout), so two
trees can be compared in one session on one card (run them in turns:
A, B, B, A). The cells are chip_smoke.py's, taken from this checkout:
  * C2: hs_solve_batched on `c2_stack` (8 pairs of noise at 1088x1920),
    configs/c2_video_batch.json;
  * C4: `c4_video` (the 17-frame 1080x1920 pan) as host numpy frames,
    configs/c4_hd_streaming.json, chunk 8: staging the windows alone (host
    copies and H2D, no solve), flow_stream, and flow_stream_warm with the
    warp prior at 25 sweeps.
Each time is chip_smoke.median_ms over N runs.

With --profile it also traces one call of each with torch.profiler and
reports wall time, device time of kernels and of copies, and the busy
share (kernel time over wall time).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

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
    kernel_us = copy_us = 0.0
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
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
        by_name[e.key] = us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall, "kernel_ms": kernel_us / 1e3, "copy_ms": copy_us / 1e3,
            "busy_share": kernel_us / 1e3 / wall,
            "top": [[k[:60], v / 1e3] for k, v in top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stream_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import opticalflowhs_tpu_torch as p
    from opticalflowhs_tpu_torch import video

    dev = torch.device("cuda", 0)
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

    calls = {"c2_batched_8": c2, "c4_stage_windows": stage, "c4_flow_stream": stream,
             "c4_flow_stream_warm": warm}
    out = {"repo": args.repo, "runs": args.runs,
           "median_ms": {k: chip_smoke.median_ms(fn, args.runs) for k, fn in calls.items()}}
    if args.profile:
        out["profile"] = {k: profile(fn) for k, fn in calls.items()}
    print(chip_smoke.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
