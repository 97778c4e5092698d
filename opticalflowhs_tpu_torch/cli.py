"""Command line of the PyTorch port, mirroring opticalflowhs_tpu/cli.py
(`hsflow`); installed as `hsflow-torch`, or run as
`python -m opticalflowhs_tpu_torch.cli`. Subcommands:

    hsflow-torch run f1.png f2.png -o out.flo [--viz flow.png] [--cfg.alpha 0.5] ...
    hsflow-torch video frames_dir/ -o flows/ [--pyramid.levels 3]
    hsflow-torch eval middlebury ~/data/middlebury [--out results.json]
    hsflow-torch bench [--shape 1024x1280] [--profile-dir DIR]
    hsflow-torch viz in.flo -o flow.png [--needle]
    hsflow-torch selftest
    hsflow-torch info

Config flags are dotted overrides onto the frozen dataclasses, e.g.
--cfg.alpha 0.5 --cfg.iters 200 --pyramid.levels 3; --config loads a JSON
preset (configs/*.json ship the five workload configs).

--device (the port's one option of its own) picks where the solves run:
cuda, the default, is cuda:0, and without a CUDA device the command exits
with the entry points' error; --device cpu runs the plain PyTorch path.
Nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _split_overrides(argv):
    """Pull --cfg.x/--pyramid.x/--mesh.x val pairs out of argv."""
    overrides = {}
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--") and "." in a:
            key = a[2:]
            sect = key.split(".", 1)[0]
            if sect in ("cfg", "hs", "pyramid", "mesh", "lk", "tvl1"):
                if "=" in key:
                    key, val = key.split("=", 1)
                else:
                    i += 1
                    if i >= len(argv):
                        raise SystemExit(f"missing value for {a}")
                    val = argv[i]
                key = key.replace("cfg.", "hs.", 1) if key.startswith("cfg.") else key
                overrides[key] = val
                i += 1
                continue
        rest.append(a)
        i += 1
    return overrides, rest


def _build_config(args, overrides):
    from opticalflowhs_tpu_torch.config import load_config

    return load_config(getattr(args, "config", None), overrides)


def _device(args):
    """The torch device of --device. The default, cuda, is the entry
    points' own default (device=None: cuda:0), so without CUDA the command
    exits with their RuntimeError's text instead of solving on the CPU."""
    from opticalflowhs_tpu_torch.solver import target_device

    try:
        return target_device(None if args.device == "cuda" else args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from e


def _to_device(img, dev):
    import torch

    return torch.from_numpy(img).to(dev)


def _host_flow(flow):
    """(H, W, 2) float32 numpy of a Flow of (H, W) tensors (bfloat16
    widened, exactly)."""
    import numpy as np

    from opticalflowhs_tpu_torch.io.host import host_array

    return np.stack([host_array(flow.u), host_array(flow.v)], axis=-1)


def _make_mesh(mesh_cfg, dev):
    """The MeshConfig's mesh: on CUDA one card a shard (every card, as the
    reference takes every device); on the CPU a virtual mesh of `dev`."""
    from opticalflowhs_tpu_torch.dist import make_mesh

    if dev.type == "cuda":
        return make_mesh(mesh_cfg)
    return make_mesh(mesh_cfg, [dev] * (mesh_cfg.batch * mesh_cfg.y * mesh_cfg.x))


def _cmd_run(args, overrides):
    import numpy as np

    from opticalflowhs_tpu_torch.io import write_flow
    from opticalflowhs_tpu_torch.io.images import load_gray, save_image
    from opticalflowhs_tpu_torch.pyramid import hs_pyramid
    from opticalflowhs_tpu_torch.viz import flow_to_color, needle_plot

    rc = _build_config(args, overrides)
    method = args.method or rc.method
    dev = _device(args)
    i1 = _to_device(load_gray(args.frame1), dev)
    i2 = _to_device(load_gray(args.frame2), dev)
    t0 = time.perf_counter()
    tiled = rc.mesh.y * rc.mesh.x > 1
    occ = None
    if method not in ("hs", "lk", "tvl1"):
        # A method the dispatcher doesn't handle must raise, never fall
        # through to HS with a wrong-method label.
        raise SystemExit(f"unknown method {method!r} (hs|lk|tvl1)")
    if args.occlusion:
        # Both directions in ONE batch-2 solve; the forward leg IS the
        # output flow.
        from opticalflowhs_tpu_torch.consistency import flow_with_occlusion

        mesh = None
        if tiled or rc.mesh.batch > 1:
            mesh = _make_mesh(rc.mesh, dev)
        flow, occ = flow_with_occlusion(
            i1, i2, rc.hs, rc.pyramid,
            lk=rc.lk if method == "lk" else None,
            tvl1=rc.tvl1 if method == "tvl1" else None,
            mesh=mesh, halo_sweeps=rc.mesh.halo_sweeps, device=dev,
        )
    elif method == "lk":
        if tiled:
            from opticalflowhs_tpu_torch.lucas_kanade import lk_solve_tiled

            flow = lk_solve_tiled(i1, i2, rc.lk, rc.pyramid,
                                  mesh=_make_mesh(rc.mesh, dev))
        else:
            from opticalflowhs_tpu_torch.lucas_kanade import lk_solve

            flow = lk_solve(i1, i2, rc.lk, rc.pyramid, device=dev)
    elif method == "tvl1":
        if tiled:
            from opticalflowhs_tpu_torch.tvl1 import tvl1_solve_tiled

            flow = tvl1_solve_tiled(i1, i2, rc.tvl1, rc.pyramid,
                                    mesh=_make_mesh(rc.mesh, dev))
        else:
            from opticalflowhs_tpu_torch.tvl1 import tvl1_solve

            flow = tvl1_solve(i1, i2, rc.tvl1, rc.pyramid, device=dev)
    elif tiled:
        # Spatial mesh requested: route through the sharded pyramid (a 1-level
        # pyramid is exactly the tiled solve).
        from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled

        flow = hs_pyramid_tiled(
            i1, i2, rc.hs, rc.pyramid, mesh=_make_mesh(rc.mesh, dev),
            halo_sweeps=rc.mesh.halo_sweeps,
        )
    else:
        flow = hs_pyramid(i1, i2, rc.hs, rc.pyramid, device=dev)
    f = _host_flow(flow)
    dt = time.perf_counter() - t0
    detail = (
        f"window={rc.lk.window} iters={rc.lk.iters}" if method == "lk"
        else f"lambda={rc.tvl1.lambda_} warps={rc.tvl1.warps} "
             f"iters={rc.tvl1.iters}" if method == "tvl1"
        else f"alpha={rc.hs.alpha} iters={rc.hs.iters} backend={rc.hs.backend}"
    )
    print(
        f"solved {i1.shape[1]}x{i1.shape[0]} {method} flow: "
        f"levels={rc.pyramid.levels} {detail} "
        + (f"mesh={rc.mesh.y}x{rc.mesh.x} " if tiled else "")
        + f"on {dev} in {dt * 1e3:.1f} ms (incl. compile on first run)"
    )
    if args.output:
        write_flow(args.output, f)  # .flo, or KITTI PNG for .png outputs
        print(f"wrote {args.output}")
    if args.viz:
        save_image(args.viz, flow_to_color(f))
        print(f"wrote {args.viz}")
    if args.needle:
        save_image(args.needle, needle_plot(f, background=i1))
        print(f"wrote {args.needle}")
    if occ is not None:
        m = occ.cpu().numpy()
        save_image(args.occlusion, m.astype(np.float32))
        print(f"wrote {args.occlusion} ({100 * m.mean():.1f}% flagged)")
    if args.egomotion:
        from opticalflowhs_tpu_torch.egomotion import estimate_egomotion

        em = estimate_egomotion(flow)
        foe = em.focus_of_expansion()
        print(
            f"egomotion: tx={float(em.tx):+.4f} ty={float(em.ty):+.4f} "
            f"omega={float(em.omega):+.6f} scale={float(em.scale):+.6f} "
            f"residual={float(em.residual):.4f} "
            f"FOE=({float(foe[0]):+.1f}, {float(foe[1]):+.1f}) px from center"
        )
    return 0


def _cmd_video(args, overrides):
    import os

    import numpy as np

    from opticalflowhs_tpu_torch.io.flo import write_flo
    from opticalflowhs_tpu_torch.io.host import host_array
    from opticalflowhs_tpu_torch.io.images import load_gray, save_image
    from opticalflowhs_tpu_torch.solver import Flow
    from opticalflowhs_tpu_torch.video import flow_stream, flow_stream_occlusion
    from opticalflowhs_tpu_torch.viz import flow_to_color

    rc = _build_config(args, overrides)
    method = args.method or rc.method
    if method not in ("hs", "lk", "tvl1"):
        raise SystemExit(f"unknown method {method!r} (hs|lk|tvl1)")
    dev = _device(args)
    from opticalflowhs_tpu_torch.io import native

    is_video_src = args.frames.startswith("cam:") or (
        os.path.isfile(args.frames)
        and args.frames.lower().endswith(native.VIDEO_EXTS)
    )
    if is_video_src:
        # Container/camera ingestion: libhsio's videoio decode ring
        # (ffmpeg-backed) feeds grayscale frames ahead of the solve.
        if not (native.build() and native.available()
                and native.video_available()):
            raise SystemExit(
                f"{args.frames}: video sources need libhsio built with "
                "OpenCV videoio (make -C native)"
            )
        _, _, _, n = native.video_info(args.frames)
        n_frames = n if n > 0 else -1
        frames = native.stream_video(args.frames, prefetch=2 * args.chunk)
    elif os.path.isdir(args.frames):
        paths = sorted(
            os.path.join(args.frames, p)
            for p in os.listdir(args.frames)
            if p.lower().endswith((".png", ".jpg", ".jpeg", ".pgm", ".ppm", ".bmp"))
        )
        n_frames = len(paths)
        # Frame directories go through the libhsio threaded prefetch loader
        # (decode overlaps the solve) whenever the library can decode every
        # frame (PNM always; PNG/JPEG/... when it was built with the OpenCV
        # codecs); else synchronous Python decode.
        if native.build() and native.available() and all(
            native.can_decode(p) for p in paths
        ):
            frames = native.stream_frames(paths, n_threads=4, prefetch=2 * args.chunk)
        else:
            frames = (load_gray(p) for p in paths)
    else:
        raise SystemExit(
            f"{args.frames}: expected a directory of frames, a video file "
            f"({'/'.join(e[1:] for e in native.VIDEO_EXTS[:4])}/...), or cam:N"
        )
    os.makedirs(args.output, exist_ok=True)
    pyr = rc.pyramid if rc.pyramid.levels > 1 else None
    mesh = None
    if rc.mesh.batch > 1:
        # DP streaming: each chunk's pairs shard over the "batch" axis.
        mesh = _make_mesh(rc.mesh, dev)
    em_file = None
    if args.egomotion:
        from opticalflowhs_tpu_torch.egomotion import estimate_egomotion

        em_file = open(os.path.join(args.output, "egomotion.jsonl"), "w")
    viz_video = None
    if args.viz_video:
        if not (native.build() and native.available()
                and native.video_available()):
            raise SystemExit("--viz-video needs libhsio built with OpenCV "
                             "videoio (make -C native)")
        viz_video = native.VideoWriter(args.viz_video, fps=args.viz_fps,
                                       rgb=True)
    t0 = time.perf_counter()
    idx = 0
    lk_cfg = rc.lk if method == "lk" else None
    tvl1_cfg = rc.tvl1 if method == "tvl1" else None
    if args.warm_warp and args.warm is None:
        raise SystemExit("--warm-warp requires --warm")
    if args.occlusion:
        if args.warm is not None:
            raise SystemExit(
                "--warm and --occlusion are mutually exclusive (the "
                "occlusion stream batches both directions per chunk)"
            )
        # Both directions per chunk in one 2B-batch solve + fb masks
        # (model-agnostic — works for hs, lk, and tvl1 streams).
        stream = (
            (fl, m.cpu().numpy())
            for fl, m in flow_stream_occlusion(frames, rc.hs, pyr,
                                               chunk=args.chunk, mesh=mesh,
                                               lk=lk_cfg, tvl1=tvl1_cfg,
                                               device=dev)
        )
    elif args.warm is not None:
        if method != "hs":
            raise SystemExit("--warm is HS streaming only")
        if any(k.startswith("pyramid.") for k in overrides):
            # Same hard-conflict treatment as --warm + mesh/--occlusion:
            # silently dropping an explicit pyramid request would be a trap.
            raise SystemExit(
                "--warm streams single-level (the standing flow prior "
                "replaces the pyramid's coarse-to-fine bootstrap); drop "
                "--warm or the --pyramid.* override"
            )
        if mesh is not None:
            raise SystemExit(
                "--warm streams sequentially and cannot honor the "
                "configured mesh batch sharding; drop --warm or the "
                "mesh.batch override"
            )
        # --warm implies single-level solving: the standing flow prior
        # replaces the pyramid's coarse-to-fine bootstrapping on coherent
        # video (the pyramid API has no warm-start seam).
        from opticalflowhs_tpu_torch.video import flow_stream_warm

        # sequential temporal warm start; each pair becomes a 1-pair chunk
        stream = (
            (Flow(fl.u[None], fl.v[None]), None)
            for fl in flow_stream_warm(
                frames, rc.hs, warm_scale=args.warm, chunk=args.chunk,
                warp_prior=args.warm_warp, device=dev,
            )
        )
    else:
        stream = ((fl, None) for fl in flow_stream(
            frames, rc.hs, pyr, chunk=args.chunk, mesh=mesh,
            lk=lk_cfg, tvl1=tvl1_cfg, device=dev))
    try:
        for chunk, masks in stream:
            if em_file is not None:
                # Fit per pair BEFORE host readback: a few reductions on
                # the device, negligible next to the solve.
                ems = [
                    estimate_egomotion(Flow(chunk.u[k], chunk.v[k]))
                    for k in range(chunk.u.shape[0])
                ]
            u = host_array(chunk.u)
            v = host_array(chunk.v)
            for k in range(u.shape[0]):
                f = np.stack([u[k], v[k]], axis=-1)
                write_flo(os.path.join(args.output, f"flow_{idx:05d}.flo"), f)
                if args.viz:
                    save_image(
                        os.path.join(args.output, f"flow_{idx:05d}.png"),
                        flow_to_color(f),
                    )
                if viz_video is not None:
                    viz_video.write(
                        flow_to_color(f).astype(np.float32) / 255.0
                    )
                if masks is not None:
                    save_image(
                        os.path.join(args.output, f"occ_{idx:05d}.png"),
                        masks[k].astype(np.float32),
                    )
                if em_file is not None:
                    em = ems[k]
                    em_file.write(json.dumps({
                        "pair": idx,
                        "tx": float(em.tx), "ty": float(em.ty),
                        "omega": float(em.omega), "scale": float(em.scale),
                        "residual": float(em.residual),
                    }) + "\n")
                idx += 1
    finally:
        # Flush fits computed so far even if the stream dies mid-run.
        if em_file is not None:
            em_file.close()
        if viz_video is not None:
            viz_video.close()
    if em_file is not None:
        print(f"wrote {os.path.join(args.output, 'egomotion.jsonl')}")
    if viz_video is not None:
        print(f"wrote {args.viz_video} ({viz_video.count} frames)")
    dt = time.perf_counter() - t0
    src = f"{n_frames} frames" if n_frames >= 0 else "a live stream"
    print(f"{idx} flows from {src} in {dt:.2f}s ({idx / dt:.1f} fps incl. compile)")
    return 0


def _cmd_eval(args, overrides):
    """EPE/AE table over a benchmark dataset (Middlebury/Sintel/KITTI)."""
    from opticalflowhs_tpu_torch.data.datasets import (
        KittiDataset, MiddleburyDataset, SintelDataset, evaluate,
    )
    from opticalflowhs_tpu_torch.pyramid import hs_pyramid

    rc = _build_config(args, overrides)
    if args.kind == "middlebury":
        ds = MiddleburyDataset(args.root)
    elif args.kind == "sintel":
        ds = SintelDataset(args.root, render_pass=args.render_pass)
    else:
        ds = KittiDataset(args.root, gt_dir=args.gt_dir)
    if args.seq:
        samples = [ds.sample(args.seq)]
    else:
        samples = ds

    method = args.method or rc.method
    if method not in ("hs", "lk", "tvl1"):
        raise SystemExit(f"unknown method {method!r} (hs|lk|tvl1)")
    dev = _device(args)
    tiled = rc.mesh.y * rc.mesh.x > 1
    if tiled:
        from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled

        mesh = _make_mesh(rc.mesh, dev)
    if method == "lk":
        from opticalflowhs_tpu_torch.lucas_kanade import lk_solve, lk_solve_tiled
    if method == "tvl1":
        from opticalflowhs_tpu_torch.tvl1 import tvl1_solve, tvl1_solve_tiled

    def solve(f1, f2):
        i1, i2 = _to_device(f1, dev), _to_device(f2, dev)
        if method == "lk":
            if tiled:
                flow = lk_solve_tiled(i1, i2, rc.lk, rc.pyramid, mesh=mesh)
            else:
                flow = lk_solve(i1, i2, rc.lk, rc.pyramid, device=dev)
        elif method == "tvl1":
            if tiled:
                flow = tvl1_solve_tiled(i1, i2, rc.tvl1, rc.pyramid, mesh=mesh)
            else:
                flow = tvl1_solve(i1, i2, rc.tvl1, rc.pyramid, device=dev)
        elif tiled:
            flow = hs_pyramid_tiled(
                i1, i2, rc.hs, rc.pyramid,
                mesh=mesh, halo_sweeps=rc.mesh.halo_sweeps,
            )
        else:
            flow = hs_pyramid(i1, i2, rc.hs, rc.pyramid, device=dev)
        return _host_flow(flow)

    t0 = time.perf_counter()
    table = evaluate(samples, solve, limit=args.limit)
    dt = time.perf_counter() - t0
    if not table:
        raise SystemExit("no GT-bearing samples found")
    width = max(len(s) for s in table)
    print(f"{'sequence':<{width}}  {'EPE':>8}  {'AE(deg)':>8}  {'n':>4}")
    for seq, row in table.items():
        if seq == "ALL":
            continue
        print(f"{seq:<{width}}  {row['epe']:>8.4f}  {row['ae']:>8.3f}  "
              f"{row['n']:>4d}")
    a = table["ALL"]
    print(f"{'ALL':<{width}}  {a['epe']:>8.4f}  {a['ae']:>8.3f}  {a['n']:>4d}"
          f"   ({dt:.1f}s, method={method} levels={rc.pyramid.levels} "
          + (f"window={rc.lk.window} iters={rc.lk.iters})" if method == "lk"
             else f"lambda={rc.tvl1.lambda_} warps={rc.tvl1.warps} "
                  f"iters={rc.tvl1.iters})" if method == "tvl1"
             else f"alpha={rc.hs.alpha} iters={rc.hs.iters} tol={rc.hs.tol})"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=2)
        print(f"wrote {args.out}")
    return 0


def _cmd_bench(args, overrides):
    from opticalflowhs_tpu_torch.bench import run_bench, run_scaling_bench

    rc = _build_config(args, overrides)
    dev = _device(args)
    h, w = (int(t) for t in args.shape.split("x"))
    if args.scaling:
        results = run_scaling_bench(rc, shape=(h, w), repeats=args.repeats,
                                    device=dev)
    else:
        results = run_bench(
            rc, shape=(h, w), profile_dir=args.profile_dir, repeats=args.repeats,
            device=dev,
        )
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 0


def _cmd_viz(args, _overrides):
    from opticalflowhs_tpu_torch.io import read_flow
    from opticalflowhs_tpu_torch.io.images import save_image
    from opticalflowhs_tpu_torch.viz import flow_to_color, needle_plot

    f = read_flow(args.flo)  # .flo or KITTI flow .png
    img = needle_plot(f) if args.needle else flow_to_color(f, max_flow=args.max_flow)
    save_image(args.output, img)
    print(f"wrote {args.output} ({f.shape[1]}x{f.shape[0]})")
    return 0


def _cmd_selftest(args, overrides):
    """On-device sanity suite for deployment validation: solve accuracy
    vs analytic GT, kernels == plain oracle exactness, format roundtrip,
    and the ego-motion fit — PASS/FAIL lines, exit 1 on any failure. On
    --device cpu the kernel check is skipped: there are no kernels."""
    import os
    import tempfile

    import numpy as np
    import torch

    from opticalflowhs_tpu_torch import HSConfig, hs_solve
    from opticalflowhs_tpu_torch.data.synthetic import translation_pair
    from opticalflowhs_tpu_torch.egomotion import estimate_egomotion
    from opticalflowhs_tpu_torch.io.flo import read_flo, write_flo
    from opticalflowhs_tpu_torch.metrics import epe, interior
    from opticalflowhs_tpu_torch.viz import flow_to_color

    failures = 0

    def check(name, ok, detail=""):
        nonlocal failures
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}"
              + (f" ({detail})" if detail else ""))
        failures += 0 if ok else 1

    dev = _device(args)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"selftest on device={dev} ({kind}; {n_dev} device(s))")
    h, w = (int(t) for t in args.shape.split("x"))
    i1, i2, gt = translation_pair(h, w, 1.0, 0.5, key=3)
    i1, i2 = _to_device(i1, dev), _to_device(i2, dev)

    # 1. accuracy gate vs analytic ground truth
    f = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=args.iters), device=dev)
    fl = _host_flow(f)
    e = epe(interior(fl, 10), interior(gt, 10))
    check("EPE vs analytic GT < 0.08", e < 0.08, f"EPE {e:.4f}")
    check("flow finite", bool(np.isfinite(fl).all()))

    # 2. kernels == plain torch oracle on THIS device
    name = "cuda == torch oracle <= 2e-5"
    if dev.type == "cuda":
        cfg = dict(alpha=0.5, iters=30)
        fp = hs_solve(i1, i2, HSConfig(backend="cuda", **cfg), device=dev)
        fj = hs_solve(i1, i2, HSConfig(backend="torch", **cfg), device=dev)
        d = max(float((fp.u - fj.u).abs().max()),
                float((fp.v - fj.v).abs().max()))
        check(name, d <= 2e-5, f"max diff {d:.2e}")
    else:
        print(f"  [SKIP] {name} (no kernels on {dev.type})")

    # 3. solver variants produce consistent flow
    fs = hs_solve(i1, i2, HSConfig(alpha=0.1, iters=max(args.iters // 8, 20),
                                   solver="sor", omega=1.5), device=dev)
    fsl = _host_flow(fs)
    es = epe(interior(fsl, 10), interior(gt, 10))
    check("SOR EPE < 0.1", es < 0.1, f"EPE {es:.4f}")

    # 4. .flo roundtrip + viz
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "t.flo")
        write_flo(p, fl)
        check(".flo roundtrip bitwise", bool(np.array_equal(read_flo(p), fl)))
    img = flow_to_color(fl)
    check("color wheel non-trivial", int(np.asarray(img).std()) > 0)

    # 5. ego-motion recovers the translation
    em = estimate_egomotion(f)
    check("egomotion tx ~ 1.0", abs(float(em.tx) - 1.0) < 0.2,
          f"tx {float(em.tx):+.3f}")

    print(("OK: all checks passed" if failures == 0
           else f"FAILED: {failures} check(s)"))
    return 0 if failures == 0 else 1


def _cmd_info(_args, _overrides):
    import torch

    import opticalflowhs_tpu_torch

    print(f"opticalflowhs_tpu_torch {opticalflowhs_tpu_torch.__version__}")
    print(f"torch {torch.__version__}, cuda runtime {torch.version.cuda}, "
          f"cuda available {torch.cuda.is_available()}")
    for i in range(torch.cuda.device_count()):
        print(f"  {i}: {torch.cuda.get_device_name(i)} (cuda)")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides, argv = _split_overrides(argv)

    p = argparse.ArgumentParser(prog="hsflow-torch", description=__doc__)
    p.add_argument("--config", help="JSON config preset (configs/*.json)")
    p.add_argument("--device", default="cuda",
                   help="where the solves run: cuda (cuda:0, the default; "
                        "exits without CUDA), cuda:N or cpu")
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("run", help="flow for one frame pair")
    pr.add_argument("frame1")
    pr.add_argument("frame2")
    pr.add_argument("-o", "--output", help=".flo output path")
    pr.add_argument("--viz", help="color-wheel PNG output path")
    pr.add_argument("--needle", help="needle-plot PNG output path")
    pr.add_argument("--method", choices=["hs", "lk", "tvl1"], default=None,
                    help="flow model family: hs (Horn-Schunck, default) or "
                         "lk (dense pyramidal Lucas-Kanade)")
    pr.add_argument("--egomotion", action="store_true",
                    help="print the 4-param rigid+zoom ego-motion fit + FOE")
    pr.add_argument("--occlusion", metavar="PNG",
                    help="also solve the reverse direction (one batch-2 "
                         "solve) and write the forward-backward occlusion "
                         "mask here")
    pr.set_defaults(fn=_cmd_run)

    pv = sub.add_parser(
        "video",
        help="flow over a directory of frames, a video file, or cam:N",
    )
    pv.add_argument("frames",
                    help="frame directory, container file (mp4/avi/...), "
                         "or cam:N for a V4L2 camera")
    pv.add_argument("-o", "--output", required=True, help="output directory")
    pv.add_argument("--viz", action="store_true", help="also write PNGs")
    pv.add_argument("--viz-video", metavar="FILE",
                    help="write the color-wheel renders as one video file "
                         "(.avi/.mp4; needs libhsio with videoio)")
    pv.add_argument("--viz-fps", type=float, default=25.0,
                    help="frame rate for --viz-video (default 25)")
    pv.add_argument("--chunk", type=int, default=8)
    pv.add_argument(
        "--warm", type=float, nargs="?", const=1.0, default=None,
        metavar="SCALE",
        help="sequential temporal warm start (HS, single level): seed each "
             "pair's solve with the previous flow scaled by SCALE "
             "(default 1.0) — cuts the iteration budget several-fold on "
             "coherent video (video.flow_stream_warm)",
    )
    pv.add_argument(
        "--warm-warp", action="store_true",
        help="with --warm: warp frame 2 by the prior and solve the "
             "residual (pyramid bootstrap on the first pair) — tracks "
             "motion beyond the ~1 px HS linearization range",
    )
    pv.add_argument("--method", choices=["hs", "lk", "tvl1"], default=None,
                    help="flow model family (default: config's, hs)")
    pv.add_argument("--egomotion", action="store_true",
                    help="write per-pair ego-motion fits to egomotion.jsonl")
    pv.add_argument("--occlusion", action="store_true",
                    help="also solve backward flow (same batched launches) "
                         "and write fb-occlusion masks occ_XXXXX.png")
    pv.set_defaults(fn=_cmd_video)

    pe = sub.add_parser(
        "eval", help="EPE/AE table over a flow dataset (Middlebury/Sintel/KITTI)"
    )
    pe.add_argument("kind", choices=["middlebury", "sintel", "kitti"])
    pe.add_argument("root", help="dataset root directory")
    pe.add_argument("--seq", help="evaluate a single sequence/frame id")
    pe.add_argument("--limit", type=int, help="max GT-bearing samples")
    pe.add_argument("--out", help="write the per-sequence table as JSON")
    pe.add_argument("--gt-dir", default="flow_occ",
                    help="KITTI GT directory (flow_occ or flow_noc)")
    pe.add_argument("--render-pass", default="clean",
                    help="Sintel render pass (clean or final)")
    pe.add_argument("--method", choices=["hs", "lk", "tvl1"], default=None,
                    help="flow model family (default: config's, hs)")
    pe.set_defaults(fn=_cmd_eval)

    pb = sub.add_parser("bench", help="benchmark harness (sweep throughput, "
                                      "latency, roofline share)")
    pb.add_argument("--shape", default="1024x1280")
    pb.add_argument("--repeats", type=int, default=10)
    pb.add_argument("--profile-dir", help="write a torch.profiler trace here")
    pb.add_argument("--out", help="write RESULTS.json here")
    pb.add_argument(
        "--scaling", action="store_true",
        help="fps at 1/N cards + weak-scaling efficiency",
    )
    pb.set_defaults(fn=_cmd_bench)

    pz = sub.add_parser("viz", help="render a .flo file")
    pz.add_argument("flo")
    pz.add_argument("-o", "--output", required=True)
    pz.add_argument("--needle", action="store_true")
    pz.add_argument("--max-flow", type=float, default=None)
    pz.set_defaults(fn=_cmd_viz)

    pi = sub.add_parser("info", help="device/runtime info")
    pi.set_defaults(fn=_cmd_info)

    ps = sub.add_parser(
        "selftest",
        help="on-device sanity suite (accuracy gate, kernels==oracle, "
             "formats, ego-motion); exit 1 on failure",
    )
    ps.add_argument("--shape", default="128x192")
    ps.add_argument("--iters", type=int, default=800)
    ps.set_defaults(fn=_cmd_selftest)

    args = p.parse_args(argv)
    return args.fn(args, overrides)


if __name__ == "__main__":
    sys.exit(main())
