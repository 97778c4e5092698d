"""The port's command line (`hsflow-torch`, opticalflowhs_tpu_torch.cli) on
the CPU (`--device cpu`) against the reference's `hsflow` and against the
port's own entry points.

Bars, each with its reason:
  * `run` at 3 levels: the .flo within 1e-5 of the reference CLI's (the
    pyramid bar of test_torch_slice.py: the flow upsampling rounds
    differently, and the warp carries it to the next level);
  * `run` at 1 level, HS and LK: within 2e-6 (the single-solve bar);
  * `eval middlebury`: each sequence's EPE within 1e-5 of the reference
    CLI's table (the flows differ by the pyramid bar);
  * the CLI against the port's own entry points, renders, KITTI files and
    dataset tables: bitwise (the same calls on the same frames);
  * refusals: the reference's message, rendered from its own source.

The reference CLI is invoked four times in all (three runs and one eval,
in module-scoped fixtures), because each of its solves compiles.
"""

import argparse
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import opticalflowhs_tpu.cli as ref_cli
import opticalflowhs_tpu.io.native as ref_native
from opticalflowhs_tpu.bench import run_bench as ref_run_bench
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.config import RunConfig as RefRun
from opticalflowhs_tpu import viz as ref_viz
from opticalflowhs_tpu.io import read_flow as ref_read_flow
from opticalflowhs_tpu.io.images import save_image as ref_save_image
import opticalflowhs_tpu_torch.cli as cli
from opticalflowhs_tpu_torch import (
    Flow,
    HSConfig,
    PyramidConfig,
    TVL1Config,
    flow_stream,
    flow_stream_warm,
    flow_with_occlusion,
    hs_pyramid,
    tvl1_solve,
)
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence, translation_pair
from opticalflowhs_tpu_torch.egomotion import estimate_egomotion
from opticalflowhs_tpu_torch.io import kitti, native, read_flow
from opticalflowhs_tpu_torch.io.flo import read_flo, write_flo
from opticalflowhs_tpu_torch.io.images import load_gray, save_image
from opticalflowhs_tpu_torch.video import flow_stream_occlusion
from opticalflowhs_tpu_torch.viz import flow_to_color

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
PYRAMID_TOL = 1e-5
SOLVE_TOL = 2e-6
EPE_TOL = 1e-5
ITERS = ["--cfg.iters", "20"]
CPU = ["--device", "cpu"]


def _max_diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _flow_np(f):
    return np.stack([f.u.numpy(), f.v.numpy()], axis=-1)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A 48x64 frame pair as PGM files and a Middlebury tree of four
    48x64 translation pairs (PNG frames, .flo ground truth)."""
    d = tmp_path_factory.mktemp("cli")
    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=3)
    save_image(d / "f1.pgm", i1)
    save_image(d / "f2.pgm", i2)
    mb = d / "mb"
    for k, (tx, ty) in enumerate(((1.0, 0.5), (-0.5, 0.25), (0.75, -1.0), (0.0, 0.5))):
        a, b, gt = translation_pair(48, 64, tx, ty, key=10 + k)
        seq = mb / "other-data" / f"seq{k}"
        seq.mkdir(parents=True)
        save_image(seq / "frame10.png", a)
        save_image(seq / "frame11.png", b)
        g = mb / "other-gt-flow" / f"seq{k}"
        g.mkdir(parents=True)
        write_flo(g / "flow10.flo", np.broadcast_to(gt, (48, 64, 2)).astype(np.float32))
    return d


@pytest.fixture(scope="module")
def ref_runs(work):
    """The reference CLI's four invocations."""
    f1, f2 = str(work / "f1.pgm"), str(work / "f2.pgm")
    out = {k: str(work / f"ref_{k}.flo") for k in ("l3", "l1", "lk")}
    assert ref_cli.main(["run", f1, f2, "-o", out["l3"]] + ITERS) == 0
    assert ref_cli.main(["run", f1, f2, "-o", out["l1"], "--pyramid.levels", "1"] + ITERS) == 0
    assert ref_cli.main(["run", f1, f2, "-o", out["lk"], "--method", "lk",
                         "--pyramid.levels", "1"]) == 0
    out["eval"] = str(work / "ref_eval.json")
    assert ref_cli.main(["eval", "middlebury", str(work / "mb"), "--out", out["eval"]]
                        + ITERS) == 0
    return out


@pytest.fixture(scope="module")
def port_runs(work):
    f1, f2 = str(work / "f1.pgm"), str(work / "f2.pgm")
    out = {k: str(work / f"port_{k}.flo") for k in ("l3", "l1", "lk")}
    assert cli.main(CPU + ["run", f1, f2, "-o", out["l3"]] + ITERS) == 0
    assert cli.main(CPU + ["run", f1, f2, "-o", out["l1"], "--pyramid.levels", "1"]
                    + ITERS) == 0
    assert cli.main(CPU + ["run", f1, f2, "-o", out["lk"], "--method", "lk",
                           "--pyramid.levels", "1"]) == 0
    out["eval"] = str(work / "port_eval.json")
    assert cli.main(CPU + ["eval", "middlebury", str(work / "mb"), "--out", out["eval"]]
                    + ITERS) == 0
    return out


@pytest.mark.parametrize("leg,tol", [("l3", PYRAMID_TOL), ("l1", SOLVE_TOL), ("lk", SOLVE_TOL)])
def test_run_matches_reference_cli(ref_runs, port_runs, leg, tol):
    got, want = read_flo(port_runs[leg]), read_flo(ref_runs[leg])
    assert got.shape == want.shape == (48, 64, 2)
    assert _max_diff(got, want) <= tol


def test_run_equals_the_entry_point(work, port_runs):
    i1, i2 = load_gray(work / "f1.pgm"), load_gray(work / "f2.pgm")
    want = hs_pyramid(i1, i2, HSConfig(iters=20), PyramidConfig(), device="cpu")
    assert np.array_equal(read_flo(port_runs["l3"]), _flow_np(want))


def test_eval_matches_reference_cli(ref_runs, port_runs):
    got = json.loads(Path(port_runs["eval"]).read_text())
    want = json.loads(Path(ref_runs["eval"]).read_text())
    assert sorted(got) == sorted(want) == ["ALL", "seq0", "seq1", "seq2", "seq3"]
    for seq in want:
        assert got[seq]["n"] == want[seq]["n"]
        assert abs(got[seq]["epe"] - want[seq]["epe"]) <= EPE_TOL


def test_eval_equals_evaluate_on_the_entry_point(work, port_runs, capsys):
    from opticalflowhs_tpu_torch.data.datasets import MiddleburyDataset, evaluate

    def solve(a, b):
        return _flow_np(hs_pyramid(a, b, HSConfig(iters=20), PyramidConfig(), device="cpu"))

    want = evaluate(MiddleburyDataset(str(work / "mb")), solve)
    assert json.loads(Path(port_runs["eval"]).read_text()) == want
    assert cli.main(CPU + ["eval", "middlebury", str(work / "mb"), "--method", "lk",
                           "--limit", "2", "--seq", "seq1", "--pyramid.levels", "2"]) == 0
    out = capsys.readouterr().out
    assert "seq1" in out and "method=lk levels=2" in out


def test_run_writes_kitti_renders_occlusion_and_egomotion(work, port_runs, capsys):
    f1, f2 = str(work / "f1.pgm"), str(work / "f2.pgm")
    k, v, n, o = (str(work / name) for name in ("k.png", "v.png", "n.png", "o.png"))
    assert cli.main(CPU + ["run", f1, f2, "-o", k, "--viz", v, "--needle", n,
                           "--egomotion"] + ITERS) == 0
    out = capsys.readouterr().out
    flow = read_flo(port_runs["l3"])
    kitti.write_flow_png(work / "k_want.png", flow)
    assert Path(k).read_bytes() == (work / "k_want.png").read_bytes()
    assert np.array_equal(read_flow(k), kitti.read_flow_png(k)[0])
    # Renders: the port's viz of the run's flow, as the reference saves them.
    i1 = load_gray(f1)
    ref_save_image(work / "v_want.png", ref_viz.flow_to_color(flow))
    ref_save_image(work / "n_want.png", ref_viz.needle_plot(flow, background=i1))
    assert Path(v).read_bytes() == (work / "v_want.png").read_bytes()
    assert Path(n).read_bytes() == (work / "n_want.png").read_bytes()
    fl = Flow(torch.from_numpy(flow[..., 0].copy()), torch.from_numpy(flow[..., 1].copy()))
    em = estimate_egomotion(fl)
    assert f"egomotion: tx={float(em.tx):+.4f} ty={float(em.ty):+.4f}" in out

    assert cli.main(CPU + ["run", f1, f2, "-o", str(work / "occ.flo"),
                           "--occlusion", o] + ITERS) == 0
    fwd, mask = flow_with_occlusion(i1, load_gray(f2), HSConfig(iters=20),
                                    PyramidConfig(), device="cpu")
    assert np.array_equal(read_flo(work / "occ.flo"), _flow_np(fwd))
    assert np.array_equal(load_gray(o), mask.numpy().astype(np.float32))
    assert f"wrote {o} ({100 * mask.numpy().mean():.1f}% flagged)" in capsys.readouterr().out


def test_run_tvl1_equals_the_entry_point(work):
    f1, f2 = str(work / "f1.pgm"), str(work / "f2.pgm")
    out = str(work / "tv.flo")
    assert cli.main(CPU + ["run", f1, f2, "-o", out, "--method", "tvl1",
                           "--pyramid.levels", "1", "--tvl1.warps", "2",
                           "--tvl1.iters", "10"]) == 0
    want = tvl1_solve(load_gray(f1), load_gray(f2), TVL1Config(warps=2, iters=10),
                      PyramidConfig(levels=1), device="cpu")
    assert np.array_equal(read_flo(out), _flow_np(want))


@pytest.fixture(scope="module")
def video_dir(work):
    frames, _ = synthetic_sequence(7, 32, 48, tx=1.0, ty=0.5)
    d = work / "frames"
    d.mkdir()
    for k, f in enumerate(frames):
        save_image(d / f"frame_{k:03d}.pgm", f)
    (d / "readme.txt").write_text("not a frame")
    return d


def _video_flows(out_dir):
    paths = sorted(p for p in os.listdir(out_dir) if p.startswith("flow_") and p.endswith(".flo"))
    return np.stack([read_flo(Path(out_dir) / p) for p in paths])


def _decoded(video_dir):
    return np.stack([load_gray(video_dir / p) for p in sorted(os.listdir(video_dir))
                     if p.endswith(".pgm")])


def test_video_loaders_agree_and_equal_flow_stream(work, video_dir, monkeypatch):
    args = CPU + ["video", str(video_dir), "--chunk", "4", "--cfg.iters", "15"]
    used = []
    if native.build() and native.available():
        real = native.stream_frames
        monkeypatch.setattr(native, "stream_frames",
                            lambda *a, **k: (used.append(1), real(*a, **k))[1])
        assert cli.main(args + ["-o", str(work / "v_native")]) == 0
        assert used, "the native loader did not run"
    monkeypatch.setattr(native, "can_decode", lambda p: False)
    assert cli.main(args + ["-o", str(work / "v_python"), "--viz"]) == 0
    got = _video_flows(work / "v_python")
    assert got.shape == (6, 32, 48, 2)
    if used:
        assert np.array_equal(_video_flows(work / "v_native"), got)
    # The CLI streams at the config's pyramid, 3 levels by default.
    chunks = list(flow_stream(_decoded(video_dir), HSConfig(iters=15), PyramidConfig(),
                              chunk=4, device="cpu"))
    want = np.concatenate([np.stack([c.u.numpy(), c.v.numpy()], axis=-1) for c in chunks])
    assert np.array_equal(got, want)
    save_image(work / "v_want2.png", flow_to_color(got[2]))
    assert (work / "v_want2.png").read_bytes() == (
        work / "v_python" / "flow_00002.png").read_bytes()


def test_video_warm_occlusion_and_egomotion(work, video_dir):
    base = CPU + ["video", str(video_dir), "--chunk", "4", "--cfg.iters", "15"]
    assert cli.main(base + ["-o", str(work / "v_warm"), "--warm", "0.9", "--warm-warp"]) == 0
    want = list(flow_stream_warm(_decoded(video_dir), HSConfig(iters=15), warm_scale=0.9,
                                 chunk=4, warp_prior=True, device="cpu"))
    assert np.array_equal(_video_flows(work / "v_warm"), np.stack([_flow_np(f) for f in want]))

    assert cli.main(base + ["-o", str(work / "v_occ"), "--occlusion", "--egomotion"]) == 0
    got = _video_flows(work / "v_occ")
    fwd, masks = [], []
    for f, m in flow_stream_occlusion(_decoded(video_dir), HSConfig(iters=15),
                                      PyramidConfig(), chunk=4, device="cpu"):
        fwd.append(np.stack([f.u.numpy(), f.v.numpy()], axis=-1))
        masks.append(m.numpy())
    assert np.array_equal(got, np.concatenate(fwd))
    masks = np.concatenate(masks)
    for k in range(6):
        assert np.array_equal(load_gray(work / "v_occ" / f"occ_{k:05d}.png"),
                              masks[k].astype(np.float32))
    lines = (work / "v_occ" / "egomotion.jsonl").read_text().splitlines()
    assert [json.loads(x)["pair"] for x in lines] == list(range(6))
    for k, line in enumerate(lines):
        em = estimate_egomotion(Flow(torch.from_numpy(got[k, ..., 0].copy()),
                                     torch.from_numpy(got[k, ..., 1].copy())))
        rec = json.loads(line)
        assert rec["tx"] == float(em.tx) and rec["ty"] == float(em.ty)


def test_bench_returns_the_references_keys(work, capsys):
    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    want = ref_run_bench(RefRun(hs=RefHS(iters=2), pyramid=RefPyr(levels=2)),
                         shape=(16, 24), repeats=1)
    out = work / "bench.json"
    prof = work / "prof"
    assert cli.main(CPU + ["bench", "--shape", "16x24", "--repeats", "1", "--cfg.iters", "2",
                           "--pyramid.levels", "2", "--out", str(out),
                           "--profile-dir", str(prof)]) == 0
    got = json.loads(out.read_text())
    assert keys(got) == keys(want)
    assert json.loads(capsys.readouterr().out) == got
    assert got["device"] == "cpu" and got["shape"] == [16, 24] and got["iters"] == 2
    # No memory rate for the CPU: null roofline fields, never a default.
    st = got["sweep_throughput"]
    assert st["roofline_GBps"] is None and st["fraction_of_roofline"] is None
    assert st["ms_per_solve"] > 0 and got["pyramid"]["fps"] > 0
    assert os.listdir(prof)
    assert cli.main(CPU + ["bench", "--scaling", "--shape", "16x24", "--repeats", "1",
                           "--cfg.iters", "2"]) == 0
    scaling = json.loads(capsys.readouterr().out)
    # The reference's keys on one device (its multi-device legs add theirs).
    assert sorted(scaling) == ["device", "fps_1chip_batched", "iters", "n_devices", "shape"]


def test_bench_roofline_tables_are_the_cards():
    from opticalflowhs_tpu_torch import bench

    h100 = "NVIDIA H100 80GB HBM3"
    assert bench.roofline_gpx_sweeps(h100) == 3350.0 / 32
    assert bench.compute_roofline_gpx_sweeps(h100) == 67.0 * 1e3 / 27
    assert bench.roofline_gpx_sweeps("TPU v5e") is None
    assert bench.compute_roofline_gpx_sweeps("cpu") is None


def test_viz_subcommand_matches_the_reference_renders(work, port_runs, capsys):
    src = port_runs["l3"]
    kitti.write_flow_png(work / "viz_src.png", read_flo(src))
    for flo in (src, str(work / "viz_src.png")):
        f = ref_read_flow(flo)
        for extra, img in (([], ref_viz.flow_to_color(f)),
                           (["--max-flow", "2"], ref_viz.flow_to_color(f, max_flow=2.0)),
                           (["--needle"], ref_viz.needle_plot(f))):
            assert cli.main(["viz", flo, "-o", str(work / "z.png")] + extra) == 0
            ref_save_image(work / "z_want.png", img)
            assert (work / "z.png").read_bytes() == (work / "z_want.png").read_bytes()
    assert "wrote" in capsys.readouterr().out


def test_selftest_on_cpu_skips_only_the_kernel_check(capsys):
    assert cli.main(CPU + ["selftest", "--shape", "32x48"]) == 0
    out = capsys.readouterr().out
    assert out.count("[PASS]") == 6 and "[FAIL]" not in out
    assert "  [SKIP] cuda == torch oracle <= 2e-5 (no kernels on cpu)" in out.splitlines()
    assert "OK: all checks passed" in out


def test_info_lists_versions(capsys):
    import opticalflowhs_tpu_torch

    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"opticalflowhs_tpu_torch {opticalflowhs_tpu_torch.__version__}" in out
    assert f"torch {torch.__version__}, cuda runtime {torch.version.cuda}" in out


def test_without_cuda_the_default_device_exits_and_never_solves(work, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f1, f2 = str(work / "f1.pgm"), str(work / "f2.pgm")
    for argv in (["run", f1, f2, "-o", str(work / "never.flo")],
                 ["video", str(work), "-o", str(work / "never")],
                 ["eval", "middlebury", str(work / "mb")],
                 ["bench", "--shape", "16x16"],
                 ["selftest", "--shape", "32x48"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code != 0
        assert "no CUDA device is available" in str(e.value.code)
    assert not (work / "never.flo").exists() and not (work / "never").exists()


def _reference_refusals(**names):
    """Every SystemExit message of the reference CLI's source that renders
    with these names bound."""
    tree = ast.parse(Path(ref_cli.__file__).read_text())
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                and getattr(node.exc.func, "id", None) == "SystemExit" and node.exc.args):
            expr = ast.Expression(node.exc.args[0])
            try:
                out.add(eval(compile(expr, "ref_cli", "eval"),
                             {"native": ref_native}, dict(names)))
            except (NameError, AttributeError):
                pass
    return out


def _refusal(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code not in (0, None)
    return str(e.value.code)


def test_refusals_match_the_reference(work, video_dir, monkeypatch):
    f1, f2 = str(work / "f1.pgm"), str(work / "f2.pgm")
    vid = CPU + ["video", str(video_dir), "-o", str(work / "refused")]
    cases = [
        (vid + ["--warm", "--occlusion"], {}),
        (vid + ["--warm", "--pyramid.levels", "2"], {}),
        (vid + ["--warm", "--mesh.batch", "2"], {}),
        (vid + ["--warm-warp"], {}),
        (vid + ["--warm", "--method", "lk"], {}),
        (CPU + ["video", str(work / "absent"), "-o", str(work / "refused")], {}),
    ]
    for argv, names in cases:
        args = argparse.Namespace(frames=argv[argv.index("video") + 1])
        msg = _refusal(argv)
        assert msg in _reference_refusals(args=args, **names), msg
    monkeypatch.setattr(native, "video_available", lambda: False)
    for argv in (CPU + ["video", "cam:0", "-o", str(work / "refused")],
                 vid + ["--viz-video", str(work / "v.avi")]):
        msg = _refusal(argv)
        args = argparse.Namespace(frames=argv[argv.index("video") + 1])
        assert msg in _reference_refusals(args=args), msg
    # An unknown method cannot come from the command line (argparse and
    # RunConfig refuse it first): the dispatcher's own refusal.
    ns = argparse.Namespace(config=None, device="cpu", method="sift", frame1=f1,
                            frame2=f2, occlusion=None)
    for fn in (cli._cmd_run, cli._cmd_video):
        ns.frames = str(video_dir)
        with pytest.raises(SystemExit) as e:
            fn(ns, {})
        assert str(e.value.code) in _reference_refusals(method="sift")
    assert _refusal(CPU + ["run", f1, "--cfg.alpha"]) == "missing value for --cfg.alpha"
    assert "missing value for --cfg.alpha" in _reference_refusals(a="--cfg.alpha")


def test_routes_waiting_for_dist_exit_with_their_message(work, video_dir):
    # These four commands once ended with the refusal of a route still to be
    # ported (the rest of dist/); now each writes the flow of its entry point,
    # called with the same mesh (a virtual mesh of the CPU), bitwise.
    from opticalflowhs_tpu_torch import LKConfig, MeshConfig, lk_solve
    from opticalflowhs_tpu_torch.dist import make_mesh
    from opticalflowhs_tpu_torch.lucas_kanade import lk_solve_tiled
    from opticalflowhs_tpu_torch.tvl1 import tvl1_solve_tiled

    f1, f2 = str(work / "f1.pgm"), str(work / "f2.pgm")
    i1, i2 = load_gray(f1), load_gray(f2)

    def mesh(**kw):
        cfg = MeshConfig(**kw)
        return make_mesh(cfg, ["cpu"] * (cfg.batch * cfg.y * cfg.x))

    run = CPU + ["run", f1, f2, "-o"]
    assert cli.main(run + [str(work / "m_lk.flo"), "--method", "lk", "--mesh.y", "2"]) == 0
    want = lk_solve_tiled(i1, i2, LKConfig(), PyramidConfig(), mesh=mesh(y=2))
    assert np.array_equal(read_flo(work / "m_lk.flo"), _flow_np(want))
    assert np.array_equal(_flow_np(want), _flow_np(lk_solve(i1, i2, LKConfig(), PyramidConfig(),
                                                            device="cpu")))
    assert cli.main(run + [str(work / "m_tv.flo"), "--method", "tvl1", "--mesh.x", "2",
                           "--tvl1.warps", "1", "--tvl1.iters", "5"]) == 0
    cfg = TVL1Config(warps=1, iters=5)
    want = tvl1_solve_tiled(i1, i2, cfg, PyramidConfig(), mesh=mesh(x=2))
    assert np.array_equal(read_flo(work / "m_tv.flo"), _flow_np(want))
    assert np.array_equal(_flow_np(want), _flow_np(tvl1_solve(i1, i2, cfg, PyramidConfig(),
                                                              device="cpu")))
    o = str(work / "m_occ.png")
    assert cli.main(run + [str(work / "m_occ.flo"), "--occlusion", o, "--mesh.batch", "2"]
                    + ITERS) == 0
    fwd, mask = flow_with_occlusion(i1, i2, HSConfig(iters=20), PyramidConfig(),
                                    mesh=mesh(batch=2))
    assert np.array_equal(read_flo(work / "m_occ.flo"), _flow_np(fwd))
    assert np.array_equal(load_gray(o), mask.numpy().astype(np.float32))
    assert cli.main(CPU + ["video", str(video_dir), "-o", str(work / "m_video"),
                           "--mesh.batch", "2"] + ITERS) == 0
    chunks = flow_stream(_decoded(video_dir), HSConfig(iters=20), PyramidConfig(),
                         mesh=mesh(batch=2))
    want = np.concatenate([np.stack([c.u.numpy(), c.v.numpy()], axis=-1) for c in chunks])
    assert np.array_equal(_video_flows(work / "m_video"), want)
    # A tiled HS run: the tiled pyramid on a virtual mesh of the CPU.
    assert cli.main(run + [str(work / "m_hs.flo"), "--mesh.y", "2", "--mesh.x", "2"]
                    + ITERS) == 0


def test_python_m_runs_without_jax():
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['opticalflowhs_tpu'] = None\n"
        "sys.argv = ['hsflow-torch', 'info']\n"
        "try:\n"
        "    runpy.run_module('opticalflowhs_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'opticalflowhs_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("opticalflowhs_tpu_torch ")


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser a CLI's main builds, caught at parse_args."""
    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main(["info"])
    monkeypatch.undo()
    return seen["parser"]


def _options(parser):
    """{option strings or dest: (dest, default, choices, nargs, const, type,
    required)} of a parser, and its subparsers' by name."""
    opts, subs = {}, {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            subs = {name: _options(sp)[0] for name, sp in a.choices.items()}
            continue
        if isinstance(a, argparse._HelpAction):
            continue
        key = tuple(a.option_strings) or a.dest
        opts[key] = (a.dest, a.default, a.choices, a.nargs, a.const,
                     getattr(a.type, "__name__", a.type), a.required)
    return opts, subs


def test_subcommands_and_flags_equal_the_references(monkeypatch):
    ref_opts, ref_subs = _options(_parser_of(ref_cli.main, monkeypatch))
    opts, subs = _options(_parser_of(cli.main, monkeypatch))
    assert sorted(subs) == sorted(ref_subs) == [
        "bench", "eval", "info", "run", "selftest", "video", "viz"]
    for name in ref_subs:
        assert subs[name] == ref_subs[name], name
    assert opts.pop(("--device",))[:2] == ("device", "cuda")  # the one flag of the port's own
    assert opts == ref_opts


def test_run_bf16_config_writes_the_widened_flow(work):
    # "hs": {"dtype": "bfloat16"}: the .flo holds the bfloat16 flow widened
    # to float32 (exact), bitwise the in-process solve's.
    cfg_file = work / "bf16.json"
    cfg_file.write_text(json.dumps({"hs": {"alpha": 0.5, "iters": 20, "dtype": "bfloat16"},
                                    "pyramid": {"levels": 2}}))
    f1, f2 = str(work / "f1.pgm"), str(work / "f2.pgm")
    out = str(work / "bf16.flo")
    assert cli.main(CPU + ["--config", str(cfg_file), "run", f1, f2, "-o", out]) == 0
    want = hs_pyramid(load_gray(f1), load_gray(f2),
                      HSConfig(alpha=0.5, iters=20, dtype="bfloat16"),
                      PyramidConfig(levels=2), device="cpu")
    assert want.u.dtype == torch.bfloat16
    assert np.array_equal(read_flo(out), np.stack([want.u.float().numpy(),
                                                   want.v.float().numpy()], axis=-1))
