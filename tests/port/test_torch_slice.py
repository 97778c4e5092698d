"""The port's main path end to end against the JAX reference on the CPU:
hs_solve, hs_pyramid and the warps on the same numpy inputs, the synthetic
data, and that the package imports without JAX.

Tolerances, each with its reason:
  * hs_solve: 2e-6 max |diff| (the reference's kernel-vs-oracle bar). The
    ops and their order are the same; XLA:CPU fuses the jitted chain, so the
    last ulp of single sweeps may differ, and the sweeps carry it along.
  * hs_pyramid: 1e-5. On top of the solve's ulps, the flow upsampling
    applies the same float32 weights as jax.image.resize but as two taps
    per axis, where the reference runs an einsum over the dense weight
    matrices (other rounding of the same sums), and the warp turns those
    differences into frame differences for the next level.
  * warps: 1e-6 for the same flow; the integer sample positions are equal
    and only the float32 blend may round differently under fusion.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.data.synthetic as ref_syn
import opticalflowhs_tpu.pyramid as ref_pyr
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.solver import Flow as RefFlow
from opticalflowhs_tpu.solver import hs_solve as ref_hs_solve
import opticalflowhs_tpu_torch.data.synthetic as syn
import opticalflowhs_tpu_torch.pyramid as pyr
from opticalflowhs_tpu_torch import Flow, HSConfig, PyramidConfig, hs_pyramid, hs_solve
from opticalflowhs_tpu_torch.io.flo import read_flo, write_flo
from opticalflowhs_tpu_torch.metrics import epe, interior

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
SOLVE_TOL = 2e-6
PYRAMID_TOL = 1e-5
WARP_TOL = 1e-6


def _max_diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize(
    "shape,alpha,iters",
    [((64, 80), 0.5, 100), ((67, 93), 1.0, 50), ((128, 192), 0.1, 300)],
)
def test_hs_solve_matches_reference(shape, alpha, iters):
    i1, i2, _ = syn.translation_pair(*shape, 1.0, 0.5, key=7)
    got = hs_solve(torch.from_numpy(i1), torch.from_numpy(i2),
                   HSConfig(alpha=alpha, iters=iters))
    want = ref_hs_solve(jnp.asarray(i1), jnp.asarray(i2),
                        RefHS(alpha=alpha, iters=iters, backend="jnp"))
    assert _max_diff(got.u, want.u) <= SOLVE_TOL
    assert _max_diff(got.v, want.v) <= SOLVE_TOL


@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_hs_solve_warm_start_matches_reference(variant):
    i1, i2, _ = syn.translation_pair(67, 93, 0.5, -0.5, key=3)
    rng = np.random.default_rng(11)
    u0, v0 = (rng.normal(0, 0.3, (67, 93)).astype(np.float32) for _ in range(2))
    got = hs_solve(torch.from_numpy(i1), torch.from_numpy(i2),
                   HSConfig(alpha=0.5, iters=40, deriv_variant=variant),
                   init=Flow(u0, v0))
    want = ref_hs_solve(jnp.asarray(i1), jnp.asarray(i2),
                        RefHS(alpha=0.5, iters=40, deriv_variant=variant,
                              backend="jnp"),
                        init=RefFlow(jnp.asarray(u0), jnp.asarray(v0)))
    assert _max_diff(got.u, want.u) <= SOLVE_TOL
    assert _max_diff(got.v, want.v) <= SOLVE_TOL


def test_hs_solve_input_errors():
    a = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="frame shapes differ: \\(8, 8\\) vs \\(8, 9\\)"):
        hs_solve(a, torch.zeros(8, 9))
    with pytest.raises(ValueError, match="2-D"):
        hs_solve(torch.zeros(2, 8, 8), torch.zeros(2, 8, 8))


@pytest.mark.parametrize(
    "cfg",
    [HSConfig(solver="sor", omega=1.6, dtype="bfloat16"),
     HSConfig(tol=1e-3, dtype="bfloat16"), HSConfig(dtype="bfloat16")],
)
def test_unported_configs_raise(cfg):
    """bfloat16 SOR is still to port and raises; bfloat16 Jacobi, to a
    fixed count or to tolerance, solves: interior mean <= 0.02 px and max
    <= 0.1 px against the reference's float32 solve (tests/port/
    test_torch_bf16.py states the bars)."""
    if cfg.solver != "jacobi":
        a = torch.zeros(16, 16)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            hs_solve(a, a, cfg)
        return
    i1, i2, _ = syn.translation_pair(48, 64, 1.0, 0.5, key=7)
    got = hs_solve(torch.from_numpy(i1), torch.from_numpy(i2), cfg)
    want = ref_hs_solve(jnp.asarray(i1), jnp.asarray(i2),
                        RefHS(alpha=cfg.alpha, iters=cfg.iters, tol=cfg.tol, backend="jnp"))
    assert got.u.dtype == got.v.dtype == torch.bfloat16
    for g, w in zip(got, want):
        d = np.abs(g.float().numpy() - np.asarray(w))[8:-8, 8:-8]
        assert d.mean() <= 0.02 and d.max() <= 0.1, (d.mean(), d.max())


@pytest.mark.parametrize(
    "shape,levels,iters", [((128, 192), 3, 20), ((67, 93), 2, 30)]
)
def test_hs_pyramid_matches_reference(shape, levels, iters):
    i1, i2, _ = syn.translation_pair(*shape, 2.5, -1.0, key=5, max_freq=0.08)
    got = hs_pyramid(torch.from_numpy(i1), torch.from_numpy(i2),
                     HSConfig(alpha=1.0, iters=iters), PyramidConfig(levels=levels))
    want = ref_pyr.hs_pyramid(jnp.asarray(i1), jnp.asarray(i2),
                              RefHS(alpha=1.0, iters=iters, backend="jnp"),
                              RefPyr(levels=levels))
    assert _max_diff(got.u, want.u) <= PYRAMID_TOL
    assert _max_diff(got.v, want.v) <= PYRAMID_TOL


def test_pyramid_too_many_levels_rejected():
    with pytest.raises(ValueError, match="below 8 px"):
        hs_pyramid(torch.zeros(16, 16), torch.zeros(16, 16),
                   pyr=PyramidConfig(levels=3))


@pytest.mark.parametrize("shape", [(64, 96), (33, 47), (67, 93)])
def test_downsample_matches_reference(shape):
    img = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    got = pyr.downsample2x(torch.from_numpy(img))
    want = ref_pyr.downsample2x(jnp.asarray(img))
    assert got.shape == want.shape
    assert _max_diff(got, want) <= WARP_TOL


@pytest.mark.parametrize(
    "src,dst", [((8, 8), (16, 16)), ((34, 47), (67, 93)), ((17, 24), (33, 47))]
)
def test_upsample_flow_matches_reference(src, dst):
    rng = np.random.default_rng(4)
    u, v = (rng.normal(0, 2, src).astype(np.float32) for _ in range(2))
    got = pyr.upsample_flow(Flow(torch.from_numpy(u), torch.from_numpy(v)), dst)
    want = ref_pyr.upsample_flow(RefFlow(jnp.asarray(u), jnp.asarray(v)), dst)
    # float32 values of magnitude ~10 after scaling: a few ulps of 1e-6.
    assert _max_diff(got.u, want.u) <= 4e-6
    assert _max_diff(got.v, want.v) <= 4e-6


def _smooth_flow(shape, amp, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u = amp * np.sin(xx / 9.0 + rng.uniform(0, 6)) + rng.normal(0, 0.3, shape)
    v = amp * np.cos(yy / 7.0 + rng.uniform(0, 6)) + rng.normal(0, 0.3, shape)
    return u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize(
    "amp,radius",
    [(1.0, 0), (1.0, 4), (6.0, 0), (6.0, 4), (6.0, 2), (12.0, 8)],
)
def test_warp_tiled_matches_reference(amp, radius):
    # amp 6 and 12 make the per-tile deviation exceed 4 (and 8) px, where
    # the reference's clamp makes the tiled warp differ from the gather.
    shape = (70, 150)
    img = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    u, v = _smooth_flow(shape, amp, seed=3)
    t = [torch.from_numpy(a) for a in (img, u, v)]
    j = [jnp.asarray(a) for a in (img, u, v)]
    got = pyr.warp_bilinear_tiled(*t, radius)
    want = ref_pyr.warp_bilinear_tiled(*j, radius)
    assert _max_diff(got, want) <= WARP_TOL
    if amp > 4:
        assert float(pyr.tile_deviation(t[1], t[2])) > 4
        gather = ref_pyr.warp_bilinear(*j)
        assert _max_diff(want, gather) > 1e-3  # the clamp is exercised


@pytest.mark.parametrize("method,amp", [("gather", 6.0), ("checked", 1.0),
                                        ("checked", 6.0), ("checked", 20.0)])
def test_warp_dispatch_matches_reference(method, amp):
    shape = (70, 150)
    img = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    u, v = _smooth_flow(shape, amp, seed=4)
    got = pyr.warp(*(torch.from_numpy(a) for a in (img, u, v)), method=method)
    want = ref_pyr.warp(*(jnp.asarray(a) for a in (img, u, v)), method=method)
    assert _max_diff(got, want) <= WARP_TOL


def test_warp_of_a_stack_matches_reference():
    # A (B, H, W) stack with one shared flow, and with a flow per image,
    # through `warp`, which sends stacks to the gather as the reference does.
    shape = (40, 150)
    img = np.random.default_rng(1).uniform(0, 1, (3,) + shape).astype(np.float32)
    flows = [_smooth_flow(shape, amp, seed=10 + k) for k, amp in enumerate((1.0, 6.0, 3.0))]
    u, v = np.stack([f[0] for f in flows]), np.stack([f[1] for f in flows])
    for fu, fv in ((u[1], v[1]), (u, v)):
        got = pyr.warp(*(torch.from_numpy(a) for a in (img, fu, fv)))
        want = ref_pyr.warp(*(jnp.asarray(a) for a in (img, fu, fv)))
        assert got.shape == img.shape
        assert _max_diff(got, want) <= WARP_TOL
    stack = torch.rand(2, 16, 24)
    z = torch.zeros(16, 24)
    assert torch.equal(pyr.warp(stack, z, z), stack)


@pytest.mark.parametrize("entry", [hs_solve, hs_pyramid])
def test_numpy_without_device_or_cuda_raises(entry, monkeypatch):
    # numpy frames go to the `device` keyword, cuda:0 by default; without a
    # CUDA device that default raises and nothing runs on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    i1, i2, _ = syn.translation_pair(32, 32, 1.0, 0.5, key=2)
    with pytest.raises(RuntimeError, match="device"):
        entry(i1, i2, HSConfig(iters=2))
    on_cpu = entry(i1, i2, HSConfig(iters=2), device="cpu")
    assert on_cpu.u.device.type == "cpu"
    assert torch.equal(on_cpu.u, entry(torch.from_numpy(i1), torch.from_numpy(i2),
                                       HSConfig(iters=2)).u)


@pytest.mark.parametrize(
    "args",
    [
        (48, 64, ref_syn.WarpSpec.translation(1.5, -0.5), 2),
        (40, 56, ref_syn.WarpSpec.rotation(3.0), 9),
        (33, 31, ref_syn.WarpSpec.zoom(1.05), 4),
    ],
)
def test_synthetic_pair_bitwise(args):
    h, w, spec, key = args
    port_spec = syn.WarpSpec(a=spec.a, t=spec.t)
    got = syn.synthetic_pair(h, w, port_spec, key=key)
    want = ref_syn.synthetic_pair(h, w, spec, key=key)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(
        syn.translation_pair(20, 30, 1.0, 0.5, key=3)[1],
        ref_syn.translation_pair(20, 30, 1.0, 0.5, key=3)[1],
    )


def test_flow_roundtrip_and_epe(tmp_path):
    # The verify recipe's gate: interior EPE < 0.05 against the analytic
    # ground truth of a 1 px shift (the reference measured 0.034).
    i1, i2, gt = syn.translation_pair(128, 192, 1.0, 0.5, key=3)
    flow = hs_solve(torch.from_numpy(i1), torch.from_numpy(i2),
                    HSConfig(alpha=0.1, iters=1500))
    f = np.stack([flow.u.numpy(), flow.v.numpy()], axis=-1)
    write_flo(tmp_path / "out.flo", f)
    np.testing.assert_array_equal(read_flo(tmp_path / "out.flo"), f)
    assert epe(interior(f, 10), interior(gt, 10)) < 0.05


# Every name of the reference's `io` and `data` is ported.
_IO_UNPORTED: set = set()


@pytest.mark.parametrize("sub,unported", [("data", set()), ("io", _IO_UNPORTED)])
def test_subpackages_export_the_references_names(sub, unported):
    import importlib

    ref = importlib.import_module(f"opticalflowhs_tpu.{sub}")
    port = importlib.import_module(f"opticalflowhs_tpu_torch.{sub}")
    assert sorted(port.__all__) == sorted(set(ref.__all__) - unported)
    assert not unported
    for name in port.__all__:
        assert callable(getattr(port, name))
    from opticalflowhs_tpu_torch.data import translation_pair
    from opticalflowhs_tpu_torch.io import read_flo as read
    assert translation_pair is syn.translation_pair and read is read_flo


def _public_names(mod) -> set:
    """Names a module defines for its users: not private, not modules, and
    not functions, classes or typing objects imported from elsewhere."""
    import inspect

    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        if getattr(value, "__module__", mod.__name__) != mod.__name__:
            continue
        out.add(name)
    return out


@pytest.mark.parametrize("name", [
    "io", "io.flo", "io.images", "io.kitti", "io.native", "io.png16", "viz",
    "logging_util", "data.datasets", "bench", "cli",
])
def test_host_modules_define_the_references_names(name):
    import importlib

    ref = importlib.import_module(f"opticalflowhs_tpu.{name}")
    port = importlib.import_module(f"opticalflowhs_tpu_torch.{name}")
    assert _public_names(port) == _public_names(ref)


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['opticalflowhs_tpu'] = None\n"
        "import opticalflowhs_tpu_torch as p\n"
        "import opticalflowhs_tpu_torch.pyramid, opticalflowhs_tpu_torch.metrics\n"
        "import opticalflowhs_tpu_torch.kernels.solve_resident\n"
        "import opticalflowhs_tpu_torch.batch, opticalflowhs_tpu_torch.video\n"
        "import opticalflowhs_tpu_torch.consistency, opticalflowhs_tpu_torch.lucas_kanade\n"
        "import opticalflowhs_tpu_torch.egomotion\n"
        "from opticalflowhs_tpu_torch import LKConfig, RunConfig, lk_solve, lk_solve_batched\n"
        "from opticalflowhs_tpu_torch.config import load_config, config_hash\n"
        "from opticalflowhs_tpu_torch.metrics import hs_energy\n"
        "import opticalflowhs_tpu_torch.tvl1, opticalflowhs_tpu_torch.kernels.tvl1_inner\n"
        "import opticalflowhs_tpu_torch.kernels.sor, opticalflowhs_tpu_torch.kernels.solve_robust\n"
        "import opticalflowhs_tpu_torch.robust, opticalflowhs_tpu_torch.checkpoint\n"
        "import opticalflowhs_tpu_torch.kernels.solve_fused\n"
        "import opticalflowhs_tpu_torch.kernels.solve_skewed\n"
        "import opticalflowhs_tpu_torch.kernels.sor_planes, opticalflowhs_tpu_torch.multigrid\n"
        "import opticalflowhs_tpu_torch.data.synthetic, opticalflowhs_tpu_torch.io.flo\n"
        "from opticalflowhs_tpu_torch.data import translation_pair\n"
        "from opticalflowhs_tpu_torch.io import read_flo, write_flo\n"
        "import opticalflowhs_tpu_torch.dist, opticalflowhs_tpu_torch.dist.halo\n"
        "import opticalflowhs_tpu_torch.dist.mesh, opticalflowhs_tpu_torch.dist.tiled_solver\n"
        "import opticalflowhs_tpu_torch.dist.pyramid_tiled\n"
        "import opticalflowhs_tpu_torch.kernels.tile, opticalflowhs_tpu_torch.kernels.ring\n"
        "import opticalflowhs_tpu_torch.cli, opticalflowhs_tpu_torch.bench\n"
        "import opticalflowhs_tpu_torch.viz, opticalflowhs_tpu_torch.logging_util\n"
        "import opticalflowhs_tpu_torch.io.images, opticalflowhs_tpu_torch.io.kitti\n"
        "import opticalflowhs_tpu_torch.io.native, opticalflowhs_tpu_torch.io.png16\n"
        "import opticalflowhs_tpu_torch.data.datasets\n"
        "from opticalflowhs_tpu_torch.io import load_gray, read_flow, write_flow\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'opticalflowhs_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print(p.hs_solve.__name__)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "hs_solve"
