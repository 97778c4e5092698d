"""The port's batched path against the JAX reference on the CPU: the batched
solve (fixed budget and to tolerance), the batched pyramid, the plain
batched kernels against the reference's Pallas kernels in interpret mode,
the batched warps, and the rule that numpy inputs never land on the CPU
unless the caller asks.

Tolerances, each with its reason (as in test_torch_slice.py):
  * solves: 2e-6 max |diff|, the reference's kernel-vs-oracle bar; the ops
    and their order are the same, XLA:CPU fuses the jitted chain, so the
    last ulp of single sweeps may differ, and the sweeps carry it along;
  * the batched pyramid: 1e-5, as hs_pyramid: the flow upsampling rounds
    the same weights differently and the warp carries that into frames;
  * warps: 1e-6 for the same flow; the integer sample positions are equal
    and only the float32 blend may round differently under fusion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.kernels.jacobi as ref_jacobi
import opticalflowhs_tpu.kernels.solve_resident as ref_resident
import opticalflowhs_tpu.pyramid as ref_pyr
from opticalflowhs_tpu.batch import hs_solve_batched as ref_hs_solve_batched
from opticalflowhs_tpu.batch import solve_level_batched as ref_solve_level_batched
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.solver import hs_solve as ref_hs_solve
import opticalflowhs_tpu_torch.pyramid as pyr
from opticalflowhs_tpu_torch import (
    HSConfig,
    LKConfig,
    PyramidConfig,
    flow_stream,
    flow_stream_warm,
    flow_video,
    flow_with_occlusion,
    hs_pyramid,
    hs_solve,
    hs_solve_batched,
)
from opticalflowhs_tpu_torch.batch import solve_level_batched, video_pairs
from opticalflowhs_tpu_torch.consistency import solve_bidirectional
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence
from opticalflowhs_tpu_torch.kernels import _build
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import solve_resident as sr
from opticalflowhs_tpu_torch.video import flow_stream_occlusion

torch.set_num_threads(1)

SOLVE_TOL = 2e-6
SOR_TOL = 1e-5
PYRAMID_TOL = 1e-5
WARP_TOL = 1e-6


# Every |diff| a test measures against the reference, recorded as the junit
# property `max_abs_diff`, so that a run with --junitxml reports the parity
# it held, and not only that it held the bar.
_DIFFS: list[float] = []


@pytest.fixture(autouse=True)
def _report_max_diff(record_property):
    _DIFFS.clear()
    yield
    if _DIFFS:
        record_property("max_abs_diff", max(_DIFFS))


def _max_diff(a, b):
    d = float(np.abs(np.asarray(a) - np.asarray(b)).max())
    _DIFFS.append(d)
    return d


def _stack(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2)]


def _video(t, h, w, key=1):
    frames, _ = synthetic_sequence(t, h, w, tx=1.0, ty=0.5, key=key)
    return frames


@pytest.mark.parametrize(
    "kw",
    [dict(iters=60), dict(iters=200, tol=1e-3), dict(iters=200, tol=5e-4, block_sweeps=8)],
)
def test_hs_solve_batched_matches_reference(kw):
    frames = _video(4, 48, 64)
    i1, i2 = frames[:-1], frames[1:]
    got = hs_solve_batched(i1, i2, HSConfig(alpha=0.5, **kw), device="cpu")
    want = ref_hs_solve_batched(jnp.asarray(i1), jnp.asarray(i2),
                                RefHS(alpha=0.5, backend="jnp", **kw))
    assert got.u.shape == (3, 48, 64)
    assert _max_diff(got.u, want.u) <= SOLVE_TOL
    assert _max_diff(got.v, want.v) <= SOLVE_TOL
    # Each image stops on its own update: the stack equals a loop of
    # single solves, bitwise.
    for b in range(3):
        one = hs_solve(torch.from_numpy(i1[b]), torch.from_numpy(i2[b]),
                       HSConfig(alpha=0.5, **kw))
        assert torch.equal(one.u, got.u[b]) and torch.equal(one.v, got.v[b])


@pytest.mark.parametrize("stacked_ok", [True, False])
@pytest.mark.parametrize(
    "kw,budget",
    [(dict(iters=60), 60), (dict(iters=200, tol=1e-3, block_sweeps=8), 120),
     (dict(solver="sor", omega=1.6, iters=40), 25)],
)
def test_solve_level_batched_matches_reference(kw, budget, stacked_ok):
    # The batch twin of solve_level against the reference's (backend "jnp":
    # its vmapped single-pair solve, each image stopping on its own), with
    # a budget of its own; = hs_solve_batched bitwise at the config's
    # budget. SOR: 1e-5 (its Gauss-Seidel order carries the last ulp on).
    frames = _video(4, 40, 56, key=6)
    i1, i2 = frames[:-1], frames[1:]
    cfg = HSConfig(alpha=0.5, **kw)
    got = solve_level_batched(torch.from_numpy(i1), torch.from_numpy(i2), cfg, budget,
                              stacked_ok)
    want = ref_solve_level_batched(jnp.asarray(i1), jnp.asarray(i2),
                                   RefHS(alpha=0.5, backend="jnp", **kw), budget, stacked_ok)
    bar = SOR_TOL if cfg.solver == "sor" else SOLVE_TOL
    assert got.u.shape == (3, 40, 56)
    assert _max_diff(got.u, want.u) <= bar
    assert _max_diff(got.v, want.v) <= bar
    at_cfg = solve_level_batched(torch.from_numpy(i1), torch.from_numpy(i2), cfg, cfg.iters,
                                 stacked_ok)
    whole = hs_solve_batched(i1, i2, cfg, device="cpu")
    assert torch.equal(at_cfg.u, whole.u) and torch.equal(at_cfg.v, whole.v)


def test_solve_level_batched_takes_stacks_only():
    i1, i2 = _stack((24, 32))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        solve_level_batched(torch.from_numpy(i1), torch.from_numpy(i2), HSConfig(), 4)


@pytest.mark.parametrize("kw", [dict(tol=2e-3), dict(tol=1e-4, block_sweeps=5)])
def test_hs_solve_to_tolerance_matches_reference(kw):
    i1, i2 = _video(2, 48, 64, key=4)
    got = hs_solve(i1, i2, HSConfig(alpha=0.3, iters=120, **kw), device="cpu")
    want = ref_hs_solve(jnp.asarray(i1), jnp.asarray(i2),
                        RefHS(alpha=0.3, iters=120, backend="jnp", **kw))
    assert _max_diff(got.u, want.u) <= SOLVE_TOL
    assert _max_diff(got.v, want.v) <= SOLVE_TOL


def test_tolerance_stops_early_and_freezes_converged_images():
    # Image 1 is a still pair: its first block already moves nothing, so it
    # stops there while image 0 runs on. The result is the per-image rule.
    i1, i2 = _video(2, 32, 48, key=2)
    a = torch.from_numpy(np.stack([i1, i1]))
    b = torch.from_numpy(np.stack([i2, i1]))
    cfg = HSConfig(alpha=0.5, iters=64, tol=1e-4, block_sweeps=4)
    got = hs_solve_batched(a, b, cfg)
    assert torch.equal(got.u[0], hs_solve(a[0], b[0], cfg).u)
    assert float(got.u[1].abs().max()) == 0.0


def test_batched_pyramid_matches_reference():
    frames = _video(3, 48, 64, key=5)
    i1, i2 = frames[:-1], frames[1:]
    got = hs_solve_batched(torch.from_numpy(i1), torch.from_numpy(i2),
                           HSConfig(alpha=1.0, iters=20), PyramidConfig(levels=2))
    want = ref_hs_solve_batched(jnp.asarray(i1), jnp.asarray(i2),
                                RefHS(alpha=1.0, iters=20, backend="jnp"),
                                RefPyr(levels=2))
    assert _max_diff(got.u, want.u) <= PYRAMID_TOL
    assert _max_diff(got.v, want.v) <= PYRAMID_TOL
    one = hs_pyramid(torch.from_numpy(i1[1]), torch.from_numpy(i2[1]),
                     HSConfig(alpha=1.0, iters=20), PyramidConfig(levels=2))
    assert _max_diff(got.u[1], one.u) <= PYRAMID_TOL


@pytest.mark.parametrize("n", [1, 7])
def test_resident_batched_plain_vs_pallas(n, monkeypatch):
    # Drop the stacked-class gate so small frames take the reference's
    # batched resident kernel, as tests/unit/test_solve_resident.py does.
    monkeypatch.setattr(ref_jacobi, "_BATCH_IMG_BYTES", 0)
    i1, i2 = _stack((2, 48, 64), seed=3)
    want = ref_resident.hs_solve_resident_batched(jnp.asarray(i1), jnp.asarray(i2),
                                                  0.5, n, interpret=True)
    assert want is not None
    got = sr.hs_solve_resident_batched(torch.from_numpy(i1), torch.from_numpy(i2),
                                       0.5, n)
    for g, w in zip(got, want):
        assert _max_diff(g.numpy(), w) <= SOLVE_TOL


@pytest.mark.parametrize("stacked", [True, False])
def test_jacobi_sweeps_batched_plain_vs_pallas(stacked, monkeypatch):
    # stacked: the (B*Hp, Wp) whole-image class; else the batched banded
    # kernel on its (B, bands) grid.
    if not stacked:
        monkeypatch.setattr(ref_jacobi, "_BATCH_IMG_BYTES", 0)
    i1, i2 = (torch.from_numpy(a) for a in _stack((2, 48, 64), seed=4))
    fields = k1.hs_derivatives(i1, i2, 0.5)
    rng = np.random.default_rng(6)
    u0, v0 = (rng.normal(0, 0.5, (2, 48, 64)).astype(np.float32) for _ in range(2))
    got = k2.jacobi_sweeps_batched(torch.from_numpy(u0), torch.from_numpy(v0),
                                   *fields, 9, block_sweeps=4)
    want = ref_jacobi.jacobi_sweeps_batched(
        jnp.asarray(u0), jnp.asarray(v0), *(jnp.asarray(f.numpy()) for f in fields),
        9, block_sweeps=4, interpret=True,
    )
    for g, w in zip(got, want):
        assert _max_diff(g.numpy(), w) <= SOLVE_TOL
    assert torch.equal(got[0], k2.jacobi_sweeps_batched_plain(
        torch.from_numpy(u0), torch.from_numpy(v0), *fields, 9)[0])


def test_batched_derivatives_are_per_image():
    i1, i2 = (torch.from_numpy(a) for a in _stack((3, 20, 30), seed=7))
    got = k1.hs_derivatives(i1, i2, 0.7, zero_sweep=True)
    for b in range(3):
        one = k1.hs_derivatives(i1[b], i2[b], 0.7, zero_sweep=True)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


def _smooth_flow(shape, amp, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u = amp * np.sin(xx / 9.0 + rng.uniform(0, 6)) + rng.normal(0, 0.3, shape)
    v = amp * np.cos(yy / 7.0 + rng.uniform(0, 6)) + rng.normal(0, 0.3, shape)
    return u.astype(np.float32), v.astype(np.float32)


def _flows(b, shape, amps):
    us, vs = zip(*(_smooth_flow(shape, a, seed=10 + k) for k, a in zip(range(b), amps)))
    return np.stack(us), np.stack(vs)


@pytest.mark.parametrize("amps", [(1.0, 1.0), (6.0, 1.0), (1.0, 12.0)])
def test_batched_tiled_warp_is_vmapped_reference(amps):
    # Each image gets its own tile means; amp 6 and 12 exceed R = 4, where
    # the clamp makes the tiled warp differ from the gather.
    shape = (70, 150)
    img = np.random.default_rng(2).uniform(0, 1, (2,) + shape).astype(np.float32)
    u, v = _flows(2, shape, amps)
    got = pyr.warp_bilinear_tiled(*(torch.from_numpy(a) for a in (img, u, v)))
    want = jax.vmap(ref_pyr.warp_bilinear_tiled)(*(jnp.asarray(a) for a in (img, u, v)))
    assert _max_diff(got, want) <= WARP_TOL
    for b in range(2):
        one = pyr.warp_bilinear_tiled(*(torch.from_numpy(a[b]) for a in (img, u, v)))
        assert torch.equal(got[b], one)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize(
    "call",
    [
        lambda a, b, v: hs_solve_batched(a, b, HSConfig(iters=2)),
        lambda a, b, v: solve_bidirectional(a[0], b[0], HSConfig(iters=2)),
        lambda a, b, v: flow_with_occlusion(a[0], b[0], HSConfig(iters=2)),
        lambda a, b, v: next(flow_stream(v, HSConfig(iters=2), chunk=2)),
        lambda a, b, v: next(flow_stream_warm(v, HSConfig(iters=2), chunk=2)),
        lambda a, b, v: next(flow_stream_occlusion(v, HSConfig(iters=2), chunk=2)),
        lambda a, b, v: flow_video(v, HSConfig(iters=2), chunk=2),
    ],
)
def test_numpy_without_device_or_cuda_raises_batched(call, monkeypatch):
    # numpy inputs default to cuda:0 and never fall back to the CPU; the
    # error names the keyword (the single-pair entry points are in
    # test_torch_slice.py).
    _no_cuda(monkeypatch)
    a, b = _stack((2, 32, 32))
    with pytest.raises(RuntimeError, match="device"):
        call(a, b, np.concatenate([a, b]))


def test_device_keyword_and_cpu_tensors():
    a, b = _stack((2, 32, 32), seed=8)
    cfg = HSConfig(alpha=0.5, iters=5)
    on_cpu = hs_solve_batched(a, b, cfg, device="cpu")
    assert on_cpu.u.device.type == "cpu"
    assert torch.equal(on_cpu.u, hs_solve_batched(torch.from_numpy(a),
                                                  torch.from_numpy(b), cfg).u)
    one = hs_solve(a[0], b[0], cfg, device="cpu")
    assert torch.equal(one.u, on_cpu.u[0])
    with pytest.raises(ValueError, match="expected"):
        hs_solve(torch.from_numpy(a[0]), torch.from_numpy(b[0]), cfg, device="meta")


def test_batched_entry_errors():
    z = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="B, H, W"):
        hs_solve_batched(z, z)
    with pytest.raises(ValueError, match="differ"):
        hs_solve_batched(torch.zeros(2, 8, 8), torch.zeros(2, 8, 9))
    # mesh= splits the stack over the batch axis (dist/gspmd.py): = the
    # untiled stack, in both dtypes; a batch it does not divide raises the
    # reference's ValueError.
    from opticalflowhs_tpu_torch import MeshConfig
    from opticalflowhs_tpu_torch.dist import make_mesh

    mesh = make_mesh(MeshConfig(batch=2), ["cpu"] * 2)
    a, b = (torch.from_numpy(np.random.default_rng(k).uniform(0, 1, (2, 8, 8))
                             .astype(np.float32)) for k in (1, 2))
    for cfg in (HSConfig(iters=3), HSConfig(solver="multigrid", iters=1, dtype="bfloat16")):
        got, want = hs_solve_batched(a, b, cfg, mesh=mesh), hs_solve_batched(a, b, cfg)
        assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)
    fw, bw = solve_bidirectional(z, z, lk=LKConfig(), mesh=mesh)
    assert torch.equal(fw.u, solve_bidirectional(z, z, lk=LKConfig())[0].u)
    with pytest.raises(ValueError, match="batch 3 not divisible by mesh batch 2"):
        hs_solve_batched(torch.zeros(3, 8, 8), torch.zeros(3, 8, 8), mesh=mesh)
    with pytest.raises(ValueError, match="T, H, W"):
        video_pairs(z)
    p1, p2 = video_pairs(torch.zeros(5, 8, 8))
    assert p1.shape == p2.shape == (4, 8, 8)


def test_batch_limit_and_wrapper_ranks():
    # One launch's grid takes at most 65535 images (gridDim.z).
    assert k1.batch_dims("k", torch.zeros(3, 4, 5)) == (3, 4, 5)
    assert k1.batch_dims("k", torch.zeros(4, 5)) == (1, 4, 5)
    with pytest.raises(ValueError, match="65535"):
        k1.batch_dims("k", torch.zeros(_build.MAX_BATCH + 1, 1, 1))
    # Each wrapper takes an (H, W) frame or a (B, H, W) stack, nothing else.
    s = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match=r"\(H, W\) or \(B, H, W\)"):
        k2.jacobi_sweeps(s, s, s, s, s, s, 1)
    with pytest.raises(ValueError, match=r"\(H, W\) or \(B, H, W\)"):
        sr.hs_solve_resident(s, s, 0.5, 3)
    # A warm-started stack equals a loop of warm-started single solves.
    i1, i2 = (torch.from_numpy(a) for a in _stack((2, 12, 20), seed=9))
    u0, v0 = (torch.from_numpy(a) for a in _stack((2, 12, 20), seed=10))
    got = sr.hs_solve_resident(i1, i2, 0.5, 6, "hs_cube", u0, v0)
    for b in range(2):
        one = sr.hs_solve_resident(i1[b], i2[b], 0.5, 6, "hs_cube", u0[b], v0[b])
        assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1])


def test_cpu_batched_path_launches_nothing():
    a, b = (torch.from_numpy(x) for x in _stack((2, 16, 24)))
    before = (k1.hs_derivatives.launches, k2.jacobi_sweeps.launches)
    hs_solve_batched(a, b, HSConfig(iters=5))
    hs_solve_batched(a, b, HSConfig(iters=20, tol=1e-3, block_sweeps=4))
    assert (k1.hs_derivatives.launches, k2.jacobi_sweeps.launches) == before
