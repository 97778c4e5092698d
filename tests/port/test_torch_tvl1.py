"""The port's TV-L1 family (tvl1.py, kernels/tvl1_inner.py) against the JAX
reference on the CPU: the operators, the inner loop against the
reference's oracle twin and its Pallas kernel in interpret mode, one warp
iteration for every warp rule, the solves single, pyramidal and batched,
and the stream and consistency entry points with tvl1=. Modelled on
tests/unit/test_tvl1.py and test_tvl1_inner.py.

Tolerances, each with its reason:
  * 0.0 for the operators (grad_forward, divergence, _mask_dual, median3):
    the same single ops, and min/max are exact.
  * 2e-6 for the inner loop: the reference's kernel-vs-oracle bar. The ops
    and their order are the same; XLA:CPU fuses the loop body, so the last
    ulp may differ and the alternations carry it along.
  * 1e-5 for one warp iteration and for the one-warp solve: the frames are
    on the [0, 255] scale, where an ulp of the warped frame is ~1e-5, and
    the reference compiles the checked warp's branches as one XLA graph
    (other rounding of the bilinear blend than the eager ops).
  * 1e-6 for the warp of a stack, on [0, 1] frames, as the port's other
    warp tests.
  * Multi-warp solves: trajectory level, the reference's own bar
    (tests/unit/test_tvl1_inner.py): the warp's floor turns an ulp of flow
    into another sample, so EPE within 2e-2, and stacks within 2e-5 as the
    reference's batched == singles test.
  * 0.0 between a stack and a loop of the port's own single solves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.consistency as ref_cons
import opticalflowhs_tpu.kernels.tvl1_inner as ref_k5
import opticalflowhs_tpu.pyramid as ref_pyr
import opticalflowhs_tpu.tvl1 as ref_tv
import opticalflowhs_tpu.video as ref_video
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.config import TVL1Config as RefTV
import opticalflowhs_tpu_torch.tvl1 as tv
import opticalflowhs_tpu_torch.video as video
from opticalflowhs_tpu_torch import (
    PyramidConfig,
    TVL1Config,
    flow_with_occlusion,
    tvl1_solve,
    tvl1_solve_batched,
)
from opticalflowhs_tpu_torch.consistency import solve_bidirectional
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence, translation_pair
from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5
from opticalflowhs_tpu_torch.metrics import epe, interior
from opticalflowhs_tpu_torch.pyramid import tile_deviation, warp_each

torch.set_num_threads(1)

INNER_TOL = 2e-6
WARP_ITER_TOL = 1e-5
WARP_TOL = 1e-6
STACK_TOL = 2e-5
EPE_TOL = 2e-2

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


def _flow_diff(got, want):
    return max(_max_diff(got[0], want[0]), _max_diff(got[1], want[1]))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _epe(f, gt, crop):
    fl = np.stack([np.asarray(f[0]), np.asarray(f[1])], -1)
    return float(epe(interior(fl, crop), interior(gt, crop)))


# -- operators ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(13, 17), (2, 9, 11), (1, 6)])
def test_grad_div_and_mask_match_reference(shape):
    rng = np.random.default_rng(0)
    a, px, py = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(3))
    for got, want in zip(tv.grad_forward(*_t(a)), ref_tv.grad_forward(*_j(a))):
        assert _max_diff(got, want) == 0.0
    for got, want in zip(tv._mask_dual(*_t(px, py)), ref_tv._mask_dual(*_j(px, py))):
        assert _max_diff(got, want) == 0.0
    assert _max_diff(tv.divergence(*_t(px, py)), ref_tv.divergence(*_j(px, py))) == 0.0


@pytest.mark.parametrize("values", ["normal", "ties"])
@pytest.mark.parametrize("shape", [(67, 93), (3, 14, 19)])
def test_median3_matches_reference(values, shape):
    rng = np.random.default_rng(2)
    a = (rng.normal(0, 1, shape) if values == "normal"
         else rng.integers(0, 3, shape)).astype(np.float32)  # quantised: many ties
    got = tv.median3(torch.from_numpy(a))
    assert _max_diff(got, ref_tv.median3(jnp.asarray(a))) == 0.0
    # The network equals the median of the 9 sorted taps.
    pad = np.pad(a, [(0, 0)] * (a.ndim - 2) + [(1, 1), (1, 1)], mode="edge")
    taps = [pad[..., i:i + a.shape[-2], j:j + a.shape[-1]] for i in range(3) for j in range(3)]
    np.testing.assert_array_equal(got.numpy(), np.sort(np.stack(taps), axis=0)[4])


# -- the inner loop -----------------------------------------------------------------


def _inner_fields(shape, seed=1):
    """Warm (u1, u2) and the inner loop's fields from a real precompute: a
    translation pair rescaled to [0, 255], so that all three cases of the
    data term fire."""
    i1, i2, _ = translation_pair(*shape, 0.7, -0.3, key=seed)
    rng = np.random.default_rng(seed)
    u1, u2 = (rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2))
    f1, f2, w1, w2 = _t(i1, i2, u1, u2)
    f1, f2 = tv.rescale_pair(f1, f2)
    rho0, gx, gy, inv_g2, th = tv.inner_fields(f1, f2, w1, w2, TVL1Config())
    rho = rho0 + w1 * gx + w2 * gy
    assert float((rho < -th).float().mean()) > 0 and float((rho > th).float().mean()) > 0
    assert float((rho.abs() <= th).float().mean()) > 0
    fields = [x.numpy() for x in (rho0, gx, gy, inv_g2, th)]
    return u1, u2, fields, tv.inner_scalars(TVL1Config())


@pytest.mark.parametrize("iters", [1, 7, 11])
@pytest.mark.parametrize("shape", [(96, 128), (131, 130)])
def test_inner_plain_matches_reference(shape, iters, monkeypatch):
    u1, u2, fields, (theta, sigma, lam_theta) = _inner_fields(shape)
    got = k5.tvl1_inner_plain(*_t(u1, u2, *fields), iters, theta, sigma, lam_theta)
    twin = ref_k5._jnp_twin(*_j(u1, u2, *fields), iters, theta, sigma, lam_theta)
    assert _flow_diff(got, twin) <= INNER_TOL
    for nb in (1, 2):  # the Pallas kernel in interpret mode, 1 and 2 bands
        monkeypatch.setattr(ref_k5, "_FORCE_NB", nb)
        kern = ref_k5.tvl1_inner(*_j(u1, u2, *fields), iters, theta, sigma, lam_theta)
        assert _flow_diff(got, kern) <= INNER_TOL


def test_inner_wrapper_on_cpu_runs_the_plain_loop():
    u1, u2, fields, scalars = _inner_fields((40, 56), seed=2)
    args = _t(u1, u2, *fields)
    keep = [a.clone() for a in args]
    k5.tvl1_inner.launches = 0
    got = k5.tvl1_inner(*args, 5, *scalars)
    want = k5.tvl1_inner_plain(*args, 5, *scalars)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert k5.tvl1_inner.launches == 0  # no kernel ran
    for a, b in zip(args, keep):
        assert torch.equal(a, b)  # inputs untouched
    with pytest.raises(ValueError, match="float32"):
        k5.tvl1_inner(*(a.double() for a in args), 5, *scalars)
    with pytest.raises(ValueError, match="contiguous"):
        k5.tvl1_inner(args[0].t(), *(a.t().contiguous() for a in args[1:]), 5, *scalars)
    with pytest.raises(ValueError, match="iters"):
        k5.tvl1_inner(*args, -1, *scalars)


# -- one warp iteration ----------------------------------------------------------


@pytest.mark.parametrize("median", [False, True])
@pytest.mark.parametrize("warp", ["gather", "tiled", "checked"])
def test_warp_iteration_matches_reference(warp, median):
    i1, i2, _ = translation_pair(48, 64, 0.7, -0.3, key=2)
    i1, i2 = (255.0 * i1).astype(np.float32), (255.0 * i2).astype(np.float32)
    rng = np.random.default_rng(0)
    u1, u2 = (rng.normal(0, 0.5, (48, 64)).astype(np.float32) for _ in range(2))
    got = tv.tvl1_warp_iteration(*_t(i1, i2, u1, u2),
                                 TVL1Config(iters=30, warp=warp, median=median))
    want = ref_tv.tvl1_warp_iteration(*_j(i1, i2, u1, u2),
                                      RefTV(iters=30, warp=warp, median=median,
                                            backend="jnp"))
    assert _flow_diff(got, want) <= WARP_ITER_TOL


def test_checked_warp_of_a_stack_is_the_vmapped_ladder():
    """Each image of a stack takes the rung of its own tile deviation (R = 4,
    R = 8, the gather), as the reference's vmapped checked warp does, and
    equals the single-image warp bitwise."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (3, 40, 150)).astype(np.float32)
    u = rng.normal(0, 0.3, (3, 40, 150)).astype(np.float32)
    v = rng.normal(0, 0.3, (3, 40, 150)).astype(np.float32)
    u[1, 10:20, 20:40] += 6.0   # deviation in (4, 8]: the R = 8 rung
    u[2, 10:20, 20:40] += 12.0  # beyond 8: the gather
    dev = tile_deviation(*_t(u, v)).tolist()
    assert dev[0] <= 4 < dev[1] <= 8 < dev[2]
    got = warp_each(*_t(img, u, v), "checked")
    want = jax.vmap(lambda a, b, c: ref_pyr.warp(a, b, c, "checked"))(*_j(img, u, v))
    assert _max_diff(got, want) <= WARP_TOL
    for k in range(3):
        one = warp_each(*_t(img[k], u[k], v[k]), "checked")
        assert torch.equal(got[k], one)


# -- solves --------------------------------------------------------------------------


def test_one_warp_solve_matches_reference():
    # One level and one warp: the warp samples at zero flow, so no sample
    # position can flip and the whole solve holds a tight bar.
    i1, i2, _ = translation_pair(64, 80, 0.6, 0.4, key=4)
    cfg = dict(warps=1, iters=100, median=True)
    got = tvl1_solve(*_t(i1, i2), TVL1Config(**cfg))
    want = ref_tv.tvl1_solve(*_j(i1, i2), RefTV(backend="jnp", **cfg))
    assert _flow_diff(got, want) <= WARP_ITER_TOL


def test_pyramid_solve_matches_reference_epe():
    i1, i2, gt = translation_pair(96, 128, 1.3, -0.8, key=3)
    cfg = dict(warps=2, iters=40)
    got = tvl1_solve(i1, i2, TVL1Config(**cfg), PyramidConfig(levels=2), device="cpu")
    want = ref_tv.tvl1_solve(*_j(i1, i2), RefTV(backend="jnp", **cfg), RefPyr(levels=2))
    e_got, e_want = _epe(got, gt, 8), _epe(want, gt, 8)
    _DIFFS.append(abs(e_got - e_want))
    assert e_got < 0.25 and abs(e_got - e_want) <= EPE_TOL, (e_got, e_want)


def test_batched_equals_singles_and_reference():
    pairs = [translation_pair(64, 96, d, 0.3, key=k) for k, d in enumerate((0.5, 1.0, -0.8))]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    # Different ranges per pair: the rescale to [0, 255] must be per pair.
    a[1] *= 3.0
    b[1] *= 3.0
    cfg = TVL1Config(warps=2, iters=20)
    got = tvl1_solve_batched(*_t(a, b), cfg)
    for k in range(3):
        one = tvl1_solve(*_t(a[k], b[k]), cfg)
        assert torch.equal(got.u[k], one.u) and torch.equal(got.v[k], one.v)
    want = ref_tv.tvl1_solve_batched(*_j(a, b), RefTV(warps=2, iters=20, backend="jnp"))
    assert _flow_diff(got, want) <= STACK_TOL


# -- streams and consistency ------------------------------------------------------------

# One warp, so that the reference's solves share one compilation per stack
# shape, and the bar is the one-warp solve's.
STREAM_CFG = dict(warps=1, iters=15)


@pytest.fixture(scope="module")
def frames():
    return synthetic_sequence(5, 48, 64, tx=1.0, ty=0.5, key=3)[0]


def test_flow_stream_and_video_tvl1_match_reference(frames):
    cfg = TVL1Config(**STREAM_CFG)
    got = list(video.flow_stream(frames, tvl1=cfg, chunk=2, device="cpu"))
    want = list(ref_video.flow_stream(frames, tvl1=RefTV(backend="jnp", **STREAM_CFG),
                                      chunk=2))
    assert [f.u.shape[0] for f in got] == [2, 2]
    for g, w in zip(got, want):
        assert _flow_diff(g, w) <= WARP_ITER_TOL
    whole = tvl1_solve_batched(frames[:-1], frames[1:], cfg, device="cpu")
    assert torch.equal(torch.cat([f.u for f in got]), whole.u)
    flow = video.flow_video(frames, tvl1=cfg, chunk=2, device="cpu")
    np.testing.assert_array_equal(flow.v, whole.v.numpy())


def test_flow_stream_occlusion_tvl1_matches_reference(frames):
    # One pair a window: both directions make the 2-image stacks of the
    # test above, so the reference reuses that compilation.
    got = list(video.flow_stream_occlusion(frames[:3], tvl1=TVL1Config(**STREAM_CFG),
                                           chunk=1, b=0.01, device="cpu"))
    want = list(ref_video.flow_stream_occlusion(
        frames[:3], tvl1=RefTV(backend="jnp", **STREAM_CFG), chunk=1, b=0.01))
    assert len(got) == 2
    (f, m), (fw, mw) = got[0], want[0]
    assert _flow_diff(f, fw) <= WARP_ITER_TOL
    assert m.dtype == torch.bool and tuple(m.shape) == (1, 48, 64)
    np.testing.assert_array_equal(m.numpy(), np.asarray(mw))
    assert 0 < int(m.sum()) < m.numel()


def test_solve_bidirectional_tvl1_matches_reference(frames):
    cfg = TVL1Config(**STREAM_CFG)
    fwd, bwd = solve_bidirectional(frames[0], frames[1], tvl1=cfg, device="cpu")
    rf, rb = ref_cons.solve_bidirectional(*_j(frames[0], frames[1]),
                                          tvl1=RefTV(backend="jnp", **STREAM_CFG))
    assert _flow_diff(fwd, rf) <= WARP_ITER_TOL and _flow_diff(bwd, rb) <= WARP_ITER_TOL
    one = tvl1_solve(frames[1], frames[0], cfg, device="cpu")
    assert torch.equal(bwd.u, one.u) and torch.equal(bwd.v, one.v)
    f2, mask = flow_with_occlusion(frames[0], frames[1], tvl1=cfg, b=0.01, device="cpu")
    assert torch.equal(f2.u, fwd.u) and mask.shape == (48, 64)


# -- validation --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "a,b,kw,match",
    [
        ((32, 32), (32, 33), {}, "differ"),
        ((2, 32, 32), (2, 32, 32), {}, "2-D"),
        ((32, 32), (32, 32), dict(pyr=PyramidConfig(levels=4)), "below 8"),
        ((32, 32), (32, 32), dict(cfg=TVL1Config(warps_per_level=(2, 1))), "warps_per_level"),
        # The batched entry checks only the rank, as the reference's: it
        # solves what the single-pair rules refuse (match None: both solve);
        # a warps_per_level shorter than the levels raises ValueError here,
        # IndexError there.
        ((32, 32), (32, 32), dict(entry="batched"), "B, H, W"),
        ((2, 7, 40), (2, 7, 40), dict(entry="batched"), None),
        ((2, 16, 16), (2, 16, 16), dict(entry="batched", pyr=PyramidConfig(levels=3)), None),
        ((2, 16, 24), (2, 16, 24), dict(entry="batched",
                                        cfg=TVL1Config(warps_per_level=(1, 1, 2))), None),
        ((2, 16, 24), (2, 16, 24), dict(entry="batched", pyr=PyramidConfig(levels=2),
                                        cfg=TVL1Config(warps_per_level=(1,))),
         "warps_per_level"),
    ],
)
def test_solve_validation_matches_reference(a, b, kw, match):
    kw = dict(kw)
    batched = kw.pop("entry", "single") == "batched"
    if batched:
        # One cheap warp (the gather, the quickest to compile): the cases
        # that solve only show that both entries take the stack.
        tv_kw = dict(warps=1, iters=2, warp="gather",
                     warps_per_level=kw["cfg"].warps_per_level if "cfg" in kw else ())
        kw["cfg"] = TVL1Config(**tv_kw)
        ref_kw = {"cfg": RefTV(backend="jnp", **tv_kw)}
        if "pyr" in kw:
            ref_kw["pyr"] = RefPyr(levels=kw["pyr"].levels, iters_per_level=())
        ref_entry, entry = ref_tv.tvl1_solve_batched, tvl1_solve_batched
    else:
        ref_kw = {k: (RefPyr(levels=v.levels) if k == "pyr"
                      else RefTV(warps_per_level=v.warps_per_level)) for k, v in kw.items()}
        ref_entry, entry = ref_tv.tvl1_solve, tvl1_solve
    ra, rb, ta, tb = jnp.zeros(a), jnp.zeros(b), torch.zeros(a), torch.zeros(b)
    if match is None:
        want = ref_entry(ra, rb, **ref_kw)
        got = entry(ta, tb, **kw)
        assert tuple(got.u.shape) == tuple(want.u.shape) == a
        return
    ref_error = IndexError if batched and match == "warps_per_level" else ValueError
    with pytest.raises(ref_error, match=None if ref_error is IndexError else match):
        ref_entry(ra, rb, **ref_kw)
    with pytest.raises(ValueError, match=match):
        entry(ta, tb, **kw)


@pytest.mark.parametrize("shape,levels", [((2, 7, 40), 1), ((2, 16, 16), 3)])
def test_batched_solves_frames_the_single_rules_refuse(shape, levels):
    # Frames below 8 px at a level: tvl1_solve refuses each pair, the
    # stacked entries of both solve them, within the reference's bars: one
    # level with the default checked warp on frames narrower than its
    # tiles, and three levels down to 4 x 4 with the gather (the checked
    # warp's three levels take the reference half a minute to compile).
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 1, (shape[0], shape[1] + 2, shape[2] + 2)).astype(np.float32)
    a = base[:, 1:-1, 1:-1]
    b = base[:, 2:, :-2] * 0.9 + base[:, 1:-1, 1:-1] * 0.1
    cfg = dict(warps=2, iters=20, warp="checked" if levels == 1 else "gather")
    got = tvl1_solve_batched(*_t(np.ascontiguousarray(a), np.ascontiguousarray(b)),
                             TVL1Config(**cfg), PyramidConfig(levels=levels))
    want = ref_tv.tvl1_solve_batched(*_j(a, b), RefTV(backend="jnp", **cfg),
                                     RefPyr(levels=levels, iters_per_level=()))
    if levels == 1:
        assert _flow_diff(got, want) <= STACK_TOL
    else:
        # Warps across levels: trajectory level, the multi-warp solves' bar
        # (EPE within EPE_TOL), held here on every pixel's endpoint.
        _flow_diff(got, want)
        end = np.hypot(got.u.numpy() - np.asarray(want.u), got.v.numpy() - np.asarray(want.v))
        assert float(end.max()) <= EPE_TOL
    with pytest.raises(ValueError, match="below 8"):
        tvl1_solve(*_t(np.ascontiguousarray(a[0]), np.ascontiguousarray(b[0])),
                   TVL1Config(**cfg), PyramidConfig(levels=levels))


def test_flow_stream_tvl1_on_a_narrow_video_matches_reference():
    # 7-row frames: the stream's stacks solve them, as the reference's do.
    frames = synthetic_sequence(4, 7, 40, tx=0.5, ty=0.2, key=5)[0]
    cfg = TVL1Config(**STREAM_CFG)
    got = list(video.flow_stream(frames, tvl1=cfg, chunk=2, device="cpu"))
    want = list(ref_video.flow_stream(frames, tvl1=RefTV(backend="jnp", **STREAM_CFG),
                                      chunk=2))
    assert [f.u.shape for f in got] == [(2, 7, 40), (1, 7, 40)]
    for g, w in zip(got, want):
        assert _flow_diff(g, w) <= WARP_ITER_TOL


def test_unsupported_options_raise():
    z = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="B, H, W"):
        tvl1_solve_batched(z, z)
    # The tiled entry and mesh= solve (dist/gspmd.py), in both dtypes, =
    # the untiled entries (tests/port/test_torch_dist_gspmd.py holds them to
    # the reference); without a mesh the tiled entry raises its ValueError.
    from opticalflowhs_tpu_torch import MeshConfig
    from opticalflowhs_tpu_torch.dist import make_mesh

    mesh = make_mesh(MeshConfig(y=2, x=2), ["cpu"] * 4)
    r = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (16, 16)).astype(np.float32))
    cfg = TVL1Config(warps=1, iters=4, dtype="bfloat16")
    got, want = tv.tvl1_solve_tiled(r, z, cfg, mesh=mesh), tvl1_solve(r, z, cfg)
    assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)
    got = tvl1_solve_batched(r[None], z[None], cfg, mesh=make_mesh(MeshConfig(), ["cpu"]))
    assert torch.equal(got.u[0], want.u)
    with pytest.raises(ValueError, match="requires a mesh"):
        tv.tvl1_solve_tiled(z, z)
    # The cuda backend takes CUDA tensors only; nothing falls back to the CPU.
    with pytest.raises(ValueError, match="CUDA"):
        tvl1_solve(z, z, TVL1Config(backend="cuda"))


@pytest.mark.parametrize("entry", [tvl1_solve, tvl1_solve_batched])
def test_numpy_without_device_or_cuda_raises(entry, monkeypatch):
    # numpy frames go to the `device` keyword, cuda:0 by default; without a
    # CUDA device that default raises and nothing runs on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((2, 16, 16) if entry is tvl1_solve_batched else (16, 16), np.float32)
    cfg = TVL1Config(warps=1, iters=2)
    with pytest.raises(RuntimeError, match="device"):
        entry(z, z, cfg)
    assert entry(z, z, cfg, device="cpu").u.device.type == "cpu"
