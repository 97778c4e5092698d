"""The port's Lucas-Kanade family (lucas_kanade.py) against the JAX
reference on the CPU: the box sum, the blur, one refinement, the solves
single, pyramidal and batched, the `lk=` streams and consistency entry
points, a gradient against `jax.grad`, and the refusals. Modelled on
tests/unit/test_lucas_kanade.py.

Tolerances, each with its reason:
  * 0.0 for `box_sum`, `_blur5` and one `lk_refine`: the same single ops
    in the same order (the box sum's shifted adds reproduce the reference's
    SAME `reduce_window`), run op by op on both sides.
  * 2e-6 for single-level solves and stacks (the reference's
    kernel-vs-oracle bar): the reference jits the whole solve, and XLA:CPU
    fuses its refinements, so the last ulps differ and later refinements
    carry them along.
  * 1e-5 for two-level solves, as for hs_pyramid: the reference's
    `jax.image.resize` upsampling rounds otherwise than the port's taps.
  * 0.0 between a stack and a loop of the port's own single solves, and
    between a stream's chunk and `lk_solve_batched` on its window.
  * Gradients: 1e-5 relative to the largest entry, for the same fused
    rounding carried through the backward pass.
Occlusion masks must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu as ref_pkg
import opticalflowhs_tpu.consistency as ref_cons
import opticalflowhs_tpu.lucas_kanade as ref_lk
import opticalflowhs_tpu.video as ref_video
from opticalflowhs_tpu.config import LKConfig as RefLK
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
import opticalflowhs_tpu_torch as port_pkg
import opticalflowhs_tpu_torch.lucas_kanade as lk
import opticalflowhs_tpu_torch.video as video
from opticalflowhs_tpu_torch import (
    Flow,
    LKConfig,
    PyramidConfig,
    TVL1Config,
    flow_with_occlusion,
    lk_solve,
    lk_solve_batched,
)
from opticalflowhs_tpu_torch.consistency import solve_bidirectional
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence, translation_pair
from opticalflowhs_tpu_torch.metrics import epe, interior

torch.set_num_threads(1)

SOLVE_TOL = 2e-6
PYRAMID_TOL = 1e-5
GRAD_RTOL = 1e-5

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


def _equal(a, b):
    return torch.equal(a.u, b.u) and torch.equal(a.v, b.v)


# The pair of the reference's warp-radius test, and a smaller one for streams.
PAIR = translation_pair(64, 96, 0.7, -0.4, key=5)
STREAM_CFG = LKConfig(iters=2, window=9)


def _video(t=5, h=32, w=48):
    return synthetic_sequence(t, h, w, tx=1.0, ty=0.5, key=3)[0]


# -- box sum, blur, one refinement ---------------------------------------------


@pytest.mark.parametrize("window", [3, 5, 15])
@pytest.mark.parametrize("shape", [(67, 93), (8, 9)])
def test_box_sum_equals_reference_bitwise(shape, window):
    # Squared noise up to ~8e5: large sums with low bits to lose. (8, 9) is
    # smaller than the 15 window, whose sums then span the whole frame.
    a = (np.random.default_rng(window).normal(0, 300, shape) ** 2).astype(np.float32)
    got = lk.box_sum(torch.from_numpy(a), window)
    assert _max_diff(got, ref_lk.box_sum(jnp.asarray(a), window)) == 0.0
    # On a stack each image is summed on its own.
    stack = lk.box_sum(torch.from_numpy(np.stack([a, a[::-1].copy()])), window)
    assert torch.equal(stack[0], got)


def test_blur5_equals_reference_bitwise():
    a = np.random.default_rng(1).normal(0, 1, (2, 19, 23)).astype(np.float32)
    assert _max_diff(lk._blur5(torch.from_numpy(a)), ref_lk._blur5(jnp.asarray(a))) == 0.0


@pytest.mark.parametrize("radius", [0, 2])
@pytest.mark.parametrize("warp", ["tiled", "gather"])
@pytest.mark.parametrize("max_step", [0.0, 0.3])
def test_lk_refine_equals_reference_bitwise(max_step, warp, radius):
    i1, i2, _ = PAIR
    rng = np.random.default_rng(7)
    u0, v0 = (rng.normal(0, 0.5, i1.shape).astype(np.float32) for _ in range(2))
    got = lk.lk_refine(*(torch.from_numpy(a) for a in (i1, i2, u0, v0)),
                       LKConfig(max_step=max_step, warp=warp), radius)
    want = ref_lk.lk_refine(*(jnp.asarray(a) for a in (i1, i2, u0, v0)),
                            RefLK(max_step=max_step, warp=warp), radius)
    assert _flow_diff(got, want) == 0.0


# -- solves ---------------------------------------------------------------------

SOLVES = {
    # levels, LKConfig fields, warp_radius: between them L1 and L2, max_step
    # 0 and > 0, smooth on and off, the tiled and the gather warp, and warp
    # radius 0 (auto) and 2.
    "L1_default": (1, {}, 0),
    "L2_gather_clipped_unsmoothed": (2, dict(iters=2, max_step=0.5, smooth=False,
                                             warp="gather"), 0),
    "L2_tiled_radius2": (2, dict(iters=2, window=9, warp="tiled"), 2),
}


@pytest.fixture(scope="module")
def ref_solves():
    i1, i2, _ = PAIR
    out = {}
    for name, (levels, fields, radius) in SOLVES.items():
        f = ref_lk.lk_solve(jnp.asarray(i1), jnp.asarray(i2), RefLK(**fields),
                            RefPyr(levels=levels, iters_per_level=(), warp_radius=radius))
        out[name] = (np.asarray(f.u), np.asarray(f.v))
    return out


@pytest.mark.parametrize("name", list(SOLVES))
def test_lk_solve_matches_reference(name, ref_solves):
    levels, fields, radius = SOLVES[name]
    i1, i2, gt = PAIR
    got = lk_solve(i1, i2, LKConfig(**fields),
                   PyramidConfig(levels=levels, iters_per_level=(), warp_radius=radius),
                   device="cpu")
    assert got.u.shape == (64, 96) and got.u.device.type == "cpu"
    assert _flow_diff(got, ref_solves[name]) <= (SOLVE_TOL if levels == 1 else PYRAMID_TOL)
    # The reference's own accuracy bar (test_recovers_small_translation).
    f = np.stack([got.u.numpy(), got.v.numpy()], -1)
    assert epe(interior(f, 12), interior(gt, 12)) < 0.08
    # Tensors solve where they lie, with the same result.
    assert _equal(got, lk_solve(torch.from_numpy(i1), torch.from_numpy(i2), LKConfig(**fields),
                                PyramidConfig(levels=levels, warp_radius=radius)))


def test_lk_solve_batched_matches_reference_and_singles():
    pairs = [translation_pair(64, 96, d, 0.3, key=k) for k, d in enumerate((0.5, 1.0, -0.8))]
    i1 = np.stack([p[0] for p in pairs])
    i2 = np.stack([p[1] for p in pairs])
    cfg = dict(iters=2, window=11)
    want = ref_lk.lk_solve_batched(jnp.asarray(i1), jnp.asarray(i2), RefLK(**cfg))
    got = lk_solve_batched(i1, i2, LKConfig(**cfg), device="cpu")
    assert got.u.shape == (3, 64, 96)
    assert _flow_diff(got, want) <= SOLVE_TOL
    for k in range(3):
        one = lk_solve(i1[k], i2[k], LKConfig(**cfg), device="cpu")
        assert torch.equal(got.u[k], one.u) and torch.equal(got.v[k], one.v)


def test_lk_solve_batched_pyramid_equals_singles():
    # Two levels, warp radius 2: each image of the stack is warped by its
    # own flow with its own tile means, as the reference's vmap.
    i1, i2 = (np.stack([a, a[:, ::-1].copy()]) for a in PAIR[:2])
    cfg, pyr = LKConfig(iters=2, window=9), PyramidConfig(levels=2, warp_radius=2)
    got = lk_solve_batched(torch.from_numpy(i1), torch.from_numpy(i2), cfg, pyr)
    for k in range(2):
        assert _equal(Flow(got.u[k], got.v[k]), lk_solve(i1[k], i2[k], cfg, pyr, device="cpu"))


def _port_grads(i1, i2, cfg):
    a = torch.from_numpy(i1).requires_grad_()
    b = torch.from_numpy(i2).requires_grad_()
    f = lk_solve(a, b, cfg)
    torch.mean(f.u * f.u + f.v * f.v).backward()
    return a.grad, b.grad


def test_lk_solve_gradient_matches_jax():
    # The gather warp: XLA:CPU takes about 10x as long to compile the
    # gradient through the reference's tiled warp (its auto radius's two
    # select loops). The port's tiled warp is checked against its gather
    # below, where a 0.5 px flow takes the same samples.
    i1, i2, _ = translation_pair(24, 31, 0.5, 0.0, key=11)

    def ref_loss(a, b):
        f = ref_lk.lk_solve(a, b, RefLK(iters=2, window=9, warp="gather"))
        return jnp.mean(f.u * f.u + f.v * f.v)

    want = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(i1), jnp.asarray(i2))
    got = _port_grads(i1, i2, LKConfig(iters=2, window=9, warp="gather"))
    tiled = _port_grads(i1, i2, LKConfig(iters=2, window=9))
    for g, t, ref in zip(got, tiled, want):
        ref = np.asarray(ref)
        assert np.isfinite(g.numpy()).all() and np.abs(ref).max() > 0
        assert _max_diff(g, ref) <= GRAD_RTOL * np.abs(ref).max()
        assert float((t - g).abs().max()) <= GRAD_RTOL * np.abs(ref).max()


# -- the lk= entry points ----------------------------------------------------------


@pytest.fixture(scope="module")
def ref_stream():
    vid = _video()
    chunks = list(ref_video.flow_stream(vid, lk=RefLK(iters=2, window=9), chunk=2))
    return [(np.asarray(c.u), np.asarray(c.v)) for c in chunks]


def test_flow_stream_lk_matches_reference(ref_stream):
    vid = _video()
    got = list(video.flow_stream(vid, lk=STREAM_CFG, chunk=2, device="cpu"))
    assert [c.u.shape[0] for c in got] == [2, 2]
    for k, (c, want) in enumerate(zip(got, ref_stream)):
        assert _flow_diff(c, want) <= SOLVE_TOL
        win = torch.from_numpy(vid[2 * k:2 * k + 3])
        assert _equal(c, lk_solve_batched(win[:-1], win[1:], STREAM_CFG))


def test_flow_video_lk_matches_reference(ref_stream):
    got = video.flow_video(_video(), lk=STREAM_CFG, chunk=2, device="cpu")
    want = [np.concatenate([c[j] for c in ref_stream]) for j in (0, 1)]
    assert got.u.shape == (4, 32, 48)
    assert _flow_diff(got, want) <= SOLVE_TOL


def test_flow_stream_occlusion_lk_matches_reference():
    # chunk 1: one 2-image solve a window, the shape of the other tests'
    # stacks, so the reference compiles no other signature.
    vid = _video()
    want = list(ref_video.flow_stream_occlusion(vid, lk=RefLK(iters=2, window=9), chunk=1))
    got = list(video.flow_stream_occlusion(vid, lk=STREAM_CFG, chunk=1, device="cpu"))
    assert len(got) == len(want) == 4
    for (f, m), (rf, rm) in zip(got, want):
        assert _flow_diff(f, (np.asarray(rf.u), np.asarray(rf.v))) <= SOLVE_TOL
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))


def test_solve_bidirectional_and_flow_with_occlusion_lk_match_reference():
    vid = _video()
    i1, i2 = vid[0], vid[1]
    rf, rb = ref_cons.solve_bidirectional(jnp.asarray(i1), jnp.asarray(i2),
                                          lk=RefLK(iters=2, window=9))
    fwd, bwd = solve_bidirectional(i1, i2, lk=STREAM_CFG, device="cpu")
    assert _flow_diff(fwd, rf) <= SOLVE_TOL and _flow_diff(bwd, rb) <= SOLVE_TOL
    both = lk_solve_batched(np.stack([i1, i2]), np.stack([i2, i1]), STREAM_CFG, device="cpu")
    assert torch.equal(fwd.u, both.u[0]) and torch.equal(bwd.v, both.v[1])
    rfo, rmask = ref_cons.flow_with_occlusion(jnp.asarray(i1), jnp.asarray(i2),
                                              lk=RefLK(iters=2, window=9))
    f, mask = flow_with_occlusion(i1, i2, lk=STREAM_CFG, device="cpu")
    assert _equal(f, fwd) and _flow_diff(f, rfo) <= SOLVE_TOL
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))


# -- refusals -------------------------------------------------------------------


@pytest.mark.parametrize(
    "call",
    [
        lambda m, a, b: m.lk_solve(a((32, 32)), a((32, 33))),
        lambda m, a, b: m.lk_solve(a((2, 32, 32)), a((2, 32, 32))),
        lambda m, a, b: m.lk_solve(a((32, 32)), a((32, 32)), pyr=b(levels=4)),
        lambda m, a, b: m.lk_solve(a((14, 40)), a((14, 40)), pyr=b(levels=2)),
        lambda m, a, b: m.lk_solve_batched(a((32, 32)), a((32, 32))),
    ],
    ids=["shapes", "ndim", "below_8px", "below_8px_short_side", "batched_rank"],
)
def test_refusals_match_reference(call):
    with pytest.raises(ValueError) as ref_err:
        call(ref_lk, jnp.zeros, RefPyr)
    with pytest.raises(ValueError) as port_err:
        call(lk, torch.zeros, PyramidConfig)
    assert str(port_err.value) == str(ref_err.value)


def test_port_only_refusals():
    z, s = torch.zeros(16, 16), torch.zeros(2, 16, 16)
    with pytest.raises(NotImplementedError, match="bfloat16.*item 6"):
        lk.lk_solve_tiled(z, z, LKConfig(dtype="bfloat16"), mesh=object())
    with pytest.raises(NotImplementedError, match="dist/"):
        lk_solve_batched(s, s, mesh=object())
    with pytest.raises(NotImplementedError, match="dist/"):
        lk.lk_solve_tiled(z, z, mesh=object())
    with pytest.raises(ValueError, match="differ"):
        lk_solve_batched(s, torch.zeros(2, 16, 17))
    with pytest.raises(ValueError, match="at most one of lk= and tvl1="):
        solve_bidirectional(z, z, lk=LKConfig(), tvl1=TVL1Config())
    with pytest.raises(ValueError, match="at most one of lk= and tvl1="):
        flow_with_occlusion(z, z, lk=LKConfig(), tvl1=TVL1Config())
    with pytest.raises(NotImplementedError, match="dist/"):
        flow_with_occlusion(z, z, lk=LKConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="dist/"):
        next(video.flow_stream_occlusion(_video(), lk=LKConfig(), mesh=object(), device="cpu"))


def test_reference_top_level_names_are_exported():
    assert set(ref_pkg.__all__) <= set(port_pkg.__all__)
    for name in ("LKConfig", "RunConfig", "lk_solve", "lk_solve_batched"):
        assert getattr(port_pkg, name) is not None
