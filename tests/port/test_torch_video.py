"""The port's streaming path (video.py, consistency.py) against the JAX
reference on the CPU, on small synthetic videos (T = 7-10 at 32x48):
flow_video, flow_stream, flow_stream_warm (warm start and warp prior,
fused and per-pair, with a tolerance), flow_stream_occlusion and
flow_with_occlusion. Modelled on tests/integration/test_video_egomotion.py.

Tolerances, each with its reason (as in test_torch_slice.py): 2e-6 for
solves (XLA:CPU fuses the jitted sweep chain, so last ulps differ and the
sweeps carry them along); 1e-5 where a pyramid is involved (the warm
stream's warp-prior bootstrap), as for hs_pyramid, and for the
forward-backward error, which adds two such flows through a warp.
Occlusion masks must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.consistency as ref_cons
import opticalflowhs_tpu.video as ref_video
from opticalflowhs_tpu.config import HSConfig as RefHS
import opticalflowhs_tpu_torch.video as video
from opticalflowhs_tpu_torch import (
    HSConfig,
    LKConfig,
    flow_with_occlusion,
    hs_solve,
    hs_solve_batched,
)
from opticalflowhs_tpu_torch.consistency import fb_error, solve_bidirectional
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence
from opticalflowhs_tpu_torch.solver import tune_omega

torch.set_num_threads(1)

SOLVE_TOL = 2e-6
PYRAMID_TOL = 1e-5


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


def _video(t=8, h=32, w=48, tx=1.0, ty=0.5, key=3):
    return synthetic_sequence(t, h, w, tx=tx, ty=ty, key=key)[0]


def _flows_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.u.shape) == tuple(np.shape(w.u))
        assert _max_diff(g.u, w.u) <= tol and _max_diff(g.v, w.v) <= tol


@pytest.mark.parametrize("chunk", [3, 4])
def test_flow_video_matches_reference(chunk):
    vid = _video(t=9)
    got = video.flow_video(vid, HSConfig(alpha=0.3, iters=60), chunk=chunk,
                           device="cpu")
    want = ref_video.flow_video(vid, RefHS(alpha=0.3, iters=60, backend="jnp"),
                                chunk=chunk)
    assert isinstance(got.u, np.ndarray) and got.u.shape == (8, 32, 48)
    assert _max_diff(got.u, want.u) <= SOLVE_TOL
    assert _max_diff(got.v, want.v) <= SOLVE_TOL
    whole = hs_solve_batched(vid[:-1], vid[1:], HSConfig(alpha=0.3, iters=60),
                             device="cpu")
    np.testing.assert_array_equal(got.u, whole.u.numpy())


def test_flow_stream_chunks_and_inputs():
    vid = _video(t=7)
    cfg = HSConfig(alpha=0.3, iters=40)
    want = list(ref_video.flow_stream(iter(list(vid)),
                                      RefHS(alpha=0.3, iters=40, backend="jnp"),
                                      chunk=4))
    got = list(video.flow_stream(iter(list(vid)), cfg, chunk=4, device="cpu"))
    assert [f.u.shape[0] for f in got] == [4, 2]
    _flows_close(got, want, SOLVE_TOL)
    # A (T, H, W) tensor is windowed where it lies, with the same result.
    on_cpu = list(video.flow_stream(torch.from_numpy(vid), cfg, chunk=4))
    for a, b in zip(on_cpu, got):
        assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)


def test_flow_stream_rejects_bad_args():
    with pytest.raises(ValueError, match="chunk"):
        list(video.flow_stream(_video(), chunk=0, device="cpu"))
    with pytest.raises(ValueError, match="T, H, W"):
        list(video.flow_stream(np.zeros((8, 8), np.float32), device="cpu"))
    # lk= solves (the Lucas-Kanade family); with mesh= it still raises.
    with pytest.raises(NotImplementedError, match="dist/"):
        list(video.flow_stream(_video(), lk=LKConfig(), mesh=object(), device="cpu"))


@pytest.mark.parametrize("entry", ["flow_stream", "flow_stream_occlusion", "flow_video"])
def test_lk_and_tvl1_together_raise(entry):
    both = dict(lk=object(), tvl1=object(), device="cpu")
    with pytest.raises(ValueError, match="at most one of lk= and tvl1="):
        out = getattr(video, entry)(_video(), **both)
        if entry != "flow_video":  # the streams are generators
            next(out)


@pytest.mark.parametrize("warp_prior", [False, True])
def test_flow_stream_warm_matches_reference(warp_prior):
    vid = _video(t=8, tx=1.5, ty=-0.5, key=5)
    cfg = HSConfig(alpha=0.2, iters=25)
    got = list(video.flow_stream_warm(vid, cfg, chunk=3, warp_prior=warp_prior,
                                      device="cpu"))
    want = list(ref_video.flow_stream_warm(
        vid, RefHS(alpha=0.2, iters=25, backend="jnp"), chunk=3,
        warp_prior=warp_prior))
    assert len(got) == 7
    _flows_close(got, want, PYRAMID_TOL if warp_prior else SOLVE_TOL)
    per_pair = list(video.flow_stream_warm(vid, cfg, chunk=3, warp_prior=warp_prior,
                                           fused=False, device="cpu"))
    for a, b in zip(got, per_pair):
        assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)


def test_flow_stream_warm_sor_auto_omega_tunes_each_pair():
    # A deliberate divergence: the reference's fused=True warm stream runs
    # every pair after the first with omega still 0, which moves nothing
    # (its solve_level skips the SOR whole solve for omega 0, and the sweeps
    # blend u + 0*(u* - u)), so the stream repeats its first flow. The port
    # tunes omega for each pair, as the reference's fused=False does.
    vid = _video(t=5, tx=1.5, ty=-0.5, key=5)
    cfg = HSConfig(alpha=0.3, iters=10, solver="sor", omega=0.0)
    got = list(video.flow_stream_warm(vid, cfg, chunk=2, device="cpu"))
    frames = torch.from_numpy(vid)
    prev = None
    for k, g in enumerate(got):
        a, b = frames[k], frames[k + 1]
        tuned = dataclasses.replace(cfg, omega=tune_omega(a, b, cfg))
        prev = hs_solve(a, b, tuned, init=prev)
        assert torch.equal(g.u, prev.u) and torch.equal(g.v, prev.v), k
    assert len(got) == 4
    assert min(float((b.u - a.u).abs().max()) for a, b in zip(got, got[1:])) > 0


def test_flow_stream_warm_composes_with_tol():
    vid = _video(t=4, w=64, key=9)
    kw = dict(alpha=0.2, iters=200, tol=5e-4, block_sweeps=8)
    got = list(video.flow_stream_warm(vid, HSConfig(**kw), chunk=2, warm_scale=0.9,
                                      device="cpu"))
    want = list(ref_video.flow_stream_warm(vid, RefHS(backend="jnp", **kw), chunk=2,
                                           warm_scale=0.9))
    _flows_close(got, want, SOLVE_TOL)


def test_flow_stream_occlusion_matches_reference():
    # b = 0.01 (the default is 0.5) makes some pixels fail the test, so the
    # masks carry information.
    vid = _video(t=8, tx=2.0, ty=1.0, key=7)
    got = list(video.flow_stream_occlusion(vid, HSConfig(alpha=0.3, iters=30),
                                           chunk=4, b=0.01, device="cpu"))
    want = list(ref_video.flow_stream_occlusion(
        vid, RefHS(alpha=0.3, iters=30, backend="jnp"), chunk=4, b=0.01))
    assert sum(m.shape[0] for _, m in got) == 7
    _flows_close([f for f, _ in got], [f for f, _ in want], SOLVE_TOL)
    for (_, m), (_, mw) in zip(got, want):
        assert m.dtype == torch.bool and tuple(m.shape) == mw.shape
        np.testing.assert_array_equal(m.numpy(), np.asarray(mw))
    assert 0 < sum(int(m.sum()) for _, m in got) < 7 * 32 * 48


def test_flow_with_occlusion_matches_reference():
    i1, i2 = _video(t=2, tx=2.0, ty=1.0, key=11)
    cfg = HSConfig(alpha=0.3, iters=40)
    ref_cfg = RefHS(alpha=0.3, iters=40, backend="jnp")
    fwd, mask = flow_with_occlusion(i1, i2, cfg, b=0.01, device="cpu")
    want, want_mask = ref_cons.flow_with_occlusion(jnp.asarray(i1), jnp.asarray(i2),
                                                   ref_cfg, b=0.01)
    assert _max_diff(fwd.u, want.u) <= SOLVE_TOL
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    f, bw = solve_bidirectional(i1, i2, cfg, device="cpu")
    rf, rb = ref_cons.solve_bidirectional(jnp.asarray(i1), jnp.asarray(i2), ref_cfg)
    assert _max_diff(bw.u, rb.u) <= SOLVE_TOL
    err = fb_error(f, bw)
    assert _max_diff(err, ref_cons.fb_error(rf, rb)) <= 1e-5
    assert err.shape == (32, 48)
