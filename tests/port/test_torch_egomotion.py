"""The port's ego-motion fit (egomotion.py) and `metrics.hs_energy` against
the JAX reference on the CPU. Modelled on the ego-motion cases of
tests/integration/test_video_egomotion.py and the energy check of
tests/integration/test_convergence.py.

Tolerances, each with its reason: both are sums over the field in float32,
and XLA:CPU and torch add in different orders, so the results differ in
their last ulps: 1e-5 relative to the larger value (and 1e-6 absolute for
values near 0, such as a roll rate of 0 whose sums cancel) for the fitted
parameters and the residual, 1e-6 relative for the energy. The exact
models also meet the reference test's own bars against the truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowhs_tpu.egomotion import estimate_egomotion as ref_estimate
from opticalflowhs_tpu.metrics import hs_energy as ref_hs_energy
from opticalflowhs_tpu.solver import Flow as RefFlow
from opticalflowhs_tpu_torch import HSConfig, LKConfig, hs_solve, lk_solve
from opticalflowhs_tpu_torch.data.synthetic import translation_pair
from opticalflowhs_tpu_torch.egomotion import EgoMotion, estimate_egomotion
from opticalflowhs_tpu_torch.metrics import hs_energy
from opticalflowhs_tpu_torch.solver import Flow

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1e-6
ENERGY_RTOL = 1e-6

_DIFFS: list[float] = []


@pytest.fixture(autouse=True)
def _report_max_diff(record_property):
    _DIFFS.clear()
    yield
    if _DIFFS:
        record_property("max_abs_diff", max(_DIFFS))


def _model_flow(h, w, tx, ty, omega, s):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    xb, yb = xx - cx, yy - cy
    return tx + s * xb - omega * yb, ty + s * yb + omega * xb


def _both(u, v, **kw):
    """The port's fit (on CPU tensors) and the reference's, of one field."""
    got = estimate_egomotion(Flow(torch.from_numpy(u), torch.from_numpy(v)), **kw)
    want = ref_estimate(RefFlow(jnp.asarray(u), jnp.asarray(v)), **kw)
    return got, want


def _check(got: EgoMotion, want) -> None:
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        d = float(np.abs(g - w).max())
        _DIFFS.append(d)
        assert d <= max(ATOL, RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize(
    "tx,ty,omega,s",
    [(1.5, -0.5, 0.0, 0.0), (0.0, 0.0, 0.02, 0.0), (0.3, 0.1, -0.01, 0.005)],
)
def test_exact_model_matches_reference(tx, ty, omega, s):
    got, want = _both(*_model_flow(48, 64, tx, ty, omega, s))
    _check(got, want)
    assert abs(float(got.tx) - tx) < 1e-4 and abs(float(got.ty) - ty) < 1e-4
    assert abs(float(got.omega) - omega) < 1e-5 and abs(float(got.scale) - s) < 1e-5
    assert float(got.residual) < 1e-4


def test_explicit_off_center_matches_reference():
    h, w = 40, 60
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy, tx, ty, s, om = 10.0, 5.0, 1.5, -0.5, 0.02, 0.01
    u = tx + s * (xx - cx) - om * (yy - cy)
    v = ty + s * (yy - cy) + om * (xx - cx)
    got, want = _both(u, v, center=(cx, cy))
    _check(got, want)
    assert abs(float(got.tx) - tx) < 1e-4 and abs(float(got.ty) - ty) < 1e-4
    assert abs(float(got.scale) - s) < 1e-6 and abs(float(got.omega) - om) < 1e-6


def test_global_offset_matches_reference():
    u, v = _model_flow(32, 40, 0.7, -0.2, 0.01, 0.003)
    got, want = _both(u, v, global_offset=(16, 24))
    _check(got, want)


def test_focus_of_expansion_matches_reference():
    got, want = _both(*_model_flow(64, 64, 0.0, 0.0, 0.0, 0.05))
    fx, fy = got.focus_of_expansion()
    assert abs(float(fx)) < 1e-3 and abs(float(fy)) < 1e-3
    # Off the center: a zoom about (cx + 6, cy - 4) with a translation.
    u, v = _model_flow(48, 64, 0.3, -0.2, 0.0, 0.05)
    got, want = _both(u, v, center=(31.5, 23.5))
    for g, w in zip(got.focus_of_expansion(), want.focus_of_expansion()):
        d = abs(float(g) - float(w))
        _DIFFS.append(d)
        assert d <= RTOL * abs(float(w)) + ATOL
    assert abs(float(got.focus_of_expansion()[0]) + 6.0) < 1e-3


def test_stacks_match_reference():
    f1 = _model_flow(32, 32, 1.0, 0.0, 0.0, 0.0)
    f2 = _model_flow(32, 32, 0.0, 2.0, 0.01, 0.002)
    u, v = (np.stack([f1[k], f2[k]]) for k in (0, 1))
    got, want = _both(u, v)
    _check(got, want)
    np.testing.assert_allclose(got.tx.numpy(), [1.0, 0.0], atol=1e-4)
    np.testing.assert_allclose(got.ty.numpy(), [0.0, 2.0], atol=1e-4)
    # Each image of the stack is fitted on its own.
    one = estimate_egomotion(Flow(torch.from_numpy(u[1]), torch.from_numpy(v[1])))
    _check(EgoMotion(*(a[1] for a in got)), one)


def test_real_flow_matches_reference():
    # An LK flow of a translating pair: a field that no model fits exactly.
    i1, i2, _ = translation_pair(48, 64, 1.0, 0.0, key=4)
    f = lk_solve(i1, i2, LKConfig(), device="cpu")
    got, want = _both(f.u.numpy(), f.v.numpy())
    _check(got, want)
    assert abs(float(got.tx) - 1.0) < 0.25 and abs(float(got.ty)) < 0.15
    assert float(got.residual) > 1e-4


def test_numpy_flow_and_refusals():
    u, v = _model_flow(16, 24, 0.5, 0.0, 0.0, 0.0)
    got = estimate_egomotion(Flow(u, v), device="cpu")
    assert got.tx.device.type == "cpu" and abs(float(got.tx) - 0.5) < 1e-5
    with pytest.raises(NotImplementedError, match="dist/"):
        estimate_egomotion(Flow(torch.from_numpy(u), torch.from_numpy(v)), axis_names=("y",))
    with pytest.raises(NotImplementedError, match="dist/"):
        hs_energy(u, u, Flow(u, v), axis_names=("y",), device="cpu")


# -- bfloat16 flows -------------------------------------------------------------


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at |x| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("case", ["single", "stack", "center"])
def test_bf16_flow_matches_reference(case):
    # A random bf16 flow, the same values through both. tx and ty come back
    # in bfloat16 as the reference returns them, within 2 bfloat16 ulps of
    # its values: one rounding of the float32 mean here, against the
    # reference's bfloat16 sum and division (1 ulp measured on these fields).
    # With center= both reparametrise the stored tx, ty in float32 (a
    # bfloat16 tx plus float32 terms), so those too are 2 ulps of the stored
    # value apart, plus 1e-5 for the float32 terms (1 ulp measured). omega,
    # scale and the residual are float32 in both, within 1e-6 (at most
    # 9.6e-7 measured: the residual's model reads the stored tx, ty, which
    # may lie an ulp apart).
    rng = np.random.default_rng(21)
    shape = (2, 22, 30) if case == "stack" else (22, 30)
    u = torch.from_numpy(rng.normal(0.4, 0.8, shape).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.normal(0.0, 0.5, shape).astype(np.float32)).bfloat16()
    kw = {"center": (7.0, 13.0)} if case == "center" else {}
    got = estimate_egomotion(Flow(u, v), **kw)
    want = ref_estimate(RefFlow(jnp.asarray(u.float().numpy()).astype(jnp.bfloat16),
                                jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)), **kw)
    stored = estimate_egomotion(Flow(u, v))
    for k, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        g, w = g.float().numpy(), np.asarray(w).astype(np.float32)
        d = np.abs(g - w)
        _DIFFS.append(float(d.max()))
        if k < 2:
            bar = 2 * _bf16_ulp(stored[k].float().numpy())
            assert (d <= bar + (1e-5 if kw else 0.0)).all(), (k, d, bar)
        else:
            assert float(d.max()) <= 1e-6, (k, d)
    assert got.tx.dtype == (torch.float32 if kw else torch.bfloat16)
    assert got.omega.dtype == got.scale.dtype == got.residual.dtype == torch.float32


# -- hs_energy ------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("shape", [(37, 53), (2, 24, 30)])
@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_hs_energy_matches_reference(variant, shape, alpha):
    rng = np.random.default_rng(5)
    i1, i2 = (rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2))
    u, v = (rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2))
    got = hs_energy(torch.from_numpy(i1), torch.from_numpy(i2),
                    Flow(torch.from_numpy(u), torch.from_numpy(v)), alpha, variant)
    want = float(ref_hs_energy(i1, i2, RefFlow(jnp.asarray(u), jnp.asarray(v)), alpha, variant))
    assert got.shape == () and got.dtype == torch.float32
    d = abs(float(got) - want)
    _DIFFS.append(d)
    assert d <= ENERGY_RTOL * abs(want)


@pytest.mark.parametrize("frames", ["translation", "noise"])
def test_hs_energy_over_sweeps_matches_reference(frames):
    # The reference's convergence diagnostic (test_convergence.py): on a
    # textured pair the energy of the Jacobi iterate never rises. Its
    # forward-difference smoothness term is not the one the sweep's
    # 8-neighbour average minimises, and on white noise (C1's frames) it
    # rises with the sweeps, in both packages alike.
    if frames == "translation":
        i1, i2, _ = translation_pair(32, 48, 1.0, 0.5, key=2)
    else:
        rng = np.random.default_rng(0)
        i1, i2 = (rng.uniform(0, 1, (32, 48)).astype(np.float32) for _ in range(2))
    alpha = 0.5
    got, want = [], []
    for n in (0, 25, 100):
        f = hs_solve(i1, i2, HSConfig(alpha=alpha, iters=n), device="cpu")
        got.append(float(hs_energy(i1, i2, f, alpha, device="cpu")))
        fl = RefFlow(jnp.asarray(f.u.numpy()), jnp.asarray(f.v.numpy()))
        want.append(float(ref_hs_energy(i1, i2, fl, alpha)))
    for g, w in zip(got, want):
        _DIFFS.append(abs(g - w))
        assert abs(g - w) <= ENERGY_RTOL * abs(w)
    falls = [b <= a for a, b in zip(got, got[1:])]
    assert falls == ([True, True] if frames == "translation" else [False, False]), got
