"""The port's plain stencils against the JAX reference's ops/stencils.py and
the float64 golden NumPy oracle (ops/golden.py), on the same numpy inputs.

Tolerances: the jnp ops run eagerly, one XLA computation per op, so each op
rounds as torch does and the results are equal (atol 0). The golden oracle
computes in float64, so float32 rounding bounds that comparison (atol
1e-6 on values of order 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowhs_tpu.ops import golden
from opticalflowhs_tpu.ops import stencils as ref
from opticalflowhs_tpu_torch.ops import stencils as port

torch.set_num_threads(1)

SHAPES = [(8, 8), (67, 93)]
GOLDEN_TOL = 1e-6


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize(
    "name", ["shift_up_row", "shift_down_row", "shift_left_col", "shift_right_col"]
)
def test_shifts_equal(shape, name):
    a, _ = _inputs(shape)
    out = getattr(port, name)(_t(a)).numpy()
    np.testing.assert_array_equal(out, _np(getattr(ref, name)(jnp.asarray(a))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_derivatives(shape, variant):
    i1, i2 = _inputs(shape)
    got = port.derivatives(_t(i1), _t(i2), variant)
    want = ref.derivatives(jnp.asarray(i1), jnp.asarray(i2), variant)
    gold = golden.derivatives_numpy(i1, i2, variant)
    for g, w, o in zip(got, want, gold):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), o, rtol=0, atol=GOLDEN_TOL)


def test_unknown_variant_raises():
    a, b = _inputs((8, 8))
    with pytest.raises(ValueError):
        port.derivatives(_t(a), _t(b), "sobel")


@pytest.mark.parametrize("shape", SHAPES)
def test_neighbor_avg(shape):
    a, _ = _inputs(shape, seed=1)
    got = port.neighbor_avg(_t(a)).numpy()
    np.testing.assert_allclose(got, _np(ref.neighbor_avg(jnp.asarray(a))), rtol=0, atol=0)
    np.testing.assert_allclose(got, golden.neighbor_avg_numpy(a), rtol=0, atol=GOLDEN_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_jacobi_step(shape, alpha):
    i1, i2 = _inputs(shape, seed=2)
    rng = np.random.default_rng(3)
    u = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    ex, ey, et = (a.numpy() for a in port.derivatives(_t(i1), _t(i2)))
    invd = (1.0 / (alpha * alpha + _t(ex) * _t(ex) + _t(ey) * _t(ey))).numpy()
    got = port.jacobi_step(*(_t(a) for a in (u, v, ex, ey, et, invd)))
    want = ref.jacobi_step(*(jnp.asarray(a) for a in (u, v, ex, ey, et, invd)))
    gold = golden.jacobi_step_numpy(u, v, ex, ey, et, alpha)
    for g, w, o in zip(got, want, gold):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), o, rtol=0, atol=GOLDEN_TOL)
