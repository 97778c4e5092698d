"""K1, K2 and the whole-solve driver on a CUDA card against their plain
versions on the same card, at edge-case shapes (partial tiles, frames
narrower or shorter than a tile, one row, one column) and sweep counts
that the sweeps per launch do not divide.

Marked `cuda`: they skip without a card. They import no JAX, so on a
machine without it they run with the repository's conftest left out:

    python -m pytest --noconftest -p no:randomly -q -m cuda tests/port/test_torch_cuda.py

Tolerance: 0.0. The kernels are built without FMA contraction and keep
the plain ops' association order, so they equal the plain versions bitwise.
"""

import numpy as np
import pytest
import torch

from opticalflowhs_tpu_torch import HSConfig, PyramidConfig, hs_pyramid, hs_solve
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import solve_resident as sr

pytestmark = pytest.mark.cuda

SHAPES = [(67, 93), (1, 7), (9, 1), (5, 300), (300, 5), (130, 129)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(shape, dev, seed, n=2, normal=False):
    rng = np.random.default_rng(seed)
    make = (lambda: rng.normal(0, 0.5, shape)) if normal else (lambda: rng.uniform(0, 1, shape))
    return [torch.from_numpy(make().astype(np.float32)).to(dev) for _ in range(n)]


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("zero_sweep", [False, True])
def test_k1_equals_plain(dev, shape, variant, zero_sweep):
    i1, i2 = _rand(shape, dev, 0)
    _equal(k1.hs_derivatives(i1, i2, 0.7, variant, zero_sweep),
           k1.derivatives_plain(i1, i2, 0.7, variant, zero_sweep))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n,s", [(1, 0), (5, 2), (13, 0), (17, 10), (9, 1)])
def test_k2_equals_plain(dev, shape, n, s):
    i1, i2 = _rand(shape, dev, 1)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand(shape, dev, 2, normal=True)
    keep = (u0.clone(), v0.clone())
    _equal(k2.jacobi_sweeps(u0, v0, *fields, n, block_sweeps=s),
           k2.jacobi_sweeps_plain(u0, v0, *fields, n))
    _equal((u0, v0), keep)  # inputs untouched


@pytest.mark.parametrize("shape", [(67, 93), (200, 333)])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("n", [1, 2, 9, 30])
def test_driver_equals_plain(dev, shape, warm, n):
    i1, i2 = _rand(shape, dev, 3)
    init = _rand(shape, dev, 4, normal=True) if warm else (None, None)
    _equal(sr.hs_solve_resident(i1, i2, 0.5, n, "hs_cube", *init),
           sr.hs_solve_resident_plain(i1, i2, 0.5, n, "hs_cube", *init))


def test_entry_points_run_the_kernels(dev):
    i1, i2 = _rand((96, 128), dev, 5)
    k1.hs_derivatives.launches = 0
    k2.jacobi_sweeps.launches = 0
    got = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=20))
    assert k1.hs_derivatives.launches == 1
    assert k2.jacobi_sweeps.launches == -(-19 // k2.sweeps_per_launch(0))
    _equal(got, hs_solve(i1, i2, HSConfig(alpha=0.5, iters=20, backend="torch")))
    k1.hs_derivatives.launches = 0
    got = hs_pyramid(i1, i2, HSConfig(alpha=1.0, iters=10), PyramidConfig(levels=3))
    assert k1.hs_derivatives.launches == 3
    _equal(got, hs_pyramid(i1, i2, HSConfig(alpha=1.0, iters=10, backend="torch"),
                           PyramidConfig(levels=3)))


def test_wrappers_reject_bad_cuda_tensors(dev):
    i1, i2 = _rand((16, 16), dev, 6)
    with pytest.raises(ValueError):
        k1.hs_derivatives(i1.double(), i2.double(), 0.5)
    with pytest.raises(ValueError):
        k1.hs_derivatives(i1, i2.cpu(), 0.5)
    with pytest.raises(ValueError):
        k2.jacobi_sweeps(i1.t(), i2, i1, i1, i1, i1, 3)
