"""The beyond-resident whole solves (K6 `hs_solve_fused`, K7
`hs_solve_skewed`) on the CPU: their plain versions against the
reference's TPU kernels run in interpret mode, as the reference's own tests
run them, and K7's band/pencil schedule, walked in plain PyTorch at the
reference's geometries, against the plain whole solve.
(test_torch_beyond_schedule.py holds the schedule at more geometries, the
routing classes and the wrappers on the CPU.)

Tolerances, each with its reason:
  * plain whole solve vs the reference's interpret-mode kernels: 2e-6 max
    |diff|, the reference's kernel-vs-oracle bar (XLA:CPU fuses the
    reference's chain, so the last ulp of a sweep may differ and later
    sweeps carry it along);
  * `skewed_schedule_plain` vs the plain whole solve: 0.0. Both run the
    same plain ops per pixel; the schedule only changes which window a
    pixel is computed in, and its in-place order must not change a bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.kernels.derivatives as ref_deriv
import opticalflowhs_tpu.kernels.jacobi as ref_jacobi
import opticalflowhs_tpu.kernels.solve_fused as ref_fused
import opticalflowhs_tpu.kernels.solve_skewed as ref_skewed
from opticalflowhs_tpu_torch.kernels import solve_fused as k6
from opticalflowhs_tpu_torch.kernels import solve_skewed as k7

torch.set_num_threads(1)

TOL = 2e-6

# Every |diff| a test measures, recorded as the junit property
# `max_abs_diff` (as in test_torch_batch.py).
_DIFFS: list[float] = []


@pytest.fixture(autouse=True)
def _report_max_diff(record_property):
    _DIFFS.clear()
    yield
    if _DIFFS:
        record_property("max_abs_diff", max(_DIFFS))


def _max_diff(got, want):
    d = max(float(np.abs(np.asarray(g) - np.asarray(w)).max()) for g, w in zip(got, want))
    _DIFFS.append(d)
    return d


def _frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (h, w)).astype(np.float32) for _ in range(2)]


def _normal(h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (h, w)).astype(np.float32) for _ in range(2)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def small_budget(monkeypatch):
    # The reference's own fixture (tests/unit/test_solve_fused.py): a band
    # of about 64 rows, so that small frames take the fused class.
    budget = 96 * 128 * 4 * ref_fused._ARRAYS
    for mod in (ref_fused, ref_jacobi, ref_deriv):
        monkeypatch.setattr(mod, "_VMEM_BUDGET", budget)


# -- K6's plain whole solve against the reference's megakernel ------------------


@pytest.mark.parametrize(
    "shape,n,variant,warm",
    [((192, 128), 12, "hs_cube", False), ((131, 130), 8, "hs_cube", False),
     ((160, 133), 10, "hs_cube", True), ((144, 129), 8, "central", False)],
)
def test_fused_plain_matches_reference_kernel(shape, n, variant, warm, small_budget):
    i1, i2 = _frames(*shape, seed=3)
    init = _normal(*shape, seed=9) if warm else [None, None]
    want = ref_fused.hs_solve_fused(
        jnp.asarray(i1), jnp.asarray(i2), 0.5, n, variant,
        u0=None if init[0] is None else jnp.asarray(init[0]),
        v0=None if init[1] is None else jnp.asarray(init[1]), interpret=True)
    assert want is not None, "the reference's fused pipeline should take this frame"
    t_init = [None, None] if init[0] is None else _t(init)
    got = k6.hs_solve_fused(*_t([i1, i2]), 0.5, n, variant, *t_init)
    assert _max_diff(got, want) <= TOL
    assert _max_diff(k6.hs_solve_fused_plain(*_t([i1, i2]), 0.5, n, variant, *t_init),
                     want) <= TOL


# -- K7: the plain schedule, and the plain solve against the reference kernel ----


def _ref_geom(h, s, n, nb):
    """The reference's hand-built skewed geometry (tests/unit/test_solve_skewed.py)."""
    sigma = ((s + 7) // 8) * 8
    band = max(sigma, ((-(-h // nb)) + sigma - 1) // sigma * sigma)
    return (s, n % s, sigma, band, band * nb)


SKEWED_CASES = [  # shape, s, n, nb, variant, warm: nb 1-3, remainders
    ((48, 128), 3, 7, 1, "hs_cube", False),
    ((40, 130), 4, 8, 3, "hs_cube", False),
    ((53, 120), 5, 12, 2, "hs_cube", False),
    ((48, 120), 3, 6, 2, "central", False),
    ((48, 128), 3, 5, 2, "hs_cube", True),
]


@pytest.mark.parametrize("shape,s,n,nb,variant,warm", SKEWED_CASES)
def test_skewed_plain_matches_reference_kernel(shape, s, n, nb, variant, warm):
    i1, i2 = _frames(*shape, seed=1)
    geom = _ref_geom(shape[0], s, n, nb)
    if warm:
        u0, v0 = _normal(*shape, seed=7)
        want = ref_skewed._solve_warm_ad(jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(u0),
                                         jnp.asarray(v0), 0.5, n, variant, geom, True)
        init = _t([u0, v0])
    else:
        want = ref_skewed._solve_zero_ad(jnp.asarray(i1), jnp.asarray(i2), 0.5, n,
                                         variant, geom, True)
        init = [None, None]
    got = k7.hs_solve_skewed(*_t([i1, i2]), 0.5, n, variant, *init)
    assert _max_diff(got, want) <= TOL
    # K7's own schedule at the reference's geometry: the plain solve, bitwise.
    sched = k7.skewed_schedule_plain(*_t([i1, i2]), 0.5, n, variant, *init,
                                     s=geom[0], band=geom[3])
    assert _max_diff(sched, got) == 0.0
