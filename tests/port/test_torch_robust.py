"""The port's Charbonnier IRLS ("robust") solver against the JAX reference on
the CPU: the weights and the frozen-weight step, the IRLS sweeps over the
refreeze cadences of tests/unit/test_solve_robust.py, the plain whole solve
against the reference's Pallas kernel in interpret mode, and `hs_solve`,
`hs_pyramid` and `hs_solve_batched` with solver="robust".

Tolerances, each with its reason:
  * 2e-6 max |diff| for the weights, one step and the sweeps: the
    reference's own kernel-vs-oracle bar (tests/unit/test_solve_robust.py).
    The ops and their order are the same; XLA:CPU fuses the chain, so the
    last ulp may differ, and XLA's rsqrt and torch's CPU rsqrt (1/sqrt) may
    differ by an ulp: the weights' max |diff| (recorded as `max_abs_diff`)
    is that ulp where it is not 0.
  * 1e-5 for whole solves through the entry points and the pyramid, as
    the SOR solves and the pyramids of the other port tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.kernels.solve_robust as ref_srb
import opticalflowhs_tpu.robust as ref_robust
import opticalflowhs_tpu.solver as ref_solver
from opticalflowhs_tpu.batch import hs_solve_batched as ref_hs_solve_batched
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.pyramid import hs_pyramid as ref_hs_pyramid
from opticalflowhs_tpu.solver import Flow as RefFlow
from opticalflowhs_tpu_torch import (
    Flow,
    HSConfig,
    PyramidConfig,
    hs_pyramid,
    hs_solve,
    hs_solve_batched,
    robust,
)
from opticalflowhs_tpu_torch.data.synthetic import two_motion_pair
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import solve_robust as k4

torch.set_num_threads(1)

STEP_TOL = 2e-6
SOLVE_TOL = 1e-5

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


def _frames(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2)]


def _flow(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2)]


def _fields(shape, seed=0):
    """(Ex, Ey, Et) of random frames, as numpy arrays."""
    i1, i2 = (torch.from_numpy(a) for a in _frames(shape, seed))
    return [f.numpy() for f in k1.derivatives_plain(i1, i2, 0.4)[:3]]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", [(16, 24), (67, 93)])
@pytest.mark.parametrize("eps", [(0.05, 0.05), (0.01, 0.2)])
def test_charbonnier_weights_match_reference(shape, eps):
    u, v = _flow(shape, seed=1)
    fields = _fields(shape, seed=2)
    got = robust.charbonnier_weights(*_t(u, v, *fields), *eps)
    want = ref_robust.charbonnier_weights(*_j(u, v, *fields), *eps)
    assert _flow_diff(got, want) <= STEP_TOL


@pytest.mark.parametrize("shape", [(16, 24), (67, 93)])
@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_robust_step_matches_reference(shape, alpha):
    u, v = _flow(shape, seed=3)
    fields = _fields(shape, seed=4)
    wd, ws = (np.array(w) for w in ref_robust.charbonnier_weights(
        *_j(u, v, *fields), 0.05, 0.05))
    got = robust.robust_step(*_t(u, v, *fields, wd, ws), alpha)
    want = ref_robust.robust_step(*_j(u, v, *fields, wd, ws), alpha)
    assert _flow_diff(got, want) <= STEP_TOL


# The (iters, k) cases of tests/unit/test_solve_robust.py at small shapes:
# k > n (one freeze), even k with a remainder, odd k crossing the
# remainder, a single sweep.
@pytest.mark.parametrize("iters,k", [(7, 20), (25, 10), (13, 5), (1, 20)])
def test_robust_sweeps_match_reference(iters, k):
    shape = (40, 56)
    fields = _fields(shape, seed=5)
    u0, v0 = _flow(shape, seed=6)
    cfg = dict(alpha=0.4, solver="robust", robust_update_every=k)
    got = robust.robust_sweeps(*_t(u0, v0, *fields), iters, HSConfig(**cfg))
    want = ref_robust.robust_sweeps(*_j(u0, v0, *fields), iters, RefHS(**cfg))
    assert _flow_diff(got, want) <= STEP_TOL
    assert sum(robust.refreeze_blocks(iters, k)) == iters


@pytest.mark.parametrize("warm", [False, True])
def test_resident_robust_plain_vs_pallas(warm):
    shape = (48, 64)
    i1, i2 = _frames(shape, seed=7)
    u0, v0 = _flow(shape, seed=8) if warm else (None, None)
    cfg = dict(alpha=0.4, iters=9, solver="robust", robust_update_every=4)
    got = k4.hs_solve_robust_resident(*_t(i1, i2), HSConfig(**cfg), *_t(u0, v0))
    want = ref_srb.hs_solve_robust_resident(*_j(i1, i2), RefHS(**cfg), *_j(u0, v0),
                                            interpret=True)
    assert want is not None
    assert _flow_diff(got, want) <= STEP_TOL


def _seam(h=40, w=64, key=3):
    return two_motion_pair(h, w, (1.0, 0.0), (-1.0, 0.0), key=key)[:2]


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(deriv_variant="central", robust_update_every=3),
     dict(tol=1e-3, block_sweeps=6), dict(warm=True)],
)
def test_hs_solve_robust_matches_reference(kw):
    kw = dict(kw)
    warm = kw.pop("warm", False)
    i1, i2 = _seam()
    cfg = dict(dict(alpha=0.2, iters=30, solver="robust", robust_update_every=7), **kw)
    init = ref_init = None
    if warm:
        u0, v0 = _flow(i1.shape, seed=9)
        init, ref_init = Flow(*_t(u0, v0)), RefFlow(*_j(u0, v0))
    got = hs_solve(*_t(i1, i2), HSConfig(**cfg), init=init)
    want = ref_solver.hs_solve(*_j(i1, i2), RefHS(backend="jnp", **cfg), init=ref_init)
    assert _flow_diff(got, want) <= SOLVE_TOL


def test_robust_pyramid_matches_reference():
    i1, i2 = _seam(48, 64, key=4)
    cfg = dict(alpha=0.2, iters=12, solver="robust", robust_update_every=5)
    got = hs_pyramid(*_t(i1, i2), HSConfig(**cfg), PyramidConfig(levels=2))
    want = ref_hs_pyramid(*_j(i1, i2), RefHS(backend="jnp", **cfg), RefPyr(levels=2))
    assert _flow_diff(got, want) <= SOLVE_TOL


@pytest.mark.parametrize("kw", [dict(), dict(tol=1e-3, block_sweeps=5)])
def test_robust_batched_equals_loop_and_reference(kw):
    pairs = [_seam(32, 48, key=k) for k in (1, 2, 3)]
    i1, i2 = (np.stack(p) for p in zip(*pairs))
    cfg = dict(alpha=0.2, iters=16, solver="robust", robust_update_every=6, **kw)
    got = hs_solve_batched(*_t(i1, i2), HSConfig(**cfg))
    want = ref_hs_solve_batched(*_j(i1, i2), RefHS(backend="jnp", **cfg))
    assert _flow_diff(got, want) <= SOLVE_TOL
    for b in range(3):
        one = hs_solve(*_t(i1[b], i2[b]), HSConfig(**cfg))
        assert torch.equal(one.u, got.u[b]) and torch.equal(one.v, got.v[b])


def test_cpu_robust_and_sor_launch_nothing():
    from opticalflowhs_tpu_torch.kernels import sor as k3
    i1, i2 = _t(*_frames((16, 24)))
    counters = (k3.sor_sweeps, k4.freeze_weights, k4.frozen_sweeps)
    before = [c.launches for c in counters]
    hs_solve(i1, i2, HSConfig(iters=5, solver="robust", robust_update_every=2))
    hs_solve(i1, i2, HSConfig(iters=5, solver="sor", omega=1.5))
    assert [c.launches for c in counters] == before
