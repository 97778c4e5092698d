"""K8's module (kernels/sor_planes.py) on the CPU: the whole solve against
the reference's color-plane kernel (`_planes_kernel`) in interpret mode, as
tests/unit/test_sor_planes.py runs it; the plain plane schedule against the
plain full-resolution SOR sweeps; and the reference's None and ValueError
contract.

Tolerances, each with its reason:
  * 1e-5 max |diff| against the reference's kernel: the bar of the SOR
    whole solves (test_torch_sor.py; n sweeps x 4 dependent color stages,
    where XLA:CPU's fused interpret-mode body may round the last ulp
    otherwise).
  * 0.0 for the plane schedule against `sor_sweeps_plain`: the [1,2,1]
    passes on planes sum the same three values in the same order, so every
    intermediate float is the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.kernels.sor_planes as ref_sp
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import sor as k3
from opticalflowhs_tpu_torch.kernels import sor_planes as k8

torch.set_num_threads(1)

SOLVE_TOL = 1e-5

# Every |diff| a test measures against the reference, recorded as the junit
# property `max_abs_diff`.
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


def _frames(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2)]


def _normal(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.4, shape).astype(np.float32) for _ in range(2)]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize(
    "shape,n,omega,warm",
    [
        ((192, 128), 7, 1.6, False),   # even/even
        ((131, 130), 5, 1.3, False),   # odd/even
        ((96, 255), 6, 1.9, False),    # even/odd
        ((97, 253), 4, 1.5, True),     # odd/odd, from a warm start
    ],
)
def test_solve_matches_reference_kernel(shape, n, omega, warm):
    i1, i2 = _frames(shape)
    init = _normal(shape, seed=7) if warm else (None, None)
    got = k8.hs_solve_sor_planes(*_t(i1, i2), 0.5, n, omega, "hs_cube", *_t(*init))
    want = ref_sp.hs_solve_sor_planes(*_j(i1, i2), 0.5, n, omega, "hs_cube", *_j(*init),
                                      interpret=True)
    assert got is not None and want is not None
    assert max(_max_diff(got[0], want[0]), _max_diff(got[1], want[1])) <= SOLVE_TOL


# Every parity of h and w, and frames of 1-3 rows or columns, where the odd
# plane is empty or a single row.
PLAIN_SHAPES = [(192, 128), (131, 130), (96, 255), (97, 253), (67, 93),
                (1, 7), (2, 9), (3, 8), (7, 1), (8, 2), (9, 3), (1, 1), (2, 3), (3, 2)]


@pytest.mark.parametrize("shape", PLAIN_SHAPES)
def test_plane_schedule_equals_plain_sor(shape):
    i1, i2 = _t(*_frames(shape, seed=1))
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _t(*_normal(shape, seed=2))
    z = torch.zeros(shape)
    for n, omega in ((1, 1.0), (5, 1.7)):
        for start, plain_start in (((None, None), (z, z)), ((u0, v0), (u0, v0))):
            got = k8.sor_planes_plain(*start, *fields, n, omega)
            want = k3.sor_sweeps_plain(*plain_start, *fields, n, omega)
            assert _max_diff(got[0], want[0]) == 0.0 and _max_diff(got[1], want[1]) == 0.0
            assert torch.equal(k8.sor_planes(*start, *fields, n, omega)[0], got[0])


@pytest.mark.parametrize("shape", [(4, 6), (5, 7), (1, 1), (6, 1)])
def test_planes_round_trip(shape):
    a = torch.arange(shape[0] * shape[1], dtype=torch.float32).reshape(shape)
    p = k8.planes(a)
    assert all(tuple(q.shape) == k8.plane_shape(*shape) for q in p)
    assert torch.equal(k8.interleave(*p, *shape), a)
    for q, (pi, pj) in zip(p, k8.COLORS):
        real = a[pi::2, pj::2]
        assert torch.equal(q[:real.shape[0], :real.shape[1]], real)
        assert float(q.sum()) == float(real.sum())  # the pad cells hold 0.0


@pytest.mark.parametrize(
    "shape", [(1088, 1920), (2160, 3840), (1440, 2560), (1600, 2048), (1601, 2048), (8, 8)]
)
def test_class_matches_reference(shape):
    # 1088x1920 is inside the class, 4K outside; 1600x2048 is its edge.
    assert k8.applicable_shape(*shape) == ref_sp.applicable_shape(*shape, jnp.float32)
    assert (k8.applicable_shape(1088, 1920) is not None
            and k8.applicable_shape(2160, 3840) is None)


def test_none_and_value_error_match_reference():
    i1, i2 = _frames((64, 128))
    t1, t2 = _t(i1, i2)
    j1, j2 = _j(i1, i2)
    for args in (((t1[None], t2[None], 0.5, 4, 1.5), (j1[None], j2[None], 0.5, 4, 1.5)),
                 ((t1, t2, 0.5, 0, 1.5), (j1, j2, 0.5, 0, 1.5)),
                 ((t1, t2, 0.5, 4, 1.5, "central"), (j1, j2, 0.5, 4, 1.5, "central"))):
        assert k8.hs_solve_sor_planes(*args[0]) is None
        assert ref_sp.hs_solve_sor_planes(*args[1], interpret=True) is None
    big = torch.zeros(2160, 3840)
    assert k8.hs_solve_sor_planes(big, big, 0.5, 4, 1.5) is None
    with pytest.raises(ValueError, match="together"):
        k8.hs_solve_sor_planes(t1, t2, 0.5, 4, 1.5, u0=t1)
    with pytest.raises(ValueError, match="together"):
        ref_sp.hs_solve_sor_planes(j1, j2, 0.5, 4, 1.5, u0=j1, interpret=True)
    # Inside the class it returns a solve, never None.
    assert k8.hs_solve_sor_planes(t1, t2, 0.5, 1, 1.5) is not None


def test_cpu_wrapper_launches_nothing_and_checks_inputs():
    i1, i2 = _t(*_frames((16, 24)))
    fields = k1.derivatives_plain(i1, i2, 0.5)
    before = k8.sor_planes.launches
    k8.hs_solve_sor_planes(i1, i2, 0.5, 3, 1.6)
    k8.sor_planes(None, None, *fields, 3, 1.6)
    assert k8.sor_planes.launches == before
    with pytest.raises(ValueError):
        k8.sor_planes(None, None, *(f.double() for f in fields), 3, 1.6)
    with pytest.raises(ValueError, match="together"):
        k8.sor_planes(i1, None, *fields, 3, 1.6)
    with pytest.raises(ValueError, match=r"\(H, W\) frame"):
        k8.sor_planes(None, None, *(f[None] for f in fields), 3, 1.6)
