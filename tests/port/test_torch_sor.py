"""The port's 4-color SOR solver against the JAX reference on the CPU: the
stencil, the plain sweeps against the reference's Pallas SOR kernels in
interpret mode, the whole-solve driver, and `hs_solve`, `hs_pyramid`,
`hs_solve_batched` and `solve_bidirectional` with solver="sor", tuned omega
included.

Tolerances, each with its reason:
  * 2e-6 max |diff| for a single sweep and for the plain sweeps against the
    Pallas kernels: the reference's own kernel-vs-oracle bar
    (tests/unit/test_sor.py). The ops and their order are the same; XLA:CPU
    fuses the chain, so the last ulp may differ.
  * 1e-5 for whole SOR solves: the reference's own bar for 20 sweeps x 4
    colors = 80 dependent relaxation stages (tests/unit/test_sor.py:131-145),
    and for the pyramids, as test_torch_slice.py states.
  * 0.01 for tune_omega: the two packages power-iterate from different
    normal vectors (torch cannot reproduce jax.random.normal), and the
    result is rounded to 0.01.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.kernels.jacobi as ref_jacobi
import opticalflowhs_tpu.kernels.solve_resident as ref_resident
import opticalflowhs_tpu.kernels.sor as ref_sor
import opticalflowhs_tpu.ops.stencils as ref_stencils
import opticalflowhs_tpu.solver as ref_solver
from opticalflowhs_tpu.batch import hs_solve_batched as ref_hs_solve_batched
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.consistency import solve_bidirectional as ref_bidirectional
from opticalflowhs_tpu.pyramid import hs_pyramid as ref_hs_pyramid
from opticalflowhs_tpu.solver import Flow as RefFlow
from opticalflowhs_tpu_torch import (
    Flow,
    HSConfig,
    PyramidConfig,
    from_reference,
    hs_pyramid,
    hs_solve,
    hs_solve_batched,
)
from opticalflowhs_tpu_torch.consistency import solve_bidirectional
from opticalflowhs_tpu_torch.data.synthetic import translation_pair, two_motion_pair
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import solve_resident as sr
from opticalflowhs_tpu_torch.kernels import sor as k3
from opticalflowhs_tpu_torch.ops import stencils
from opticalflowhs_tpu_torch.solver import precompute, sweeps, tune_omega

torch.set_num_threads(1)

STEP_TOL = 2e-6
SOLVE_TOL = 1e-5
PYRAMID_TOL = 1e-5

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


def _flow_diff(got, want):
    return max(_max_diff(got.u, want.u), _max_diff(got.v, want.v))


def _frames(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2)]


def _fields(shape, seed=0, alpha=0.5):
    """(Ex, Ey, Et, invd) of random frames, as numpy arrays."""
    i1, i2 = (torch.from_numpy(a) for a in _frames(shape, seed))
    return [f.numpy() for f in k1.derivatives_plain(i1, i2, alpha)]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", [(16, 24), (67, 93)])
@pytest.mark.parametrize("omega", [1.0, 1.7])
def test_sor_step_matches_reference(shape, omega):
    fields = _fields(shape, seed=1)
    rng = np.random.default_rng(2)
    u, v = (rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2))
    colors = stencils.color_masks(*shape)
    ref_colors = ref_stencils.color_masks(*shape)
    for c, r in zip(colors, ref_colors):
        np.testing.assert_array_equal(c.numpy(), np.asarray(r))
    got = stencils.sor_step(*_t(u, v, *fields), omega, colors)
    want = ref_stencils.sor_step(*_j(u, v, *fields), omega, ref_colors)
    assert _flow_diff(Flow(*got), RefFlow(*want)) <= STEP_TOL


def test_color_masks_are_per_image_on_a_stack():
    fields = [np.stack([f, f[::-1].copy()]) for f in _fields((12, 18), seed=3)]
    z = np.zeros((2, 12, 18), np.float32)
    got = k3.sor_sweeps_plain(*_t(z, z, *fields), 3, 1.6)
    for b in range(2):
        one = k3.sor_sweeps_plain(*_t(z[b], z[b], *(f[b] for f in fields)), 3, 1.6)
        assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1])


@pytest.mark.parametrize("shape", [(64, 80), (57, 83)])
def test_sor_sweeps_plain_vs_pallas(shape):
    # The whole-image TPU kernel (_sor_vmem_kernel), as
    # tests/unit/test_sor.py::test_kernel_matches_oracle runs it.
    fields = _fields(shape, seed=2)
    rng = np.random.default_rng(4)
    u0, v0 = (rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2))
    got = k3.sor_sweeps(*_t(u0, v0, *fields), 9, 1.85)
    want = ref_sor.sor_sweeps(*_j(u0, v0, *fields), 9, 1.85, interpret=True)
    assert _flow_diff(Flow(*got), RefFlow(*want)) <= STEP_TOL


@pytest.mark.parametrize("shape,band,s", [((48, 96), 16, 2), ((50, 70), 8, 1)])
def test_sor_sweeps_plain_vs_banded_pallas(shape, band, s):
    # The banded TPU kernel (_sor_banded_kernel), 4s-row halo slabs, with a
    # remainder launch, as tests/unit/test_sor.py runs it.
    fields = _fields(shape, seed=4)
    h, w = shape
    hp = ref_jacobi._round_up(h, band)
    wp = ref_jacobi._round_up(w, ref_jacobi._LANE)
    z = np.zeros(shape, np.float32)
    args = [ref_jacobi.pad_to_tiles(a, hp, wp) for a in _j(z, z, *fields)]
    n = 2 * s + 1
    uo, vo = ref_sor._sor_sweeps_banded(*args, n, s, band, h, w, 1.8, True)
    got = k3.sor_sweeps(*_t(z, z, *fields), n, 1.8, block_sweeps=s)
    assert _flow_diff(Flow(*got), RefFlow(uo[:h, :w], vo[:h, :w])) <= STEP_TOL


@pytest.mark.parametrize("shape", [(64, 80), (67, 93)])
@pytest.mark.parametrize("warm", [False, True])
def test_resident_sor_plain_vs_pallas(shape, warm):
    i1, i2 = _frames(shape, seed=5)
    rng = np.random.default_rng(6)
    u0, v0 = ((rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2))
              if warm else (None, None))
    got = sr.hs_solve_resident_sor(*_t(i1, i2), 0.5, 12, 1.7, "hs_cube", *_t(u0, v0))
    want = ref_resident.hs_solve_resident_sor(*_j(i1, i2), 0.5, 12, 1.7, "hs_cube",
                                              *_j(u0, v0), interpret=True)
    assert want is not None
    assert _flow_diff(Flow(*got), RefFlow(*want)) <= SOLVE_TOL


def test_precompute_and_sweeps_match_reference_solver():
    # The reference's fallback chain for SOR: solver.precompute + sweeps.
    i1, i2 = _frames((40, 56), seed=7)
    cfg = HSConfig(alpha=0.6, solver="sor", omega=1.6, deriv_variant="central")
    ref_cfg = RefHS(alpha=0.6, solver="sor", omega=1.6, deriv_variant="central",
                    backend="jnp")
    fields = precompute(*_t(i1, i2), cfg)
    z = torch.zeros(40, 56)
    got = sweeps(z, z, *fields, 7, cfg)
    ref_fields = ref_solver.precompute(*_j(i1, i2), ref_cfg)
    zj = jnp.zeros((40, 56), jnp.float32)
    want = ref_solver.sweeps(zj, zj, *ref_fields, 7, ref_cfg)
    assert _flow_diff(got, want) <= SOLVE_TOL


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(deriv_variant="central"), dict(tol=1e-3),
     dict(tol=1e-4, block_sweeps=3), dict(warm=True)],
)
def test_hs_solve_sor_matches_reference(kw):
    # 48x64, alpha 0.5, i20: the reference's own backend-parity case.
    kw = dict(kw)
    warm = kw.pop("warm", False)
    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=5)
    cfg = dict(alpha=0.5, iters=20, solver="sor", omega=1.7, **kw)
    init, ref_init = None, None
    if warm:
        rng = np.random.default_rng(8)
        u0, v0 = (rng.normal(0, 0.3, (48, 64)).astype(np.float32) for _ in range(2))
        init, ref_init = Flow(*_t(u0, v0)), RefFlow(*_j(u0, v0))
    got = hs_solve(*_t(i1, i2), HSConfig(**cfg), init=init)
    want = ref_solver.hs_solve(*_j(i1, i2), RefHS(backend="jnp", **cfg), init=ref_init)
    assert _flow_diff(got, want) <= SOLVE_TOL


def test_sor_pyramid_matches_reference():
    i1, i2, _ = translation_pair(64, 96, 2.5, -1.0, key=5, max_freq=0.08)
    cfg = dict(alpha=0.5, iters=15, solver="sor", omega=1.6)
    got = hs_pyramid(*_t(i1, i2), HSConfig(**cfg), PyramidConfig(levels=2))
    want = ref_hs_pyramid(*_j(i1, i2), RefHS(backend="jnp", **cfg), RefPyr(levels=2))
    assert _flow_diff(got, want) <= PYRAMID_TOL


def test_sor_bidirectional_matches_reference():
    i1, i2, _ = translation_pair(40, 48, 1.0, 0.5, key=6)
    cfg = dict(alpha=0.5, iters=12, solver="sor", omega=1.6)
    got = solve_bidirectional(*_t(i1, i2), HSConfig(**cfg))
    want = ref_bidirectional(*_j(i1, i2), RefHS(backend="jnp", **cfg))
    for g, w in zip(got, want):
        assert _flow_diff(g, w) <= SOLVE_TOL


@pytest.mark.parametrize("kw", [dict(), dict(tol=1e-3, block_sweeps=4)])
def test_sor_batched_equals_loop_and_reference(kw):
    i1, i2 = _frames((3, 40, 48), seed=7)
    cfg = dict(alpha=0.5, iters=12, solver="sor", omega=1.6, **kw)
    got = hs_solve_batched(*_t(i1, i2), HSConfig(**cfg))
    want = ref_hs_solve_batched(*_j(i1, i2), RefHS(backend="jnp", **cfg))
    assert _flow_diff(got, want) <= SOLVE_TOL
    for b in range(3):
        one = hs_solve(*_t(i1[b], i2[b]), HSConfig(**cfg))
        assert torch.equal(one.u, got.u[b]) and torch.equal(one.v, got.v[b])


@pytest.mark.parametrize("warp,radius", [("checked", 0), ("tiled", 1)])
def test_sor_batched_pyramid_warps_per_pair(warp, radius):
    # For SOR the reference vmaps the single-pair pyramid, which honours
    # "checked" and warp_radius (the Jacobi stack route reads neither). A
    # seam of +-2 px inside each 32x128 tile makes R = 1 clamp.
    pairs = [two_motion_pair(48, 128, (2.0, 0.0), (-2.0, 0.0), key=k)[:2] for k in (1, 2)]
    i1, i2 = (np.stack(p) for p in zip(*pairs))
    cfg = dict(alpha=0.3, iters=10, solver="sor", omega=1.5)
    pyr = dict(levels=2, warp=warp, warp_radius=radius)
    got = hs_solve_batched(*_t(i1, i2), HSConfig(**cfg), PyramidConfig(**pyr))
    want = ref_hs_solve_batched(*_j(i1, i2), RefHS(backend="jnp", **cfg), RefPyr(**pyr))
    assert _flow_diff(got, want) <= PYRAMID_TOL
    for b in range(2):
        one = hs_pyramid(*_t(i1[b], i2[b]), HSConfig(**cfg), PyramidConfig(**pyr))
        assert torch.equal(one.u, got.u[b]) and torch.equal(one.v, got.v[b])
    if radius == 1:  # the warp rule matters here: Jacobi's R = 4 differs
        jac = hs_solve_batched(*_t(i1, i2), HSConfig(**cfg), PyramidConfig(levels=2))
        assert float((jac.u - got.u).abs().max()) > 1e-4


@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_tune_omega_matches_reference(alpha):
    i1, i2, _ = translation_pair(64, 96, 1.0, 0.0, key=5)
    got = tune_omega(*_t(i1, i2), HSConfig(alpha=alpha))
    want = ref_solver.tune_omega(*_j(i1, i2), RefHS(alpha=alpha))
    _DIFFS.append(abs(got - want))
    assert abs(got - want) <= 0.01 + 1e-9


def test_omega_sentinel_is_tuned_per_pair():
    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=9)
    a, b = _t(i1, i2)
    auto = HSConfig(alpha=0.3, iters=10, solver="sor", omega=0.0)
    om = tune_omega(a, b, auto)
    assert 1.0 <= om <= 1.98
    explicit = dataclasses.replace(auto, omega=om)
    for got, want in [
        (hs_solve(a, b, auto), hs_solve(a, b, explicit)),
        (hs_pyramid(a, b, auto, PyramidConfig(levels=2)),
         hs_pyramid(a, b, explicit, PyramidConfig(levels=2))),
        (solve_bidirectional(a, b, auto)[1], solve_bidirectional(a, b, explicit)[1]),
    ]:
        assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)
        assert float(got.u.abs().max()) > 0.1  # omega 0 would move nothing
    with pytest.raises(ValueError, match="single-pair"):
        hs_solve_batched(a[None], b[None], auto)


@pytest.mark.parametrize(
    "kw",
    [dict(solver="sor", omega=1.71, iters=50, backend="pallas"),
     dict(solver="robust", robust_update_every=5, robust_eps_s=0.01, tol=1e-4)],
)
def test_from_reference_carries_solver_fields(kw):
    ref_cfg = RefHS(**kw)
    got = from_reference(dataclasses.asdict(ref_cfg))
    for f in dataclasses.fields(ref_cfg):
        want = getattr(ref_cfg, f.name)
        if f.name == "backend":
            want = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}[want]
        assert getattr(got, f.name) == want, f.name
