"""The port's multigrid solver (multigrid.py, solver="multigrid") against the
JAX reference on the CPU: the operator, residual, smoother and transfers,
the coefficient hierarchy, the V-cycles, and every entry point that
reaches `solve_level` (hs_solve with a fixed count and to tolerance,
hs_solve_batched, hs_pyramid, the streams, hs_solve_checkpointed).

Tolerances, each with its reason:
  * 2e-6 max |diff| for the pieces (operator, residual, a few smoothing
    sweeps, the hierarchy): the reference's kernel-vs-oracle bar; the ops
    and their order are the same, XLA:CPU fuses the jitted chains, so the
    last ulp may differ.
  * 0.0 for restrict and prolong: sums of the same terms in the same order
    with exact weights.
  * 1e-5 for whole solves (V-cycles, 32 coarse sweeps each) and pyramids,
    the bar of the SOR solves and of hs_pyramid (test_torch_sor.py).
  * 2e-5 for each pair of the warm stream: a multigrid solve from a
    converged 1 px prior; the coarse grids scale the data term and the
    residual by 4 a level, which magnifies the last-ulp differences of
    XLA's fused chains (1.07e-5 measured on this 48x64 video, about 90
    float32 ulps of flows near 1). The reference allows 1e-5 between two
    XLA builds of the same V-cycles (tests/unit/test_multigrid.py).
Batched = singles and checkpointed = uninterrupted are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.multigrid as ref_mg
from opticalflowhs_tpu.batch import hs_solve_batched as ref_hs_solve_batched
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.ops import stencils as ref_stencils
from opticalflowhs_tpu.pyramid import hs_pyramid as ref_hs_pyramid
from opticalflowhs_tpu.solver import Flow as RefFlow
from opticalflowhs_tpu.solver import hs_solve as ref_hs_solve
from opticalflowhs_tpu_torch import (
    Flow,
    HSConfig,
    PyramidConfig,
    flow_stream,
    flow_stream_warm,
    hs_pyramid,
    hs_solve,
    hs_solve_batched,
    hs_solve_checkpointed,
)
from opticalflowhs_tpu_torch import multigrid as mg
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence, translation_pair
from opticalflowhs_tpu_torch.metrics import epe, interior
from opticalflowhs_tpu_torch.ops import stencils

torch.set_num_threads(1)

PIECE_TOL = 2e-6
SOLVE_TOL = 1e-5
STREAM_TOL = 2e-5

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
    return max(_max_diff(got[0], want[0]), _max_diff(got[1], want[1]))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _system(shape, alpha=0.5, seed=0):
    """(ex, ey, et) of random frames as numpy arrays (the port's plain
    derivatives), alpha^2, and a random (u, v) and (gu, gv)."""
    rng = np.random.default_rng(seed)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)) for _ in range(2))
    ex, ey, et = (f.numpy() for f in stencils.derivatives(i1, i2))
    u, v, gu, gv = (rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(4))
    return ex, ey, et, alpha * alpha, (u, v), (gu, gv)


def _products(ex, ey):
    return ex * ex, ex * ey, ey * ey


SHAPES = [(17, 23), (16, 24), (33, 48)]


@pytest.mark.parametrize("shape", SHAPES)
def test_operator_and_residual_match_reference(shape):
    ex, ey, et, a2, (u, v), (gu, gv) = _system(shape, seed=1)
    prods = _products(ex, ey)
    got = mg.hs_operator(*_t(u, v, *prods), a2)
    want = ref_mg.hs_operator(*_j(u, v, *prods), a2)
    assert _flow_diff(got, want) <= PIECE_TOL
    got = mg.residual(*_t(u, v, gu, gv, *prods), a2)
    want = ref_mg.residual(*_j(u, v, gu, gv, *prods), a2)
    assert _flow_diff(got, want) <= PIECE_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_gs_general_matches_reference(shape):
    ex, ey, et, a2, (u, v), (gu, gv) = _system(shape, seed=2)
    lvl = mg._level(*_t(*_products(ex, ey)), a2)
    ref_lvl = ref_mg._level(*_j(*_products(ex, ey)), a2)
    for c, r in zip(lvl[5], ref_lvl[5]):
        np.testing.assert_array_equal(c.numpy(), np.asarray(r))
    assert _max_diff(lvl[4], ref_lvl[4]) <= PIECE_TOL
    got = mg.gs_general(*_t(u, v, gu, gv), lvl, 3)
    want = ref_mg.gs_general(*_j(u, v, gu, gv), ref_lvl, 3)
    assert _flow_diff(got, want) <= PIECE_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_restrict_and_prolong_match_reference(shape):
    a = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    got = mg.restrict(torch.from_numpy(a))
    want = ref_mg.restrict(jnp.asarray(a))
    assert tuple(got.shape) == want.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    assert _max_diff(got, want) == 0.0
    # The 2-D stride formulation, bitwise (the reference's own pin).
    t = stencils.shift_down_row(torch.from_numpy(a)) + 2.0 * torch.from_numpy(a) \
        + stencils.shift_up_row(torch.from_numpy(a))
    s = stencils.shift_right_col(t) + 2.0 * t + stencils.shift_left_col(t)
    assert torch.equal(got, s[::2, ::2] * (1.0 / 16.0))
    up = mg.prolong(got, *shape)
    assert tuple(up.shape) == shape
    assert _max_diff(up, ref_mg.prolong(want, *shape)) == 0.0


def test_build_levels_matches_reference():
    ex, ey, _, _, _, _ = _system((70, 90), seed=4)
    got = mg._build_levels(*_t(ex, ey), 0.7)
    want = jax.jit(ref_mg._build_levels, static_argnums=2)(*_j(ex, ey), 0.7)
    assert [tuple(lv[0].shape) for lv in got] == [lv[0].shape for lv in want]
    assert len(got) == 4  # 70x90 -> 35x45 -> 18x23 -> 9x12
    for g, w in zip(got, want):
        for k in (0, 1, 2, 4):
            assert _max_diff(g[k], w[k]) <= PIECE_TOL * max(1.0, float(np.abs(w[k]).max()))


def test_stack_is_one_pass_equal_to_singles():
    systems = [_system((20, 28), seed=10 + k) for k in range(3)]
    ex, ey, et = (torch.from_numpy(np.stack([s[k] for s in systems])) for k in range(3))
    z = torch.zeros_like(ex)
    got = mg.mg_solve(z, z, ex, ey, et, 0.6, 2)
    for k in range(3):
        one = mg.mg_solve(z[k], z[k], ex[k], ey[k], et[k], 0.6, 2)
        assert torch.equal(got[0][k], one[0]) and torch.equal(got[1][k], one[1])


@pytest.mark.parametrize("shape,cycles,warm", [((48, 64), 1, False), ((37, 53), 3, True)])
def test_mg_sweeps_matches_reference(shape, cycles, warm):
    ex, ey, et, _, (u, v), _ = _system(shape, seed=5)
    if not warm:
        u, v = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    invd = np.zeros(shape, np.float32)  # unused by both
    got = mg.mg_sweeps(*_t(u, v, ex, ey, et, invd), cycles, HSConfig(alpha=0.8))
    want = jax.jit(ref_mg.mg_sweeps, static_argnums=(6, 7))(
        *_j(u, v, ex, ey, et, invd), cycles, RefHS(alpha=0.8))
    assert _flow_diff(got, want) <= SOLVE_TOL


@pytest.mark.parametrize(
    "kw",
    [dict(iters=2), dict(iters=6, tol=1e-30),
     dict(iters=2, warm=True, deriv_variant="central"), dict(iters=0)],
)
def test_hs_solve_multigrid_matches_reference(kw):
    kw = dict(kw)
    warm = kw.pop("warm", False)
    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=5)
    cfg = dict(alpha=1.0, solver="multigrid", **kw)
    init, ref_init = None, None
    if warm:
        rng = np.random.default_rng(8)
        u0, v0 = (rng.normal(0, 0.3, (48, 64)).astype(np.float32) for _ in range(2))
        init, ref_init = Flow(*_t(u0, v0)), RefFlow(*_j(u0, v0))
    got = hs_solve(*_t(i1, i2), HSConfig(**cfg), init=init)
    want = ref_hs_solve(*_j(i1, i2), RefHS(backend="jnp", **cfg), init=ref_init)
    assert _flow_diff(got, want) <= SOLVE_TOL
    if kw.get("tol") == 1e-30:  # never converges: the full budget, as fixed count
        fixed = hs_solve(*_t(i1, i2), HSConfig(alpha=1.0, solver="multigrid", iters=6))
        assert torch.equal(got.u, fixed.u) and torch.equal(got.v, fixed.v)


def test_multigrid_beats_jacobi_at_alpha_1():
    # The reason multigrid exists (the reference's test_multigrid.py, at a
    # quarter of its size): 2 V-cycles against 100 and 800 Jacobi sweeps.
    i1, i2, gt = translation_pair(128, 192, 1.0, 0.0, key=3)

    def run(solver, iters):
        f = hs_solve(*_t(i1, i2), HSConfig(alpha=1.0, iters=iters, solver=solver))
        return epe(interior(np.stack([f.u.numpy(), f.v.numpy()], -1), 8), interior(gt, 8))

    e_mg2 = run("multigrid", 2)
    assert e_mg2 * 5 <= run("jacobi", 100)
    assert e_mg2 <= run("jacobi", 800)


@pytest.mark.parametrize("kw", [dict(iters=5, tol=2e-3)])
def test_batched_multigrid_equals_singles_and_reference(kw):
    rng = np.random.default_rng(7)
    i1, i2 = (rng.uniform(0, 1, (3, 40, 48)).astype(np.float32) for _ in range(2))
    cfg = dict(alpha=1.0, solver="multigrid", **kw)
    got = hs_solve_batched(*_t(i1, i2), HSConfig(**cfg))
    want = ref_hs_solve_batched(*_j(i1, i2), RefHS(backend="jnp", **cfg))
    assert _flow_diff(got, want) <= SOLVE_TOL
    for b in range(3):
        one = hs_solve(*_t(i1[b], i2[b]), HSConfig(**cfg))
        assert torch.equal(one.u, got.u[b]) and torch.equal(one.v, got.v[b])


def test_multigrid_pyramids_match_reference():
    i1, i2, _ = translation_pair(64, 96, 2.5, -1.0, key=5, max_freq=0.08)
    cfg = dict(alpha=1.0, iters=2, solver="multigrid")
    got = hs_pyramid(*_t(i1, i2), HSConfig(**cfg), PyramidConfig(levels=2))
    want = ref_hs_pyramid(*_j(i1, i2), RefHS(backend="jnp", **cfg), RefPyr(levels=2))
    assert _flow_diff(got, want) <= SOLVE_TOL
    # The batched pyramid warps each image by the single-pair rule for
    # every solver but Jacobi, so a stack equals the single pyramids.
    stack = [torch.from_numpy(np.stack([a, a[:, ::-1].copy()])) for a in (i1, i2)]
    both = hs_solve_batched(*stack, HSConfig(**cfg), PyramidConfig(levels=2))
    for b in range(2):
        one = hs_pyramid(stack[0][b], stack[1][b], HSConfig(**cfg), PyramidConfig(levels=2))
        assert torch.equal(one.u, both.u[b]) and torch.equal(one.v, both.v[b])


def test_multigrid_streams_match_reference():
    # 48x64 frames and the config of the hs_solve tests, so that the
    # reference's solves below reuse their compiled programs.
    vid = synthetic_sequence(5, 48, 64, tx=1.0, ty=0.5, key=3)[0]
    cfg = dict(alpha=1.0, iters=2, solver="multigrid")
    got = list(flow_stream(vid, HSConfig(**cfg), chunk=2, device="cpu"))
    assert [c.u.shape[0] for c in got] == [2, 2]
    whole = hs_solve_batched(*_t(vid[:-1], vid[1:]), HSConfig(**cfg))
    assert torch.equal(torch.cat([c.u for c in got]), whole.u)
    assert torch.equal(torch.cat([c.v for c in got]), whole.v)
    # The warm stream pair by pair: each pair is the reference's solve from
    # the stream's previous flow, so the differences do not add up along
    # the chain.
    got = list(flow_stream_warm(vid, HSConfig(**cfg), chunk=2, device="cpu"))
    assert len(got) == 4
    prev = None
    for k, g in enumerate(got):
        want = ref_hs_solve(*_j(vid[k], vid[k + 1]), RefHS(backend="jnp", **cfg),
                            init=None if prev is None else RefFlow(*_j(prev.u, prev.v)))
        assert _flow_diff(g, want) <= STREAM_TOL
        prev = g


def test_checkpointed_multigrid_equals_uninterrupted(tmp_path):
    i1, i2, _ = translation_pair(40, 56, 1.0, 0.5, key=6)
    cfg = HSConfig(alpha=1.0, iters=5, solver="multigrid", checkpoint_every=2)
    got = hs_solve_checkpointed(*_t(i1, i2), cfg, str(tmp_path / "mg.npz"))
    whole = hs_solve(*_t(i1, i2), HSConfig(alpha=1.0, iters=5, solver="multigrid"))
    assert torch.equal(got.u, whole.u) and torch.equal(got.v, whole.v)


def test_smoother_is_sor_omega_1_on_the_fine_level():
    # The reference's first rung: with g = -d*Et, the general smoother is
    # exactly 4-color SOR at omega 1 (the rank-1 reduction of the 2x2 solve).
    ex, ey, et, a2, _, _ = _system((24, 40), seed=9)
    ex, ey, et = _t(ex, ey, et)
    invd = 1.0 / (a2 + ex * ex + ey * ey)
    colors = stencils.color_masks(24, 40)
    lvl = mg._level(ex * ex, ex * ey, ey * ey, a2)
    z = torch.zeros_like(ex)
    u1, v1 = mg.gs_general(z, z, -ex * et, -ey * et, lvl, 3)
    u2, v2 = z, z
    for _ in range(3):
        u2, v2 = stencils.sor_step(u2, v2, ex, ey, et, invd, 1.0, colors)
    assert max(float((u1 - u2).abs().max()), float((v1 - v2).abs().max())) <= 1e-5
    ref_colors = ref_stencils.color_masks(24, 40)
    for c, r in zip(colors, ref_colors):
        np.testing.assert_array_equal(c.numpy(), np.asarray(r))
