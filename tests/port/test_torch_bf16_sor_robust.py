"""bfloat16 on the SOR and IRLS solvers (HSConfig(solver="sor" | "robust",
dtype="bfloat16")) on the CPU: the port's plain bfloat16 twins, the
schedule twins of K3, K4 and K8, and every entry point against the JAX
reference on the same numpy inputs.

The port's rule (the package docstring, ops/stencils.py `store`):
bfloat16 storage, float32 arithmetic, each array rounded once where it is
stored. SOR rounds u and v once a sweep, at its end: the four color stages
read the earlier stages' float32 values. IRLS rounds wd and ws at each
freeze and u and v once a sweep. Bars, each with its reason and its
measured value:
  * K3's 5 sweeps from the same bfloat16 fields, against the reference's
    `_sor_vmem_kernel` in interpret mode: on those fields widened, within
    K3_ULP = 2^-8, one bfloat16 ulp at the flow's magnitude (|u|, |v| < 1;
    measured 2.9e-3); in bfloat16, no further than the reference's own
    bfloat16 kernel lies from its float32 run plus K3_ULP (measured 0.0215
    against 0.0212: the reference rounds at every color stage, the port
    once a sweep).
  * K4 from the same bfloat16 frames, against the reference's
    `_robust_kernel` in interpret mode: atol 1e-2, the same bar; measured
    3.9e-3.
  * The entry points: interior (8 px in) mean <= 0.02 px and max <= 0.1 px
    against the reference's float32 solve of the same inputs, the bars of
    the Jacobi path (tests/port/test_torch_bf16.py); IRLS also mean < 0.1
    against the reference's bfloat16 solve (the reference's bar). Measured
    at these sizes: at most 0.006 mean and 0.05 max against float32.
  * SOR against the reference's bfloat16 SOR: not held to a bar. The
    reference's bfloat16 SOR drifts 0.14-0.85 px mean from its own float32
    solve (ROADMAP.md queue 3), the port's less than 0.001; the test
    records the distance (junit property `ref_bf16_mean`) and checks only
    that the port is the closer of the two to float32.
  * tune_omega in bfloat16 against the reference's bfloat16 omega: no
    further from it than it lies from the reference's float32 omega, plus
    OMEGA_TOL = 0.01, one quantum of the rounding (the reference's
    bfloat16 power iteration rounds its norms and drifts: 1.97 against
    1.81 at alpha 1; the port's 1.84, measured 0.13 and 0.00 from it at
    alpha 1.0 and 0.1); and within OMEGA_F32_TOL = 0.03 of the reference's
    float32 omega (rho from bfloat16 fields; measured 0.03 and 0.00).
"""

import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowhs_tpu import batch as ref_batch
from opticalflowhs_tpu import consistency as ref_cons
from opticalflowhs_tpu import pyramid as ref_pyr
from opticalflowhs_tpu import solver as ref_solver
from opticalflowhs_tpu import video as ref_video
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.kernels import solve_robust as ref_srb
from opticalflowhs_tpu.kernels import sor as ref_sor
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
    robust,
)
from opticalflowhs_tpu_torch.data.synthetic import (
    synthetic_sequence,
    translation_pair,
    two_motion_pair,
)
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import solve_robust as k4
from opticalflowhs_tpu_torch.kernels import sor as k3
from opticalflowhs_tpu_torch.kernels import sor_planes as k8
from opticalflowhs_tpu_torch.ops import stencils
from opticalflowhs_tpu_torch.solver import tune_omega

torch.set_num_threads(1)

BF16 = torch.bfloat16
K3_ULP = 2.0 ** -8
K4_ATOL = 1e-2
MEAN_TOL = 0.02
MAX_TOL = 0.1
REF_BAR = 0.1
OMEGA_TOL = 0.01
OMEGA_F32_TOL = 0.03
EDGE = 8
OMEGA = 1.7

SOR = HSConfig(alpha=0.5, iters=30, solver="sor", omega=OMEGA)
ROBUST = HSConfig(alpha=0.3, iters=30, solver="robust", robust_update_every=10)
CFGS = {"sor": SOR, "robust": ROBUST}


def _t(a) -> torch.Tensor:
    """A reference (JAX) array as a float32 CPU tensor, exactly."""
    return torch.from_numpy(np.array(a, np.float32))


def _bf(*a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(BF16) for x in a)


def _interior(d):
    return d[..., EDGE:-EDGE, EDGE:-EDGE]


def _ref(cfg: HSConfig, dtype: str) -> RefHS:
    return RefHS(alpha=cfg.alpha, iters=cfg.iters, tol=cfg.tol, block_sweeps=cfg.block_sweeps,
                 deriv_variant=cfg.deriv_variant, solver=cfg.solver, omega=cfg.omega,
                 robust_update_every=cfg.robust_update_every, backend="jnp", dtype=dtype)


def _means(got, want):
    """Interior mean and max |got - want| over u and v, in px."""
    d = [_interior((g.float() - _t(w)).abs()) for g, w in zip(got, want)]
    return max(float(x.mean()) for x in d), max(float(x.max()) for x in d)


def _dtypes(solver, heavy=False):
    """The reference's dtypes a test solves in: float32, and bfloat16 for
    IRLS, whose bar holds (SOR's distance is recorded by test_hs_solve_bf16),
    except in the `heavy` cases (the reference's pyramids of stacks and its
    warped warm stream), whose bfloat16 compiles cost most of this file's
    time; the single-pair pyramid and the plain stream carry that bar."""
    return ("float32", "bfloat16") if solver == "robust" and not heavy else ("float32",)


def _check_flow(got, want32, want16=None, solver="robust", record=None):
    """got (bfloat16) against the reference's float32 flow within the bars,
    and against its bfloat16 flow, where given: within REF_BAR for IRLS; for
    SOR the distance is recorded and the port must be the closer to
    float32."""
    assert got.u.dtype == got.v.dtype == BF16
    mean32, max32 = _means(got, want32)
    assert mean32 <= MEAN_TOL and max32 <= MAX_TOL, (mean32, max32)
    if want16 is None:
        return
    mean16, _ = _means(got, want16)
    if record is not None:
        record("ref_bf16_mean", mean16)
        record("ref_f32_mean", mean32)
    if solver == "robust":
        assert mean16 < REF_BAR, mean16
    else:
        ref_drift, _ = _means(Flow(_t(want16.u), _t(want16.v)), want32)
        assert mean32 <= ref_drift, (mean32, ref_drift)


@functools.cache
def _pair(h=48, w=64, key=5):
    return translation_pair(h, w, 1.0, 0.5, key=key)[:2]


@functools.cache
def _seq():
    return synthetic_sequence(3, 48, 64, 0.75, 0.25, key=4)[0]


# -- the plain bfloat16 twins -------------------------------------------------------


def _fields16(shape, seed, alpha=0.5):
    rng = np.random.default_rng(seed)
    i1, i2, u0, v0 = _bf(*(rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(4)))
    return (u0, v0), k1.derivatives_plain(i1, i2, alpha)


def test_plain_sor_bf16_is_the_float32_sweep_rounded_once():
    (u, v), f = _fields16((37, 50), 1)
    colors = stencils.color_masks(37, 50)
    for _ in range(3):
        wu, wv = stencils.sor_step(u.float(), v.float(), *(x.float() for x in f), OMEGA,
                                   colors)
        u, v = k3.sor_sweeps_plain(u, v, *f, 1, OMEGA)
        assert u.dtype == BF16
        assert torch.equal(u, wu.to(BF16)) and torch.equal(v, wv.to(BF16))
    (u0, v0), f = _fields16((2, 37, 50), 2)
    want = (u0, v0)
    for _ in range(5):
        want = stencils.store(stencils.sor_step, *want, *f, OMEGA, colors)
    got = k3.sor_sweeps_plain(u0, v0, *f, 5, OMEGA)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_irls_bf16_rounds_the_weights_and_each_sweep():
    (u, v), f = _fields16((33, 47), 3)
    ex, ey, et = f[:3]
    wd, ws = robust.charbonnier_weights(u, v, ex, ey, et, 0.05, 0.01)
    w32 = robust.charbonnier_weights(u.float(), v.float(), ex.float(), ey.float(),
                                     et.float(), 0.05, 0.01)
    assert wd.dtype == ws.dtype == BF16
    assert torch.equal(wd, w32[0].to(BF16)) and torch.equal(ws, w32[1].to(BF16))
    got = robust.robust_step(u, v, ex, ey, et, wd, ws, 0.3)
    want = robust.robust_step(*(x.float() for x in (u, v, ex, ey, et, wd, ws)), 0.3)
    assert got[0].dtype == BF16
    assert torch.equal(got[0], want[0].to(BF16)) and torch.equal(got[1], want[1].to(BF16))
    cfg = HSConfig(alpha=0.3, solver="robust", robust_update_every=4)
    uv = (u, v)
    for m in robust.refreeze_blocks(11, 4):
        w = robust.charbonnier_weights(*uv, ex, ey, et, cfg.robust_eps_d, cfg.robust_eps_s)
        for _ in range(m):
            uv = robust.robust_step(*uv, ex, ey, et, *w, cfg.alpha)
    got = robust.robust_sweeps(u, v, ex, ey, et, 11, cfg)
    assert torch.equal(got[0], uv[0]) and torch.equal(got[1], uv[1])


@pytest.mark.parametrize("shape", [(36, 50), (37, 51), (36, 51), (37, 50), (3, 40), (41, 2)])
@pytest.mark.parametrize("warm", [False, True])
def test_plain_planes_and_k8_schedule_bf16_equal_plain_sor(shape, warm):
    (u0, v0), f = _fields16(shape, 4)
    start = (u0, v0) if warm else (None, None)
    uv = (u0, v0) if warm else (torch.zeros_like(u0), torch.zeros_like(u0))
    for n in (1, 4, 7):
        want = k3.sor_sweeps_plain(*uv, *f, n, OMEGA)
        for got in (k8.sor_planes_plain(*start, *f, n, OMEGA),
                    k8.k8_schedule_plain(*start, *f, n, OMEGA, s=2 if n > 3 else 0)):
            assert got[0].dtype == BF16
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("s", range(1, k3.K3_MAX_SWEEPS + 1))
def test_k3_schedule_bf16_equals_plain_at_every_s(s):
    # 136 columns: a multiple of 8, so even s stage 16-byte groups (copy_group).
    for shape, n in (((40, 136), s + 1), ((2, 21, 50), s)):
        (u0, v0), f = _fields16(shape, 5)
        for uv in ((u0, v0), (torch.zeros_like(u0),) * 2):
            got = k3.k3_sweeps_schedule_plain(*uv, *f, n, s, OMEGA)
            want = k3.sor_sweeps_plain(*uv, *f, n, OMEGA)
            assert got[0].dtype == BF16
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (shape, s)


def test_k3_schedule_shows_the_bf16_traps():
    (u0, v0), f = _fields16((40, 136), 6)
    want = k3.sor_sweeps_plain(u0, v0, *f, 3, OMEGA)
    # Rows exchanged in bfloat16 inside a sweep: the odd rows' half reads the
    # even rows rounded, where the plain sweep's later stages read float32.
    half = k3.k3_launch_schedule_plain(u0, v0, *f, 3, OMEGA, round_at="half")
    assert not torch.equal(half[0], want[0])
    # 16-byte copies where the window's first column is not a multiple of 8
    # (odd s: c0 = tile x (128 - 8s) - 4s): the groups at the right edge
    # straddle it, and what they drop reaches the owned tile.
    wide = k3.k3_launch_schedule_plain(u0, v0, *f, 3, OMEGA, group=8)
    assert bool(torch.isnan(wide[0].float()).any())
    rule = k3.k3_launch_schedule_plain(u0, v0, *f, 3, OMEGA)
    assert torch.equal(rule[0], want[0]) and torch.equal(rule[1], want[1])


@pytest.mark.parametrize("s", range(1, k4.K4_MAX_SWEEPS + 1))
def test_k4_schedule_bf16_equals_plain_at_every_s(s):
    for shape in ((40, 136), (2, 19, 50)):
        (u0, v0), f = _fields16(shape, 7)
        ex, ey, et = f[:3]
        for uv in ((u0, v0), (torch.zeros_like(u0),) * 2):
            wd, ws = robust.charbonnier_weights(*uv, ex, ey, et, 0.05, 0.01)
            n = s + 1
            want = uv
            for _ in range(n):
                want = robust.robust_step(*want, ex, ey, et, wd, ws, 0.3)
            got = k4.k4_sweeps_schedule_plain(*uv, ex, ey, et, wd, ws, n, s, 0.3)
            assert got[0].dtype == BF16
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (shape, s)
    if s == 3:  # 16-byte groups where the window's first column is 4 mod 8
        (u0, v0), f = _fields16((40, 136), 8)
        wd, ws = robust.charbonnier_weights(u0, v0, *f[:3], 0.05, 0.01)
        wide = k4.k4_launch_schedule_plain(u0, v0, *f[:3], wd, ws, 3, 0.3, group=8)
        assert bool(torch.isnan(wide[0].float()).any())


# -- the first sweeps against the reference's kernels -----------------------------


def test_k3_plain_bf16_sweeps_match_the_reference_kernel(record_property):
    rng = np.random.default_rng(9)
    i1, i2 = (rng.uniform(0, 1, (40, 136)).astype(np.float32) for _ in range(2))
    fields = ref_solver.precompute(jnp.asarray(i1), jnp.asarray(i2),
                                   RefHS(alpha=0.7, dtype="bfloat16"))
    z = jnp.zeros_like(fields[0])
    r16 = ref_sor.sor_sweeps(z, z, *fields, 5, OMEGA, interpret=True)
    wide = [f.astype(jnp.float32) for f in fields]
    z = jnp.zeros_like(wide[0])
    r32 = ref_sor.sor_sweeps(z, z, *wide, 5, OMEGA, interpret=True)
    mine = [_t(f).to(BF16) for f in fields]  # the same bfloat16 values
    zero = torch.zeros(40, 136, dtype=BF16)
    got = k3.sor_sweeps(zero, zero, *mine, 5, OMEGA)
    assert got[0].dtype == got[1].dtype == BF16

    def dist(a, b):
        return max(float((x.float() - _t(y)).abs().max()) for x, y in zip(a, b))

    d32, d16, drift = dist(got, r32), dist(got, r16), dist([_t(a) for a in r16], r32)
    record_property("max_abs_diff", d32)
    record_property("ref_bf16_diff", d16)
    assert max(float(_t(a).abs().max()) for a in r32) < 1.0
    assert d32 <= K3_ULP, d32
    assert d16 <= drift + K3_ULP, (d16, drift)


def test_k4_plain_bf16_solve_matches_the_reference_kernel(record_property):
    i1, i2, _ = two_motion_pair(32, 64, (1.0, 0.0), (-1.0, 0.0), key=3)
    cfg = HSConfig(alpha=0.3, iters=6, solver="robust", robust_update_every=3)
    want = ref_srb.hs_solve_robust_resident(jnp.asarray(i1, jnp.bfloat16),
                                            jnp.asarray(i2, jnp.bfloat16),
                                            _ref(cfg, "bfloat16"), interpret=True)
    assert want is not None
    got = k4.hs_solve_robust_resident(*_bf(i1, i2), cfg)
    assert got[0].dtype == BF16
    d = max(float((g.float() - _t(w)).abs().max()) for g, w in zip(got, want))
    record_property("max_abs_diff", d)
    assert d <= K4_ATOL, d


# -- every entry point against the reference's solves ------------------------------


@functools.cache
def _ref_solve(cfg: HSConfig, dtype: str, key=5, warm=False):
    i1, i2 = _pair(key=key)
    init = None
    if warm:
        u0, v0 = _warm(i1.shape)
        init = ref_solver.Flow(jnp.asarray(u0), jnp.asarray(v0))
    return ref_solver.hs_solve(jnp.asarray(i1), jnp.asarray(i2), _ref(cfg, dtype), init=init)


@functools.cache
def _warm(shape):
    rng = np.random.default_rng(2)
    return tuple(rng.normal(0, 0.3, shape).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("solver", ["sor", "robust"])
@pytest.mark.parametrize("case", ["zero", "central", "warm", "tol"])
def test_hs_solve_bf16(solver, case, record_property):
    cfg = CFGS[solver]
    if case == "central":
        cfg = dataclasses.replace(cfg, deriv_variant="central")
    if case == "tol":  # SOR to tolerance through resident blocks; IRLS refreezes a block
        cfg = dataclasses.replace(cfg, iters=32, tol=1e-3, block_sweeps=8)
    i1, i2 = _pair()
    kw = {}
    if case == "warm":
        kw = dict(init=Flow(*_warm(i1.shape)))
    got = hs_solve(i1, i2, dataclasses.replace(cfg, dtype="bfloat16"), device="cpu", **kw)
    want = [_ref_solve(cfg, dt, warm=case == "warm") for dt in ("float32", "bfloat16")]
    _check_flow(got, *want, solver=solver, record=record_property)


@pytest.mark.parametrize("solver", ["sor", "robust"])
@pytest.mark.parametrize("levels", [1, 2])
def test_hs_solve_batched_bf16(solver, levels):
    frames = _seq()
    cfg = CFGS[solver]
    pyr = PyramidConfig(levels=levels) if levels > 1 else None
    rpyr = RefPyr(levels=levels) if levels > 1 else None
    got = hs_solve_batched(frames[:-1], frames[1:], dataclasses.replace(cfg, dtype="bfloat16"),
                           pyr, device="cpu")
    want = [ref_batch.hs_solve_batched(jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]),
                                       _ref(cfg, dt), rpyr)
            for dt in _dtypes(solver, heavy=levels > 1)]
    _check_flow(got, *want, solver=solver)


@pytest.mark.parametrize("solver", ["sor", "robust"])
def test_hs_pyramid_bf16(solver):
    i1, i2, _ = translation_pair(48, 64, 2.5, -1.0, key=5, max_freq=0.08)
    cfg = dataclasses.replace(CFGS[solver], alpha=1.0 if solver == "sor" else 0.3)
    got = hs_pyramid(i1, i2, dataclasses.replace(cfg, dtype="bfloat16"),
                     PyramidConfig(levels=2), device="cpu")
    want = [ref_pyr.hs_pyramid(jnp.asarray(i1), jnp.asarray(i2), _ref(cfg, dt),
                               RefPyr(levels=2)) for dt in _dtypes(solver)]
    _check_flow(got, *want, solver=solver)


@pytest.mark.parametrize("solver", ["sor", "robust"])
@pytest.mark.parametrize("kind", ["stream", "warm_prior"])
def test_streams_bf16(solver, kind):
    frames = _seq()
    cfg = CFGS[solver]
    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    if kind == "stream":
        got = list(flow_stream(frames, c16, chunk=2, device="cpu"))
        want = [list(ref_video.flow_stream(frames, _ref(cfg, dt), chunk=2))
                for dt in _dtypes(solver)]
    else:
        prior = kind == "warm_prior"
        got = list(flow_stream_warm(frames, c16, chunk=2, warp_prior=prior, device="cpu"))
        want = [list(ref_video.flow_stream_warm(frames, _ref(cfg, dt), chunk=2,
                                                warp_prior=prior))
                for dt in _dtypes(solver, heavy=True)]
    assert all(len(got) == len(w) for w in want)
    for g, *w in zip(got, *want):
        _check_flow(g, *w, solver=solver)


@pytest.mark.parametrize("solver", ["sor", "robust"])
def test_bidirectional_and_occlusion_bf16(solver):
    from opticalflowhs_tpu_torch.consistency import solve_bidirectional
    from opticalflowhs_tpu_torch.video import flow_stream_occlusion

    frames = _seq()
    cfg = CFGS[solver]
    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    got = solve_bidirectional(frames[0], frames[1], c16, device="cpu")
    want = [ref_cons.solve_bidirectional(jnp.asarray(frames[0]), jnp.asarray(frames[1]),
                                         _ref(cfg, dt)) for dt in _dtypes(solver)]
    for k in range(2):
        _check_flow(got[k], *(w[k] for w in want), solver=solver)
    (flow, mask), = flow_stream_occlusion(frames, c16, chunk=2, a=0.0, b=1e-4, device="cpu")
    assert mask.dtype == torch.bool and flow.u.dtype == BF16
    want = [ref_batch.hs_solve_batched(jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]),
                                       _ref(cfg, dt)) for dt in _dtypes(solver)]
    _check_flow(flow, *want, solver=solver)


@pytest.mark.parametrize("solver", ["sor", "robust"])
def test_checkpointed_bf16(solver, tmp_path):
    i1, i2 = _pair()
    cfg = dataclasses.replace(CFGS[solver], checkpoint_every=12, dtype="bfloat16")
    if solver == "robust":  # segments end on refreeze blocks, as in the reference
        cfg = dataclasses.replace(cfg, checkpoint_every=20)
    got = hs_solve_checkpointed(i1, i2, cfg, str(tmp_path / "ck.npz"), device="cpu")
    with np.load(str(tmp_path / "ck.npz")) as z:
        assert z["u"].dtype == np.float32 and bytes(z["dtype"]).decode() == "bfloat16"
        assert np.array_equal(z["u"], got.u.float().numpy())
    want = [_ref_solve(CFGS[solver], dt) for dt in ("float32", "bfloat16")]
    _check_flow(got, *want, solver=solver)
    if solver == "robust":  # 20 ends on a refreeze block: the uninterrupted solve
        whole = hs_solve(i1, i2, dataclasses.replace(cfg, checkpoint_every=0), device="cpu")
        assert torch.equal(got.u, whole.u) and torch.equal(got.v, whole.v)


@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_tune_omega_bf16_matches_the_references_bf16_omega(alpha, record_property):
    i1, i2, _ = translation_pair(64, 96, 1.0, 0.0, key=5)
    got = tune_omega(i1, i2, HSConfig(alpha=alpha, dtype="bfloat16"), device="cpu")
    want16, want32 = (ref_solver.tune_omega(jnp.asarray(i1), jnp.asarray(i2),
                                            RefHS(alpha=alpha, dtype=dt))
                      for dt in ("bfloat16", "float32"))
    record_property("omega_diff", abs(got - want16))
    assert abs(got - want16) <= abs(want16 - want32) + OMEGA_TOL + 1e-9, (got, want16, want32)
    assert abs(got - want32) <= OMEGA_F32_TOL + 1e-9, (got, want32)


def test_omega_zero_bf16_solves_with_the_tuned_omega():
    i1, i2 = _pair()
    cfg = dataclasses.replace(SOR, omega=0.0)
    got = hs_solve(i1, i2, dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
    omega = tune_omega(i1, i2, dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
    same = hs_solve(i1, i2, dataclasses.replace(cfg, omega=omega, dtype="bfloat16"),
                    device="cpu")
    assert torch.equal(got.u, same.u) and torch.equal(got.v, same.v)
    _check_flow(got, ref_solver.hs_solve(jnp.asarray(i1), jnp.asarray(i2),
                                         _ref(cfg, "float32")))


@pytest.mark.parametrize("solver", ["sor", "robust"])
def test_cli_run_bf16_config(solver, tmp_path):
    from opticalflowhs_tpu_torch import cli
    from opticalflowhs_tpu_torch.io.flo import read_flo
    from opticalflowhs_tpu_torch.io.images import load_gray, save_image

    i1, i2 = _pair()
    f1, f2 = str(tmp_path / "f1.pgm"), str(tmp_path / "f2.pgm")
    save_image(f1, i1)
    save_image(f2, i2)
    cfg = CFGS[solver]
    fields = {k: getattr(cfg, k) for k in ("alpha", "iters", "solver", "omega",
                                            "robust_update_every")}
    cfg_file = tmp_path / "c.json"
    cfg_file.write_text(json.dumps({"hs": dict(fields, dtype="bfloat16"),
                                    "pyramid": {"levels": 1}}))
    out = str(tmp_path / "o.flo")
    assert cli.main(["--device", "cpu", "--config", str(cfg_file), "run", f1, f2,
                     "-o", out]) == 0
    j1, j2 = load_gray(f1), load_gray(f2)
    want = hs_solve(j1, j2, dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
    assert np.array_equal(read_flo(out), np.stack([want.u.float().numpy(),
                                                   want.v.float().numpy()], axis=-1))
    ref = [ref_solver.hs_solve(jnp.asarray(j1), jnp.asarray(j2), _ref(cfg, dt))
           for dt in _dtypes(solver)]
    _check_flow(want, *ref, solver=solver)


@pytest.mark.parametrize("shape", [(1088, 1920), (1440, 2560), (2160, 3840), (48, 64)])
def test_k8_plane_class_counts_bf16_bytes_as_the_reference(shape):
    from opticalflowhs_tpu.kernels import sor_planes as ref_sp

    for itemsize, dt in ((4, jnp.float32), (2, jnp.bfloat16)):
        assert k8.applicable_shape(*shape, itemsize) == ref_sp.applicable_shape(*shape, dt)
    if shape == (48, 64):  # on CPU tensors: the plain planes, in bfloat16
        i1, i2 = _bf(*_pair())
        got = k8.hs_solve_sor_planes(i1, i2, 0.5, 7, OMEGA)
        want = k3.sor_sweeps_plain(torch.zeros_like(i1), torch.zeros_like(i1),
                                   *k1.derivatives_plain(i1, i2, 0.5), 7, OMEGA)
        assert got[0].dtype == BF16
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
