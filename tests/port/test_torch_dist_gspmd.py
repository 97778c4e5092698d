"""The reference's GSPMD routes in the port (dist/gspmd.py) on the CPU:
tiled robust and multigrid (`hs_solve_tiled`, `hs_pyramid_tiled`),
`mesh=` on the batched entries, the streams and consistency, and the
tiled TV-L1 and Lucas-Kanade entries, each on meshes of CPU devices in one
process (["cpu"] * 8), against the port's untiled entry and the
reference's route on its 8 fake CPU devices (tests/conftest.py). Inputs
come from seeded numpy generators.

Bars, each with its reason:
  * against the port's untiled entry: bitwise. Each batch group runs that
    entry on its own pairs (the same ops on the same values), and a pair
    or a spatial mesh's frame is solved whole on the mesh's first device.
  * against the reference's route, the bar the port's untiled test of
    the family uses: robust 2e-6 (its IRLS solve bar at these few sweeps;
    test_torch_robust.py holds longer solves to 1e-5), multigrid 1e-5
    (test_torch_multigrid.py), the Jacobi pyramids 1e-5
    (test_torch_batch.py), TV-L1 1e-5 for the one-warp solve
    (test_torch_tvl1.py), LK 2e-6 at one level (test_torch_lk.py). The
    reference's tiled TV-L1 and LK compile for 12-30 s each here, so each
    is called once, at one level; their multi-level tiled routes are held
    to the port's untiled ones bitwise, which test_torch_tvl1.py (every
    pixel's endpoint within 2e-2) and test_torch_lk.py (1e-5) hold to the
    reference.
  * bfloat16 routes against the reference's float32 route: interior (8 px
    in) mean <= 0.02 px and max <= 0.1 px, ROADMAP.md queue 3's bars for
    the bfloat16 storage rule.
  * gradients of the tiled robust and multigrid solves against jax.grad of
    the reference's tiled route: 1e-5 relative to the gradient's largest
    entry (test_torch_autodiff.py's bar), and the port's tiled gradient =
    its untiled gradient bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.config as ref_config
import opticalflowhs_tpu.consistency as ref_cons
import opticalflowhs_tpu.dist as ref_dist
import opticalflowhs_tpu.lucas_kanade as ref_lk
import opticalflowhs_tpu.tvl1 as ref_tv
import opticalflowhs_tpu.video as ref_video
from opticalflowhs_tpu.batch import hs_solve_batched as ref_batched
import opticalflowhs_tpu_torch.video as video
from opticalflowhs_tpu_torch import (
    HSConfig,
    LKConfig,
    MeshConfig,
    PyramidConfig,
    TVL1Config,
    flow_with_occlusion,
    hs_pyramid,
    hs_solve,
    hs_solve_batched,
    lk_solve,
    lk_solve_batched,
    tvl1_solve,
    tvl1_solve_batched,
)
from opticalflowhs_tpu_torch.consistency import solve_bidirectional
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence, translation_pair
from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled, hs_solve_tiled, make_mesh
from opticalflowhs_tpu_torch.lucas_kanade import lk_solve_tiled
from opticalflowhs_tpu_torch.tvl1 import tvl1_solve_tiled

torch.set_num_threads(1)

BF16 = torch.bfloat16
ROBUST_TOL = 2e-6
MG_TOL = 1e-5
PYRAMID_TOL = 1e-5
TVL1_TOL = 1e-5
LK_TOL = 2e-6
MEAN_TOL = 0.02
MAX_TOL = 0.1
EDGE = 8
GRAD_RTOL = 1e-5

ROBUST = dict(solver="robust", alpha=0.3, iters=6, robust_update_every=3)
ROBUST_TOL_CFG = dict(solver="robust", alpha=0.3, iters=16, robust_update_every=4,
                      tol=1e-3, block_sweeps=4)
MG = dict(solver="multigrid", alpha=1.0, iters=2)
MG_TOL_CFG = dict(solver="multigrid", alpha=1.0, iters=5, tol=2e-3)
CFGS = {"robust": ROBUST, "robust-tol": ROBUST_TOL_CFG, "multigrid": MG, "multigrid-tol": MG_TOL_CFG}


def _mesh(b=1, y=2, x=2):
    return make_mesh(MeshConfig(batch=b, y=y, x=x), ["cpu"] * (b * y * x))


def _ref_mesh(b=1, y=2, x=2):
    return ref_dist.make_mesh(ref_config.MeshConfig(batch=b, y=y, x=x))


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.roll(a, (1, 1), axis=(-2, -1)) + rng.normal(0, 0.01, shape).astype(np.float32)
    return a, b.astype(np.float32)


def _equal(got, want):
    assert got.u.dtype == want.u.dtype
    assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)


def _diff(got, want):
    return max(float(np.abs(np.asarray(got[k].float(), np.float64)
                            - np.asarray(want[k], np.float64)).max()) for k in (0, 1))


def _bf16_close(got, want):
    d = [np.abs(np.asarray(got[k].float(), np.float64) - np.asarray(want[k], np.float64))
         [..., EDGE:-EDGE, EDGE:-EDGE] for k in (0, 1)]
    mean, top = max(float(x.mean()) for x in d), max(float(x.max()) for x in d)
    assert mean <= MEAN_TOL and top <= MAX_TOL, (mean, top)


# -- tiled robust and multigrid ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stack", [False, True])
@pytest.mark.parametrize("name", list(CFGS))
def test_tiled_gspmd_solver_equals_untiled(name, stack, dtype):
    # A pair on a 2 x 2 mesh is solved whole on the first device; a stack of
    # 4 splits into two groups of 2 on a (2, 2, 2) mesh. Odd shapes.
    cfg = HSConfig(dtype=dtype, **CFGS[name])
    if stack:
        a, b = (torch.from_numpy(x) for x in _frames((4, 37, 45), 1))
        got = hs_solve_tiled(a, b, cfg, _mesh(2), halo_sweeps=3)
        want = hs_solve_batched(a, b, cfg)
    else:
        a, b = (torch.from_numpy(x) for x in _frames((67, 93), 2))
        got = hs_solve_tiled(a, b, cfg, _mesh(), halo_sweeps=3)
        want = hs_solve(a, b, cfg)
    _equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stack", [False, True])
@pytest.mark.parametrize("solver", ["robust", "multigrid"])
def test_pyramid_tiled_gspmd_equals_untiled(solver, stack, dtype):
    # Robust and multigrid levels through the batch groups; the cold ops on
    # the first device (a stack warps with the gather, as the tiled Jacobi
    # pyramid's stacks).
    cfg = HSConfig(dtype=dtype, **CFGS[solver])
    pyr = PyramidConfig(levels=2, warp="gather" if stack else "auto")
    if stack:
        a, b = (torch.from_numpy(x) for x in _frames((2, 48, 64), 3))
        got = hs_pyramid_tiled(a, b, cfg, pyr, _mesh(2))
        want = hs_solve_batched(a, b, cfg, pyr)
    else:
        a, b = (torch.from_numpy(x) for x in _frames((48, 64), 4))
        got = hs_pyramid_tiled(a, b, cfg, pyr, _mesh())
        want = hs_pyramid(a, b, cfg, pyr)
    _equal(got, want)


@pytest.mark.parametrize("solver", ["robust", "multigrid"])
def test_tiled_gspmd_solver_matches_reference(solver, record_property):
    # One reference call a family: a stack of 2 (odd shape) on a (2, 2, 2)
    # mesh, robust to tol, multigrid a fixed count; the port's float32 route
    # within the family's bar, its bfloat16 route by the queue-3 bars.
    kw = ROBUST_TOL_CFG if solver == "robust" else MG
    a, b = _frames((2, 35, 47), 5)
    want = ref_dist.hs_solve_tiled(jnp.asarray(a), jnp.asarray(b),
                                   ref_config.HSConfig(**kw, backend="jnp"), mesh=_ref_mesh(2))
    mesh = _mesh(2)
    got = hs_solve_tiled(a, b, HSConfig(**kw), mesh)
    d = _diff(got, want)
    record_property("max_abs_diff", d)
    assert d <= (ROBUST_TOL if solver == "robust" else MG_TOL)
    _bf16_close(hs_solve_tiled(a, b, HSConfig(dtype="bfloat16", **kw), mesh), want)


def test_pyramid_tiled_robust_matches_reference(record_property):
    a, b = _frames((48, 64), 6)
    pyr = dict(levels=2)
    want = ref_dist.hs_pyramid_tiled(jnp.asarray(a), jnp.asarray(b),
                                     ref_config.HSConfig(**ROBUST, backend="jnp"),
                                     ref_config.PyramidConfig(**pyr), mesh=_ref_mesh())
    got = hs_pyramid_tiled(a, b, HSConfig(**ROBUST), PyramidConfig(**pyr), _mesh())
    d = _diff(got, want)
    record_property("max_abs_diff", d)
    assert d <= PYRAMID_TOL


@pytest.mark.parametrize("solver", ["robust", "multigrid"])
def test_tiled_gspmd_gradient_matches_reference(solver, record_property):
    # d(mean u^2 + mean v^2)/d frame 2 through the tiled route: = the port's
    # untiled gradient bitwise, and jax.grad of the reference's tiled route.
    kw = dict(ROBUST, iters=4, robust_update_every=2) if solver == "robust" else dict(MG, iters=1)
    a, b = _frames((16, 24), 7)
    rmesh = _ref_mesh()

    def ref_loss(i2):
        f = ref_dist.hs_solve_tiled(jnp.asarray(a), i2, ref_config.HSConfig(**kw, backend="jnp"),
                                    mesh=rmesh)
        return jnp.mean(f.u ** 2) + jnp.mean(f.v ** 2)

    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(b)))

    def grad(fn):
        i2 = torch.from_numpy(b).requires_grad_()
        f = fn(torch.from_numpy(a), i2)
        (f.u.pow(2).mean() + f.v.pow(2).mean()).backward()
        return i2.grad

    got = grad(lambda x, y: hs_solve_tiled(x, y, HSConfig(**kw), _mesh()))
    assert torch.equal(got, grad(lambda x, y: hs_solve(x, y, HSConfig(**kw))))
    d = float(np.abs(got.numpy() - want).max())
    record_property("max_abs_diff", d)
    assert d <= GRAD_RTOL * float(np.abs(want).max())


# -- mesh= on the batched entries ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(iters=12), dict(iters=40, tol=1e-3, block_sweeps=4),
                                dict(solver="sor", omega=1.6, iters=8), ROBUST, MG])
def test_batched_mesh_equals_untiled(kw, dtype):
    a, b = (torch.from_numpy(x) for x in _frames((4, 32, 40), 8))
    cfg = HSConfig(dtype=dtype, **kw)
    got = hs_solve_batched(a, b, cfg, mesh=_mesh(2, 1, 1))
    want = hs_solve_batched(a, b, cfg)
    _equal(got, want)
    # numpy stacks go to the mesh's first device
    _equal(hs_solve_batched(a.numpy(), b.numpy(), cfg, mesh=_mesh(4, 1, 1)), want)


@pytest.mark.parametrize("warp", ["auto", "tiled", "gather", "checked"])
def test_batched_mesh_pyramid_takes_the_single_pair_warp(warp):
    # A mesh-sharded stack takes the reference's stacked_ok=False route: each
    # image warped by pyramid.warp's rule with pyr.warp and warp_radius, so a
    # Jacobi pyramid equals a loop of single-pair hs_pyramid calls.
    pairs = [translation_pair(40, 56, 1.5, -1.0, key=k) for k in range(4)]
    a = torch.from_numpy(np.stack([p[0] for p in pairs]))
    b = torch.from_numpy(np.stack([p[1] for p in pairs]))
    cfg = HSConfig(alpha=1.0, iters=10)
    pyr = PyramidConfig(levels=2, warp=warp, warp_radius=2 if warp == "tiled" else 0)
    got = hs_solve_batched(a, b, cfg, pyr, mesh=_mesh(2, 1, 1))
    for k in range(4):
        one = hs_pyramid(a[k], b[k], cfg, pyr)
        assert torch.equal(got.u[k], one.u) and torch.equal(got.v[k], one.v)


def test_batched_mesh_pyramid_matches_reference(record_property):
    pairs = [translation_pair(40, 56, 1.5, -1.0, key=k) for k in range(2)]
    a, b = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    kw, pyr = dict(alpha=1.0, iters=10), dict(levels=2, warp="auto")
    want = ref_batched(jnp.asarray(a), jnp.asarray(b), ref_config.HSConfig(**kw),
                       ref_config.PyramidConfig(**pyr), mesh=_ref_mesh(2, 1, 1))
    got = hs_solve_batched(a, b, HSConfig(**kw), PyramidConfig(**pyr), mesh=_mesh(2, 1, 1))
    d = _diff(got, want)
    record_property("max_abs_diff", d)
    assert d <= PYRAMID_TOL


def test_batched_mesh_refuses_an_indivisible_stack():
    a = np.zeros((3, 16, 16), np.float32)
    want = "batch 3 not divisible by mesh batch 2"
    for call in (lambda: hs_solve_batched(a, a, HSConfig(iters=2), mesh=_mesh(2, 1, 1)),
                 lambda: hs_solve_tiled(a, a, HSConfig(**ROBUST), _mesh(2)),
                 lambda: lk_solve_batched(a, a, mesh=_mesh(2, 1, 1)),
                 lambda: tvl1_solve_batched(a, a, mesh=_mesh(2, 1, 1))):
        with pytest.raises(ValueError) as e:
            call()
        assert str(e.value) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels", [1, 2])
def test_lk_mesh_and_tiled_equal_untiled(levels, dtype):
    cfg, pyr = LKConfig(dtype=dtype), PyramidConfig(levels=levels, iters_per_level=())
    a, b = (torch.from_numpy(x) for x in _frames((4, 32, 40), 9))
    _equal(lk_solve_batched(a, b, cfg, pyr, mesh=_mesh(2, 1, 1)), lk_solve_batched(a, b, cfg, pyr))
    _equal(lk_solve_tiled(a[0], b[0], cfg, pyr, mesh=_mesh()), lk_solve(a[0], b[0], cfg, pyr))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels", [1, 2])
def test_tvl1_mesh_and_tiled_equal_untiled(levels, dtype):
    cfg = TVL1Config(warps=2, iters=10, dtype=dtype)
    pyr = PyramidConfig(levels=levels, iters_per_level=())
    a, b = (torch.from_numpy(x) for x in _frames((2, 32, 40), 10))
    _equal(tvl1_solve_batched(a, b, cfg, pyr, mesh=_mesh(2, 1, 1)),
           tvl1_solve_batched(a, b, cfg, pyr))
    _equal(tvl1_solve_tiled(a[0], b[0], cfg, pyr, mesh=_mesh()), tvl1_solve(a[0], b[0], cfg, pyr))


def test_lk_tiled_matches_reference(record_property):
    # One reference call (its tiled compile costs about 12 s here): one
    # level; the tiled pyramids are the untiled ones bitwise (above), held
    # to the reference's in test_torch_lk.py.
    i1, i2, _ = translation_pair(24, 32, 0.7, -0.4, key=3)
    pyr = dict(levels=1, iters_per_level=())
    want = ref_lk.lk_solve_tiled(jnp.asarray(i1), jnp.asarray(i2), ref_config.LKConfig(),
                                 ref_config.PyramidConfig(**pyr), mesh=_ref_mesh())
    got = lk_solve_tiled(i1, i2, LKConfig(), PyramidConfig(**pyr), mesh=_mesh())
    d = _diff(got, want)
    record_property("max_abs_diff", d)
    assert d <= LK_TOL
    _bf16_close(lk_solve_tiled(i1, i2, LKConfig(dtype="bfloat16"), PyramidConfig(**pyr),
                               mesh=_mesh()), want)


def test_tvl1_tiled_matches_reference(record_property):
    # One reference call (its tiled compile costs about 16 s here, 31 s at
    # two levels): one warp at one level, the one-warp solve's bar; the
    # multi-level tiled solves are the untiled ones bitwise (above), held
    # to the reference's by endpoint in test_torch_tvl1.py.
    i1, i2, _ = translation_pair(24, 32, 0.7, -0.4, key=4)
    kw, pyr = dict(warps=1, iters=10), dict(levels=1, iters_per_level=())
    want = ref_tv.tvl1_solve_tiled(jnp.asarray(i1), jnp.asarray(i2),
                                   ref_config.TVL1Config(**kw, backend="jnp"),
                                   ref_config.PyramidConfig(**pyr), mesh=_ref_mesh())
    got = tvl1_solve_tiled(i1, i2, TVL1Config(**kw), PyramidConfig(**pyr), mesh=_mesh())
    d = _diff(got, want)
    record_property("max_abs_diff", d)
    assert d <= TVL1_TOL
    _bf16_close(tvl1_solve_tiled(i1, i2, TVL1Config(dtype="bfloat16", **kw),
                                 PyramidConfig(**pyr), mesh=_mesh()), want)


# -- streams -----------------------------------------------------------------------------


def _video():
    return synthetic_sequence(8, 24, 32, tx=0.6, ty=-0.3, key=11)[0]


@pytest.mark.parametrize("family", ["hs", "lk", "tvl1"])
def test_streams_with_mesh_equal_unsharded(family):
    # 8 frames in windows of 3 pairs: 3, 3 and the remainder 1, which a
    # batch of 3 does not divide and runs unsharded, as the reference's.
    fam = {"hs": {}, "lk": dict(lk=LKConfig()),
           "tvl1": dict(tvl1=TVL1Config(warps=1, iters=8))}[family]
    cfg = HSConfig(iters=10)
    frames = _video()
    mesh = _mesh(3, 1, 1)
    got = list(video.flow_stream(frames, cfg, chunk=3, mesh=mesh, **fam))
    want = list(video.flow_stream(frames, cfg, chunk=3, device="cpu", **fam))
    assert [g.u.shape[0] for g in got] == [3, 3, 1]
    for g, w in zip(got, want):
        _equal(g, w)
    occ = list(video.flow_stream_occlusion(frames, cfg, chunk=3, mesh=_mesh(2, 1, 1), **fam))
    ref = list(video.flow_stream_occlusion(frames, cfg, chunk=3, device="cpu", **fam))
    for (g, gm), (w, wm) in zip(occ, ref):
        _equal(g, w)
        assert torch.equal(gm, wm)
    whole = video.flow_video(frames, cfg, chunk=3, mesh=mesh, **fam)
    assert np.array_equal(whole.u, torch.cat([w.u for w in want]).numpy())


def test_flow_stream_with_mesh_matches_reference(record_property):
    frames = _video()
    kw = dict(alpha=1.0, iters=10)
    want = list(ref_video.flow_stream(frames, ref_config.HSConfig(**kw), chunk=3,
                                      mesh=_ref_mesh(3, 1, 1)))
    got = list(video.flow_stream(frames, HSConfig(**kw), chunk=3, mesh=_mesh(3, 1, 1)))
    d = max(_diff(g, w) for g, w in zip(got, want))
    record_property("max_abs_diff", d)
    assert len(got) == len(want) == 3 and d <= 2e-6


# -- consistency --------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["hs", "hs-sor", "lk", "tvl1"])
@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 2)])
def test_bidirectional_with_mesh_equals_untiled(shape, family):
    # A spatial mesh: HS through one batch-2 hs_pyramid_tiled, LK and TV-L1
    # through their tiled entries once a direction; a batch-only mesh: the
    # batched entries with mesh=.
    i1, i2, _ = translation_pair(32, 48, 0.8, 0.3, key=6)
    fam = {"hs": {}, "hs-sor": dict(cfg=HSConfig(solver="sor", omega=0.0, iters=6)),
           "lk": dict(lk=LKConfig()), "tvl1": dict(tvl1=TVL1Config(warps=1, iters=8))}[family]
    cfg = fam.pop("cfg", HSConfig(iters=12))
    got = flow_with_occlusion(i1, i2, cfg, mesh=_mesh(*shape), halo_sweeps=3, **fam)
    want = flow_with_occlusion(i1, i2, cfg, device="cpu", **fam)
    _equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    fb, bw = solve_bidirectional(i1, i2, cfg, mesh=_mesh(*shape), **fam)
    _equal(bw, solve_bidirectional(i1, i2, cfg, device="cpu", **fam)[1])


def test_spatial_occlusion_with_halo_sweeps_matches_reference(record_property):
    # The repaired signature: halo_sweeps reaches the batch-2 tiled pyramid.
    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=7)
    kw, pyr = dict(alpha=1.0, iters=12), dict(levels=2)
    want_f, want_m = ref_cons.flow_with_occlusion(
        jnp.asarray(i1), jnp.asarray(i2), ref_config.HSConfig(**kw, backend="jnp"),
        ref_config.PyramidConfig(**pyr), mesh=_ref_mesh(), halo_sweeps=4)
    got_f, got_m = flow_with_occlusion(i1, i2, HSConfig(**kw), PyramidConfig(**pyr),
                                       mesh=_mesh(), halo_sweeps=4)
    d = _diff(got_f, want_f)
    record_property("max_abs_diff", d)
    assert d <= PYRAMID_TOL
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))


# -- the reference's ValueErrors --------------------------------------------------------------


def _errors(tv_mod, lk_mod, cfg_mod, mesh):
    z3, z2 = np.zeros((2, 16, 16), np.float32), np.zeros((16, 16), np.float32)
    return [
        lambda: tv_mod.tvl1_solve_tiled(z3, z3, cfg_mod.TVL1Config(), mesh=mesh),
        lambda: tv_mod.tvl1_solve_tiled(z2, z2[:, :-1], cfg_mod.TVL1Config(), mesh=mesh),
        lambda: tv_mod.tvl1_solve_tiled(z2, z2, cfg_mod.TVL1Config()),
        lambda: lk_mod.lk_solve_tiled(z3, z3, cfg_mod.LKConfig(), mesh=mesh),
        lambda: lk_mod.lk_solve_tiled(z2, z2[:, :-1], cfg_mod.LKConfig(), mesh=mesh),
        lambda: lk_mod.lk_solve_tiled(z2, z2, cfg_mod.LKConfig()),
    ]


@pytest.mark.parametrize("k", range(6))
def test_tiled_family_errors_match_reference(k):
    import opticalflowhs_tpu_torch.config as port_config
    import opticalflowhs_tpu_torch.lucas_kanade as port_lk
    import opticalflowhs_tpu_torch.tvl1 as port_tv

    with pytest.raises(ValueError) as ref_err:
        _errors(ref_tv, ref_lk, ref_config, _ref_mesh())[k]()
    with pytest.raises(ValueError) as port_err:
        _errors(port_tv, port_lk, port_config, _mesh())[k]()
    assert str(port_err.value) == str(ref_err.value)
