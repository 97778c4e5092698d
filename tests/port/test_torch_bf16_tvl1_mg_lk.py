"""bfloat16 on TV-L1, multigrid and Lucas-Kanade (TVL1Config, HSConfig
(solver="multigrid") and LKConfig with dtype="bfloat16") on the CPU: the
plain bfloat16 twins, K5's schedule twin, and every single-card entry
point against the JAX reference on the same numpy inputs.

The port's rule (the package docstring, ops/stencils.py `store`):
bfloat16 storage, float32 arithmetic, each array rounded once where it is
stored. TV-L1 rounds the rescaled frames, the five inner-loop fields, u1
and u2 where the u-step stores them and the duals where the p-step does;
multigrid each level's coefficients, the right-hand side, residuals,
restrictions, corrections and u, v once a smoother sweep; LK the warped
frame, the gradients, the window sums and the flow after each refinement
and blur. Bars, each with its reason and its measured value:
  * K5's schedule twin (`k5_iters_schedule_plain`) = `tvl1_inner_plain`
    bitwise in bfloat16 at every s: the kernel's staging and rounding
    points are the twin's.
  * The inner loop from the same bfloat16 fields: within INNER_ULP = 2^-6
    (two bfloat16 ulps at |u| < 2) of the reference's float32 twin on
    those fields widened (measured 0.0098 at 7 and 11 alternations), and
    no further from the reference's bfloat16 kernel (interpret mode) than
    that kernel lies from the float32 twin plus INNER_ULP (measured 0.023
    against 0.028: the reference rounds at other points).
  * The entry points: interior (8 px in) mean <= 0.02 px and max <= 0.1 px
    against the reference's float32 solve of the same inputs, the bars of
    the Jacobi, SOR and IRLS paths. Measured at these sizes: at most 0.003
    mean and 0.02 max against float32 (ROADMAP.md queue 3).
  * Against the reference's bfloat16 solve (one-level LK and fixed-count
    multigrid; each bfloat16 compile of the reference costs seconds, and
    tests/port/bf16_divergence.py prints all three families' distances for
    ROADMAP.md queue 3): LK within REF_BAR = 0.1 mean (the reference's bar
    for its own bfloat16). Multigrid is not held to its bfloat16 solve: the
    reference's bfloat16 V-cycles drift 0.058 px mean from its own float32
    solve at 4 cycles, the port's 0.001; the test records the distance
    (junit property `ref_bf16_mean`) and checks that the port is the
    closer of the two to float32.
  * The bfloat16 TV-L1 gradient against jax.grad of the reference's
    float32 solve (one level, one warp, 5 alternations, the gather warp,
    16 x 32): cosine >= GRAD_COS = 0.9 and relative L2 distance <=
    GRAD_REL = 0.4. The gradient of a bfloat16 solve is bfloat16, and the
    L1 term's three cases switch where the rounded state crosses a
    threshold, in both frameworks: measured cosine 0.957 and relative L2
    0.29; the reference's own bfloat16 gradient lies at 0.977 and 0.22
    (0.936 and 0.354 on a 24 x 32 pair, where the port's is at 0.954 and
    0.304).
  * 0.0 between a stack and a loop of the port's own single solves, and
    between a stream and the stack it solves.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.kernels.tvl1_inner as ref_k5
from opticalflowhs_tpu import batch as ref_batch
from opticalflowhs_tpu import lucas_kanade as ref_lk
from opticalflowhs_tpu import pyramid as ref_pyr
from opticalflowhs_tpu import solver as ref_solver
from opticalflowhs_tpu import tvl1 as ref_tv
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import LKConfig as RefLK
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.config import TVL1Config as RefTV
from opticalflowhs_tpu_torch import (
    Flow,
    HSConfig,
    LKConfig,
    PyramidConfig,
    TVL1Config,
    cli,
    flow_stream,
    flow_stream_warm,
    hs_pyramid,
    hs_solve,
    hs_solve_batched,
    lk_solve,
    lk_solve_batched,
    tvl1_solve,
    tvl1_solve_batched,
)
from opticalflowhs_tpu_torch import tvl1 as tv
from opticalflowhs_tpu_torch.config import load_config
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence, translation_pair
from opticalflowhs_tpu_torch.io.flo import read_flo
from opticalflowhs_tpu_torch.io.images import load_gray, save_image
from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5

torch.set_num_threads(1)

BF16 = torch.bfloat16
INNER_ULP = 2.0 ** -6
MEAN_TOL = 0.02
MAX_TOL = 0.1
REF_BAR = 0.1
GRAD_COS = 0.9
GRAD_REL = 0.4
EDGE = 8

TV = dict(warps=2, iters=20)
TV_PYR = dict(warps=1, iters=20)  # the two-level solve: one warp a level
MG = dict(alpha=1.0, iters=4, solver="multigrid")
ONE = dict(levels=1, iters_per_level=())


def _t(a) -> torch.Tensor:
    """A reference (JAX) array as a float32 CPU tensor, exactly."""
    return torch.from_numpy(np.array(a, np.float32))


def _means(got, want):
    """Interior mean and max |got - want| over u and v, in px."""
    d = [(g.float() - _t(w)).abs()[..., EDGE:-EDGE, EDGE:-EDGE] for g, w in zip(got, want)]
    return max(float(x.mean()) for x in d), max(float(x.max()) for x in d)


def _check(got, want32, want16=None, record=None, held=True):
    """got (bfloat16) within the bars of the reference's float32 flow; and,
    where given, of its bfloat16 flow (`held`), or recorded as the distance
    to it with the port the closer of the two to float32."""
    assert got.u.dtype == got.v.dtype == BF16
    mean, mx = _means(got, want32)
    assert mean <= MEAN_TOL and mx <= MAX_TOL, (mean, mx)
    if want16 is None:
        return
    m16 = _means(got, want16)[0]
    if held:
        assert m16 < REF_BAR, m16
        return
    record("ref_bf16_mean", m16)
    assert mean < _means(tuple(_t(w) for w in want16), want32)[0]


@functools.cache
def _pair(h=64, w=96, key=5):
    return translation_pair(h, w, 1.0, 0.0, key=key)[:2]


@functools.cache
def _video():
    return synthetic_sequence(5, 48, 64, tx=1.0, ty=0.5, key=3)[0]


# -- K5's bfloat16 twins ------------------------------------------------------------


def _fields16(shape, seed):
    """bfloat16 warm flow and the five fields of a bfloat16 warp iteration,
    from a translation pair rescaled to [0, 255] (all three data-term
    cases fire)."""
    frames = [translation_pair(*shape[-2:], 0.7, -0.3, key=seed + k)[:2]
              for k in range(shape[0] if len(shape) == 3 else 1)]
    i1, i2 = (torch.from_numpy(np.stack([f[j] for f in frames])).reshape(shape).to(BF16)
              for j in (0, 1))
    rng = np.random.default_rng(seed)
    u1, u2 = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(BF16)
              for _ in range(2))
    cfg = TVL1Config(dtype="bfloat16")
    f1, f2 = tv.rescale_pair(i1, i2)
    fields = tv.inner_fields(f1, f2, u1, u2, cfg)
    rho = fields[0].float() + u1.float() * fields[1].float() + u2.float() * fields[2].float()
    th = fields[4].float()
    assert all(float(m.float().mean()) > 0 for m in (rho < -th, rho > th, rho.abs() <= th))
    return u1, u2, fields, tv.inner_scalars(cfg)


@pytest.mark.parametrize("s", range(1, k5.K5_MAX_ITERS + 1))
def test_k5_schedule_twin_equals_plain_bf16(s):
    for shape in ((40, 130), (2, 37, 45)):
        u1, u2, fields, scalars = _fields16(shape, 11)
        assert all(f.dtype == BF16 for f in fields)
        iters = 2 * s + 1  # s does not divide it: a shorter last launch
        want = k5.tvl1_inner_plain(u1, u2, *fields, iters, *scalars)
        got = k5.k5_iters_schedule_plain(u1, u2, *fields, iters, s, *scalars)
        assert got[0].dtype == want[0].dtype == BF16
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k5_wrapper_on_cpu_runs_the_bf16_plain_twin():
    u1, u2, fields, scalars = _fields16((24, 40), 12)
    k5.tvl1_inner.launches = 0
    got = k5.tvl1_inner(u1, u2, *fields, 9, *scalars, block_iters=3)
    assert k5.tvl1_inner.launches == 0
    want = k5.tvl1_inner_plain(u1, u2, *fields, 9, *scalars)
    assert got[0].dtype == BF16 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="dtype"):
        k5.tvl1_inner(u1, u2.float(), *fields, 3, *scalars)


@pytest.mark.parametrize("iters", [7, 11])
def test_inner_plain_bf16_against_reference(iters):
    u1, u2, fields, scalars = _fields16((96, 128), 1)
    got = k5.tvl1_inner_plain(u1, u2, *fields, iters, *scalars)
    wide = [jnp.asarray(a.float().numpy()) for a in (u1, u2, *fields)]
    twin32 = ref_k5._jnp_twin(*wide, iters, *scalars)
    kern16 = ref_k5.tvl1_inner(*(a.astype(jnp.bfloat16) for a in wide), iters, *scalars)
    d32 = max(float((g.float() - _t(w)).abs().max()) for g, w in zip(got, twin32))
    assert d32 <= INNER_ULP, d32
    d16 = max(float((g.float() - _t(w)).abs().max()) for g, w in zip(got, kern16))
    own = max(float((_t(a) - _t(b)).abs().max()) for a, b in zip(kern16, twin32))
    assert d16 <= own + INNER_ULP, (d16, own)


# -- TV-L1 -----------------------------------------------------------------------------


def _ref_tv(levels, kw):
    i1, i2 = _pair()
    return ref_tv.tvl1_solve(jnp.asarray(i1), jnp.asarray(i2), RefTV(backend="jnp", **kw),
                             RefPyr(levels=levels, iters_per_level=()))


@pytest.mark.parametrize("levels,kw", [(1, TV), (2, TV_PYR)])
def test_tvl1_solve_bf16(levels, kw):
    i1, i2 = _pair()
    got = tvl1_solve(i1, i2, TVL1Config(dtype="bfloat16", **kw), PyramidConfig(levels=levels),
                     device="cpu")
    _check(got, _ref_tv(levels, kw))


def test_tvl1_batched_and_stream_bf16():
    # A stack of the pair both ways = the single solves bitwise, its first
    # image held to the reference's single solve (whose compilation the
    # one-level test shares); a stream's chunks = the batched solve's stacks.
    i1, i2 = _pair()
    cfg = TVL1Config(dtype="bfloat16", **TV)
    got = tvl1_solve_batched(np.stack([i1, i2]), np.stack([i2, i1]), cfg, device="cpu")
    for k, (a, b) in enumerate(((i1, i2), (i2, i1))):
        one = tvl1_solve(a, b, cfg, device="cpu")
        assert torch.equal(got.u[k], one.u) and torch.equal(got.v[k], one.v)
    _check(Flow(got.u[0], got.v[0]), _ref_tv(1, TV))
    frames = _video()
    chunks = list(flow_stream(frames, tvl1=cfg, chunk=2, device="cpu"))
    whole = tvl1_solve_batched(frames[:-1], frames[1:], cfg, device="cpu")
    assert chunks[0].u.dtype == BF16
    assert torch.equal(torch.cat([f.u for f in chunks]), whole.u)
    assert torch.equal(torch.cat([f.v for f in chunks]), whole.v)


def test_tvl1_grad_bf16_against_reference():
    a, b = translation_pair(16, 32, 1.0, 0.0, key=6)[:2]
    kw = dict(warps=1, iters=5, warp="gather")
    ta, tb = (torch.from_numpy(np.ascontiguousarray(x)).requires_grad_() for x in (a, b))
    f = tvl1_solve(ta, tb, TVL1Config(dtype="bfloat16", **kw), PyramidConfig(levels=1))
    assert f.u.dtype == BF16
    loss = f.u.float().square().mean() + f.v.float().square().mean()
    got = np.concatenate([g.numpy().ravel() for g in torch.autograd.grad(loss, (ta, tb))])

    def loss32(x, y):
        r = ref_tv.tvl1_solve(x, y, RefTV(backend="jnp", **kw), RefPyr(**ONE))
        return jnp.mean(r.u ** 2) + jnp.mean(r.v ** 2)

    g = jax.jit(jax.grad(loss32, argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    r32 = np.concatenate([np.asarray(x).ravel() for x in g])
    cos = float(got @ r32 / np.linalg.norm(got) / np.linalg.norm(r32))
    rel = float(np.linalg.norm(got - r32) / np.linalg.norm(r32))
    assert cos >= GRAD_COS and rel <= GRAD_REL, (cos, rel)


# -- multigrid --------------------------------------------------------------------------


def _ref_mg(dtype, tol=0.0):
    i1, i2 = _pair(key=3)
    return ref_solver.hs_solve(jnp.asarray(i1), jnp.asarray(i2),
                               RefHS(backend="jnp", dtype=dtype, tol=tol, **MG))


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_multigrid_hs_solve_bf16(tol, record_property):
    i1, i2 = _pair(key=3)
    got = hs_solve(i1, i2, HSConfig(dtype="bfloat16", tol=tol, **MG), device="cpu")
    if tol:
        _check(got, _ref_mg("float32", tol))
    else:
        _check(got, _ref_mg("float32"), _ref_mg("bfloat16"), record_property, held=False)


def test_multigrid_batched_bf16_equals_singles_and_reference():
    frames = _video()
    cfg = HSConfig(dtype="bfloat16", **MG)
    got = hs_solve_batched(frames[:3], frames[1:4], cfg, device="cpu")
    for k in range(3):
        one = hs_solve(frames[k], frames[k + 1], cfg, device="cpu")
        assert torch.equal(got.u[k], one.u) and torch.equal(got.v[k], one.v)
    want = ref_batch.hs_solve_batched(jnp.asarray(frames[:3]), jnp.asarray(frames[1:4]),
                                      RefHS(backend="jnp", **MG))
    _check(got, want)


def test_multigrid_pyramid_bf16():
    i1, i2 = translation_pair(64, 96, 3.0, 1.5, key=0, max_freq=0.06)[:2]
    kw = dict(MG, iters=2)
    got = hs_pyramid(i1, i2, HSConfig(dtype="bfloat16", **kw), PyramidConfig(levels=2),
                     device="cpu")
    want = ref_pyr.hs_pyramid(jnp.asarray(i1), jnp.asarray(i2), RefHS(backend="jnp", **kw),
                              RefPyr(levels=2))
    _check(got, want)


def test_multigrid_warm_stream_bf16():
    # Each pair warm-starts from the previous pair's bfloat16 flow (the
    # reference's rule, held against it in float32 by test_torch_multigrid.py).
    frames = _video()
    cfg = HSConfig(dtype="bfloat16", **dict(MG, iters=2))
    got = list(flow_stream_warm(frames, cfg, device="cpu"))
    assert len(got) == 4
    prev = None
    for k, g in enumerate(got):
        prev = hs_solve(frames[k], frames[k + 1], cfg, init=prev, device="cpu")
        assert g.u.dtype == BF16 and torch.equal(g.u, prev.u) and torch.equal(g.v, prev.v)


# -- Lucas-Kanade ------------------------------------------------------------------------


def _ref_lk(levels, dtype):
    i1, i2 = _pair()
    return ref_lk.lk_solve(jnp.asarray(i1), jnp.asarray(i2), RefLK(dtype=dtype),
                           RefPyr(levels=levels, iters_per_level=()))


@pytest.mark.parametrize("levels", [1, 2])
def test_lk_solve_bf16(levels):
    i1, i2 = _pair()
    got = lk_solve(i1, i2, LKConfig(dtype="bfloat16"),
                   PyramidConfig(levels=levels, iters_per_level=()), device="cpu")
    _check(got, _ref_lk(levels, "float32"), _ref_lk(1, "bfloat16") if levels == 1 else None)


def test_lk_batched_and_stream_bf16():
    frames = _video()
    cfg = LKConfig(dtype="bfloat16")
    got = lk_solve_batched(frames[:-1], frames[1:], cfg, device="cpu")
    for k in range(4):
        one = lk_solve(frames[k], frames[k + 1], cfg, device="cpu")
        assert torch.equal(got.u[k], one.u) and torch.equal(got.v[k], one.v)
    want = ref_lk.lk_solve_batched(jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]), RefLK())
    _check(got, want)
    chunks = list(flow_stream(frames, lk=cfg, chunk=2, device="cpu"))
    assert torch.equal(torch.cat([f.u for f in chunks]), got.u)
    assert torch.equal(torch.cat([f.v for f in chunks]), got.v)


# -- the command line ------------------------------------------------------------------


@pytest.mark.parametrize("method", ["tvl1", "lk"])
def test_cli_run_bf16_writes_the_widened_flow(method, tmp_path):
    i1, i2 = translation_pair(48, 64, 1.0, 0.5, key=3)[:2]
    f1, f2, out = (str(tmp_path / n) for n in ("f1.pgm", "f2.pgm", "out.flo"))
    save_image(f1, i1)
    save_image(f2, i2)
    conf = tmp_path / "bf16.json"
    conf.write_text(json.dumps({"pyramid": {"levels": 1},
                                method: {"dtype": "bfloat16", "iters": 3}}))
    assert cli.main(["--device", "cpu", "--config", str(conf), "run", f1, f2, "-o", out,
                     "--method", method]) == 0
    a, b = load_gray(f1), load_gray(f2)
    rc = load_config(str(conf))
    solve = tvl1_solve if method == "tvl1" else lk_solve
    want = solve(a, b, getattr(rc, method), rc.pyramid, device="cpu")
    assert want.u.dtype == BF16
    assert np.array_equal(read_flo(out), np.stack([want.u.float().numpy(),
                                                   want.v.float().numpy()], axis=-1))
