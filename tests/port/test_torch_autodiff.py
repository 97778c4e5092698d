"""Gradients through the port: the sqrt(n)-checkpointed plain loops, the
kernel entries' autograd scheme (kernels/autodiff.py), and the port's
gradients against the reference's `jax.grad` and `jax.jvp`.

The reference's cases are tests/unit/test_remat.py (the checkpointed loop)
and tests/integration/test_autodiff.py (grad and jvp through hs_solve, its
Pallas backend against its jnp backend). Bars:
  - checkpointed = plain loop, forward and gradients: bitwise (the same
    ops in the same order, recomputed);
  - the autograd scheme on the CPU (each entry's kernel path is its plain
    version there) = plain autograd of its twin: bitwise;
  - the port against `jax.grad`: atol 2e-5, rtol 1e-4 (test_remat.py's
    bar); TV-L1 atol 1e-4, rtol 1e-4 (the reference's own jnp and Pallas
    gradients differ by about 5e-5 there); forward mode against `jax.jvp`:
    the same 2e-5, 1e-4.
Each parity test records its max |diff| as the junit property
`max_abs_diff`."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwad

import opticalflowhs_tpu.batch as ref_batch
import opticalflowhs_tpu.pyramid as ref_pyramid
import opticalflowhs_tpu.solver as ref_solver
import opticalflowhs_tpu.tvl1 as ref_tvl1
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.config import TVL1Config as RefTV
from opticalflowhs_tpu.data.synthetic import translation_pair
from opticalflowhs_tpu_torch import robust
from opticalflowhs_tpu_torch import tvl1 as tv
from opticalflowhs_tpu_torch.batch import hs_solve_batched
from opticalflowhs_tpu_torch.config import HSConfig, PyramidConfig, TVL1Config
from opticalflowhs_tpu_torch.kernels import autodiff
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import solve_fused as k6
from opticalflowhs_tpu_torch.kernels import solve_resident as sr
from opticalflowhs_tpu_torch.kernels import solve_robust as k4
from opticalflowhs_tpu_torch.kernels import solve_skewed as k7
from opticalflowhs_tpu_torch.kernels import sor as k3
from opticalflowhs_tpu_torch.kernels import sor_planes as k8
from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5
from opticalflowhs_tpu_torch.ops import stencils
from opticalflowhs_tpu_torch.pyramid import hs_pyramid
from opticalflowhs_tpu_torch.solver import hs_solve

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
TVL1_ATOL = 1e-4

_DIFFS: list[float] = []


@pytest.fixture(autouse=True)
def _report_max_diff(record_property):
    _DIFFS.clear()
    yield
    if _DIFFS:
        record_property("max_abs_diff", max(_DIFFS))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    _DIFFS.append(float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _equal(got, want):
    d = float((got - want).detach().abs().max()) if got.numel() else 0.0
    _DIFFS.append(d)
    assert d == 0.0


def _rand(shape, seed, normal=False):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.5, shape) if normal else rng.uniform(0, 1, shape)
    return torch.from_numpy(a.astype(np.float32))


def _fields(shape, seed):
    return k1.derivatives_plain(_rand(shape, seed), _rand(shape, seed + 1), 0.5)


def _grads(fn, inputs, weights_seed=9):
    """Outputs of fn(*inputs) and the gradients of a weighted sum of them
    with respect to the inputs that require grad (zeros for one that no
    output depends on: TV-L1's threshold only selects a case)."""
    outs = fn(*inputs)
    rng = np.random.default_rng(weights_seed)
    loss = sum((o * torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))).sum()
               for o in outs)
    wrt = [t for t in inputs if t is not None and t.requires_grad]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)
    return [o.detach() for o in outs], list(grads)


def _jacobi_hand(u, v, ex, ey, et, invd, n):
    for _ in range(n):
        u, v = stencils.jacobi_step(u, v, ex, ey, et, invd)
    return u, v


# -- 1. the checkpointed loop: forward = the plain loop ---------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 9, 10, 17, 25, 100])
def test_checkpointed_loop_forward_equals_plain_loop(n):
    ex, ey, et, invd = (f.requires_grad_() for f in _fields((24, 32), 0))
    u = torch.zeros_like(ex).requires_grad_()
    v = torch.zeros_like(ex)
    step = lambda uv: stencils.jacobi_step(*uv, ex, ey, et, invd)
    uc, vc = stencils.checkpointed_loop(step, (u, v), n)
    up, vp = _jacobi_hand(u, v, ex, ey, et, invd, n)
    _equal(uc, up)
    _equal(vc, vp)
    with torch.no_grad():
        un, vn = stencils.checkpointed_loop(step, (u, v), n)
    _equal(un, up)
    _equal(vn, vp)


# -- 2. the checkpointed plain loops' gradients = un-checkpointed loops ----------

def _unchecked(monkeypatch):
    """The plain loops with every block run plainly: the same ops with no
    recomputation."""
    plain_block = lambda fn, state: tuple(fn(*state))
    monkeypatch.setattr(stencils, "checkpoint_block", plain_block)
    monkeypatch.setattr(robust, "checkpoint_block", plain_block)


def _loops(shape):
    ex, ey, et, invd = _fields(shape, 3)
    u, v = _rand(shape, 5, normal=True), _rand(shape, 6, normal=True)
    cfg = HSConfig(alpha=0.3, solver="robust", robust_update_every=4)
    u1, u2, fields, scalars = _tvl1_problem(shape, 7)
    return {
        "jacobi": ((u, v, ex, ey, et, invd), lambda *t: k2.jacobi_sweeps_plain(*t, 23)),
        "sor": ((u, v, ex, ey, et, invd), lambda *t: k3.sor_sweeps_plain(*t, 23, 1.5)),
        "robust": ((u, v, ex, ey, et), lambda *t: robust.robust_sweeps(*t, 10, cfg)),
        "tvl1_inner": ((u1, u2) + tuple(fields),
                       lambda *t: k5.tvl1_inner_plain(*t, 10, *scalars)),
        "planes": ((u, v, ex, ey, et, invd), lambda *t: k8.sor_planes_plain(*t, 9, 1.6)),
    }


def _tvl1_problem(shape, seed):
    """Warm (u1, u2) and the inner loop's fields as tvl1_warp_iteration
    computes them, from a pair on the [0, 255] scale."""
    i1, i2 = 255.0 * _rand(shape, seed), 255.0 * _rand(shape, seed + 1)
    u1, u2 = _rand(shape, seed + 2, normal=True), _rand(shape, seed + 3, normal=True)
    cfg = TVL1Config()
    return u1, u2, tv.inner_fields(i1, i2, u1, u2, cfg), tv.inner_scalars(cfg)


@pytest.mark.parametrize("loop", ["jacobi", "sor", "robust", "tvl1_inner", "planes"])
def test_checkpointed_loop_gradients_equal_unchecked_loop(loop, monkeypatch):
    inputs, fn = _loops((13, 18))[loop]
    inputs = [t.clone().requires_grad_() for t in inputs]
    outs, grads = _grads(fn, inputs)
    _unchecked(monkeypatch)
    outs_p, grads_p = _grads(fn, inputs)
    for a, b in zip(outs + grads, outs_p + grads_p):
        _equal(a, b)


def test_jacobi_gradients_equal_a_hand_loop():
    inputs = [t.clone().requires_grad_() for t in _loops((13, 18))["jacobi"][0]]
    _, got = _grads(lambda *t: k2.jacobi_sweeps_plain(*t, 23), inputs)
    _, want = _grads(lambda *t: _jacobi_hand(*t, 23), inputs)
    for a, b in zip(got, want):
        _equal(a, b)


# -- 3. the structure engages: O(sqrt(n)) states on the tape ----------------------

def _saved(fn):
    """The tensors autograd saves while fn() runs (outside checkpointed
    blocks: those keep their input states and recompute the rest)."""
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return saved


@pytest.mark.parametrize("n", [23, 100])
def test_checkpointed_loop_stores_block_states(n):
    ex, ey, et, invd = (f.requires_grad_() for f in _fields((24, 32), 0))
    u, v = (torch.zeros_like(ex).requires_grad_() for _ in range(2))
    step = lambda uv: stencils.jacobi_step(*uv, ex, ey, et, invd)
    per_step = len(_saved(lambda: step((u, v))))
    plain = len(_saved(lambda: _jacobi_hand(u, v, ex, ey, et, invd, n)))
    ckpt = len(_saved(lambda: stencils.checkpointed_loop(step, (u, v), n)))
    b = math.isqrt(n)
    assert plain == n * per_step
    # n // b blocks keep their two input fields; the remainder (< b steps)
    # tapes plainly, at most one block's tape.
    assert ckpt == 2 * (n // b) + (n % b) * per_step
    assert ckpt <= 2 * (math.ceil(math.sqrt(n)) + 1) + b * per_step
    if n == 100:
        assert ckpt == 20 and plain == 100 * per_step


# -- 4. the autograd scheme, each entry's kernel path in the kernel's place -------

def _as_kernel_entry(monkeypatch):
    """On the CPU an entry's kernel path is its plain version. Route CPU
    tensors that need a gradient through `KernelEntry` as CUDA tensors are,
    so that each entry's wiring (its kernel and twin callables) runs."""
    def needs_grad(*tensors):
        return any(isinstance(t, torch.Tensor)
                   and ((t.requires_grad and torch.is_grad_enabled())
                        or fwad.unpack_dual(t).tangent is not None)
                   for t in tensors)
    monkeypatch.setattr(autodiff, "needs_grad", needs_grad)


_CFG_R = HSConfig(alpha=0.3, iters=7, solver="robust", robust_update_every=3)


def _entries(shape):
    """(name, inputs, entry call, plain twin call), every entry of the
    scheme; warm starts take (u0, v0) last, zero starts pass None."""
    i1, i2 = _rand(shape, 11), _rand(shape, 12)
    u, v = _rand(shape, 13, normal=True), _rand(shape, 14, normal=True)
    ex, ey, et, invd = _fields(shape, 15)
    u1, u2, tfields, scalars = _tvl1_problem(shape, 16)
    out = [
        ("K1", (i1, i2), lambda a, b: k1.hs_derivatives(a, b, 0.5),
         lambda a, b: k1.derivatives_plain(a, b, 0.5)),
        ("K1 zero sweep", (i1, i2), lambda a, b: k1.hs_derivatives(a, b, 0.5, zero_sweep=True),
         lambda a, b: k1.derivatives_plain(a, b, 0.5, zero_sweep=True)),
        ("K2", (u, v, ex, ey, et, invd), lambda *t: k2.jacobi_sweeps(*t, 7),
         lambda *t: k2.jacobi_sweeps_plain(*t, 7)),
        ("K3", (u, v, ex, ey, et, invd), lambda *t: k3.sor_sweeps(*t, 5, 1.6),
         lambda *t: k3.sor_sweeps_plain(*t, 5, 1.6)),
        ("K4 robust_sweeps", (u, v, ex, ey, et), lambda *t: k4.robust_sweeps(*t, 7, _CFG_R),
         lambda *t: robust.robust_sweeps(*t, 7, _CFG_R)),
        ("K5", (u1, u2) + tuple(tfields), lambda *t: k5.tvl1_inner(*t, 5, *scalars),
         lambda *t: k5.tvl1_inner_plain(*t, 5, *scalars)),
    ]
    solves = [
        ("K1 + K2", lambda a, b, c, d: sr.hs_solve_resident(a, b, 0.5, 7, u0=c, v0=d),
         lambda a, b, c, d: sr.hs_solve_resident_plain(a, b, 0.5, 7, u0=c, v0=d)),
        ("K1 + K3", lambda a, b, c, d: sr.hs_solve_resident_sor(a, b, 0.5, 5, 1.6, u0=c, v0=d),
         lambda a, b, c, d: sr.hs_solve_resident_sor_plain(a, b, 0.5, 5, 1.6, u0=c, v0=d)),
        ("K1 + K4", lambda a, b, c, d: k4.hs_solve_robust_resident(a, b, _CFG_R, c, d),
         lambda a, b, c, d: k4.hs_solve_robust_resident_plain(a, b, _CFG_R, c, d)),
        ("K1 + K6", lambda a, b, c, d: k6.hs_solve_fused(a, b, 0.5, 7, u0=c, v0=d),
         lambda a, b, c, d: k6.hs_solve_fused_plain(a, b, 0.5, 7, u0=c, v0=d)),
        ("K1 + K7", lambda a, b, c, d: k7.hs_solve_skewed(a, b, 0.5, 7, u0=c, v0=d),
         lambda a, b, c, d: k7.hs_solve_skewed_plain(a, b, 0.5, 7, u0=c, v0=d)),
    ]
    if len(shape) == 2:
        solves.append((
            "K1 + K8", lambda a, b, c, d: k8.hs_solve_sor_planes(a, b, 0.5, 5, 1.6, u0=c, v0=d),
            lambda a, b, c, d: k8.sor_planes_plain(c, d, *k1.derivatives_plain(a, b, 0.5), 5, 1.6)))
        out.append(("K8", (u, v, ex, ey, et, invd), lambda *t: k8.sor_planes(*t, 5, 1.6),
                    lambda *t: k8.sor_planes_plain(*t, 5, 1.6)))
    else:
        out.append(("K1 + K6 batched", (i1, i2),
                    lambda a, b: k6.hs_solve_fused_batched(a, b, 0.5, 7),
                    lambda a, b: k6.hs_solve_fused_batched_plain(a, b, 0.5, 7)))
        out.append(("K1 + K7 batched", (i1, i2),
                    lambda a, b: k7.hs_solve_skewed_batched(a, b, 0.5, 7),
                    lambda a, b: k7.hs_solve_skewed_batched_plain(a, b, 0.5, 7)))
    for name, call, twin in solves:
        out.append((name + " zero", (i1, i2), lambda a, b, call=call: call(a, b, None, None),
                    lambda a, b, twin=twin: twin(a, b, None, None)))
        out.append((name + " warm", (i1, i2, u, v), call, twin))
    return out


_CASES = [pytest.param(s, k, id=f"{'x'.join(map(str, s))}-{e[0]}")
          for s in [(13, 18), (3, 11, 14)] for k, e in enumerate(_entries(s))]


@pytest.mark.parametrize("shape,k", _CASES)
@pytest.mark.parametrize("wrt", ["all", "first"])
def test_kernel_entry_gradients_equal_plain_autograd(shape, k, wrt, monkeypatch):
    """Each entry through `KernelEntry` (kernel path forward, twin VJP
    backward) = plain autograd of its twin, bitwise: outputs and every
    input's gradient; with wrt="first" only the first input requires grad."""
    name, inputs, call, twin = _entries(shape)[k]
    inputs = [t.clone().requires_grad_(wrt == "all" or i == 0) for i, t in enumerate(inputs)]
    want_outs, want = _grads(twin, inputs)
    _as_kernel_entry(monkeypatch)
    outs = call(*inputs)
    assert all(o.grad_fn is not None for o in outs), name
    assert any(type(o.grad_fn).__name__ == "KernelEntryBackward" for o in outs), name
    got_outs, got = _grads(call, inputs)
    for a, b in zip(got_outs + got, want_outs + want):
        _equal(a, b)


def test_kernel_entry_returns_fresh_outputs(monkeypatch):
    """An early exit that returns its start (n = 0) comes back as a fresh
    tensor with the identity's gradient."""
    _as_kernel_entry(monkeypatch)
    u, v = (_rand((9, 12), s, normal=True).requires_grad_() for s in (1, 2))
    fields = _fields((9, 12), 3)
    ou, ov = k2.jacobi_sweeps(u, v, *fields, 0)
    assert ou.data_ptr() != u.data_ptr() and ou.grad_fn is not None
    (ou.sum() + 2 * ov.sum()).backward()
    _equal(u.grad, torch.ones_like(u))
    _equal(v.grad, torch.full_like(v, 2.0))


def test_kernel_entry_refuses_forward_mode():
    ex, ey, et, invd = _fields((9, 12), 3)
    u, v = torch.zeros_like(ex), torch.zeros_like(ex)
    run = lambda *t: k2.jacobi_sweeps_plain(*t, 3)
    with fwad.dual_level():
        du = fwad.make_dual(u, torch.ones_like(u))
        with pytest.raises(NotImplementedError, match="jvp"):
            autodiff.KernelEntry.apply(run, run, du, v, ex, ey, et, invd)


def test_needs_grad_leaves_the_cpu_path_alone():
    a = torch.zeros(3, 4, requires_grad=True)
    assert not autodiff.needs_grad(a, None, 0.5)
    with fwad.dual_level():
        assert not autodiff.needs_grad(fwad.make_dual(torch.zeros(3, 4), torch.ones(3, 4)))


def test_tolerance_route_differentiates():
    """Solve to tolerance with grad on: the blocks taken keep one graph, and
    with a tolerance no block meets, the gradient equals the fixed-count
    sweeps' (the reference's while_loop refuses reverse mode here)."""
    i1, i2 = _rand((13, 18), 21), _rand((13, 18), 22).requires_grad_()
    cfg = HSConfig(alpha=0.5, iters=12, tol=1e-30, block_sweeps=4)
    got = torch.autograd.grad(hs_solve(i1, i2, cfg).u.square().sum(), i2)[0]
    ex, ey, et, invd = k1.derivatives_plain(i1, i2, 0.5)
    z = torch.zeros_like(ex)
    u, _ = k2.jacobi_sweeps_plain(z, z, ex, ey, et, invd, 12)
    _equal(got, torch.autograd.grad(u.square().sum(), i2)[0])


# -- 5. the port's gradients against the reference's jax.grad ----------------------

def _pair(h, w, seed):
    return translation_pair(h, w, 1.0, 0.0, key=seed)[:2]


def _grad_pair(port_solve, ref_solve, a, b, loss="sum"):
    """Gradients of the loss of the flow with respect to both frames: the
    port's (plain path, CPU) and the reference's jax.grad."""
    def port_loss(f):
        if loss == "mean":
            return f.u.square().mean() + f.v.square().mean()
        return f.u.sum() + 0.5 * f.v.square().sum()

    def ref_loss(f):
        if loss == "mean":
            return jnp.mean(f.u ** 2) + jnp.mean(f.v ** 2)
        return jnp.sum(f.u) + 0.5 * jnp.sum(f.v ** 2)

    ta, tb = (torch.from_numpy(np.ascontiguousarray(x)).requires_grad_() for x in (a, b))
    got = torch.autograd.grad(port_loss(port_solve(ta, tb)), (ta, tb))
    want = jax.jit(jax.grad(lambda x, y: ref_loss(ref_solve(x, y)), argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    assert float(np.abs(np.asarray(want[1])).max()) > 0
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


_HS_CASES = {
    "jacobi i8": (dict(alpha=0.5, iters=8), (16, 32)),
    "jacobi i23": (dict(alpha=0.5, iters=23), (24, 32)),
    "sor": (dict(alpha=0.5, iters=23, solver="sor", omega=1.5), (24, 32)),
    "robust": (dict(alpha=0.3, iters=10, solver="robust", robust_update_every=4), (16, 32)),
    "multigrid": (dict(alpha=1.0, iters=2, solver="multigrid"), (32, 48)),
}


@pytest.mark.parametrize("case,backend", [(c, "jnp") for c in _HS_CASES]
                         + [("jacobi i8", "pallas"), ("sor", "pallas"), ("robust", "pallas")])
def test_hs_solve_grad_matches_reference(case, backend):
    kw, (h, w) = _HS_CASES[case]
    a, b = _pair(h, w, 6)
    got, want = _grad_pair(lambda x, y: hs_solve(x, y, HSConfig(**kw)),
                           lambda x, y: ref_solver.hs_solve(x, y, RefHS(backend=backend, **kw)),
                           a, b)
    for g, r in zip(got, want):
        _close(g, r)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_batched_grad_matches_reference(backend):
    a, b = _pair(16, 32, 9)
    a, b = np.stack([a, a[::-1]]), np.stack([b, b[::-1]])
    kw = dict(alpha=0.5, iters=6)

    def port(x, y):
        return hs_solve_batched(x, y, HSConfig(**kw))

    def ref(x, y):
        return ref_batch.hs_solve_batched(x, y, RefHS(backend=backend, **kw))
    got, want = _grad_pair(port, ref, a, b, loss="mean")
    for g, r in zip(got, want):
        _close(g, r)


def test_pyramid_grad_matches_reference():
    a, b = _pair(32, 48, 4)
    kw = dict(alpha=0.5, iters=20)
    got, want = _grad_pair(
        lambda x, y: hs_pyramid(x, y, HSConfig(**kw), PyramidConfig(levels=2)),
        lambda x, y: ref_pyramid.hs_pyramid(x, y, RefHS(backend="jnp", **kw), RefPyr(levels=2)),
        a, b)
    for g, r in zip(got, want):
        _close(g, r)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_tvl1_grad_matches_reference(backend):
    """One level, one warp, 5 alternations, with the gather warp: the
    reference's checked warp takes about 40 s to differentiate on the CPU
    (the card's G3 runs `TVL1Config()`'s checked warp through K5)."""
    a, b = _pair(16, 32, 6)
    kw = dict(warps=1, iters=5, warp="gather")
    got, want = _grad_pair(
        lambda x, y: tv.tvl1_solve(x, y, TVL1Config(**kw), PyramidConfig(levels=1)),
        lambda x, y: ref_tvl1.tvl1_solve(x, y, RefTV(backend=backend, **kw),
                                         RefPyr(levels=1, iters_per_level=())),
        a, b)
    for g, r in zip(got, want):
        _close(g, r, atol=TVL1_ATOL)


# -- 6. forward mode on the plain backend against jax.jvp ---------------------------

def test_jvp_matches_reference():
    a, b = _pair(12, 24, 8)
    d = (np.random.default_rng(0).normal(size=a.shape) * 0.01).astype(np.float32)
    kw = dict(alpha=0.8, iters=5)
    with fwad.dual_level():
        x = fwad.make_dual(torch.from_numpy(a), torch.from_numpy(d))
        flow = hs_solve(x, torch.from_numpy(b), HSConfig(**kw))
        got = [fwad.unpack_dual(f).tangent.numpy() for f in (flow.u, flow.v)]
    _, want = jax.jvp(lambda x: tuple(ref_solver.hs_solve(x, jnp.asarray(b),
                                                          RefHS(backend="jnp", **kw))),
                      (jnp.asarray(a),), (jnp.asarray(d),))
    for g, r in zip(got, want):
        _close(g, np.asarray(r))
