"""bfloat16 (HSConfig(dtype="bfloat16"), solver="jacobi") on the CPU: the
port's plain bfloat16 twins and entry points against the JAX reference on
the same numpy inputs.

The port's rule (the package docstring, ops/stencils.py `store`):
bfloat16 storage, float32 arithmetic, each array rounded once where it is
stored, u and v after every sweep. The reference's bfloat16 rounds where
XLA:CPU puts its roundings, op by op or not, so the two are held to bars,
not bitwise. Bars, each with its reason:
  * K2's sweeps from the same bfloat16 fields: atol 1e-2 against the
    reference's Pallas kernel in interpret mode, the reference's own bar
    for its kernel against its jnp sweeps (tests/unit/test_bf16.py).
  * K1's fields from the same bfloat16 frames, against the reference's
    kernel in interpret mode: Ex, Ey and Et within K1_ABS = 2^-8, one
    bfloat16 ulp at the frames' scale [0.5, 1) (the reference rounds its
    partial sums, whose magnitude reaches 2, the port once at the end;
    measured: 2^-8 for hs_cube, 0 for central), and 1/den within K1_ULPS
    = 2 ulps of its own value (the reference also rounds alpha^2 + Ex^2
    and its sum with Ey^2; measured: 2). An ulp of bfloat16 is 2^-7 of the
    power of two at or below the value.
  * The reference's own claim, mirrored (64 x 96, alpha 0.2, 300 sweeps):
    the bfloat16 flow's interior mean |du| against the float32 solve
    < 0.1.
  * The entry points: interior (8 px in) mean <= 0.02 px and max <= 0.1 px
    against the reference's float32 solve of the same inputs, and mean
    < 0.1 (the reference's bar) against its bfloat16 solve. At these sizes
    the port measured 0.001-0.007 mean and at most 0.03 max against
    float32; the reference's bfloat16 drifts further from its own float32
    solve than the port does (ROADMAP.md queue 3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowhs_tpu import batch as ref_batch
from opticalflowhs_tpu import pyramid as ref_pyr
from opticalflowhs_tpu import video as ref_video
from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.config import PyramidConfig as RefPyr
from opticalflowhs_tpu.kernels import derivatives as ref_k1
from opticalflowhs_tpu.kernels import jacobi as ref_k2
from opticalflowhs_tpu.solver import hs_solve as ref_hs_solve
from opticalflowhs_tpu.solver import precompute as ref_precompute
from opticalflowhs_tpu_torch import (
    HSConfig,
    PyramidConfig,
    flow_stream,
    flow_stream_warm,
    hs_pyramid,
    hs_solve,
    hs_solve_batched,
    hs_solve_checkpointed,
)
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence, translation_pair
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import jacobi as k2

torch.set_num_threads(1)

BF16 = torch.bfloat16
K2_ATOL = 1e-2
K1_ABS = 2.0 ** -8
K1_ULPS = 2
MEAN_TOL = 0.02
MAX_TOL = 0.1
REF_BAR = 0.1
EDGE = 8


def _t(a) -> torch.Tensor:
    """A reference (JAX) array as a float32 CPU tensor, exactly."""
    return torch.from_numpy(np.array(a, np.float32))


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| in bfloat16 ulps of the larger magnitude."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(BF16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


def _interior(d):
    return d[..., EDGE:-EDGE, EDGE:-EDGE]


def _check_flow(got, want32, want16):
    """got (bfloat16) against the reference's float32 and bfloat16 flows."""
    assert got.u.dtype == got.v.dtype == BF16
    for g, w32, w16 in zip(got, want32, want16):
        d32 = _interior((g.float() - _t(w32)).abs())
        assert float(d32.mean()) <= MEAN_TOL, float(d32.mean())
        assert float(d32.max()) <= MAX_TOL, float(d32.max())
        d16 = _interior((g.float() - _t(w16)).abs())
        assert float(d16.mean()) < REF_BAR, float(d16.mean())


def _ref(cfg: HSConfig, dtype: str) -> RefHS:
    return RefHS(alpha=cfg.alpha, iters=cfg.iters, tol=cfg.tol, block_sweeps=cfg.block_sweeps,
                 deriv_variant=cfg.deriv_variant, backend="jnp", dtype=dtype)


def test_k2_plain_bf16_sweeps_match_the_reference_kernel():
    rng = np.random.default_rng(0)
    i1, i2 = (rng.uniform(0, 1, (32, 144)).astype(np.float32) for _ in range(2))
    fields = ref_precompute(jnp.asarray(i1), jnp.asarray(i2),
                            RefHS(alpha=0.7, dtype="bfloat16"))
    z = jnp.zeros_like(fields[0])
    ru, rv = ref_k2.jacobi_sweeps(z, z, *fields, 5, interpret=True)
    mine = [_t(f).to(BF16) for f in fields]  # the same bfloat16 values
    zero = torch.zeros(32, 144, dtype=BF16)
    u, v = k2.jacobi_sweeps(zero, zero, *mine, 5)
    assert u.dtype == v.dtype == BF16
    assert float((u.float() - _t(ru)).abs().max()) <= K2_ATOL
    assert float((v.float() - _t(rv)).abs().max()) <= K2_ATOL


@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("shape", [(32, 144), (67, 93)])
def test_k1_plain_bf16_fields_match_the_reference_kernel(variant, shape):
    rng = np.random.default_rng(1)
    i1, i2 = (rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2))
    want = ref_k1.derivatives_precompute(jnp.asarray(i1, jnp.bfloat16),
                                         jnp.asarray(i2, jnp.bfloat16), 0.7, variant,
                                         interpret=True)
    got = k1.hs_derivatives(torch.from_numpy(i1).to(BF16), torch.from_numpy(i2).to(BF16),
                            0.7, variant)
    for g, w in zip(got, want):
        assert g.dtype == BF16 and g.shape == shape
    for g, w in zip(got[:3], want[:3]):
        assert float((g.float() - _t(w)).abs().max()) <= K1_ABS
    assert _ulps(got[3], _t(want[3])) <= K1_ULPS


def test_bf16_solve_tracks_float32_as_the_reference_claims():
    i1, i2, _ = translation_pair(64, 96, 1.0, 0.0, key=13)
    f16 = hs_solve(i1, i2, HSConfig(alpha=0.2, iters=300, dtype="bfloat16"), device="cpu")
    f32 = ref_hs_solve(jnp.asarray(i1), jnp.asarray(i2), RefHS(alpha=0.2, iters=300))
    assert f16.u.dtype == BF16
    du = _interior((f16.u.float() - _t(f32.u)).abs())
    assert float(du.mean()) < 0.1, float(du.mean())


@pytest.mark.parametrize("cfg,init", [
    (HSConfig(alpha=0.2, iters=300), False),
    (HSConfig(alpha=0.5, iters=100, deriv_variant="central"), False),
    (HSConfig(alpha=0.5, iters=60), True),
    (HSConfig(alpha=0.5, iters=64, tol=1e-3), False),
])
def test_hs_solve_bf16(cfg, init):
    i1, i2, _ = translation_pair(64, 96, 1.0, 0.5, key=13)
    kw, rkw = {}, {}
    if init:
        rng = np.random.default_rng(2)
        u0, v0 = (rng.normal(0, 0.3, (64, 96)).astype(np.float32) for _ in range(2))
        from opticalflowhs_tpu.solver import Flow as RefFlow
        from opticalflowhs_tpu_torch import Flow
        kw = dict(init=Flow(u0, v0))
        rkw = dict(init=RefFlow(jnp.asarray(u0), jnp.asarray(v0)))
    got = hs_solve(i1, i2, dataclasses.replace(cfg, dtype="bfloat16"), device="cpu", **kw)
    want = [ref_hs_solve(jnp.asarray(i1), jnp.asarray(i2), _ref(cfg, dt), **rkw)
            for dt in ("float32", "bfloat16")]
    _check_flow(got, *want)


@pytest.mark.parametrize("tol,levels", [(0.0, 1), (1e-3, 1), (0.0, 2)])
def test_hs_solve_batched_bf16(tol, levels):
    frames = synthetic_sequence(4, 64, 96, 1.0, -0.5, key=3)[0]
    cfg = HSConfig(alpha=0.5, iters=64, tol=tol)
    pyr = PyramidConfig(levels=levels) if levels > 1 else None
    rpyr = RefPyr(levels=levels) if levels > 1 else None
    got = hs_solve_batched(frames[:-1], frames[1:], dataclasses.replace(cfg, dtype="bfloat16"),
                           pyr, device="cpu")
    want = [ref_batch.hs_solve_batched(jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]),
                                       _ref(cfg, dt), rpyr) for dt in ("float32", "bfloat16")]
    _check_flow(got, *want)


@pytest.mark.parametrize("shape,levels", [((64, 96), 2), ((128, 192), 3)])
def test_hs_pyramid_bf16(shape, levels):
    i1, i2, _ = translation_pair(*shape, 2.5, -1.0, key=5, max_freq=0.08)
    cfg = HSConfig(alpha=1.0, iters=40)
    got = hs_pyramid(i1, i2, dataclasses.replace(cfg, dtype="bfloat16"),
                     PyramidConfig(levels=levels), device="cpu")
    want = [ref_pyr.hs_pyramid(jnp.asarray(i1), jnp.asarray(i2), _ref(cfg, dt),
                               RefPyr(levels=levels)) for dt in ("float32", "bfloat16")]
    _check_flow(got, *want)


@pytest.mark.parametrize("kind", ["stream", "warm", "warm_prior"])
def test_streams_bf16(kind):
    frames = synthetic_sequence(5, 64, 96, 0.75, 0.25, key=4)[0]
    cfg = HSConfig(alpha=0.5, iters=50)
    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    if kind == "stream":
        got = list(flow_stream(frames, c16, chunk=2, device="cpu"))
        want = [list(ref_video.flow_stream(frames, _ref(cfg, dt), chunk=2))
                for dt in ("float32", "bfloat16")]
    else:
        prior = kind == "warm_prior"
        got = list(flow_stream_warm(frames, c16, chunk=2, warp_prior=prior, device="cpu"))
        want = [list(ref_video.flow_stream_warm(frames, _ref(cfg, dt), chunk=2,
                                                warp_prior=prior))
                for dt in ("float32", "bfloat16")]
    assert len(got) == len(want[0]) == len(want[1])
    for g, w32, w16 in zip(got, *want):
        _check_flow(g, w32, w16)


# -- checkpoints, host exits and refusals ------------------------------------------


def test_checkpointed_bf16_equals_the_uninterrupted_solve(tmp_path, monkeypatch):
    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=21)
    cfg = HSConfig(alpha=0.5, iters=20, checkpoint_every=7, dtype="bfloat16")
    want = hs_solve(i1, i2, dataclasses.replace(cfg, checkpoint_every=0), device="cpu")
    p = str(tmp_path / "bf16.npz")
    got = hs_solve_checkpointed(i1, i2, cfg, p, device="cpu")
    assert got.u.dtype == BF16 and torch.equal(got.u, want.u) and torch.equal(got.v, want.v)
    with np.load(p) as z:  # the exact float32 widening, the dtype recorded
        assert z["u"].dtype == np.float32 and bytes(z["dtype"]).decode() == "bfloat16"
        assert np.array_equal(z["u"], want.u.float().numpy())
    # Stopped after its second segment, as a crash would stop it, then resumed.
    import opticalflowhs_tpu_torch.checkpoint as ck
    solve, calls = ck.hs_solve, []

    def stop_on_third(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("stopped")
        return solve(*a, **k)

    p2 = str(tmp_path / "stop.npz")
    monkeypatch.setattr(ck, "hs_solve", stop_on_third)
    with pytest.raises(RuntimeError, match="stopped"):
        hs_solve_checkpointed(i1, i2, cfg, p2, device="cpu")
    monkeypatch.setattr(ck, "hs_solve", solve)
    flow, done = ck.load_state(p2, cfg, device="cpu")
    assert done == 14 and flow.u.dtype == BF16
    got = hs_solve_checkpointed(i1, i2, cfg, p2, device="cpu")
    assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)


def test_a_reference_bf16_checkpoint_is_read_exactly(tmp_path):
    # The reference stores its bfloat16 state as 2-byte values (numpy sees
    # |V2 without ml_dtypes): read as the same bfloat16 bits, then resumed.
    import opticalflowhs_tpu.checkpoint as ref_ck
    from opticalflowhs_tpu_torch import checkpoint as ck

    i1, i2, _ = translation_pair(48, 64, 1.0, 0.5, key=22)
    fields = dict(alpha=0.5, iters=10, checkpoint_every=10, dtype="bfloat16")
    p = str(tmp_path / "ref.npz")
    ref = ref_ck.hs_solve_checkpointed(jnp.asarray(i1), jnp.asarray(i2), RefHS(**fields), p)
    with np.load(p) as z:
        assert z["u"].dtype.kind == "V" and z["u"].dtype.itemsize == 2
    flow, done = ck.load_state(p, HSConfig(**fields), device="cpu")
    assert done == 10 and flow.u.dtype == BF16
    assert torch.equal(flow.u.float(), _t(ref.u)) and torch.equal(flow.v.float(), _t(ref.v))
    more = HSConfig(**dict(fields, iters=20))
    with pytest.raises(ValueError, match="different config"):
        hs_solve_checkpointed(i1, i2, more, p, device="cpu")  # the hash names iters


def test_bf16_flows_leave_for_the_host_widened(tmp_path):
    from opticalflowhs_tpu_torch.io import read_flow, write_flow
    from opticalflowhs_tpu_torch.metrics import epe
    from opticalflowhs_tpu_torch.video import flow_video
    from opticalflowhs_tpu_torch.viz import flow_to_color

    i1, i2, gt = translation_pair(48, 64, 1.0, 0.5, key=23)
    f = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=30, dtype="bfloat16"), device="cpu")
    stacked = torch.stack([f.u, f.v], -1)
    wide = stacked.float().numpy()
    for name in ("f.flo", "f.png"):
        write_flow(str(tmp_path / name), stacked)
        back = read_flow(str(tmp_path / name))
        tol = 0.0 if name.endswith(".flo") else 1 / 64  # KITTI's 1/64 px grid
        assert np.abs(back - wide).max() <= tol
    assert epe(stacked, gt) == epe(wide, gt)
    assert np.array_equal(flow_to_color(stacked), flow_to_color(wide))
    frames = synthetic_sequence(3, 32, 48, key=5)[0]
    vid = flow_video(frames, HSConfig(iters=10, dtype="bfloat16"), chunk=1, device="cpu")
    assert vid.u.dtype == np.float32 and vid.u.shape == (2, 32, 48)


def test_bidirectional_and_occlusion_streams_bf16():
    from opticalflowhs_tpu_torch.consistency import occlusion_mask, solve_bidirectional
    from opticalflowhs_tpu_torch.video import flow_stream_occlusion

    frames = synthetic_sequence(3, 48, 64, 1.0, 0.5, key=6)[0]
    cfg = HSConfig(alpha=0.5, iters=30, dtype="bfloat16")
    fwd, bwd = solve_bidirectional(frames[0], frames[1], cfg, device="cpu")
    both = hs_solve_batched(frames[[0, 1]], frames[[1, 0]], cfg, device="cpu")
    assert fwd.u.dtype == BF16
    assert torch.equal(fwd.u, both.u[0]) and torch.equal(bwd.v, both.v[1])
    (flow, mask), = flow_stream_occlusion(frames, cfg, chunk=2, a=0.0, b=1e-4, device="cpu")
    stack = hs_solve_batched(np.concatenate([frames[:-1], frames[1:]]),
                             np.concatenate([frames[1:], frames[:-1]]), cfg, device="cpu")
    assert torch.equal(flow.u, stack.u[:2])
    back = type(flow)(stack.u[2:], stack.v[2:])
    assert torch.equal(mask, occlusion_mask(flow, back, a=0.0, b=1e-4))
    assert 0 < int(mask.sum()) < mask.numel()


def test_bf16_refusals():
    # Every solver, TV-L1 and LK run in bfloat16 untiled (tests/port/
    # test_torch_bf16_sor_robust.py, test_torch_bf16_tvl1_mg_lk.py), and
    # hs_solve_tiled in bfloat16 solves, = the untiled solve bitwise
    # (test_torch_bf16_dist.py); the tiled TV-L1 and LK entries, once
    # refused, solve in bfloat16 too, = their untiled entries bitwise.
    # What is refused: float16.
    from opticalflowhs_tpu_torch import LKConfig, MeshConfig, TVL1Config
    from opticalflowhs_tpu_torch.dist import hs_solve_tiled, make_mesh
    from opticalflowhs_tpu_torch.lucas_kanade import lk_solve_tiled
    from opticalflowhs_tpu_torch.tvl1 import tvl1_solve_tiled

    z = torch.zeros(16, 16)
    mesh = make_mesh(MeshConfig(y=2, x=1), ["cpu"] * 2)
    i1, i2 = (torch.from_numpy(a) for a in translation_pair(16, 16, 1.0, 0.0, key=2)[:2])
    for cfg in (HSConfig(solver="sor", iters=5, dtype="bfloat16"),
                HSConfig(iters=5, dtype="bfloat16")):
        got = hs_solve_tiled(i1, i2, cfg, mesh)
        want = hs_solve(i1, i2, cfg)
        assert got.u.dtype == BF16
        assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)
    from opticalflowhs_tpu_torch import lk_solve, tvl1_solve

    for tiled, untiled, cfg in ((tvl1_solve_tiled, tvl1_solve, TVL1Config(warps=1, iters=3,
                                                                          dtype="bfloat16")),
                                (lk_solve_tiled, lk_solve, LKConfig(dtype="bfloat16"))):
        got, want = tiled(i1, i2, cfg, mesh=mesh), untiled(i1, i2, cfg)
        assert got.u.dtype == BF16
        assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)
    with pytest.raises(ValueError, match="dtype must be one of"):
        HSConfig(dtype="float16")
    # K9 takes float32 or bfloat16, one dtype across its arrays.
    from opticalflowhs_tpu_torch.kernels import tile as k9

    b = z.to(BF16)
    half = z.half()[None]
    org = k9.origin_table(b[None], [0], [0])
    with pytest.raises(ValueError, match="expected float32 or bfloat16"):
        k9.tile_sweeps(*(half for _ in range(6)), 2, org, 16, 16)
    with pytest.raises(ValueError, match="dtype"):
        k9.sor_tile_sweeps(b[None], *(z[None] for _ in range(5)), 2, 1.5, org, 16, 16)
    with pytest.raises(ValueError, match="dtype"):
        k2.jacobi_sweeps(b, b, z, z, z, z, 2)  # one dtype across the arrays


# -- routing: the reference's classes in bfloat16's bytes --------------------------

ROUTE_SIZES = [(1088, 1920), (1440, 2560), (1800, 3200), (2160, 3840), (2880, 5120),
               (3240, 5760), (4320, 7680)]


@pytest.mark.parametrize("shape", ROUTE_SIZES)
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_bf16_routing_follows_the_references_bf16_classes(shape, variant, monkeypatch):
    import jax

    from opticalflowhs_tpu import solver as ref_solver
    from opticalflowhs_tpu.kernels import solve_fused as ref_fused
    from opticalflowhs_tpu.kernels import solve_resident as ref_resident
    from opticalflowhs_tpu.kernels import solve_skewed as ref_skewed
    from opticalflowhs_tpu_torch.kernels import solve_fused as k6
    from opticalflowhs_tpu_torch.kernels import solve_resident as sr
    from opticalflowhs_tpu_torch.kernels import solve_skewed as k7
    from opticalflowhs_tpu_torch.solver import whole_solve_route

    for var in ("HSFLOW_RESIDENT_SOLVE", "HSFLOW_SKEWED_SOLVE", "HSFLOW_FUSED_SOLVE"):
        monkeypatch.delenv(var, raising=False)
    h, w = shape
    frame = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
    for iters in (50, 100):
        assert sr.applicable(h, w, iters, variant, 2) == ref_resident.applicable(
            frame, iters, variant)
        assert k7.applicable(h, w, iters, 2) == ref_skewed.applicable(frame, iters)
        assert k6.applicable(h, w, iters, 32, 2) == ref_fused.applicable(frame, iters, 32)
        if (ref_solver.resident_solve_enabled(iters)
                and ref_resident.applicable(frame, iters, variant) is not None):
            want = "resident"
        elif ref_solver.skewed_solve_enabled(iters) and ref_skewed.applicable(frame, iters):
            want = "skewed"
        elif ref_solver.fused_solve_enabled(iters) and ref_fused.applicable(frame, iters, 32):
            want = "fused"
        else:
            want = "chain"
        assert whole_solve_route(h, w, iters, variant, 0, "bfloat16") == want
    # hs_cube at 1080p, 4K and 8K takes the same route in both dtypes; central
    # 1080p fits the reference's whole-image class in bfloat16's bytes, so
    # it takes the K1 + K2 chain there, not K6.
    if shape in ((1088, 1920), (2160, 3840), (4320, 7680)):
        same = variant == "hs_cube" or shape != (1088, 1920)
        assert (whole_solve_route(h, w, 100, variant, 0, "bfloat16")
                == whole_solve_route(h, w, 100, variant)) == same
