"""dist/reshard.py and the sharded sums (`axis_names=` on
estimate_egomotion and hs_energy) on the CPU, on meshes of CPU devices in
one process, against the whole arrays and the reference's shard_map forms
on its 8 fake CPU devices (tests/conftest.py). Inputs come from seeded
numpy generators.

Bars, each with its reason:
  * layout changes (`shard`, `reshard`, `time_to_space`, `space_to_time`,
    `timesharded_pairs`): exact. They only copy, and the reference's
    collectives only copy.
  * the copy discipline: each destination block receives only slices of
    its own extent (a copy never larger than the block, and the elements
    moved into it equal its true extent), and nothing but `gather`
    assembles the whole array.
  * sharded sums against the whole-field value: 1e-5, relative to the
    value's magnitude where it exceeds 1 (float32 sums in another order,
    the bar the card check holds at config 5's 16 shards), and against the
    reference's shard_map estimate 1e-5 (its own sharded test's is 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import opticalflowhs_tpu.config as ref_config
import opticalflowhs_tpu.dist as ref_dist
import opticalflowhs_tpu.dist.reshard as ref_reshard
from opticalflowhs_tpu.egomotion import estimate_egomotion as ref_egomotion
from opticalflowhs_tpu.solver import Flow as RefFlow
from opticalflowhs_tpu_torch import Flow, MeshConfig
from opticalflowhs_tpu_torch.dist import make_mesh
import opticalflowhs_tpu_torch.dist.reshard as rs
from opticalflowhs_tpu_torch.egomotion import estimate_egomotion
from opticalflowhs_tpu_torch.metrics import hs_energy

torch.set_num_threads(1)

SUM_TOL = 1e-5


def _mesh(b=1, y=2, x=2):
    return make_mesh(MeshConfig(batch=b, y=y, x=x), ["cpu"] * (b * y * x))


def _ref_mesh(b=1, y=2, x=2):
    return ref_dist.make_mesh(ref_config.MeshConfig(batch=b, y=y, x=x))


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32))


def _close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= SUM_TOL * max(1.0, abs(want)), (got, want)


MESHES = [(2, 2, 2), (4, 1, 1), (1, 2, 4), (2, 1, 3)]
SHAPES = [(8, 32, 40), (17, 37, 45), (3, 67, 93)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mshape", MESHES)
def test_time_space_round_trip(mshape, shape):
    # Odd shapes pad to the mesh grid and crop back; T = 3 on a batch of 4
    # leaves a group of padding only.
    mesh = _mesh(*mshape)
    x = _rand(shape, 1)
    t = rs.shard(x, mesh, rs.TIME)
    s = rs.time_to_space(t, mesh)
    assert s.spec == rs.SPACE and torch.equal(s.gather(), x)
    back = rs.space_to_time(s, mesh)
    assert back.spec == rs.TIME and torch.equal(back.gather(), x)
    assert torch.equal(rs.time_to_space(x.numpy(), mesh).gather(), x)
    for c, blk in s.blocks.items():
        assert blk.device == mesh.devices[c]
        t0, r0, c0 = s.offset(c)
        want = torch.zeros_like(blk)
        part = x[:, r0:r0 + blk.shape[1], c0:c0 + blk.shape[2]]
        want[:, :part.shape[1], :part.shape[2]] = part
        assert torch.equal(blk, want)


@pytest.mark.parametrize("spec", [rs.TIME, rs.SPACE, ("batch", "y", "x"), (None, None, "x"),
                                  (None, None, None)])
def test_reshard_between_any_two_specs(spec):
    mesh = _mesh(2, 2, 2)
    x = _rand((6, 21, 30), 2)
    for start in (rs.TIME, rs.SPACE, ("batch", "y", "x")):
        y = rs.reshard(rs.shard(x, mesh, start), mesh, spec)
        assert y.spec == spec and torch.equal(y.gather(), x)
    flat = rs.reshard(x[0], mesh, spec[1:])
    assert torch.equal(flat.gather(), x[0])
    with pytest.raises(ValueError, match="splits T over 'batch'"):
        rs.shard(x, mesh, ("y", None, None))


@pytest.mark.parametrize("direction", ["time_to_space", "space_to_time"])
def test_each_destination_receives_only_its_slices(direction, monkeypatch):
    mesh = _mesh(2, 2, 2)
    x = _rand((8, 30, 44), 3)
    src = rs.shard(x, mesh, rs.TIME if direction == "time_to_space" else rs.SPACE)
    moved: dict = {}
    real = rs.move

    def spy(dst, s):
        moved.setdefault(dst.device.type, []).append(dst.numel())
        real(dst, s)

    monkeypatch.setattr(rs, "move", spy)
    out = getattr(rs, direction)(src, mesh)
    block = out.layout.bl * out.layout.th * out.layout.tw
    assert max(moved["cpu"]) <= block
    assert sum(moved["cpu"]) == x.numel()  # every element once, no replica
    # one slice from each source block into each destination block
    assert len(moved["cpu"]) == len(src.blocks) * len(out.blocks)


def test_time_to_space_matches_reference():
    x = _rand((8, 32, 40), 4).numpy()
    rmesh = _ref_mesh(2, 2, 2)
    want = ref_reshard.time_to_space(jax.device_put(x, NamedSharding(rmesh, P("batch", None, None))),
                                     rmesh)
    got = rs.time_to_space(x, _mesh(2, 2, 2))
    assert np.array_equal(got.gather().numpy(), np.asarray(want))
    back = ref_reshard.space_to_time(want, rmesh)
    assert np.array_equal(rs.space_to_time(got, _mesh(2, 2, 2)).gather().numpy(), np.asarray(back))


@pytest.mark.parametrize("t", [8, 17])
def test_timesharded_pairs_match_reference(t):
    # T = 8 on 4 groups is the reference's even case; T = 17 pads to 20 and
    # covers its 16 pairs (the padded frames' pairs are invalid too).
    x = _rand((t, 12, 16), 5)
    mesh = _mesh(4, 1, 1)
    i1, i2, valid = rs.timesharded_pairs(rs.shard(x, mesh, rs.TIME))
    ok = valid.gather()
    assert int(ok.sum()) == t - 1
    assert torch.equal(i1.gather()[ok], x[:-1]) and torch.equal(i2.gather()[ok], x[1:])
    for g in range(4):
        assert valid.local((g, 0, 0)).device == mesh.devices[g, 0, 0]
    if t == 8:
        rmesh = _ref_mesh(4, 1, 1)
        fn = jax.jit(jax.shard_map(ref_reshard.timesharded_pairs, mesh=rmesh,
                                   in_specs=P("batch", None, None),
                                   out_specs=(P("batch", None, None), P("batch", None, None),
                                              P("batch")), check_vma=False))
        r1, r2, rv = fn(jax.device_put(x.numpy(), NamedSharding(rmesh, P("batch", None, None))))
        assert np.array_equal(i1.gather().numpy(), np.asarray(r1))
        assert np.array_equal(i2.gather().numpy(), np.asarray(r2))
        assert np.array_equal(ok.numpy(), np.asarray(rv))
    with pytest.raises(ValueError, match="sharded as"):
        rs.timesharded_pairs(rs.shard(x, mesh, rs.SPACE))


# -- sharded sums -----------------------------------------------------------------------


def _model_flow(h, w, tx, ty, om, sc, seed=0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    rng = np.random.default_rng(seed)
    u = tx + sc * (xx - cx) - om * (yy - cy) + rng.normal(0, 0.05, (h, w))
    v = ty + sc * (yy - cy) + om * (xx - cx) + rng.normal(0, 0.05, (h, w))
    return u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mshape,shape", [((1, 2, 4), (32, 64)), ((1, 4, 4), (67, 93)),
                                          ((1, 3, 1), (40, 50))])
def test_sharded_egomotion_equals_whole(mshape, shape, dtype):
    u, v = (torch.from_numpy(a).to(dtype) for a in _model_flow(*shape, 0.7, -0.2, 0.01, 0.003))
    mesh = _mesh(*mshape)
    spec = ("y", "x")
    got = estimate_egomotion(Flow(rs.shard(u, mesh, spec), rs.shard(v, mesh, spec)),
                             center=(10.0, 5.0), axis_names=("y", "x"))
    want = estimate_egomotion(Flow(u, v), center=(10.0, 5.0))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g.float(), w.float())
    assert got.tx.device == mesh.first


def test_sharded_egomotion_of_a_stack():
    # A (T, H, W) stack split over batch, y and x: one estimate a frame.
    f = [_model_flow(24, 40, 0.3 * k, -0.1 * k, 0.002 * k, 0.001, seed=k) for k in range(5)]
    u, v = (torch.from_numpy(np.stack([x[i] for x in f])) for i in (0, 1))
    mesh = _mesh(2, 2, 2)
    spec = ("batch", "y", "x")
    got = estimate_egomotion(Flow(rs.shard(u, mesh, spec), rs.shard(v, mesh, spec)),
                             axis_names=("y", "x"))
    want = estimate_egomotion(Flow(u, v))
    for g, w in zip(got, want):
        assert g.shape == (5,)
        for a, b in zip(g, w):
            _close(a, b)


def test_sharded_egomotion_matches_reference_shard_map():
    # The reference's test_egomotion_sharded_matches_unsharded form.
    u, v = _model_flow(32, 64, 0.7, -0.2, 0.01, 0.003)
    rmesh = _ref_mesh(1, 2, 4)

    def body(a, b):
        em = ref_egomotion(RefFlow(a, b), axis_names=("y", "x"),
                           global_offset=(jax.lax.axis_index("y") * 16,
                                          jax.lax.axis_index("x") * 16))
        return jnp.stack([em.tx, em.ty, em.omega, em.scale, em.residual])

    fn = jax.jit(jax.shard_map(body, mesh=rmesh, in_specs=(P("y", "x"), P("y", "x")),
                               out_specs=P()))
    sh = NamedSharding(rmesh, P("y", "x"))
    want = np.asarray(fn(jax.device_put(u, sh), jax.device_put(v, sh)))
    mesh = _mesh(1, 2, 4)
    got = estimate_egomotion(Flow(rs.shard(u, mesh, ("y", "x")), rs.shard(v, mesh, ("y", "x"))),
                             axis_names=("y", "x"))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("mshape,shape", [((1, 2, 2), (32, 40)), ((1, 4, 4), (67, 93)),
                                          ((2, 2, 2), (3, 37, 45))])
def test_sharded_energy_equals_whole(mshape, shape, variant):
    i1, i2 = _rand(shape, 6), _rand(shape, 7)
    u, v = _rand(shape, 8) - 0.5, _rand(shape, 9) - 0.5
    mesh = _mesh(*mshape)
    spec = ("batch", "y", "x") if len(shape) == 3 else ("y", "x")
    axes = ("batch", "y", "x") if len(shape) == 3 else ("y", "x")
    s = [rs.shard(a, mesh, spec) for a in (i1, i2, u, v)]
    got = hs_energy(s[0], s[1], Flow(s[2], s[3]), alpha=0.7, deriv_variant=variant,
                    axis_names=axes)
    want = hs_energy(i1, i2, Flow(u, v), alpha=0.7, deriv_variant=variant)
    assert got.device == mesh.first and got.dtype == torch.float32
    _close(got, want)


def test_sharded_sums_refusals():
    u = torch.zeros(16, 16)
    mesh = _mesh(1, 2, 2)
    with pytest.raises(TypeError, match="Sharded"):
        estimate_egomotion(Flow(u, u), axis_names=("y",))
    with pytest.raises(TypeError, match="Sharded"):
        hs_energy(u, u, Flow(u, u), axis_names=("y",), device="cpu")
    s = rs.shard(u, mesh, ("y", "x"))
    with pytest.raises(ValueError, match="must name every mesh axis"):
        estimate_egomotion(Flow(s, s), axis_names=("y",))
    with pytest.raises(ValueError, match="must name every mesh axis"):
        estimate_egomotion(Flow(s, s), axis_names=("batch", "y", "x"))
    with pytest.raises(ValueError, match="differ in layout"):
        estimate_egomotion(Flow(s, rs.shard(u, mesh, (None, "x"))), axis_names=("y", "x"))
    with pytest.raises(ValueError, match="differ in layout"):
        hs_energy(s, rs.shard(u, mesh, ("y", None)), Flow(s, s), axis_names=("y", "x"))
