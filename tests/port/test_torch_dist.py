"""The port's tiled solver (dist/, kernels/tile.py) against the JAX reference
on the CPU: the same numpy inputs go to both packages; the reference runs on
its 8 fake CPU devices (tests/conftest.py), the port on a mesh of 8 CPU
devices in one process.

Tolerances, each with its reason:
  * halo_pad, the labelled grid: exact (copies only).
  * masked stencils: 2e-6 (the reference's kernel-vs-oracle bar; same ops
    in the same order, XLA:CPU may fuse the last ulp differently).
  * tile_sweeps_plain against the reference's Pallas tile kernel (interpret
    mode): 2e-6 on the pixels a shard computes exactly (the padded shard
    shrunk by one ring a sweep; the reference rolls where the port clamps
    at the shard's own edge, so the decaying halo itself differs). SOR:
    1e-5, the ring shrinks four a sweep.
  * hs_solve_tiled: 2e-6 for Jacobi, 1e-5 for SOR against the reference's
    hs_solve_tiled; against the port's own untiled solve, bitwise (the same
    ops on the same values: tiled == untiled).
  * hs_pyramid_tiled: 1e-5 against the reference's (the pyramid bar of
    test_torch_slice.py), bitwise against the port's untiled hs_pyramid.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import opticalflowhs_tpu.config as ref_config
import opticalflowhs_tpu.dist as ref_dist
import opticalflowhs_tpu.kernels.jacobi as ref_jacobi
import opticalflowhs_tpu.kernels.sor as ref_sor
from opticalflowhs_tpu.ops import stencils as ref_st
from opticalflowhs_tpu_torch import HSConfig, PyramidConfig, hs_pyramid, hs_solve
from opticalflowhs_tpu_torch.batch import hs_solve_batched
from opticalflowhs_tpu_torch.config import MeshConfig
from opticalflowhs_tpu_torch.dist import halo as halo_mod
from opticalflowhs_tpu_torch.dist import (
    halo_pad,
    hs_pyramid_tiled,
    hs_solve_tiled,
    make_mesh,
    mesh_for_devices,
)
from opticalflowhs_tpu_torch.kernels import tile
from opticalflowhs_tpu_torch.ops import stencils

torch.set_num_threads(1)

SOLVE_TOL = 2e-6
SOR_TOL = 1e-5
PYRAMID_TOL = 1e-5
CPU8 = ["cpu"] * 8


def _record(record_property, d):
    record_property("max_abs_diff", d)
    return d


def _max_diff(a, b):
    return float(np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)).max())


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2))


def _grid_of(a: np.ndarray, my: int, mx: int):
    th, tw = a.shape[-2] // my, a.shape[-1] // mx
    return [[torch.from_numpy(a[..., i * th:(i + 1) * th, j * tw:(j + 1) * tw].copy())
             for j in range(mx)] for i in range(my)]


# -- halo exchange -------------------------------------------------------------------


def _labeled(h, w):
    return (np.arange(h)[:, None] * 1000.0 + np.arange(w)[None, :]).astype(np.float32)


@pytest.mark.parametrize("my,mx", [(1, 1), (2, 2), (2, 4), (4, 2), (1, 8)])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_halo_pad_matches_reference(my, mx, s):
    import jax

    h, w = 16 * my, 16 * mx
    g = _labeled(h, w)
    mesh = ref_dist.make_mesh(ref_config.MeshConfig(batch=1, y=my, x=mx))
    fn = jax.jit(jax.shard_map(lambda t: ref_dist.halo_pad(t, s)[None, None], mesh=mesh,
                               in_specs=P("y", "x"), out_specs=P("y", "x", None, None)))
    want = np.asarray(fn(jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("y", "x")))))
    got = halo_pad(_grid_of(g, my, mx), s)
    for i in range(my):
        for j in range(mx):
            np.testing.assert_array_equal(got[i][j].numpy(), want[i, j])


def test_pad_grid_one_axis_and_stacks():
    # (sy, 0): rows only, as the rdma path pads a row-decomposed mesh; a
    # (B, th, tw) stack pads each image alike.
    g = np.stack([_labeled(32, 24), -_labeled(32, 24)])
    got = halo_mod.pad_grid(_grid_of(g, 4, 1), 3, 0)
    gpad = np.pad(g, ((0, 0), (3, 3), (0, 0)), mode="edge")
    for i in range(4):
        np.testing.assert_array_equal(got[i][0].numpy(), gpad[:, i * 8:i * 8 + 14])
    with pytest.raises(ValueError, match="exceeds"):
        halo_mod.pad_grid(_grid_of(g, 4, 1), 9, 0)


# -- masked stencils --------------------------------------------------------------------


@pytest.mark.parametrize("origin", [(-3, -5), (7, 11), (20, -2)])
def test_masked_stencils_match_reference(origin, record_property):
    rng = np.random.default_rng(3)
    shape, h, w = (24, 31), 40, 36
    u, v, ex, ey, et = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(5))
    invd = (1.0 / (0.25 + ex * ex + ey * ey)).astype(np.float32)
    gr = origin[0] + np.arange(shape[0])[:, None] + np.zeros(shape, np.int64)
    gc = origin[1] + np.arange(shape[1])[None, :] + np.zeros(shape, np.int64)
    rm = ref_st.edge_masks(jnp.asarray(gr), jnp.asarray(gc), h, w)
    pm = stencils.edge_masks(torch.from_numpy(gr), torch.from_numpy(gc), h, w)
    for a, b in zip(rm, pm):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    t = [torch.from_numpy(a) for a in (u, v, ex, ey, et, invd)]
    j = [jnp.asarray(a) for a in (u, v, ex, ey, et, invd)]
    d = _max_diff(stencils.neighbor_avg_masked(t[0], pm), ref_st.neighbor_avg_masked(j[0], rm))
    d = max(d, *(_max_diff(a, b) for a, b in zip(
        stencils.jacobi_step_masked(*t, pm), ref_st.jacobi_step_masked(*j, rm))))
    colors_p = stencils.global_colors(torch.from_numpy(gr), torch.from_numpy(gc))
    colors_r = tuple((jnp.asarray(gr) % 2 == pi) & (jnp.asarray(gc) % 2 == pj)
                     for pi in (0, 1) for pj in (0, 1))
    d = max(d, *(_max_diff(a, b) for a, b in zip(
        stencils.sor_step_masked(*t, 1.6, colors_p, pm),
        ref_st.sor_step_masked(*j, 1.6, colors_r, rm))))
    for variant in ("hs_cube", "central"):
        d = max(d, *(_max_diff(a, b) for a, b in zip(
            stencils.derivatives_masked(t[2], t[3], pm, variant),
            ref_st.derivatives_masked(j[2], j[3], rm, variant))))
    assert _record(record_property, d) <= SOLVE_TOL


# -- K9's plain versions against the reference's Pallas tile kernels -----------------


def _tile_problem(shape, seed):
    rng = np.random.default_rng(seed)
    i1, i2 = (rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2))
    ex, ey, et = ref_st.derivatives(jnp.asarray(i1), jnp.asarray(i2))
    invd = 1.0 / (0.25 + ex * ex + ey * ey)
    u, v = (rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(2))
    return [np.asarray(a) for a in (u, v, ex, ey, et, invd)]


@pytest.mark.parametrize("origin", [(-3, -5), (17, 129), (-4, 33), (45, -1)])
@pytest.mark.parametrize("sor", [False, True])
def test_tile_sweeps_plain_matches_reference_kernel(origin, sor, record_property):
    shape, h, w, n = (40, 72), 80, 200, 3
    arrs = _tile_problem(shape, 9)
    t = [torch.from_numpy(a.copy()) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    if sor:
        got = tile.sor_tile_sweeps(*t, n, 1.6, tile.origin_table(t[0], *origin), h, w)
        want = ref_sor.sor_tile_sweeps(*j, n, 1.6, *origin, h, w, interpret=True)
        ring = 4 * n
    else:
        got = tile.tile_sweeps(*t, n, tile.origin_table(t[0], *origin), h, w)
        want = ref_jacobi.tile_sweeps(*j, n, *origin, h, w, interpret=True)
        ring = n
    exact = (slice(ring, -ring), slice(ring, -ring))
    d = max(_max_diff(got[k].numpy()[exact], np.asarray(want[k])[exact]) for k in (0, 1))
    assert _record(record_property, d) <= (SOR_TOL if sor else SOLVE_TOL)


@pytest.mark.parametrize("sor", [False, True])
def test_tile_sweeps_stack_equals_slices(sor):
    # Per-slice origins: one call on a stack = one call per slice.
    arrs = [np.stack([a, a[::-1].copy(), -a]) for a in _tile_problem((30, 41), 10)]
    t = [torch.from_numpy(a) for a in arrs]
    rows, cols = [-4, 13, 50], [-3, 0, 27]
    args = (4, 1.6) if sor else (4,)
    fn = tile.sor_tile_sweeps if sor else tile.tile_sweeps
    got = fn(*t, *args, tile.origin_table(t[0], rows, cols), 70, 60)
    for k in range(3):
        one = fn(*(a[k] for a in t), *args, tile.origin_table(t[0][k], rows[k], cols[k]), 70, 60)
        assert torch.equal(got[0][k], one[0]) and torch.equal(got[1][k], one[1])


# -- hs_solve_tiled ------------------------------------------------------------------------


def _ref_tiled(i1, i2, cfg_kwargs, mesh_shape, s):
    mesh = ref_dist.make_mesh(ref_config.MeshConfig(*mesh_shape))
    return ref_dist.hs_solve_tiled(jnp.asarray(i1), jnp.asarray(i2),
                                   ref_config.HSConfig(backend="jnp", **cfg_kwargs),
                                   mesh=mesh, halo_sweeps=s)


TILED_CASES = [
    # shape, mesh (batch, y, x), halo_sweeps, config
    ((37, 115), (1, 2, 4), 1, dict(alpha=0.5, iters=12)),
    ((63, 61), (1, 8, 1), 3, dict(alpha=0.5, iters=13)),
    ((64, 96), (1, 1, 8), 2, dict(alpha=0.5, iters=12)),
    ((67, 93), (1, 2, 2), 5, dict(alpha=1.0, iters=17)),
    ((63, 61), (1, 1, 1), 3, dict(alpha=0.5, iters=10, deriv_variant="central")),
    ((64, 96), (1, 2, 4), 3, dict(alpha=0.5, iters=40, tol=1e-3)),
    ((64, 96), (1, 2, 2), 1, dict(alpha=0.5, iters=9, solver="sor", omega=1.6)),
    ((67, 93), (1, 2, 2), 2, dict(alpha=0.5, iters=7, solver="sor", omega=1.7)),
    ((67, 93), (1, 2, 2), 1, dict(alpha=0.5, iters=30, solver="sor", omega=1.6, tol=1e-3)),
    ((4, 64, 96), (2, 2, 2), 2, dict(alpha=0.5, iters=12)),
    ((4, 64, 96), (2, 2, 2), 3, dict(alpha=0.5, iters=30, tol=2e-3)),
]


@pytest.mark.parametrize("shape,mesh_shape,s,kw", TILED_CASES,
                         ids=[f"{c[0]}-{c[1]}-s{c[2]}-{c[3].get('solver', 'jacobi')}"
                              f"{'-tol' if c[3].get('tol') else ''}" for c in TILED_CASES])
def test_hs_solve_tiled_matches_reference(shape, mesh_shape, s, kw, record_property):
    i1, i2 = _frames(shape, 5)
    if len(shape) == 3:  # one image of the stack converges at the first check
        i2[1] = i1[1]
    cfg = HSConfig(**kw)
    mesh = make_mesh(MeshConfig(*mesh_shape), CPU8)
    got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=s)
    want = _ref_tiled(i1, i2, kw, mesh_shape, s)
    assert got.u.shape == shape and got.u.device.type == "cpu"
    d = max(_max_diff(got.u, want.u), _max_diff(got.v, want.v))
    assert _record(record_property, d) <= (SOR_TOL if cfg.solver == "sor" else SOLVE_TOL)
    t1, t2 = torch.from_numpy(i1), torch.from_numpy(i2)
    # To tolerance the untiled solve checks every block_sweeps sweeps, the
    # tiled one every halo block: the same cadence gives the same stop.
    ucfg = dataclasses.replace(cfg, block_sweeps=s) if cfg.tol > 0 else cfg
    untiled = (hs_solve_batched if len(shape) == 3 else hs_solve)(t1, t2, ucfg)
    assert torch.equal(got.u, untiled.u) and torch.equal(got.v, untiled.v)


@pytest.mark.parametrize("mesh_shape", [(1, 1, 1), (1, 4, 1), (1, 8, 1), (1, 2, 2),
                                        (1, 1, 4), (1, 2, 4), (2, 2, 2)])
@pytest.mark.parametrize("s", [1, 4])
def test_rdma_on_cpu_shards_equals_untiled(mesh_shape, s):
    # The reference refuses rdma off the TPU; here CPU shards run the ring
    # kernels' plain versions (K11 on (y, 1) meshes, K12 otherwise).
    shape = (4, 67, 93) if mesh_shape[0] > 1 else (67, 93)
    i1, i2 = (torch.from_numpy(a) for a in _frames(shape, 6))
    cfg = HSConfig(alpha=0.5, iters=11)
    mesh = make_mesh(MeshConfig(*mesh_shape), CPU8)
    got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=s, halo_impl="rdma")
    want = (hs_solve_batched if len(shape) == 3 else hs_solve)(i1, i2, cfg)
    assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)


def test_tiled_on_a_repeated_device_equals_distinct_devices():
    # A virtual mesh (one device repeated) and the tests' 8-device mesh run
    # the same decomposition.
    i1, i2 = (torch.from_numpy(a) for a in _frames((37, 115), 7))
    cfg = HSConfig(alpha=0.5, iters=9)
    a = hs_solve_tiled(i1, i2, cfg, make_mesh(MeshConfig(y=2, x=4), CPU8), halo_sweeps=2)
    b = hs_solve_tiled(i1, i2, cfg, make_mesh(MeshConfig(y=2, x=4), [torch.device("cpu")] * 8),
                       halo_sweeps=2)
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)


# -- hs_pyramid_tiled ---------------------------------------------------------------------


def test_hs_pyramid_tiled_matches_reference(record_property):
    rng = np.random.default_rng(8)
    i1 = rng.uniform(0, 1, (67, 93)).astype(np.float32)
    i2 = np.roll(i1, (1, 2), axis=(0, 1))
    cfg = HSConfig(alpha=1.0, iters=15)
    pyr = PyramidConfig(levels=2)
    mesh = make_mesh(MeshConfig(y=2, x=2, halo_sweeps=4), CPU8)
    got = hs_pyramid_tiled(i1, i2, cfg, pyr, mesh, halo_sweeps=4)
    rmesh = ref_dist.make_mesh(ref_config.MeshConfig(y=2, x=2))
    want = ref_dist.hs_pyramid_tiled(jnp.asarray(i1), jnp.asarray(i2),
                                     ref_config.HSConfig(alpha=1.0, iters=15, backend="jnp"),
                                     ref_config.PyramidConfig(levels=2), mesh=rmesh,
                                     halo_sweeps=4)
    d = max(_max_diff(got.u, want.u), _max_diff(got.v, want.v))
    assert _record(record_property, d) <= PYRAMID_TOL
    untiled = hs_pyramid(torch.from_numpy(i1), torch.from_numpy(i2), cfg, pyr)
    assert torch.equal(got.u, untiled.u) and torch.equal(got.v, untiled.v)


@pytest.mark.parametrize("kw", [dict(solver="sor", omega=0.0, iters=8),
                                dict(iters=6, tol=1e-2, block_sweeps=2), dict(iters=10)])
def test_hs_pyramid_tiled_equals_untiled(kw):
    # omega = 0 tunes omega on the pair first, as hs_pyramid does, and the
    # coarsest level's 8 x 12 shards clamp SOR's halo to one sweep; a stack
    # splits over the batch axis (tol: the untiled check cadence is
    # block_sweeps, the tiled one halo_sweeps). Stacks warp with the gather on the tiled
    # path (the reference's rule for 3-D frames), so the batched pyramid is
    # asked for the gather too.
    i1, i2 = (torch.from_numpy(a) for a in _frames((2, 64, 96), 12))
    cfg = HSConfig(alpha=1.0, **kw)
    pyr = PyramidConfig(levels=3, warp="gather")
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2), CPU8)
    pairs = (i1[0], i2[0]) if cfg.omega == 0.0 else (i1, i2)
    got = hs_pyramid_tiled(*pairs, cfg, pyr, mesh, halo_sweeps=2)
    want = (hs_pyramid(*pairs, cfg, pyr) if pairs[0].ndim == 2
            else hs_solve_batched(*pairs, cfg, pyr))
    assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)


# -- errors, the mesh, the fault hook ----------------------------------------------------------


def _errors(mod, cfg_mod, mesh, frames):
    i1, i2 = frames
    return [
        lambda: mod.hs_solve_tiled(i1, i2, cfg_mod.HSConfig(iters=4)),
        lambda: mod.hs_solve_tiled(i1, i2, cfg_mod.HSConfig(iters=4), mesh=mesh, halo_sweeps=100),
        lambda: mod.hs_solve_tiled(i1, i2, cfg_mod.HSConfig(iters=4), mesh=mesh, halo_sweeps=0),
        lambda: mod.hs_solve_tiled(i1, i2, cfg_mod.HSConfig(iters=4), mesh=mesh, halo_impl="nccl"),
        lambda: mod.hs_solve_tiled(i1, i2, cfg_mod.HSConfig(solver="sor", omega=0.0), mesh=mesh),
        lambda: mod.hs_solve_tiled(i1, i2, cfg_mod.HSConfig(solver="sor", omega=1.5), mesh=mesh,
                                   halo_impl="rdma"),
        lambda: mod.hs_solve_tiled(i1, i2, cfg_mod.HSConfig(tol=1e-3), mesh=mesh,
                                   halo_impl="rdma"),
        lambda: mod.hs_solve_tiled(i1, i2, cfg_mod.HSConfig(solver="robust"), mesh=mesh,
                                   halo_impl="rdma"),
        lambda: mod.hs_solve_tiled(np.stack([i1] * 3), np.stack([i2] * 3),
                                   cfg_mod.HSConfig(iters=4), mesh=mesh),
        lambda: mod.hs_pyramid_tiled(i1, i2),
        lambda: mod.hs_pyramid_tiled(i1, i2[:, :-1], mesh=mesh),
        lambda: mod.hs_pyramid_tiled(np.stack([i1] * 2), np.stack([i2] * 2),
                                     cfg_mod.HSConfig(solver="sor", omega=0.0), mesh=mesh),
    ]


@pytest.mark.parametrize("k", range(12))
def test_validation_errors_match_reference(k):
    frames = _frames((32, 64), 1)
    ref_mesh = ref_dist.make_mesh(ref_config.MeshConfig(batch=2, y=2, x=2))
    port_mesh = make_mesh(MeshConfig(batch=2, y=2, x=2), CPU8)
    import opticalflowhs_tpu_torch.config as port_config
    import opticalflowhs_tpu_torch.dist as port_dist
    with pytest.raises(ValueError) as ref_err:
        _errors(ref_dist, ref_config, ref_mesh, frames)[k]()
    with pytest.raises(ValueError) as port_err:
        _errors(port_dist, port_config, port_mesh, frames)[k]()
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("solver", ["robust", "multigrid"])
def test_gspmd_routes_raise_not_implemented(solver):
    i1, i2 = _frames((32, 64), 2)
    mesh = make_mesh(MeshConfig(y=2, x=2), CPU8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hs_solve_tiled(i1, i2, HSConfig(solver=solver), mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hs_pyramid_tiled(i1, i2, HSConfig(solver=solver), PyramidConfig(levels=2), mesh)


def test_mesh_construction(monkeypatch):
    assert mesh_for_devices(8).shape == (1, 2, 4)
    assert mesh_for_devices(8, batch=2).shape == (2, 2, 2)
    assert mesh_for_devices(1).shape == (1, 1, 1)
    with pytest.raises(ValueError):
        mesh_for_devices(8, batch=3)
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2), CPU8)
    assert mesh.axis_names == ("batch", "y", "x")
    assert mesh.shape == {"batch": 2, "y": 2, "x": 2}
    assert mesh.first == torch.device("cpu") and mesh.devices.shape == (2, 2, 2)
    with pytest.raises(ValueError, match="needs 32 devices, have 8"):
        make_mesh(MeshConfig(batch=2, y=4, x=4), CPU8)
    # By default the mesh takes the CUDA devices, and there are none here.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        make_mesh(MeshConfig())
    with pytest.raises(ValueError, match="CPU devices or CUDA devices"):
        make_mesh(MeshConfig(x=2), ["cpu", "meta"])


def test_backend_cuda_on_cpu_shards_raises():
    i1, i2 = _frames((32, 64), 3)
    mesh = make_mesh(MeshConfig(y=2, x=2), CPU8)
    for impl in ("ppermute", "rdma"):
        with pytest.raises(ValueError, match="backend='cuda'"):
            hs_solve_tiled(i1, i2, HSConfig(iters=2, backend="cuda"), mesh, halo_impl=impl)


def test_fault_hook_corrupts_the_result():
    i1, i2 = (torch.from_numpy(a) for a in _frames((32, 64), 4))
    cfg = HSConfig(alpha=0.5, iters=6)
    mesh = make_mesh(MeshConfig(y=2, x=2), CPU8)
    clean = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=2)
    halo_mod.set_fault_hook(lambda t: t + 1.0)
    try:
        bad = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=2)
    finally:
        halo_mod.set_fault_hook(None)
    assert float((bad.u - clean.u).abs().max()) > 1e-3
    again = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=2)
    assert torch.equal(again.u, clean.u)


def test_replicate_global_edges_matches_edge_padding():
    g = _labeled(16, 24)
    padded = halo_pad(_grid_of(g, 2, 2), 2)
    for row in padded:  # garble every halo, then re-assert the global edges
        for t in row:
            t[..., :2, :] = -1.0
            t[..., -2:, :] = -1.0
            t[..., :, :2] = -1.0
            t[..., :, -2:] = -1.0
    halo_mod.replicate_global_edges(padded, 2)
    gpad = np.pad(g, 2, mode="edge")
    np.testing.assert_array_equal(padded[0][0].numpy()[:2, :-2], gpad[:2, :12 + 2])
    np.testing.assert_array_equal(padded[1][1].numpy()[-2:, 2:], gpad[-2:, 14:])
    assert float(padded[0][0][-1, 5]) == -1.0  # a halo facing another shard stays
