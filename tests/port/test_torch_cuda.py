"""K1-K12 and the whole-solve drivers on a CUDA card against their
plain versions on the same card, at edge-case shapes (partial tiles, frames
narrower or shorter than a tile, one row, one column; for K2 and K9 also
those of K2's window, warps and lanes, every sweeps per launch, and
shard edges at warp and lane boundaries; for K3 and K4 those of their
own windows at every sweeps per launch, with the launches their plans make; for K5 every alternations per
launch, and its geometry without spills) and sweep counts that the sweeps
per launch do not divide; single frames and (B, H, W)
stacks, where each image of a batched launch must equal the single-frame
kernel on that image; the launch counts; and the single, batched and
streaming entry points with the Jacobi, SOR and IRLS solvers and with
TV-L1; K6 and K7 (the persistent whole-solve kernels) at small forced
geometries, the routes of `hs_solve` into them, and their failures; K8
(the SOR solve on parity planes) against the plain planes, the plain SOR
sweeps and the K1 + K3 chain at every parity of h and w; multigrid on the
card (K1, then the plain V-cycles); K9 (shard sweeps keyed to a global
origin) and K10-K12 (the ring exchange and fused ring solves) on virtual
meshes of one card, the tiled solver there against the untiled solve, the
refusals of a mixed mesh and of a grid too large to be resident;
gradients through every kernel entry (= the plain twin's) and the guard
of the parts without a scheme; and Lucas-Kanade, the ego-motion fit
and hs_energy, which launch no kernel, against their CPU runs.

Marked `cuda`: they skip without a card. They import no JAX, so on a
machine without it they run with the repository's conftest left out:

    python -m pytest --noconftest -p no:randomly -q -m cuda tests/port/test_torch_cuda.py

Tolerance: 0.0. The kernels are built without FMA contraction and keep
the plain ops' association order, so they equal the plain versions bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from opticalflowhs_tpu_torch import (
    Flow,
    HSConfig,
    LKConfig,
    PyramidConfig,
    TVL1Config,
    flow_stream,
    flow_stream_warm,
    flow_with_occlusion,
    hs_pyramid,
    hs_solve,
    hs_solve_batched,
    lk_solve,
    lk_solve_batched,
    tvl1_solve,
    tvl1_solve_batched,
)
from opticalflowhs_tpu_torch import robust
from opticalflowhs_tpu_torch import tvl1 as tv
from opticalflowhs_tpu_torch.consistency import solve_bidirectional
from opticalflowhs_tpu_torch.data.synthetic import synthetic_sequence, translation_pair
from opticalflowhs_tpu_torch.egomotion import estimate_egomotion
from opticalflowhs_tpu_torch.kernels import counted_wrappers
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import solve_fused as k6
from opticalflowhs_tpu_torch.kernels import solve_resident as sr
from opticalflowhs_tpu_torch.kernels import solve_robust as k4
from opticalflowhs_tpu_torch.kernels import solve_skewed as k7
from opticalflowhs_tpu_torch.kernels import sor as k3
from opticalflowhs_tpu_torch.kernels import sor_planes as k8
from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5
from opticalflowhs_tpu_torch.metrics import hs_energy
from opticalflowhs_tpu_torch.solver import tune_omega
from opticalflowhs_tpu_torch.video import flow_stream_occlusion

pytestmark = pytest.mark.cuda

SHAPES = [(67, 93), (1, 7), (9, 1), (5, 300), (300, 5), (130, 129)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(shape, dev, seed, n=2, normal=False):
    rng = np.random.default_rng(seed)
    make = (lambda: rng.normal(0, 0.5, shape)) if normal else (lambda: rng.uniform(0, 1, shape))
    return [torch.from_numpy(make().astype(np.float32)).to(dev) for _ in range(n)]


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("zero_sweep", [False, True])
def test_k1_equals_plain(dev, shape, variant, zero_sweep):
    i1, i2 = _rand(shape, dev, 0)
    _equal(k1.hs_derivatives(i1, i2, 0.7, variant, zero_sweep),
           k1.derivatives_plain(i1, i2, 0.7, variant, zero_sweep))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n,s", [(1, 0), (5, 2), (13, 0), (17, 10), (9, 1)])
def test_k2_equals_plain(dev, shape, n, s):
    i1, i2 = _rand(shape, dev, 1)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand(shape, dev, 2, normal=True)
    keep = (u0.clone(), v0.clone())
    _equal(k2.jacobi_sweeps(u0, v0, *fields, n, block_sweeps=s),
           k2.jacobi_sweeps_plain(u0, v0, *fields, n))
    _equal((u0, v0), keep)  # inputs untouched


# K2's own geometry (48 x 128 windows, a warp spanning 128 columns, lanes of
# 4 columns, 3 rows a warp): frames narrower than a lane, a warp or a tile,
# of 1-3 rows, a last tile of one column (w = 113 at s = 8), one column.
K2_EDGE_SHAPES = [(1, 1), (2, 7), (3, 31), (1, 32), (2, 33), (3, 63), (5, 65), (9, 129),
                  (33, 113), (40, 1)]


@pytest.mark.parametrize("shape", K2_EDGE_SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("s", range(1, 13))
def test_k2_edge_shapes_equal_plain(dev, shape, b, s):
    full = shape if b == 1 else (b,) + shape
    i1, i2 = _rand(full, dev, 90)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand(full, dev, 91, normal=True)
    n = 2 * k2.sweeps_per_launch(s) + 1  # s does not divide n
    _equal(k2.jacobi_sweeps(u0, v0, *fields, n, block_sweeps=s),
           k2.jacobi_sweeps_plain(u0, v0, *fields, n))


@pytest.mark.parametrize("w", [64, 93])
def test_k2_unaligned_views_equal_plain(dev, w):
    # Contiguous views 4 bytes off a 16-byte boundary take the 4-byte copies.
    h = 50
    flat = [torch.from_numpy(np.random.default_rng(92 + k).normal(0, 0.5, 1 + h * w)
                             .astype(np.float32)).to(dev) for k in range(4)]
    u0, v0, i1, i2 = (f[1:].view(h, w) for f in flat)
    fields = k1.derivatives_plain(i1.abs(), i2.abs(), 0.5)
    _equal(k2.jacobi_sweeps(u0, v0, *fields, 11), k2.jacobi_sweeps_plain(u0, v0, *fields, 11))


def test_k2_geometry_on_the_card(dev):
    geo = k2.k2_geometry(dev)
    th, tw, _ = k2.k2_tile(k2.sweeps_per_launch(0))
    assert (geo["tile_h"], geo["tile_w"]) == (th, tw)
    assert geo["threads"] == k2.K2_THREADS and geo["smem_bytes"] == k2.K2_SMEM_BYTES
    assert 0 < geo["registers"] <= 65536 // k2.K2_THREADS and geo["blocks_per_sm"] >= 1


def test_k2_launch_counts_on_the_main_paths(dev):
    i1, i2 = _rand((96, 128), dev, 93)
    cfg = HSConfig(alpha=0.5, iters=100)
    for run, want in ((lambda: hs_solve(i1, i2, cfg), (1, 13)),
                      (lambda: hs_pyramid(i1, i2, cfg, PyramidConfig(levels=3)), (3, 39)),
                      (lambda: hs_solve_batched(torch.stack([i1, i2, i1]),
                                                torch.stack([i2, i1, i2]), cfg), (1, 13))):
        k1.hs_derivatives.launches = 0
        k2.jacobi_sweeps.launches = 0
        run()
        assert (k1.hs_derivatives.launches, k2.jacobi_sweeps.launches) == want


@pytest.mark.parametrize("shape", [(67, 93), (200, 333)])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("n", [1, 2, 9, 30])
def test_driver_equals_plain(dev, shape, warm, n):
    i1, i2 = _rand(shape, dev, 3)
    init = _rand(shape, dev, 4, normal=True) if warm else (None, None)
    _equal(sr.hs_solve_resident(i1, i2, 0.5, n, "hs_cube", *init),
           sr.hs_solve_resident_plain(i1, i2, 0.5, n, "hs_cube", *init))


def test_entry_points_run_the_kernels(dev):
    i1, i2 = _rand((96, 128), dev, 5)
    k1.hs_derivatives.launches = 0
    k2.jacobi_sweeps.launches = 0
    got = hs_solve(i1, i2, HSConfig(alpha=0.5, iters=20))
    assert k1.hs_derivatives.launches == 1
    assert k2.jacobi_sweeps.launches == -(-19 // k2.sweeps_per_launch(0))
    _equal(got, hs_solve(i1, i2, HSConfig(alpha=0.5, iters=20, backend="torch")))
    k1.hs_derivatives.launches = 0
    got = hs_pyramid(i1, i2, HSConfig(alpha=1.0, iters=10), PyramidConfig(levels=3))
    assert k1.hs_derivatives.launches == 3
    _equal(got, hs_pyramid(i1, i2, HSConfig(alpha=1.0, iters=10, backend="torch"),
                           PyramidConfig(levels=3)))


def test_wrappers_reject_bad_cuda_tensors(dev):
    i1, i2 = _rand((16, 16), dev, 6)
    with pytest.raises(ValueError):
        k1.hs_derivatives(i1.double(), i2.double(), 0.5)
    with pytest.raises(ValueError):
        k1.hs_derivatives(i1, i2.cpu(), 0.5)
    with pytest.raises(ValueError):
        k2.jacobi_sweeps(i1.t(), i2, i1, i1, i1, i1, 3)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("zero_sweep", [False, True])
def test_k1_batched_equals_plain(dev, shape, b, variant, zero_sweep):
    i1, i2 = _rand((b,) + shape, dev, 7)
    got = k1.hs_derivatives(i1, i2, 0.7, variant, zero_sweep)
    _equal(got, k1.derivatives_plain(i1, i2, 0.7, variant, zero_sweep))
    for k in range(b):
        _equal([g[k] for g in got], k1.hs_derivatives(i1[k], i2[k], 0.7, variant, zero_sweep))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n,s", [(1, 0), (13, 0), (17, 10)])
def test_k2_batched_equals_plain(dev, shape, b, n, s):
    i1, i2 = _rand((b,) + shape, dev, 8)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand((b,) + shape, dev, 9, normal=True)
    got = k2.jacobi_sweeps_batched(u0, v0, *fields, n, block_sweeps=s)
    _equal(got, k2.jacobi_sweeps_batched_plain(u0, v0, *fields, n))
    for k in range(b):
        one = k2.jacobi_sweeps(u0[k], v0[k], *(f[k] for f in fields), n, block_sweeps=s)
        _equal([g[k] for g in got], one)


@pytest.mark.parametrize("shape", [(67, 93), (200, 333)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 30])
def test_batched_driver_equals_plain(dev, shape, b, n):
    i1, i2 = _rand((b,) + shape, dev, 10)
    _equal(sr.hs_solve_resident_batched(i1, i2, 0.5, n),
           sr.hs_solve_resident_batched_plain(i1, i2, 0.5, n))


def test_batched_entry_points_run_the_kernels(dev):
    i1, i2 = _rand((4, 96, 128), dev, 11)
    cfg = HSConfig(alpha=0.5, iters=20)
    plain = HSConfig(alpha=0.5, iters=20, backend="torch")
    k1.hs_derivatives.launches = 0
    k2.jacobi_sweeps.launches = 0
    got = hs_solve_batched(i1, i2, cfg)
    assert k1.hs_derivatives.launches == 1
    assert k2.jacobi_sweeps.launches == -(-19 // k2.sweeps_per_launch(0))
    _equal(got, hs_solve_batched(i1, i2, plain))
    tol = HSConfig(alpha=0.5, iters=64, tol=1e-3, block_sweeps=8)
    _equal(hs_solve_batched(i1, i2, tol),
           hs_solve_batched(i1, i2, HSConfig(alpha=0.5, iters=64, tol=1e-3,
                                             block_sweeps=8, backend="torch")))
    _equal(hs_solve(i1[0], i2[0], tol), hs_solve(i1[0], i2[0], HSConfig(
        alpha=0.5, iters=64, tol=1e-3, block_sweeps=8, backend="torch")))
    pyr = PyramidConfig(levels=2)
    _equal(hs_solve_batched(i1, i2, cfg, pyr), hs_solve_batched(i1, i2, plain, pyr))


def test_streams_default_to_the_card(dev):
    vid = np.random.default_rng(12).uniform(0, 1, (6, 64, 96)).astype(np.float32)
    cfg = HSConfig(alpha=0.5, iters=10)
    chunks = list(flow_stream(vid, cfg, chunk=4))
    assert [c.u.shape[0] for c in chunks] == [4, 1]
    assert chunks[0].u.device.type == "cuda"
    whole = hs_solve_batched(torch.from_numpy(vid).to(dev)[:-1],
                             torch.from_numpy(vid).to(dev)[1:], cfg)
    _equal((torch.cat([c.u for c in chunks]), torch.cat([c.v for c in chunks])), whole)
    warm = list(flow_stream_warm(vid, cfg, chunk=2, warp_prior=True))
    plain = list(flow_stream_warm(vid, HSConfig(alpha=0.5, iters=10, backend="torch"),
                                  chunk=2, warp_prior=True))
    for a, b in zip(warm, plain):
        _equal(a, b)


# -- K3 (4-color SOR) and K4 (IRLS freeze and sweeps) ------------------------


def _k3_launches(shape, n, s, dev):
    """K3 launches of n sweeps at block_sweeps s: K3's plan for the shape."""
    return k3.launches(n, k3.sweeps_per_launch(s, shape, n, k3.device_blocks(dev)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n,s", [(1, 0), (5, 2), (9, 1), (13, 0), (7, 3), (6, 4), (23, 11),
                                 (17, 8), (12, 5), (25, 12)])
def test_k3_equals_plain(dev, shape, b, n, s):
    i1, i2 = _rand((b,) + shape, dev, 13)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand((b,) + shape, dev, 14, normal=True)
    keep = (u0.clone(), v0.clone())
    k3.sor_sweeps.launches = 0
    got = k3.sor_sweeps(u0, v0, *fields, n, 1.7, block_sweeps=s)
    assert k3.sor_sweeps.launches == _k3_launches(u0.shape, n, s, dev)
    _equal(got, k3.sor_sweeps_plain(u0, v0, *fields, n, 1.7))
    _equal((u0, v0), keep)  # inputs untouched
    for k in range(b):
        one = k3.sor_sweeps(u0[k], v0[k], *(f[k] for f in fields), n, 1.7, block_sweeps=s)
        _equal([g[k] for g in got], one)


@pytest.mark.parametrize("shape", [(67, 93), (200, 333)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_sor_driver_equals_plain(dev, shape, b, warm, variant):
    i1, i2 = _rand((b,) + shape, dev, 15)
    init = _rand((b,) + shape, dev, 16, normal=True) if warm else (None, None)
    k1.hs_derivatives.launches = 0
    k3.sor_sweeps.launches = 0
    got = sr.hs_solve_resident_sor(i1, i2, 0.5, 11, 1.6, variant, *init)
    assert (k1.hs_derivatives.launches, k3.sor_sweeps.launches) == (
        1, _k3_launches(i1.shape, 11, 0, dev))
    _equal(got, sr.hs_solve_resident_sor_plain(i1, i2, 0.5, 11, 1.6, variant, *init))


# K3's own geometry (48 x 128 windows, tiles less 2s rows and 4s columns of
# halo, warps of 4 rows, lanes of 4 columns): frames one pixel below and
# above one and two tiles at every s, stacks, zero and warm starts.
def _k3_edge_shape(s, kind):
    th, tw, _, _ = k3.k3_tile(s)
    return {"one-": (th - 1, tw - 1), "one+": (th + 1, tw + 1),
            "two-": (2 * th - 1, 2 * tw - 1), "two+": (2 * th + 1, 2 * tw + 1)}[kind]


@pytest.mark.parametrize("s", range(1, k3.K3_MAX_SWEEPS + 1))
@pytest.mark.parametrize("kind", ["one-", "one+", "two-", "two+"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k3_tile_edge_shapes_equal_plain(dev, s, kind, b, warm):
    full = (b,) + _k3_edge_shape(s, kind)
    i1, i2 = _rand(full, dev, 100 + s)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand(full, dev, 101, normal=True) if warm else (torch.zeros(full, device=dev),) * 2
    n = 2 * s + 1  # s does not divide n
    k3.sor_sweeps.launches = 0
    got = k3.sor_sweeps(u0, v0, *fields, n, 1.7, block_sweeps=s)
    assert k3.sor_sweeps.launches == k3.launches(n, s)
    _equal(got, k3.sor_sweeps_plain(u0, v0, *fields, n, 1.7))


@pytest.mark.parametrize("s", range(1, k3.K3_MAX_SWEEPS + 1))
@pytest.mark.parametrize("w", [96, 93])
def test_k3_unaligned_views_equal_plain(dev, s, w):
    # Contiguous views 4 bytes off a 16-byte boundary take the 4-byte copies.
    h = 50
    flat = [torch.from_numpy(np.random.default_rng(102 + k).normal(0, 0.5, 1 + 2 * h * w)
                             .astype(np.float32)).to(dev) for k in range(4)]
    u0, v0, i1, i2 = (f[1:].view(2, h, w) for f in flat)
    fields = k1.derivatives_plain(i1.abs(), i2.abs(), 0.5)
    n = s + 2
    _equal(k3.sor_sweeps(u0, v0, *fields, n, 1.7, block_sweeps=s),
           k3.sor_sweeps_plain(u0, v0, *fields, n, 1.7))


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("s", [1, 4, k3.K3_MAX_SWEEPS])
def test_k3_geometry_on_the_card(dev, shard, s):
    geo = k3.k3_geometry(dev, s, shard)
    th, tw, _, _ = k3.k3_tile(s)
    assert (geo["sweeps"], geo["tile_h"], geo["tile_w"]) == (s, th, tw)
    assert geo["threads"] == k3.K3_THREADS and geo["smem_bytes"] == k3.K3_SMEM_BYTES
    assert 0 < geo["registers"] <= 65536 // k3.K3_THREADS and geo["spill_bytes"] == 0
    assert geo["blocks_per_sm"] == 1
    assert k3.device_blocks(dev) == geo["sms"]


def test_k2_geometry_unchanged_beside_k3(dev):
    # K3 shares K2's cp.async helpers only: K2's and K9's builds stay as they were.
    for shard in (False, True):
        geo = k2.k2_geometry(dev, 8, shard)
        assert (geo["tile_h"], geo["tile_w"], geo["threads"]) == (32, 112, k2.K2_THREADS)
        assert geo["smem_bytes"] == k2.K2_SMEM_BYTES and geo["spill_bytes"] == 0
        assert geo["registers"] <= 128 and geo["blocks_per_sm"] == 1


@pytest.mark.parametrize("shape,n", [((1088, 1920), 50), ((2, 272, 480), 50), ((67, 93), 11),
                                     ((3, 1080, 1920), 4)])
def test_k3_launches_follow_the_plan(dev, shape, n):
    i1, i2 = _rand(shape, dev, 103)
    k1.hs_derivatives.launches = 0
    k3.sor_sweeps.launches = 0
    sr.hs_solve_resident_sor(i1, i2, 0.5, n, 1.7)
    s = k3.sweeps_per_launch(0, shape, n, k3.device_blocks(dev))
    assert (k1.hs_derivatives.launches, k3.sor_sweeps.launches) == (1, k3.launches(n, s))
    assert s == k3.sweeps_per_launch(0, shape, n)  # one block a multiprocessor, 132 of them


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [1, 3])
def test_k4_freeze_equals_plain(dev, shape, b):
    i1, i2 = _rand((b,) + shape, dev, 17)
    ex, ey, et, _ = k1.derivatives_plain(i1, i2, 0.4)
    u, v = _rand((b,) + shape, dev, 18, normal=True)
    for eps in ((0.05, 0.05), (0.01, 0.2)):
        _equal(k4.freeze_weights(u, v, ex, ey, et, *eps),
               robust.charbonnier_weights(u, v, ex, ey, et, *eps))


def _k4_launches(shape, n, s, dev):
    """K4 sweep launches of a block of n sweeps at block_sweeps s: K4's plan
    for the shape."""
    return k4.launches(n, k4.sweeps_per_launch(s, shape, n, k4.device_blocks(dev)))


def _robust_plain(u, v, ex, ey, et, wd, ws, n):
    for _ in range(n):
        u, v = robust.robust_step(u, v, ex, ey, et, wd, ws, 0.3)
    return u, v


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n,s", [(1, 0), (5, 2), (13, 0), (17, 10), (9, 1), (20, 0),
                                 (29, k4.K4_MAX_SWEEPS), (16, k4.K4_MAX_SWEEPS + 1)])
def test_k4_sweeps_equal_plain(dev, shape, b, n, s):
    i1, i2 = _rand((b,) + shape, dev, 19)
    ex, ey, et, _ = k1.derivatives_plain(i1, i2, 0.4)
    u0, v0 = _rand((b,) + shape, dev, 20, normal=True)
    wd, ws = robust.charbonnier_weights(u0, v0, ex, ey, et, 0.05, 0.05)
    keep = (u0.clone(), v0.clone())
    k4.frozen_sweeps.launches = 0
    got = k4.frozen_sweeps(u0, v0, ex, ey, et, wd, ws, 0.3, n, block_sweeps=s)
    assert k4.frozen_sweeps.launches == _k4_launches(u0.shape, n, s, dev)
    _equal(got, _robust_plain(u0, v0, ex, ey, et, wd, ws, n))
    _equal((u0, v0), keep)
    for k in range(b):
        one = k4.frozen_sweeps(u0[k], v0[k], ex[k], ey[k], et[k], wd[k], ws[k], 0.3, n,
                               block_sweeps=s)
        _equal([g[k] for g in got], one)


@pytest.mark.parametrize("shape", [(67, 93), (200, 333)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("iters,k", [(13, 1), (13, 5), (25, 20), (8, 20), (100, 20)])
@pytest.mark.parametrize("warm", [False, True])
def test_robust_driver_equals_plain(dev, shape, b, iters, k, warm):
    i1, i2 = _rand((b,) + shape, dev, 21)
    init = _rand((b,) + shape, dev, 22, normal=True) if warm else (None, None)
    cfg = HSConfig(alpha=0.3, iters=iters, solver="robust", robust_update_every=k)
    k1.hs_derivatives.launches = 0
    k4.freeze_weights.launches = 0
    k4.frozen_sweeps.launches = 0
    got = k4.hs_solve_robust_resident(i1, i2, cfg, *init)
    blocks = robust.refreeze_blocks(iters, k)
    assert (k1.hs_derivatives.launches, k4.freeze_weights.launches,
            k4.frozen_sweeps.launches) == (
        1, len(blocks), sum(_k4_launches(i1.shape, m, 0, dev) for m in blocks))
    _equal(got, k4.hs_solve_robust_resident_plain(i1, i2, cfg, *init))


# K4's sweep geometry (windows of K4_WINDOW_H x 128, the tile less s rows
# and s columns (rounded up to 4 on the left), warps of K4_THREAD_ROWS rows,
# lanes of 4 columns): frames one pixel below and above one and two tiles at
# every s, stacks, zero and warm starts, both derivative variants.
def _k4_edge_shape(s, kind):
    th, tw, _ = k4.k4_tile(s)
    return {"one-": (th - 1, tw - 1), "one+": (th + 1, tw + 1),
            "two-": (2 * th - 1, 2 * tw - 1), "two+": (2 * th + 1, 2 * tw + 1)}[kind]


@pytest.mark.parametrize("s", range(1, k4.K4_MAX_SWEEPS + 1))
@pytest.mark.parametrize("kind", ["one-", "one+", "two-", "two+"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k4_tile_edge_shapes_equal_plain(dev, s, kind, b, warm):
    full = (b,) + _k4_edge_shape(s, kind)
    i1, i2 = _rand(full, dev, 110 + s)
    ex, ey, et, _ = k1.derivatives_plain(i1, i2, 0.4, "central" if s % 2 else "hs_cube")
    u0, v0 = _rand(full, dev, 111, normal=True) if warm else (torch.zeros(full, device=dev),) * 2
    wd, ws = robust.charbonnier_weights(u0, v0, ex, ey, et, 0.05, 0.05)
    n = 2 * s + 1  # s does not divide n
    k4.frozen_sweeps.launches = 0
    got = k4.frozen_sweeps(u0, v0, ex, ey, et, wd, ws, 0.3, n, block_sweeps=s)
    assert k4.frozen_sweeps.launches == k4.launches(n, s)
    _equal(got, _robust_plain(u0, v0, ex, ey, et, wd, ws, n))


@pytest.mark.parametrize("s", range(1, k4.K4_MAX_SWEEPS + 1))
@pytest.mark.parametrize("w", [96, 93])
def test_k4_unaligned_views_equal_plain(dev, s, w):
    # Contiguous views 4 bytes off a 16-byte boundary take the 4-byte copies.
    h = 40
    flat = [torch.from_numpy(np.random.default_rng(112 + k).normal(0, 0.5, 1 + 2 * h * w)
                             .astype(np.float32)).to(dev) for k in range(4)]
    u0, v0, i1, i2 = (f[1:].view(2, h, w) for f in flat)
    ex, ey, et, _ = k1.derivatives_plain(i1.abs(), i2.abs(), 0.4)
    wd, ws = robust.charbonnier_weights(u0, v0, ex, ey, et, 0.05, 0.05)
    n = s + 2
    _equal(k4.frozen_sweeps(u0, v0, ex, ey, et, wd, ws, 0.3, n, block_sweeps=s),
           _robust_plain(u0, v0, ex, ey, et, wd, ws, n))


@pytest.mark.parametrize("s", [1, 5, 8, k4.K4_MAX_SWEEPS])
def test_k4_geometry(dev, s):
    geo = k4.k4_geometry(dev, s)
    th, tw, lh = k4.k4_tile(s)
    assert (geo["sweeps"], geo["tile_h"], geo["tile_w"], geo["left_halo"]) == (s, th, tw, lh)
    assert (geo["window_h"], geo["thread_rows"], geo["threads"]) == (
        k4.K4_WINDOW_H, k4.K4_THREAD_ROWS, k4.K4_THREADS)
    assert geo["smem_bytes"] == k4.K4_SMEM_BYTES
    assert 0 < geo["registers"] <= min(255, 65536 // k4.K4_THREADS)
    assert geo["spill_bytes"] == 0 and geo["blocks_per_sm"] == 1
    assert k4.device_blocks(dev) == geo["sms"]


def test_k4_reciprocal_equals_the_ieee_division_over_every_float(dev):
    # The sweep kernel forms 1/det by the division's own fast path without
    # its branch, for every det whose exponent that path takes.
    assert k4.rcp_check(dev) == {"mismatch_div": 0, "mismatch_double": 0,
                                 "checked": 2 * 252 * 2 ** 23}


@pytest.mark.parametrize("shape,iters,k", [((1088, 1920), 100, 20), ((2, 272, 480), 30, 7),
                                           ((67, 93), 13, 5), ((3, 1080, 1920), 20, 20)])
def test_k4_launches_follow_the_plan(dev, shape, iters, k):
    i1, i2 = _rand(shape, dev, 113)
    cfg = HSConfig(alpha=0.25, iters=iters, solver="robust", robust_update_every=k)
    k4.frozen_sweeps.launches = 0
    k4.hs_solve_robust_resident(i1, i2, cfg)
    blocks = robust.refreeze_blocks(iters, k)
    plan = [k4.sweeps_per_launch(0, shape, m, k4.device_blocks(dev)) for m in blocks]
    assert k4.frozen_sweeps.launches == sum(k4.launches(m, s) for m, s in zip(blocks, plan))


def test_sor_and_robust_entry_points_run_the_kernels(dev):
    i1, i2 = _rand((3, 96, 128), dev, 23)
    counters = (k1.hs_derivatives, k3.sor_sweeps, k4.freeze_weights, k4.frozen_sweeps)
    for kw in (dict(solver="sor", omega=1.6), dict(solver="robust", robust_update_every=7),
               dict(solver="sor", omega=1.6, tol=1e-3, block_sweeps=4),
               dict(solver="robust", tol=1e-3, block_sweeps=6)):
        cfg = HSConfig(alpha=0.5, iters=20, **kw)
        plain = HSConfig(alpha=0.5, iters=20, backend="torch", **kw)
        for c in counters:
            c.launches = 0
        got = hs_solve(i1[0], i2[0], cfg)
        ran = [c.launches for c in counters]
        assert ran[0] == 1 and (ran[1] > 0 if kw["solver"] == "sor" else min(ran[2:]) > 0)
        _equal(got, hs_solve(i1[0], i2[0], plain))
        _equal(hs_solve_batched(i1, i2, cfg), hs_solve_batched(i1, i2, plain))
        pyr = PyramidConfig(levels=2, warp="checked")
        _equal(hs_pyramid(i1[0], i2[0], cfg, pyr), hs_pyramid(i1[0], i2[0], plain, pyr))
        _equal(hs_solve_batched(i1, i2, cfg, pyr), hs_solve_batched(i1, i2, plain, pyr))
        for a, b in zip(solve_bidirectional(i1[0], i2[0], cfg),
                        solve_bidirectional(i1[0], i2[0], plain)):
            _equal(a, b)


def test_tune_omega_on_the_card_equals_plain(dev):
    i1, i2 = _rand((96, 128), dev, 24)
    for alpha in (0.1, 1.0):
        k2.jacobi_sweeps.launches = 0
        om = tune_omega(i1, i2, HSConfig(alpha=alpha), power_iters=60)
        assert k2.jacobi_sweeps.launches == 60
        assert om == tune_omega(i1, i2, HSConfig(alpha=alpha, backend="torch"),
                                power_iters=60)
        # The CPU starts from the same vectors; its sums round in another
        # order, which can move the rounded omega by one step at most.
        assert abs(om - tune_omega(i1.cpu(), i2.cpu(), HSConfig(alpha=alpha),
                                   power_iters=60)) <= 0.01 + 1e-9


# -- K5 (the TV-L1 inner loop) and the TV-L1 entry points ----------------------


def _tvl1_fields(shape, dev, seed):
    """Warm (u1, u2) and the inner loop's fields, computed as
    tvl1_warp_iteration computes them, from a pair on the [0, 255] scale."""
    i1, i2 = (255.0 * a for a in _rand(shape, dev, seed))
    u1, u2 = _rand(shape, dev, seed + 1, normal=True)
    cfg = TVL1Config()
    return u1, u2, tv.inner_fields(i1, i2, u1, u2, cfg), tv.inner_scalars(cfg)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("iters", [1, 7])
def test_k5_equals_plain(dev, shape, b, iters):
    u1, u2, fields, scalars = _tvl1_fields((b,) + shape, dev, 25)
    keep = (u1.clone(), u2.clone())
    k5.tvl1_inner.launches = 0
    got = k5.tvl1_inner(u1, u2, *fields, iters, *scalars)
    assert k5.tvl1_inner.launches == k5.k5_geometry(dev, 0, u1.shape, iters)["launches"]
    _equal(got, k5.tvl1_inner_plain(u1, u2, *fields, iters, *scalars))
    _equal((u1, u2), keep)  # inputs untouched
    for k in range(b):
        one = k5.tvl1_inner(u1[k], u2[k], *(f[k] for f in fields), iters, *scalars)
        _equal([g[k] for g in got], one)


# K5's geometry (32 x 128 windows, a warp a window row of 128 columns, lanes
# of 4 columns): K2's edge shapes, and frames one row and column past K5's
# tiles: 25 x 121 past one and 49 x 241 past two tiles of s = 4 (24 x 120),
# 31 x 121 past one of s = 1 (30 x 120); K2's 33 x 113 lies past two of
# s = 8 (16 x 112).
K5_EDGE_SHAPES = K2_EDGE_SHAPES + [(25, 121), (49, 241), (31, 121)]


@pytest.mark.parametrize("shape", K5_EDGE_SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("s", range(1, k5.K5_MAX_ITERS + 1))
def test_k5_edge_shapes_equal_plain(dev, shape, b, s):
    full = shape if b == 1 else (b,) + shape
    u1, u2, fields, scalars = _tvl1_fields(full, dev, 28)
    for iters in sorted({1, 7, 2 * s + 1}):  # s does not divide 2s + 1
        k5.tvl1_inner.launches = 0
        got = k5.tvl1_inner(u1, u2, *fields, iters, *scalars, block_iters=s)
        assert k5.tvl1_inner.launches == -(-iters // s)
        _equal(got, k5.tvl1_inner_plain(u1, u2, *fields, iters, *scalars))


@pytest.mark.parametrize("w", [64, 93])
def test_k5_unaligned_views_equal_plain(dev, w):
    # Contiguous views 4 bytes off a 16-byte boundary take the 4-byte copies.
    def unaligned(t):
        v = torch.empty(1 + t.numel(), device=dev)[1:].view(t.shape)
        v.copy_(t)
        return v

    u1, u2, fields, scalars = _tvl1_fields((50, w), dev, 29)
    args = [unaligned(t) for t in (u1, u2, *fields)]
    _equal(k5.tvl1_inner(*args, 11, *scalars), k5.tvl1_inner_plain(*args, 11, *scalars))


@pytest.mark.parametrize("s", [0] + list(range(1, k5.K5_MAX_ITERS + 1)))
@pytest.mark.parametrize("shape", [(1088, 1920), (544, 960), (272, 480), (8, 1088, 1920)])
def test_k5_geometry_on_the_card(dev, s, shape):
    geo = k5.k5_geometry(dev, s, shape, 100)
    if s:
        assert geo["iters_per_launch"] == s
    else:  # the cost rule's choice
        assert 2 <= geo["iters_per_launch"] <= 8
    assert geo["launches"] == -(-100 // geo["iters_per_launch"])
    assert geo["spill_bytes"] == 0 and 0 < geo["registers"] <= 65536 // geo["threads"]
    assert geo["blocks_per_sm"] >= 1
    assert (geo["window_h"], geo["threads"], geo["smem_bytes"]) == (
        k5.K5_WINDOW_H, k5.K5_THREADS, k5.K5_SMEM_BYTES)
    assert (geo["tile_h"], geo["tile_w"]) == k5.k5_tile(geo["iters_per_launch"])[:2]


def test_k5_rejects_bad_tensors(dev):
    u1, u2, fields, scalars = _tvl1_fields((16, 24), dev, 26)
    with pytest.raises(ValueError, match="float32"):
        k5.tvl1_inner(u1.double(), u2.double(), *(f.double() for f in fields), 3, *scalars)
    with pytest.raises(ValueError, match="contiguous"):
        k5.tvl1_inner(u1[:, ::2], u2[:, ::2], *(f[:, ::2] for f in fields), 3, *scalars)
    with pytest.raises(ValueError, match="device"):
        k5.tvl1_inner(u1, u2.cpu(), *fields, 3, *scalars)
    with pytest.raises(ValueError, match="block_iters"):
        k5.tvl1_inner(u1, u2, *fields, 3, *scalars, block_iters=k5.K5_MAX_ITERS + 1)
    # backend="cuda" takes CUDA frames only; nothing falls back to the CPU.
    with pytest.raises(ValueError, match="CUDA"):
        tvl1_solve(u1.cpu(), u2.cpu(), TVL1Config(backend="cuda"))


def test_tvl1_entry_points_run_k5(dev):
    i1, i2 = _rand((3, 96, 128), dev, 27)
    i2 = 0.8 * i1 + 0.2 * i2  # correlated frames, so the flow is not noise
    cfg = TVL1Config(warps=2, iters=10)
    plain = TVL1Config(warps=2, iters=10, backend="torch")
    pyr = PyramidConfig(levels=2)
    k5.tvl1_inner.launches = 0
    got = tvl1_solve(i1[0], i2[0], cfg, pyr)
    per_call = [k5.k5_geometry(dev, 0, hw, 10)["launches"] for hw in ((96, 128), (48, 64))]
    assert k5.tvl1_inner.launches == 2 * sum(per_call)  # warps x each level's calls
    _equal(got, tvl1_solve(i1[0], i2[0], plain, pyr))
    k5.tvl1_inner.launches = 0
    stack = tvl1_solve_batched(i1, i2, cfg)
    assert k5.tvl1_inner.launches == 2 * k5.k5_geometry(dev, 0, i1.shape, 10)["launches"]
    _equal(stack, tvl1_solve_batched(i1, i2, plain))
    for k in range(3):
        _equal([a[k] for a in stack], tvl1_solve(i1[k], i2[k], cfg))
    vid = torch.cat([i1, i2[-1:]])
    chunks = list(flow_stream(vid, tvl1=cfg, chunk=2))
    whole = tvl1_solve_batched(vid[:-1], vid[1:], cfg)
    _equal((torch.cat([c.u for c in chunks]), torch.cat([c.v for c in chunks])), whole)
    (f, m), (fp, mp) = (next(flow_stream_occlusion(vid, tvl1=c, chunk=3)) for c in (cfg, plain))
    _equal(f, fp)
    assert torch.equal(m, mp)
    for a, b in zip(solve_bidirectional(i1[0], i2[0], tvl1=cfg),
                    solve_bidirectional(i1[0], i2[0], tvl1=plain)):
        _equal(a, b)


def test_tvl1_stack_of_frames_below_8_px_runs_k5(dev):
    # tvl1_solve refuses 7-row frames; the stacked entry takes them, as the
    # reference's does, through K5.
    i1, i2 = _rand((2, 7, 40), dev, 28)
    i2 = 0.8 * i1 + 0.2 * i2
    k5.tvl1_inner.launches = 0
    got = tvl1_solve_batched(i1, i2, TVL1Config(warps=2, iters=10))
    assert k5.tvl1_inner.launches > 0
    _equal(got, tvl1_solve_batched(i1, i2, TVL1Config(warps=2, iters=10, backend="torch")))


# -- K6 and K7 (whole solve in one sweep launch) --------------------------------

BEYOND_SHAPES = [(67, 93), (131, 130), (1, 7), (9, 1), (200, 333)]
BEYOND_NS = [(1, 0), (7, 0), (9, 4), (100, 0), (17, 10)]  # s does not divide n


@pytest.mark.parametrize("shape", BEYOND_SHAPES)
@pytest.mark.parametrize("n,s", BEYOND_NS)
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("blocks", [0, 2])
def test_k6_equals_plain(dev, shape, n, s, warm, blocks):
    i1, i2 = _rand(shape, dev, 40)
    init = _rand(shape, dev, 41, normal=True) if warm else (None, None)
    keep = [a.clone() for a in init if a is not None]
    got = k6.hs_solve_fused(i1, i2, 0.5, n, "hs_cube", *init, block_sweeps=s, blocks=blocks)
    _equal(got, k6.hs_solve_fused_plain(i1, i2, 0.5, n, "hs_cube", *init))
    _equal(got, sr.hs_solve_resident(i1, i2, 0.5, n, "hs_cube", *init, block_sweeps=s))
    _equal([a for a in init if a is not None], keep)  # the start is not written


@pytest.mark.parametrize("shape", BEYOND_SHAPES)
@pytest.mark.parametrize("n,s", BEYOND_NS)
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("band,blocks", [(0, 0), (16, 0), (16, 8)])
def test_k7_equals_plain(dev, shape, n, s, warm, band, blocks):
    i1, i2 = _rand(shape, dev, 42)
    init = _rand(shape, dev, 43, normal=True) if warm else (None, None)
    keep = [a.clone() for a in init if a is not None]
    got = k7.hs_solve_skewed(i1, i2, 0.5, n, "central", *init, block_sweeps=s,
                             band=band, blocks=blocks)
    _equal(got, k7.hs_solve_skewed_plain(i1, i2, 0.5, n, "central", *init))
    _equal(got, sr.hs_solve_resident(i1, i2, 0.5, n, "central", *init, block_sweeps=s))
    _equal([a for a in init if a is not None], keep)


@pytest.mark.parametrize("shape", [(67, 93), (131, 130)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [7, 100])
def test_k6_k7_batched_equal_plain_and_singles(dev, shape, b, n):
    i1, i2 = _rand((b,) + shape, dev, 44)
    want = k6.hs_solve_fused_batched_plain(i1, i2, 0.5, n)
    for got in (k6.hs_solve_fused_batched(i1, i2, 0.5, n, blocks=2),
                k7.hs_solve_skewed_batched(i1, i2, 0.5, n, band=24),
                sr.hs_solve_resident_batched(i1, i2, 0.5, n)):
        _equal(got, want)
        for k in range(b):
            _equal([g[k] for g in got], k7.hs_solve_skewed(i1[k], i2[k], 0.5, n, band=24))


def test_hs_solve_routes_to_k6_and_k7(dev):
    counters = (k1.hs_derivatives, k2.jacobi_sweeps, k6.hs_solve_fused, k7.hs_solve_skewed)
    cases = [((1088, 1920), HSConfig(alpha=0.5, iters=64, deriv_variant="central"), (1, 0, 1, 0)),
             ((2160, 3840), HSConfig(alpha=0.5, iters=64), (1, 0, 0, 1)),
             ((2160, 3840), HSConfig(alpha=0.5, iters=63), (1, 8, 0, 0)),
             ((1088, 1920), HSConfig(alpha=0.5, iters=64), (1, 8, 0, 0))]
    for shape, cfg, want in cases:
        i1, i2 = _rand(shape, dev, 45)
        u0, v0 = _rand(shape, dev, 46, normal=True)
        for init in (None, Flow(u0, v0)):
            for c in counters:
                c.launches = 0
            got = hs_solve(i1, i2, cfg, init=init)
            assert tuple(c.launches for c in counters) == want, (shape, cfg, init is None)
            plain = dataclasses.replace(cfg, backend="torch")
            _equal(got, hs_solve(i1, i2, plain, init=init))


def test_k6_k7_failures_raise(dev):
    i1, i2 = _rand((131, 130), dev, 47)
    before = (k6.hs_solve_fused.launches, k7.hs_solve_skewed.launches)
    with pytest.raises(RuntimeError, match="hs_solve_fused_sweeps"):
        k6.hs_solve_fused(i1, i2, 0.5, 9, blocks=10**6)   # cannot all be resident
    with pytest.raises(RuntimeError, match="hs_solve_skewed_sweeps"):
        k7.hs_solve_skewed(i1, i2, 0.5, 9, blocks=10**6)
    with pytest.raises(ValueError, match="resident blocks"):
        k7.hs_solve_skewed(i1, i2, 0.5, 9, band=128, blocks=2)  # 8 tiles a band
    with pytest.raises(ValueError):
        k6.hs_solve_fused(i1, i2, 0.5, 9, u0=i1)
    with pytest.raises(ValueError):
        k7.hs_solve_skewed_batched(i1, i2, 0.5, 9)
    assert (k6.hs_solve_fused.launches, k7.hs_solve_skewed.launches) == before


# K2's tile is 32 x 112 at s = 8: shapes just past it and its rows and
# columns, and one or two rows past a lane (4) of columns.
K6_K7_EDGE_SHAPES = [(33, 113), (32, 113), (33, 112), (65, 225), (1, 113), (97, 5)]
K6_K7_MAX_S = k2.sweeps_per_launch(1000)  # the highest s a block_sweeps gives


@pytest.mark.parametrize("shape", K6_K7_EDGE_SHAPES)
@pytest.mark.parametrize("s", range(1, K6_K7_MAX_S + 1))
def test_k6_k7_every_s_at_edge_shapes(dev, shape, s):
    i1, i2 = _rand(shape, dev, 48)
    u0, v0 = _rand(shape, dev, 49, normal=True)
    n = 2 * s + 1  # three sweep blocks, the last one the remainder 1
    for init in ((None, None), (u0, v0)):
        want = k6.hs_solve_fused_plain(i1, i2, 0.5, n, "hs_cube", *init)
        _equal(k6.hs_solve_fused(i1, i2, 0.5, n, "hs_cube", *init, block_sweeps=s), want)
        _equal(k7.hs_solve_skewed(i1, i2, 0.5, n, "hs_cube", *init, block_sweeps=s), want)
        _equal(k7.hs_solve_skewed(i1, i2, 0.5, n, "hs_cube", *init, block_sweeps=s,
                                  band=1, blocks=1), want)


@pytest.mark.parametrize("s", [1, 8, k2.K2_MAX_SWEEPS])
def test_k6_k7_launches_at_the_largest_s(dev, s):
    # The C entry points take s up to K2's 16 (block_sweeps stops at 10).
    i1, i2 = _rand((70, 250), dev, 50)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    z = torch.zeros_like(i1)
    want = k2.jacobi_sweeps_plain(z, z, *fields, 3 * s + 2)
    _equal(k6.launch_fused(None, None, *fields, 3 * s + 2, s), want)
    _equal(k7.launch_skewed(None, None, *fields, 3 * s + 2, s), want)
    _equal(k7.launch_skewed(None, None, *fields, 3 * s + 2, s, band=1, blocks=2), want)


@pytest.mark.parametrize("blocks", [1, 2, 3])
@pytest.mark.parametrize("b", [1, 3])
def test_k6_on_small_grids_walks_many_tiles(dev, blocks, b):
    shape = (b, 131, 300) if b > 1 else (131, 300)  # 5 x 3 tiles an image at s 8
    i1, i2 = _rand(shape, dev, 51)
    want = k6.hs_solve_fused_plain(i1, i2, 0.5, 27, "hs_cube")
    _equal(k6.hs_solve_fused(i1, i2, 0.5, 27, "hs_cube", blocks=blocks), want)
    _equal(k6.hs_solve_fused(i1, i2, 0.5, 27, "hs_cube", blocks=blocks, block_sweeps=4), want)


@pytest.mark.parametrize("w", [64, 93, 130])
@pytest.mark.parametrize("blocks", [0, 1, 3])
def test_k6_k7_unaligned_views_equal_plain(dev, w, blocks):
    # Contiguous views 4 bytes off a 16-byte boundary take the 4-byte path,
    # which reads u/v around the SM's L1 (__ldcg): a pair is re-read two
    # sweep blocks after an SM last held it, so n covers at least 3 blocks.
    h = 70
    flat = [torch.from_numpy(np.random.default_rng(52 + k).normal(0, 0.5, 1 + h * w)
                             .astype(np.float32)).to(dev) for k in range(4)]
    u0, v0, i1, i2 = (f[1:].view(h, w) for f in flat)
    i1, i2 = i1.abs(), i2.abs()
    for n in (29, 40):
        want = k6.hs_solve_fused_plain(i1, i2, 0.5, n, "hs_cube", u0, v0)
        _equal(k6.hs_solve_fused(i1, i2, 0.5, n, "hs_cube", u0, v0, blocks=blocks), want)
        for band in (0, 1):
            _equal(k7.hs_solve_skewed(i1, i2, 0.5, n, "hs_cube", u0, v0, band=band,
                                      blocks=blocks), want)


# (shape, band rows, blocks) -> K7's m and bands at s 8 (32 x 112 tiles).
K7_FORCED = [
    ((70, 250), 1, 3, 1, 3),     # 3 tiles a band on 3 blocks: m 1, 3 bands
    ((70, 250), 33, 3, 2, 2),    # 2 tile rows, 6 tiles on 3 blocks: m 2, 2 bands
    ((70, 250), 96, 3, 3, 1),    # the whole frame, 9 tiles on 3 blocks: m 3, 1 band
    ((200, 250), 64, 2, 3, 4),   # 6 tiles on 2 blocks: m 3, 4 bands
    ((200, 250), 32, 1, 3, 7),   # one tile row on 1 block: m 3, 7 bands
    ((200, 500), 32, 5, 1, 7),   # 5 tiles a band on 5 blocks: m 1, 7 bands
    ((130, 600), 64, 4, 3, 3),   # 12 tiles on 4 blocks: m 3, 3 bands
]


@pytest.mark.parametrize("shape,band,blocks,m,bands", K7_FORCED)
@pytest.mark.parametrize("n", [8, 17, 100])
def test_k7_forced_bands_and_tiles_a_block(dev, shape, band, blocks, m, bands, n):
    plan = k7.geometry(*shape, 8, blocks, band)
    assert (plan[2], plan[4]) == (m, bands)
    i1, i2 = _rand(shape, dev, 53)
    u0, v0 = _rand(shape, dev, 54, normal=True)
    for init in ((None, None), (u0, v0)):
        got = k7.hs_solve_skewed(i1, i2, 0.5, n, "central", *init, band=band, blocks=blocks)
        _equal(got, k7.hs_solve_skewed_plain(i1, i2, 0.5, n, "central", *init))
        _equal(got, sr.hs_solve_resident(i1, i2, 0.5, n, "central", *init))


def test_k7_on_a_wide_frame(dev):
    # 12,000 px across: 108 tiles of 112 a row; on 40 blocks 3 a block.
    i1, i2 = _rand((70, 12000), dev, 55)
    want = k7.hs_solve_skewed_plain(i1, i2, 0.5, 17, "hs_cube")
    assert k7.geometry(70, 12000, 8, 40)[2] == 3
    _equal(k7.hs_solve_skewed(i1, i2, 0.5, 17, blocks=40), want)
    _equal(k7.hs_solve_skewed(i1, i2, 0.5, 17), want)
    _equal(k6.hs_solve_fused(i1, i2, 0.5, 17), want)
    with pytest.raises(ValueError, match="wide"):
        k7.hs_solve_skewed(i1, i2, 0.5, 17, blocks=30)  # 108 > 3 x 30


@pytest.mark.parametrize("s", range(1, K6_K7_MAX_S + 1))
def test_k6_k7_geometry_has_no_spills(dev, s):
    for geo in (k6.k6_geometry(dev, s), k7.k7_geometry(dev, 2160, 3840, s)):
        assert (geo["tile_h"], geo["tile_w"]) == k2.k2_tile(s)[:2]
        assert geo["threads"] == k2.K2_THREADS and geo["spill_bytes"] == 0
        assert 0 < geo["registers"] <= 65536 // k2.K2_THREADS
        assert geo["blocks_per_sm"] >= 1
    assert k6.k6_geometry(dev, s)["smem_bytes"] == k2.K2_SMEM_BYTES
    geo = k7.k7_geometry(dev, 2160, 3840, s)
    assert geo["smem_bytes"] == 4 * k2.K2_SMEM_BYTES // 3
    assert (geo["m"], geo["band"], geo["bands"]) == k7.geometry(2160, 3840, s, geo["grid"])[2:]


def test_k6_k7_refusals(dev):
    i1, i2 = _rand((131, 130), dev, 56)
    u0, v0 = _rand((131, 130), dev, 57, normal=True)
    before = (k6.hs_solve_fused.launches, k7.hs_solve_skewed.launches)
    grid = k6.resident_blocks("hs_solve_fused_blocks", 0)
    with pytest.raises(RuntimeError, match="hs_solve_fused_sweeps"):
        k6.hs_solve_fused(i1, i2, 0.5, 9, blocks=grid + 1)   # one block too many
    with pytest.raises(RuntimeError, match="hs_solve_skewed_sweeps"):
        k7.hs_solve_skewed(i1, i2, 0.5, 9, blocks=grid + 1)
    with pytest.raises(ValueError, match="resident blocks"):
        k7.hs_solve_skewed(i1, i2, 0.5, 9, band=200, blocks=1)  # 10 tiles > 3
    assert (k6.hs_solve_fused.launches, k7.hs_solve_skewed.launches) == before
    # The stream is still usable: no refused launch left an error behind.
    _equal(k6.hs_solve_fused(i1, i2, 0.5, 9), k6.hs_solve_fused_plain(i1, i2, 0.5, 9))
    # A start that requires grad is no longer refused: it is solved through
    # the kernel, differentiably (kernels/autodiff.py).
    for solve in (k6.hs_solve_fused, k7.hs_solve_skewed):
        out = solve(i1, i2, 0.5, 9, "hs_cube", u0, v0.clone().requires_grad_())
        assert all(o.grad_fn is not None for o in out)
        _equal([o.detach() for o in out], k6.hs_solve_fused_plain(i1, i2, 0.5, 9, u0=u0, v0=v0))


# -- K8 (the SOR solve on parity planes), multigrid, the gradient guard ---------

# Every parity of h and w (the reference's test shapes, and 67x93), and
# frames of 1-3 rows or columns, where a plane is a single row or all pad.
PLANES_SHAPES = [(192, 128), (131, 130), (96, 255), (97, 253), (67, 93),
                 (1, 7), (2, 9), (3, 8), (7, 1), (8, 2), (9, 3)]


@pytest.mark.parametrize("shape", PLANES_SHAPES)
@pytest.mark.parametrize("n", [1, 4, 7])
@pytest.mark.parametrize("warm", [False, True])
def test_k8_equals_plain_and_the_k3_chain(dev, shape, n, warm):
    i1, i2 = _rand(shape, dev, 60)
    init = _rand(shape, dev, 61, normal=True) if warm else (None, None)
    keep = [a.clone() for a in init if a is not None]
    fields = k1.derivatives_plain(i1, i2, 0.5)
    k8.sor_planes.launches = 0
    got = k8.sor_planes(*init, *fields, n, 1.7)
    assert k8.sor_planes.launches == 1  # the whole solve in one launch
    _equal(got, k8.sor_planes_plain(*init, *fields, n, 1.7))
    z = torch.zeros_like(i1)
    _equal(got, k3.sor_sweeps_plain(*(init if warm else (z, z)), *fields, n, 1.7))
    k1.hs_derivatives.launches = k3.sor_sweeps.launches = 0
    whole = k8.hs_solve_sor_planes(i1, i2, 0.5, n, 1.7, "hs_cube", *init)
    assert (k1.hs_derivatives.launches, k8.sor_planes.launches) == (1, 2)
    assert k3.sor_sweeps.launches == 0
    _equal(whole, got)
    _equal(whole, sr.hs_solve_resident_sor(i1, i2, 0.5, n, 1.7, "hs_cube", *init))
    _equal([a for a in init if a is not None], keep)  # the start is not written


# K8 at every s its blocks take and on small grids that walk many tiles a
# block: frames one pixel below and above K3's tiles at s = 2 (40 x 112),
# every parity of h and w; n with a remainder block and at least 3 blocks.
@pytest.mark.parametrize("shape", [(39, 111), (41, 113), (81, 225), (80, 224), (1, 1)])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 7, k3.K3_MAX_SWEEPS])
@pytest.mark.parametrize("blocks", [0, 1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k8_every_s_and_small_grids_equal_plain(dev, shape, s, blocks, warm):
    i1, i2 = _rand(shape, dev, 64)
    init = _rand(shape, dev, 65, normal=True) if warm else (None, None)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    n = 3 * s + 2
    k8.sor_planes.launches = 0
    got = k8.sor_planes(*init, *fields, n, 1.7, block_sweeps=s, blocks=blocks)
    assert k8.sor_planes.launches == 1
    z = torch.zeros_like(i1)
    _equal(got, k3.sor_sweeps_plain(*(init if warm else (z, z)), *fields, n, 1.7))
    _equal(got, k3.sor_sweeps(*(init if warm else (z, z)), *fields, n, 1.7, block_sweeps=s))


@pytest.mark.parametrize("w", [64, 93, 130])
@pytest.mark.parametrize("blocks", [0, 1, 3])
def test_k8_unaligned_views_equal_plain(dev, w, blocks):
    # Contiguous views 4 bytes off a 16-byte boundary take the 4-byte path,
    # which reads u/v around the SM's L1 (__ldcg): a pair is re-read two
    # sweep blocks after an SM last held it, so n covers at least 3 blocks.
    h = 70
    flat = [torch.from_numpy(np.random.default_rng(66 + k).normal(0, 0.5, 1 + h * w)
                             .astype(np.float32)).to(dev) for k in range(4)]
    u0, v0, i1, i2 = (f[1:].view(h, w) for f in flat)
    fields = [torch.cat([f.new_zeros(1), f.flatten()])[1:].view(h, w)
              for f in k1.derivatives_plain(i1.abs(), i2.abs(), 0.5)]
    for init in ((u0, v0), (None, None)):
        z = torch.zeros_like(u0)
        want = k3.sor_sweeps_plain(*(init if init[0] is not None else (z, z)), *fields, 13, 1.7)
        _equal(k8.sor_planes(*init, *fields, 13, 1.7, block_sweeps=4, blocks=blocks), want)


@pytest.mark.parametrize("s", range(1, k3.K3_MAX_SWEEPS + 1))
def test_k8_geometry_has_no_spills(dev, s):
    geo = k8.k8_geometry(dev, s)
    assert (geo["tile_h"], geo["tile_w"]) == k3.k3_tile(s)[:2]
    assert geo["threads"] == k3.K3_THREADS and geo["smem_bytes"] == k3.K3_SMEM_BYTES
    assert geo["spill_bytes"] == 0 and 0 < geo["registers"] <= 65536 // k3.K3_THREADS
    assert geo["blocks_per_sm"] >= 1


def test_k8_refusals(dev):
    i1, i2 = _rand((131, 130), dev, 67)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    before = k8.sor_planes.launches
    grid = k6.resident_blocks("hs_sor_planes_blocks", 0)
    with pytest.raises(RuntimeError, match="hs_sor_planes"):
        k8.sor_planes(None, None, *fields, 9, 1.7, blocks=grid + 1)  # one block too many
    with pytest.raises(ValueError, match=">= 0"):
        k8.sor_planes(None, None, *fields, 9, 1.7, block_sweeps=-1)
    assert k8.sor_planes.launches == before
    # The stream is still usable: no refused launch left an error behind.
    _equal(k8.sor_planes(None, None, *fields, 9, 1.7), k8.sor_planes_plain(None, None, *fields,
                                                                           9, 1.7))


def test_k8_contract(dev):
    i1, i2 = _rand((64, 96), dev, 62)
    big = torch.zeros(2160, 3840, device=dev)
    before = (k1.hs_derivatives.launches, k8.sor_planes.launches)
    assert k8.hs_solve_sor_planes(big, big, 0.5, 4, 1.7) is None   # outside the class
    assert k8.hs_solve_sor_planes(i1[None], i2[None], 0.5, 4, 1.7) is None
    assert k8.hs_solve_sor_planes(i1, i2, 0.5, 0, 1.7) is None
    assert k8.hs_solve_sor_planes(i1, i2, 0.5, 4, 1.7, "central") is None
    assert (k1.hs_derivatives.launches, k8.sor_planes.launches) == before
    with pytest.raises(ValueError, match="together"):
        k8.hs_solve_sor_planes(i1, i2, 0.5, 4, 1.7, u0=i1)
    with pytest.raises(ValueError):
        k8.sor_planes(None, None, *(f[None] for f in k1.derivatives_plain(i1, i2, 0.5)), 4, 1.7)
    u0, v0 = _rand((64, 96), dev, 63, normal=True)
    before = k8.sor_planes.launches
    _equal(k8.sor_planes(u0, v0, *k1.derivatives_plain(i1, i2, 0.5), 0, 1.7), (u0, v0))
    assert k8.sor_planes.launches == before  # n = 0 launches nothing


@pytest.mark.parametrize("kw", [dict(iters=2), dict(iters=6, tol=1e-3), dict(iters=1, warm=True)])
def test_multigrid_on_the_card_equals_plain(dev, kw):
    kw = dict(kw)
    warm = kw.pop("warm", False)
    i1, i2 = _rand((3, 96, 128), dev, 64)
    init = Flow(*_rand((96, 128), dev, 65, normal=True)) if warm else None
    cfg = HSConfig(alpha=1.0, solver="multigrid", **kw)
    plain = dataclasses.replace(cfg, backend="torch")
    counters = (k1.hs_derivatives, k2.jacobi_sweeps, k3.sor_sweeps)
    for c in counters:
        c.launches = 0
    got = hs_solve(i1[0], i2[0], cfg, init=init)
    assert tuple(c.launches for c in counters) == (1, 0, 0)  # K1, then plain V-cycles
    _equal(got, hs_solve(i1[0], i2[0], plain, init=init))
    k1.hs_derivatives.launches = 0
    stack = hs_solve_batched(i1, i2, cfg)
    assert k1.hs_derivatives.launches == 1  # one K1 for the whole stack
    _equal(stack, hs_solve_batched(i1, i2, plain))
    for k in range(3):
        _equal([a[k] for a in stack], hs_solve(i1[k], i2[k], cfg))
    pyr = PyramidConfig(levels=2)
    _equal(hs_pyramid(i1[0], i2[0], cfg, pyr), hs_pyramid(i1[0], i2[0], plain, pyr))


# -- gradients: every kernel entry = its plain twin --------------------------------
#
# Each entry of the autograd scheme (kernels/autodiff.py: the kernel forward,
# the plain twin's VJP backward) on CUDA tensors that require grad, against
# the plain twin on the same tensors: outputs and the gradient of every
# input bitwise, the forward's launches counted and none in the backward.

_CFG_R = HSConfig(alpha=0.3, iters=5, solver="robust", robust_update_every=2)
_GRAD_SHAPES = [(40, 56), (3, 37, 61)]


def _grad_entries(dev, shape):
    """{name: (inputs, kernel-route call, plain call)} for every entry of the
    scheme at `shape`, zero and warm starts; K8's only for a 2-D frame."""
    i1, i2 = _rand(shape, dev, 66)
    u, v = _rand(shape, dev, 67, normal=True)
    f = tuple(k1.derivatives_plain(i1, i2, 0.5))
    u1, u2, tf, sc = _tvl1_fields(shape, dev, 68)
    plain_hs = HSConfig(iters=3, backend="torch")
    out = {
        "K1": ((i1, i2), lambda a, b: k1.hs_derivatives(a, b, 0.5, zero_sweep=True),
               lambda a, b: k1.derivatives_plain(a, b, 0.5, zero_sweep=True)),
        "K2": ((u, v) + f, lambda *t: k2.jacobi_sweeps(*t, 9),
               lambda *t: k2.jacobi_sweeps_plain(*t, 9)),
        "K3": ((u, v) + f, lambda *t: k3.sor_sweeps(*t, 5, 1.6),
               lambda *t: k3.sor_sweeps_plain(*t, 5, 1.6)),
        "K4 robust_sweeps": ((u, v) + f[:3], lambda *t: k4.robust_sweeps(*t, 5, _CFG_R),
                             lambda *t: robust.robust_sweeps(*t, 5, _CFG_R)),
        "K5": ((u1, u2) + tuple(tf), lambda *t: k5.tvl1_inner(*t, 7, *sc),
               lambda *t: k5.tvl1_inner_plain(*t, 7, *sc)),
        "hs_solve": ((i1[0], i2[0]) if len(shape) == 3 else (i1, i2),
                     lambda a, b: hs_solve(a, b, HSConfig(iters=3)),
                     lambda a, b: hs_solve(a, b, plain_hs)),
        "hs_solve multigrid": (
            (i1[0], i2[0]) if len(shape) == 3 else (i1, i2),
            lambda a, b: hs_solve(a, b, HSConfig(iters=1, solver="multigrid")),
            lambda a, b: hs_solve(a, b, HSConfig(iters=1, solver="multigrid",
                                                 backend="torch"))),
    }
    solves = {
        "K1 + K2": (lambda a, b, c, d: sr.hs_solve_resident(a, b, 0.5, 9, u0=c, v0=d),
                    lambda a, b, c, d: sr.hs_solve_resident_plain(a, b, 0.5, 9, u0=c, v0=d)),
        "K1 + K3": (lambda a, b, c, d: sr.hs_solve_resident_sor(a, b, 0.5, 5, 1.6, u0=c, v0=d),
                    lambda a, b, c, d: sr.hs_solve_resident_sor_plain(a, b, 0.5, 5, 1.6,
                                                                      u0=c, v0=d)),
        "K1 + K4": (lambda a, b, c, d: k4.hs_solve_robust_resident(a, b, _CFG_R, c, d),
                    lambda a, b, c, d: k4.hs_solve_robust_resident_plain(a, b, _CFG_R, c, d)),
        "K1 + K6": (lambda a, b, c, d: k6.hs_solve_fused(a, b, 0.5, 9, u0=c, v0=d),
                    lambda a, b, c, d: k6.hs_solve_fused_plain(a, b, 0.5, 9, u0=c, v0=d)),
        "K1 + K7": (lambda a, b, c, d: k7.hs_solve_skewed(a, b, 0.5, 9, u0=c, v0=d),
                    lambda a, b, c, d: k7.hs_solve_skewed_plain(a, b, 0.5, 9, u0=c, v0=d)),
    }
    if len(shape) == 2:
        out["K8"] = ((u, v) + f, lambda *t: k8.sor_planes(*t, 5, 1.6),
                     lambda *t: k8.sor_planes_plain(*t, 5, 1.6))
        solves["K1 + K8"] = (
            lambda a, b, c, d: k8.hs_solve_sor_planes(a, b, 0.5, 5, 1.6, u0=c, v0=d),
            lambda a, b, c, d: k8.sor_planes_plain(c, d, *k1.derivatives_plain(a, b, 0.5),
                                                   5, 1.6))
    for name, (call, twin) in solves.items():
        out[name + " zero"] = ((i1, i2), lambda a, b, call=call: call(a, b, None, None),
                               lambda a, b, twin=twin: twin(a, b, None, None))
        out[name + " warm"] = ((i1, i2, u, v), call, twin)
    return out


_GRAD_NAMES = ["K1", "K2", "K3", "K4 robust_sweeps", "K5", "hs_solve", "hs_solve multigrid"] + [
    f"K1 + K{k} {start}" for k in (2, 3, 4, 6, 7) for start in ("zero", "warm")]
_GRAD_CASES = [(s, n) for s in _GRAD_SHAPES for n in _GRAD_NAMES] + [
    ((40, 56), n) for n in ("K8", "K1 + K8 zero", "K1 + K8 warm")]


def _weighted_grads(fn, inputs):
    outs = fn(*inputs)
    gen = torch.Generator().manual_seed(9)
    loss = sum((o * torch.randn(o.shape, generator=gen).to(o.device)).sum() for o in outs)
    wrt = [t for t in inputs if t.requires_grad]
    return outs, torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("shape,name", _GRAD_CASES)
@pytest.mark.parametrize("wrt", ["all", "first"])
def test_kernel_entries_differentiate_as_their_plain_twins(dev, shape, name, wrt):
    inputs, call, twin = _grad_entries(dev, shape)[name]
    inputs = [t.clone().requires_grad_(wrt == "all" or i == 0) for i, t in enumerate(inputs)]
    counters = counted_wrappers().values()
    for c in counters:
        c.launches = 0
    outs, grads = _weighted_grads(call, inputs)
    fwd = sum(c.launches for c in counters)
    assert fwd > 0 and all(o.grad_fn is not None for o in outs), name
    want_outs, want = _weighted_grads(twin, inputs)
    assert sum(c.launches for c in counters) == fwd  # the backward launches none
    _equal([o.detach() for o in outs], [o.detach() for o in want_outs])
    _equal(grads, want)


@pytest.mark.parametrize("part", ["freeze", "sweeps"])
def test_k4_parts_refuse_frames_that_require_grad(dev, part):
    u, v = _rand((40, 56), dev, 67, normal=True)
    ex, ey, et, _ = k1.derivatives_plain(*_rand((40, 56), dev, 66), 0.5)
    wd, ws = robust.charbonnier_weights(u, v, ex, ey, et, 0.05, 0.05)
    call = ((lambda a: k4.freeze_weights(a, v, ex, ey, et, 0.05, 0.05)) if part == "freeze"
            else (lambda a: k4.frozen_sweeps(a, v, ex, ey, et, wd, ws, 0.3, 3)))
    a = u.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="does not differentiate.*no_grad"):
        call(a)
    with torch.no_grad():
        out = call(a)
    assert all(not t.requires_grad for t in out)


def test_kernel_entries_refuse_forward_mode(dev):
    import torch.autograd.forward_ad as fwad
    i1, i2 = _rand((40, 56), dev, 66)
    f = k1.derivatives_plain(i1, i2, 0.5)
    with fwad.dual_level():
        d1 = fwad.make_dual(i1, torch.ones_like(i1))
        for call in (lambda: k1.hs_derivatives(d1, i2, 0.5),
                     lambda: sr.hs_solve_resident(d1, i2, 0.5, 3),
                     lambda: k2.jacobi_sweeps(d1, i2, *f, 3),
                     lambda: hs_solve(d1, i2, HSConfig(iters=3))):
            with pytest.raises(NotImplementedError, match="jvp"):
                call()
        # The plain backend carries the tangent.
        flow = hs_solve(d1, i2, HSConfig(iters=3, backend="torch"))
        assert fwad.unpack_dual(flow.u).tangent is not None


# -- the tiled solver: K9-K12 on virtual meshes -------------------------------

from opticalflowhs_tpu_torch.config import MeshConfig  # noqa: E402
from opticalflowhs_tpu_torch.dist import hs_solve_tiled, make_mesh  # noqa: E402
from opticalflowhs_tpu_torch.kernels import ring  # noqa: E402
from opticalflowhs_tpu_torch.kernels import tile as k9  # noqa: E402


def _tile_problem(dev, shape, seed, stack=0):
    full = (stack,) + shape if stack else shape
    i1, i2 = _rand(full, dev, seed)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand(full, dev, seed + 1, normal=True)
    return u0, v0, fields


# Padded-shard origins: the four corners of a 300 x 400 image, negative and
# odd, and an odd interior origin.
_CORNERS = {"tl": lambda ph, pw: (-4, -3), "tr": lambda ph, pw: (-3, 400 - pw + 5),
            "bl": lambda ph, pw: (300 - ph + 3, -5), "br": lambda ph, pw: (300 - ph + 4, 400 - pw + 3),
            "mid": lambda ph, pw: (117, 33)}


@pytest.mark.parametrize("shape", [(67, 93), (131, 130)])
@pytest.mark.parametrize("corner", list(_CORNERS))
@pytest.mark.parametrize("sor", [False, True])
def test_k9_equals_plain(dev, shape, corner, sor):
    u0, v0, fields = _tile_problem(dev, shape, 70)
    r0, c0 = _CORNERS[corner](*shape)
    for n in (7, 13):
        if sor:
            got = k9.sor_tile_sweeps(u0, v0, *fields, n, 1.6, k9.origin_table(u0, r0, c0), 300, 400)
            want = k9.sor_tile_sweeps_plain(u0, v0, *fields, n, 1.6, r0, c0, 300, 400)
        else:
            got = k9.tile_sweeps(u0, v0, *fields, n, k9.origin_table(u0, r0, c0), 300, 400)
            want = k9.tile_sweeps_plain(u0, v0, *fields, n, r0, c0, 300, 400)
        _equal(got, want)  # every element of the padded shard, halo included


def _k2_edge_origins(s):
    """Shard origins that put the true top (left) edge of the first window
    at a warp's first row and inside a warp's rows (at a lane's first
    column, inside a lane and at its last column)."""
    _, _, lh = k2.k2_tile(s)
    rows = [-(k2.K2_WARP_ROWS * m - s) for m in (3, 4)]
    rows += [r - 1 for r in rows] + [r - 2 for r in rows]
    cols = [-(k2.K2_LANE_COLS * m - lh) for m in (3, 4)]
    cols += [c - 1 for c in cols] + [c - 3 for c in cols]
    return rows, cols


@pytest.mark.parametrize("s", [1, 3, 4, 8])
@pytest.mark.parametrize("shape", [(37, 45), (60, 140)])
def test_k9_true_edges_at_warp_and_lane_boundaries(dev, s, shape):
    rows, cols = _k2_edge_origins(s)
    # A 70 x 150 image: the shards hold its bottom and right edges too.
    h, w = 70, 150
    rows = rows + [h - shape[0] + 2, h - shape[0] + 5]
    cols = cols + [w - shape[1] + 3, w - shape[1] + 4]
    u0, v0, fields = _tile_problem(dev, shape, 76, stack=len(rows))
    org = k9.origin_table(u0, rows, cols)
    got = k9.tile_sweeps(u0, v0, *fields, 2 * s + 1, org, h, w, block_sweeps=s)
    _equal(got, k9.tile_sweeps_plain(u0, v0, *fields, 2 * s + 1, rows, cols, h, w))


@pytest.mark.parametrize("sor", [False, True])
def test_k9_stack_of_shards_is_one_launch(dev, sor):
    u0, v0, fields = _tile_problem(dev, (67, 93), 72, stack=3)
    rows, cols = [-4, 117, 300 - 67 + 3], [-3, 33, 400 - 93 + 4]
    counter = k9.sor_tile_sweeps if sor else k9.tile_sweeps
    counter.launches = 0
    if sor:
        got = k9.sor_tile_sweeps(u0, v0, *fields, 4, 1.6, k9.origin_table(u0, rows, cols), 300, 400)
        want = k9.sor_tile_sweeps_plain(u0, v0, *fields, 4, 1.6, rows, cols, 300, 400)
    else:
        got = k9.tile_sweeps(u0, v0, *fields, 4, k9.origin_table(u0, rows, cols), 300, 400)
        want = k9.tile_sweeps_plain(u0, v0, *fields, 4, rows, cols, 300, 400)
    assert counter.launches == 1
    _equal(got, want)
    for k in range(3):
        f = [a[k] for a in fields]
        org = k9.origin_table(u0[k], rows[k], cols[k])
        one = (k9.sor_tile_sweeps(u0[k], v0[k], *f, 4, 1.6, org, 300, 400) if sor
               else k9.tile_sweeps(u0[k], v0[k], *f, 4, org, 300, 400))
        _equal((got[0][k], got[1][k]), one)



@pytest.mark.parametrize("s", range(1, k3.K3_MAX_SWEEPS + 1))
def test_k9_sor_at_odd_and_even_origins_equals_plain(dev, s):
    # Shards of a 300 x 400 image whose origins flip the row or column
    # parity (or both), with true edges inside, one launch for the stack.
    ph, pw = 37, 150
    rows = [-4, -3, 117, 116, 5, 300 - ph + 3, 300 - ph + 4]
    cols = [-3, -4, 33, 32, -6, 400 - pw + 4, 400 - pw + 5]
    u0, v0, fields = _tile_problem(dev, (ph, pw), 104, stack=len(rows))
    org = k9.origin_table(u0, rows, cols)
    k9.sor_tile_sweeps.launches = 0
    got = k9.sor_tile_sweeps(u0, v0, *fields, 2 * s + 1, 1.6, org, 300, 400, block_sweeps=s)
    assert k9.sor_tile_sweeps.launches == k3.launches(2 * s + 1, s)
    _equal(got, k9.sor_tile_sweeps_plain(u0, v0, *fields, 2 * s + 1, 1.6, rows, cols, 300, 400))

@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("halo", [1, 3, 12])
@pytest.mark.parametrize("stack", [0, 2])
def test_k10_equals_plain(dev, n_shards, halo, stack):
    tiles = [_rand(((stack,) if stack else ()) + (12, 37), dev, 80 + k, n=1)[0]
             for k in range(n_shards)]
    ring.ring_halo_exchange.launches = 0
    got = ring.ring_halo_exchange(tiles, halo)
    assert ring.ring_halo_exchange.launches == 1  # one launch for the device
    for g, r in zip(got, ring.ring_halo_exchange_plain(tiles, halo)):
        assert torch.equal(g, r)


# K10's 16-byte rows (w % 4 == 0) and its 4-byte rows (w % 4 = 1, 2, 3), a
# halo of one row and of the whole shard (each row then lands in both
# neighbours' halos), rings of 1, 2 and 4 shards, single and stacked.
@pytest.mark.parametrize("w", [36, 37, 38, 39])
@pytest.mark.parametrize("halo", [1, 10])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("stack", [0, 3])
def test_k10_row_paths_equal_plain(dev, w, halo, n_shards, stack):
    tiles = [_rand(((stack,) if stack else ()) + (10, w), dev, 85 + k, n=1)[0]
             for k in range(n_shards)]
    ring.ring_halo_exchange.launches = 0
    got = ring.ring_halo_exchange(tiles, halo)
    assert ring.ring_halo_exchange.launches == 1  # one launch for the device
    for g, r in zip(got, ring.ring_halo_exchange_plain(tiles, halo)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("halo", [1, 5, 12])
def test_k10_unaligned_views_equal_plain(dev, halo):
    # Contiguous views 4 bytes off a 16-byte boundary, at a width that is a
    # multiple of 4: the 4-byte rows.
    h, w = 12, 64
    tiles = [torch.from_numpy(np.random.default_rng(88 + k).normal(0, 0.5, 1 + h * w)
                              .astype(np.float32)).to(dev)[1:].view(h, w) for k in range(4)]
    got = ring.ring_halo_exchange(tiles, halo)
    for g, r in zip(got, ring.ring_halo_exchange_plain(tiles, halo)):
        assert torch.equal(g, r)


def _ring_problem(dev, my, mx, th, tw, sy, sx, seed, h, w):
    grid_u, grid_v, grid_f, origins = [], [], [], []
    for i in range(my):
        ru, rv, rf, ro = [], [], [], []
        for j in range(mx):
            u0, v0 = _rand((th, tw), dev, seed + 10 * i + j, normal=True)
            a, b = _rand((th + 2 * sy, tw + 2 * sx), dev, seed + 100 + 10 * i + j)
            ru.append(u0)
            rv.append(v0)
            rf.append(tuple(k1.derivatives_plain(a, b, 0.5)))
            ro.append((i * th, j * tw))
        grid_u.append(ru)
        grid_v.append(rv)
        grid_f.append(rf)
        origins.append(ro)
    return grid_u, grid_v, grid_f, origins


@pytest.mark.parametrize("my", [1, 2, 4])
@pytest.mark.parametrize("n,s", [(7, 4), (12, 4), (13, 8)])
def test_k11_equals_plain(dev, my, n, s):
    th, tw, sy = 40, 93, 8
    gu, gv, gf, go = _ring_problem(dev, my, 1, th, tw, sy, 0, 90, my * th - 3, tw)
    u, v, f = [r[0] for r in gu], [r[0] for r in gv], [r[0] for r in gf]
    rows = [o[0][0] for o in go]
    ring.ring_fused_sweeps.launches = 0
    got = ring.ring_fused_sweeps(u, v, f, n, s, rows, my * th - 3, tw)
    assert ring.ring_fused_sweeps.launches == 1  # one launch for every shard
    want = ring.ring_fused_sweeps_plain(u, v, f, n, s, rows, my * th - 3, tw)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("my,mx", [(1, 1), (2, 2), (1, 4), (2, 1)])
@pytest.mark.parametrize("n,s", [(7, 4), (12, 4), (13, 8)])
def test_k12_equals_plain(dev, my, mx, n, s):
    th, tw, sg = 40, 50, 8
    h, w = my * th - 3, mx * tw - 5
    gu, gv, gf, go = _ring_problem(dev, my, mx, th, tw, sg, sg, 95, h, w)
    ring.ring_fused_sweeps_2d.launches = 0
    got = ring.ring_fused_sweeps_2d(gu, gv, gf, n, s, go, h, w)
    assert ring.ring_fused_sweeps_2d.launches == 1
    want = ring.ring_fused_sweeps_2d_plain(gu, gv, gf, n, s, go, h, w)
    for i in range(my):
        for j in range(mx):
            _equal((got[0][i][j], got[1][i][j]), (want[0][i][j], want[1][i][j]))


# K11 and K12 on K2's window loop. Meshes: (my, 0) is a 1-D ring of my
# shards (K11), (my, mx) a 2-D one (K12).
RING_MESHES = [(1, 0), (2, 0), (4, 0), (5, 0), (1, 1), (2, 2), (1, 4), (4, 1), (3, 2)]


def _ring_rings(dev, my, mx, s, seed, stack=0, warm=True, th=None, tw=None):
    """One ring of Shards with a halo exactly s deep: by default two K2
    tile rows a shard, the second cut short, and a true image that ends
    inside the last shards. Returns (rings, h, w)."""
    th = th or (k2.K2_WINDOW_H - 2 * s) + 7
    tw = tw or (37 if mx == 0 else s + 21)
    sx, mx = (s if mx else 0), max(mx, 1)
    lead = (stack,) if stack else ()
    grid = []
    for i in range(my):
        row = []
        for j in range(mx):
            if warm:
                u0, v0 = _rand(lead + (th, tw), dev, seed + 10 * i + j, normal=True)
            else:
                u0, v0 = (torch.zeros(lead + (th, tw), device=dev) for _ in range(2))
            a, b = _rand(lead + (th + 2 * s, tw + 2 * sx), dev, seed + 100 + 10 * i + j)
            row.append(ring.Shard(u0, v0, tuple(k1.derivatives_plain(a, b, 0.5)), i * th,
                                  j * tw))
        grid.append(row)
    return [grid], my * th - 2, mx * tw - 3


def _ring_equal(rings, n, s, h, w, **kw):
    two_d = rings[0][0][0].fields[0].shape[-1] != rings[0][0][0].u.shape[-1]
    counter = ring.ring_fused_sweeps_2d if two_d else ring.ring_fused_sweeps
    counter.launches = 0
    got = ring.ring_solve(rings, n, s, h, w, **kw)
    assert counter.launches == 1  # one launch for the device's every image
    want = ring.ring_solve_plain(rings, n, s, h, w)
    for g_grid, w_grid in zip(got, want):
        for g_row, w_row in zip(g_grid, w_grid):
            for g, r in zip(g_row, w_row):
                _equal(g, r)


@pytest.mark.parametrize("s", range(1, ring.MAX_RING_SWEEPS + 1))
@pytest.mark.parametrize("my,mx", RING_MESHES)
def test_k11_k12_equal_plain_at_every_block_depth(dev, my, mx, s):
    # n = 2s + 1: three sweep blocks, the last one short; sx = s, so s not a
    # multiple of 4 runs the 4-byte path.
    rings, h, w = _ring_rings(dev, my, mx, s, 200 + s)
    _ring_equal(rings, 2 * s + 1, s, h, w)


@pytest.mark.parametrize("my,mx", RING_MESHES)
@pytest.mark.parametrize("stack", [0, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k11_k12_stacks_and_starts_equal_plain(dev, my, mx, stack, warm):
    rings, h, w = _ring_rings(dev, my, mx, 4, 230, stack=stack, warm=warm)
    _ring_equal(rings, 13, 4, h, w)


@pytest.mark.parametrize("my,mx", [(4, 0), (2, 2)])
@pytest.mark.parametrize("th", [60, 130])
@pytest.mark.parametrize("blocks", [0, 1, 3])
def test_k11_k12_tile_orders_and_small_grids_equal_plain(dev, my, mx, th, blocks):
    # Shards of 2 x 3 K2 tiles (edge rows only) or 4 x 3 (the interior rows
    # walked first, the edge rows last), by the resident grid or by 1 or 3
    # blocks (each doing every exchange job).
    rings, h, w = _ring_rings(dev, my, mx, 4, 240, th=th, tw=300)
    _ring_equal(rings, 17, 4, h, w, blocks=blocks)


@pytest.mark.parametrize("mx", [0, 1])
def test_k11_k12_unaligned_views_equal_plain(dev, mx):
    # One shard a device keeps its fields as given: contiguous views 4 bytes
    # off a 16-byte boundary run the 4-byte path over 4 sweep blocks.
    s, th, tw = 4, 50, 64
    sx = s if mx else 0
    eh, ew = th + 2 * s, tw + 2 * sx
    flat = [torch.from_numpy(np.random.default_rng(250 + k).uniform(0, 1, 1 + eh * ew)
                             .astype(np.float32)).to(dev) for k in range(2)]
    fields = tuple(f.contiguous() for f in k1.derivatives_plain(
        *(f[1:].view(eh, ew) for f in flat), 0.5))
    views = []
    for f in fields:
        buf = torch.empty(1 + eh * ew, device=dev)
        buf[1:] = f.flatten()
        views.append(buf[1:].view(eh, ew))
    assert views[0].data_ptr() % 16 != 0
    u0, v0 = _rand((th, tw), dev, 252, normal=True)
    rings = [[[ring.Shard(u0, v0, tuple(views), 0, 0)]]]
    _ring_equal(rings, 15, s, th - 1, tw - 2)


@pytest.mark.parametrize("s", range(1, ring.MAX_RING_SWEEPS + 1))
@pytest.mark.parametrize("two_d", [False, True])
def test_k11_k12_geometry_has_no_spills(dev, s, two_d):
    geo = ring.ring_geometry(dev, s, two_d=two_d)
    th, tw, _ = k2.k2_tile(s)
    assert (geo["tile_h"], geo["tile_w"]) == (th, tw)
    assert geo["threads"] == k2.K2_THREADS and geo["smem_bytes"] == k2.K2_SMEM_BYTES
    assert 0 < geo["registers"] <= 65536 // k2.K2_THREADS and geo["spill_bytes"] == 0
    assert geo["blocks_per_sm"] == 1


def test_k11_k12_refuse_a_block_deeper_than_k2s_window(dev):
    rings, h, w = _ring_rings(dev, 2, 2, 17, 260, th=40, tw=40)
    with pytest.raises(ValueError, match="at most 16"):
        ring.ring_solve(rings, 40, 17, h, w)


def test_ring_tables_are_kept_per_stream(dev):
    # A table is read only by launches on the stream it was made on, so an
    # evicted one never goes back to another stream's pool while they run.
    side = torch.cuda.Stream(dev)
    first = ring._table([b"ring table"], dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        other = ring._table([b"ring table"], dev)
        rings, h, w = _ring_rings(dev, 2, 0, 4, 280)
        _ring_equal(rings, 9, 4, h, w)
    torch.cuda.current_stream(dev).wait_stream(side)
    assert other.data_ptr() != first.data_ptr()
    assert ring._table([b"ring table"], dev) is first


@pytest.mark.parametrize("two_d", [False, True])
def test_k11_k12_grid_too_large_is_refused(dev, two_d):
    rings, h, w = _ring_rings(dev, 2, int(two_d), 4, 270)
    with pytest.raises(RuntimeError, match="hs_ring_fused_sweeps"):
        ring.ring_solve(rings, 8, 4, h, w, blocks=100_000)


@pytest.mark.parametrize("my,mx", [(1, 1), (2, 2), (4, 4), (1, 4), (4, 1)])
@pytest.mark.parametrize("s", [1, 4])
def test_tiled_solve_on_a_virtual_mesh_equals_untiled(dev, my, mx, s):
    i1, i2 = _rand((130, 197), dev, 60)
    mesh = make_mesh(MeshConfig(y=my, x=mx), [dev] * (my * mx))
    cfg = HSConfig(alpha=0.5, iters=23)
    k9.tile_sweeps.launches = 0
    got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=s)
    assert k9.tile_sweeps.launches == -(-23 // s)  # one a block for 16 shards
    _equal(got, hs_solve(i1, i2, cfg))
    _equal(got, hs_solve_tiled(i1, i2, HSConfig(alpha=0.5, iters=23, backend="torch"),
                               mesh, halo_sweeps=s))
    ring.ring_fused_sweeps.launches = ring.ring_fused_sweeps_2d.launches = 0
    rdma = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=s, halo_impl="rdma")
    assert ring.ring_fused_sweeps.launches + ring.ring_fused_sweeps_2d.launches == 1
    _equal(rdma, got)
    sor = HSConfig(alpha=0.5, iters=9, solver="sor", omega=1.6)
    if 130 // my > 4 * s and 197 // mx > 4 * s:
        _equal(hs_solve_tiled(i1, i2, sor, mesh, halo_sweeps=s),
               hs_solve_tiled(i1, i2, dataclasses.replace(sor, backend="torch"), mesh,
                              halo_sweeps=s))


def test_tiled_solve_stack_and_tol_on_a_virtual_mesh(dev):
    i1, i2 = _rand((4, 64, 96), dev, 61)
    i2[1] = i1[1]  # converges at the first check
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2), [dev] * 8)
    for cfg in (HSConfig(alpha=0.5, iters=20), HSConfig(alpha=0.5, iters=40, tol=1e-3)):
        got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=3)
        _equal(got, hs_solve_tiled(i1, i2, dataclasses.replace(cfg, backend="torch"), mesh,
                                   halo_sweeps=3))
    _equal(hs_solve_tiled(i1, i2, HSConfig(alpha=0.5, iters=20), mesh, halo_sweeps=3,
                          halo_impl="rdma"),
           hs_solve_tiled(i1, i2, HSConfig(alpha=0.5, iters=20), mesh, halo_sweeps=3))


def test_mixed_mesh_is_refused(dev):
    with pytest.raises(ValueError, match="CPU devices or CUDA devices"):
        make_mesh(MeshConfig(y=1, x=2), ["cpu", dev])


def test_k11_grid_too_large_is_refused(dev):
    gu, gv, gf, go = _ring_problem(dev, 2, 1, 40, 93, 4, 0, 97, 80, 93)
    u, v, f = [r[0] for r in gu], [r[0] for r in gv], [r[0] for r in gf]
    with pytest.raises(RuntimeError, match="hs_ring_fused_sweeps"):
        ring.ring_fused_sweeps(u, v, f, 8, 4, [0, 40], 80, 93, blocks=100_000)


def _dist_guarded(dev, dtype=torch.float32):
    """(tensor, call) of each dist/ kernel entry, its arrays in `dtype`."""
    u0, v0, fields = (a.to(dtype) if torch.is_tensor(a) else tuple(f.to(dtype) for f in a)
                      for a in _tile_problem(dev, (40, 56), 75))
    gu, gv, gf, go = _ring_problem(dev, 2, 1, 20, 56, 4, 0, 76, 40, 56)
    gu, gv = ([[a.to(dtype) for a in row] for row in g] for g in (gu, gv))
    gf = [[tuple(f.to(dtype) for f in fs) for fs in row] for row in gf]
    i1, i2 = (a.to(dtype) for a in _rand((40, 56), dev, 77))
    mesh = make_mesh(MeshConfig(y=2, x=2), [dev] * 4)
    org = k9.origin_table(u0, -3, -3)
    cfg = HSConfig(iters=3, dtype=str(dtype).removeprefix("torch."))
    return [
        (u0, lambda a: k9.tile_sweeps(a, v0, *fields, 3, org, 40, 56)),
        (u0, lambda a: k9.sor_tile_sweeps(a, v0, *fields, 3, 1.6, org, 40, 56)),
        (u0, lambda a: ring.ring_halo_exchange([a, v0], 2)),
        (gu[0][0], lambda a: ring.ring_fused_sweeps([a, gu[1][0]], [gv[0][0], gv[1][0]],
                                                    [gf[0][0], gf[1][0]], 4, 4, [0, 20], 40, 56)),
        (i1, lambda a: hs_solve_tiled(a, i2, cfg, mesh)),
    ]


@pytest.mark.parametrize("k", range(5))
def test_dist_kernel_entries_refuse_frames_that_require_grad(dev, k):
    base, call = _dist_guarded(dev)[k]
    a = base.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="does not differentiate.*no_grad"):
        call(a)
    with torch.no_grad():
        call(a)


# -- Lucas-Kanade, ego-motion and hs_energy: plain torch on the card -------------
#
# No kernel: LK, the ego-motion fit and hs_energy are PyTorch ops on the
# frames' device, as the reference runs them as XLA ops outside any kernel,
# and none of K1-K12 launches. LK is elementwise ops, gathers and exact sums
# of integer-valued floats (the tiled warp's tile means), which round alike
# on the card and the CPU: the card equals the CPU run bitwise. The
# ego-motion moments and the energy are float32 sums, which the card adds
# in another order: 1e-5 relative (1e-6 absolute near 0). Gradients pass
# through index_put's atomic adds on the card: 1e-5 relative to the largest
# entry.

SUM_RTOL = 1e-5
SUM_ATOL = 1e-6

LK_SOLVES = [
    (1, {}, 0),
    (2, dict(iters=2, max_step=0.5, smooth=False, warp="gather"), 0),
    (3, dict(window=9, warp="tiled"), 2),
]


def _launch_counts():
    return {n: w.launches for n, w in counted_wrappers().items()}


def _equal_cpu(got, want):
    for g, w in zip(got, want):
        assert g.is_cuda and not w.is_cuda
        assert torch.equal(g.cpu(), w), float((g.cpu() - w).abs().max())


def _lk_pair(dev, h=131, w=190):
    i1, i2, _ = translation_pair(h, w, 0.7, -0.4, key=5)
    return torch.from_numpy(i1).to(dev), torch.from_numpy(i2).to(dev)


@pytest.mark.parametrize("levels,fields,radius", LK_SOLVES)
def test_lk_solve_on_the_card_equals_cpu(dev, levels, fields, radius):
    i1, i2 = _lk_pair(dev)
    cfg, pyr = LKConfig(**fields), PyramidConfig(levels=levels, warp_radius=radius)
    before = _launch_counts()
    got = lk_solve(i1, i2, cfg, pyr)
    assert got.u.device == dev and _launch_counts() == before
    _equal_cpu(got, lk_solve(i1.cpu(), i2.cpu(), cfg, pyr))


@pytest.mark.parametrize("levels", [1, 2])
def test_lk_solve_batched_on_the_card_equals_cpu_and_singles(dev, levels):
    a, b = _rand((3, 67, 140), dev, 81)
    b = 0.5 * (a + b)  # correlated frames, so that the flow is not noise
    cfg, pyr = LKConfig(iters=2, window=9), PyramidConfig(levels=levels)
    before = _launch_counts()
    got = lk_solve_batched(a, b, cfg, pyr)
    assert _launch_counts() == before
    _equal_cpu(got, lk_solve_batched(a.cpu(), b.cpu(), cfg, pyr))
    for k in range(3):
        one = lk_solve_batched(a[k:k + 1], b[k:k + 1], cfg, pyr)
        assert torch.equal(got.u[k], one.u[0]) and torch.equal(got.v[k], one.v[0])


def test_lk_streams_on_the_card_equal_cpu(dev):
    vid = synthetic_sequence(5, 40, 140, tx=1.0, ty=0.5, key=3)[0]
    cfg = LKConfig(iters=2, window=9)
    before = _launch_counts()
    got = list(flow_stream(vid, lk=cfg, chunk=2))  # numpy frames: cuda:0
    occ = list(flow_stream_occlusion(vid, lk=cfg, chunk=2))
    fwd, bwd = solve_bidirectional(vid[0], vid[1], lk=cfg)
    f_occ, m_occ = flow_with_occlusion(vid[0], vid[1], lk=cfg, a=0.0, b=1e-4)
    torch.cuda.synchronize()
    assert _launch_counts() == before
    for g, w in zip(got, flow_stream(vid, lk=cfg, chunk=2, device="cpu")):
        assert g.u.device == dev
        _equal_cpu(g, w)
    for (gf, gm), (wf, wm) in zip(occ, flow_stream_occlusion(vid, lk=cfg, chunk=2,
                                                             device="cpu")):
        _equal_cpu(gf, wf)
        assert torch.equal(gm.cpu(), wm)
    wf, wb = solve_bidirectional(vid[0], vid[1], lk=cfg, device="cpu")
    _equal_cpu(fwd, wf)
    _equal_cpu(bwd, wb)
    wf, wm = flow_with_occlusion(vid[0], vid[1], lk=cfg, a=0.0, b=1e-4, device="cpu")
    _equal_cpu(f_occ, wf)
    assert torch.equal(m_occ.cpu(), wm) and 0 < float(wm.float().mean()) < 1


def test_numpy_inputs_of_lk_egomotion_and_energy_default_to_cuda0(dev):
    i1, i2, _ = translation_pair(48, 64, 0.7, -0.4, key=5)
    f = lk_solve(i1, i2)
    assert f.u.device == torch.device("cuda", 0)
    fb = lk_solve_batched(np.stack([i1, i2]), np.stack([i2, i1]))
    assert fb.u.device == torch.device("cuda", 0)
    host = Flow(f.u.cpu().numpy(), f.v.cpu().numpy())
    assert estimate_egomotion(host).tx.device == torch.device("cuda", 0)
    assert hs_energy(i1, i2, host).device == torch.device("cuda", 0)


def test_lk_solve_backward_on_the_card(dev):
    i1, i2, _ = translation_pair(48, 64, 0.5, 0.0, key=11)
    grads = {}
    for d in (dev, torch.device("cpu")):
        a = torch.from_numpy(i1).to(d).requires_grad_()
        b = torch.from_numpy(i2).to(d).requires_grad_()
        f = lk_solve(a, b, LKConfig(iters=2, window=9))
        torch.mean(f.u * f.u + f.v * f.v).backward()
        grads[d.type] = (a.grad.cpu(), b.grad.cpu())
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert bool(torch.isfinite(g).all()) and float(w.abs().max()) > 0
        assert float((g - w).abs().max()) <= SUM_RTOL * float(w.abs().max())


def _close_sums(got, want):
    for g, w in zip(got, want):
        assert g.is_cuda
        g = g.cpu()
        tol = max(SUM_ATOL, SUM_RTOL * float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol, (g, w)


@pytest.mark.parametrize("stack", [0, 2])
@pytest.mark.parametrize("center,offset", [(None, None), ((31.5, 23.5), None),
                                           (None, (270, 480))])
def test_egomotion_on_the_card_equals_cpu(dev, stack, center, offset):
    shape = (270, 480) if stack == 0 else (stack, 270, 480)
    rng = np.random.default_rng(82)
    yy, xx = np.mgrid[0:270, 0:480].astype(np.float32)
    u = (0.3 + 0.002 * (xx - 239.5) + 0.001 * (yy - 134.5)
         + rng.normal(0, 0.05, shape)).astype(np.float32)
    v = (-0.2 + 0.002 * (yy - 134.5) - 0.001 * (xx - 239.5)
         + rng.normal(0, 0.05, shape)).astype(np.float32)
    kw = dict(center=center, global_offset=offset)
    got = estimate_egomotion(Flow(torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev)), **kw)
    want = estimate_egomotion(Flow(torch.from_numpy(u), torch.from_numpy(v)), **kw)
    _close_sums(got, want)
    _close_sums(got.focus_of_expansion(), want.focus_of_expansion())


@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("shape", [(270, 480), (3, 67, 140)])
def test_hs_energy_on_the_card_equals_cpu(dev, variant, shape):
    i1, i2 = _rand(shape, dev, 83)
    u, v = _rand(shape, dev, 84, normal=True)
    got = hs_energy(i1, i2, Flow(u, v), 0.5, variant)
    want = hs_energy(i1.cpu(), i2.cpu(), Flow(u.cpu(), v.cpu()), 0.5, variant)
    assert got.is_cuda and got.shape == ()
    assert abs(float(got) - float(want)) <= SUM_RTOL * abs(float(want))


# -- bfloat16: K1, K2, K6 and K7's bfloat16 builds = their plain twins -----------
#
# The storage rule (ops/stencils.py `store`): bfloat16 arrays, float32
# arithmetic, each array rounded once where it is stored, u and v after
# every sweep. The kernels' bfloat16 builds follow it, so they equal the
# plain bfloat16 twins bitwise, with the float32 plan's launches.

BF16 = torch.bfloat16


def _rand16(shape, dev, seed, n=2, normal=False):
    return [a.to(BF16) for a in _rand(shape, dev, seed, n, normal)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("zero_sweep", [False, True])
def test_k1_bf16_equals_plain(dev, shape, b, variant, zero_sweep):
    i1, i2 = _rand16(shape if b == 1 else (b,) + shape, dev, 100)
    got = k1.hs_derivatives(i1, i2, 0.7, variant, zero_sweep)
    assert all(g.dtype == BF16 for g in got)
    _equal(got, k1.derivatives_plain(i1, i2, 0.7, variant, zero_sweep))
    if b > 1:
        for k in range(b):
            _equal([g[k] for g in got], k1.hs_derivatives(i1[k], i2[k], 0.7, variant,
                                                          zero_sweep))


# Widths a multiple of 8 stage bfloat16 rows 16 bytes at a time where the
# tile's first column is a multiple of 8 (csrc/k2_window.cuh `bf16_wide`).
BF16_WIDE_SHAPES = [(70, 248), (33, 112)]


@pytest.mark.parametrize("shape", K2_EDGE_SHAPES + [(67, 93), (130, 129)] + BF16_WIDE_SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("s", range(1, 13))
def test_k2_bf16_edge_shapes_equal_plain(dev, shape, b, s):
    full = shape if b == 1 else (b,) + shape
    i1, i2 = _rand16(full, dev, 101)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand16(full, dev, 102, normal=True)
    n = 2 * k2.sweeps_per_launch(s) + 1  # s does not divide n
    k2.jacobi_sweeps.launches = 0
    got = k2.jacobi_sweeps(u0, v0, *fields, n, block_sweeps=s)
    assert k2.jacobi_sweeps.launches == -(-n // k2.sweeps_per_launch(s))
    assert got[0].dtype == BF16
    _equal(got, k2.jacobi_sweeps_plain(u0, v0, *fields, n))


@pytest.mark.parametrize("n", range(1, 24))
def test_k2_bf16_every_n_equals_plain(dev, n):
    i1, i2 = _rand16((3, 67, 93), dev, 103)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand16((3, 67, 93), dev, 104, normal=True)
    keep = (u0.clone(), v0.clone())
    k2.jacobi_sweeps.launches = 0
    _equal(k2.jacobi_sweeps(u0, v0, *fields, n), k2.jacobi_sweeps_plain(u0, v0, *fields, n))
    assert k2.jacobi_sweeps.launches == -(-n // k2.sweeps_per_launch(0))
    _equal((u0, v0), keep)


@pytest.mark.parametrize("w", [64, 93])
@pytest.mark.parametrize("off", [1, 4])
def test_k2_bf16_unaligned_views_equal_plain(dev, w, off):
    # Views 2 bytes off an 8-byte boundary take the 2-byte loads, 8 bytes off
    # a 16-byte one the 8-byte copies.
    h = 50
    flat = [torch.from_numpy(np.random.default_rng(105 + k).normal(0, 0.5, off + h * w)
                             .astype(np.float32)).to(dev).to(BF16) for k in range(4)]
    u0, v0, i1, i2 = (f[off:].view(h, w) for f in flat)
    fields = k1.derivatives_plain(i1.abs(), i2.abs(), 0.5)
    _equal(k2.jacobi_sweeps(u0, v0, *fields, 11), k2.jacobi_sweeps_plain(u0, v0, *fields, 11))


@pytest.mark.parametrize("shape", BEYOND_SHAPES + BF16_WIDE_SHAPES)
@pytest.mark.parametrize("n,s", BEYOND_NS)
@pytest.mark.parametrize("warm", [False, True])
def test_k6_k7_bf16_equal_plain(dev, shape, n, s, warm):
    i1, i2 = _rand16(shape, dev, 106)
    init = _rand16(shape, dev, 107, normal=True) if warm else (None, None)
    want = k6.hs_solve_fused_plain(i1, i2, 0.5, n, "hs_cube", *init)
    assert want[0].dtype == BF16
    for blocks in (0, 2):
        _equal(k6.hs_solve_fused(i1, i2, 0.5, n, "hs_cube", *init, block_sweeps=s,
                                 blocks=blocks), want)
    for band, blocks in ((0, 0), (16, 0), (16, 8)):
        _equal(k7.hs_solve_skewed(i1, i2, 0.5, n, "hs_cube", *init, block_sweeps=s,
                                  band=band, blocks=blocks), want)
    _equal(sr.hs_solve_resident(i1, i2, 0.5, n, "hs_cube", *init, block_sweeps=s), want)


@pytest.mark.parametrize("shape", K6_K7_EDGE_SHAPES)
@pytest.mark.parametrize("s", range(1, K6_K7_MAX_S + 1))
def test_k6_k7_bf16_every_s_at_edge_shapes(dev, shape, s):
    i1, i2 = _rand16(shape, dev, 108)
    u0, v0 = _rand16(shape, dev, 109, normal=True)
    n = 2 * s + 1
    for init in ((None, None), (u0, v0)):
        want = k6.hs_solve_fused_plain(i1, i2, 0.5, n, "central", *init)
        _equal(k6.hs_solve_fused(i1, i2, 0.5, n, "central", *init, block_sweeps=s), want)
        _equal(k7.hs_solve_skewed(i1, i2, 0.5, n, "central", *init, block_sweeps=s), want)
        _equal(k7.hs_solve_skewed(i1, i2, 0.5, n, "central", *init, block_sweeps=s,
                                  band=1, blocks=1), want)


@pytest.mark.parametrize("b", [1, 3])
def test_k6_k7_bf16_stacks_and_unaligned_views(dev, b):
    i1, i2 = _rand16((b, 131, 130), dev, 110)
    want = k6.hs_solve_fused_batched_plain(i1, i2, 0.5, 27)
    _equal(k6.hs_solve_fused_batched(i1, i2, 0.5, 27, blocks=3), want)
    _equal(k7.hs_solve_skewed_batched(i1, i2, 0.5, 27, band=24), want)
    for w, off in ((93, 1), (248, 4), (248, 8)):  # the 2-byte, 8-byte and 16-byte paths
        h = 70
        flat = [torch.from_numpy(np.random.default_rng(111 + k).normal(0, 0.5, off + h * w)
                                 .astype(np.float32)).to(dev).to(BF16) for k in range(4)]
        u0, v0, j1, j2 = (f[off:].view(h, w) for f in flat)
        j1, j2 = j1.abs(), j2.abs()
        want = k6.hs_solve_fused_plain(j1, j2, 0.5, 29, "hs_cube", u0, v0)
        _equal(k6.hs_solve_fused(j1, j2, 0.5, 29, "hs_cube", u0, v0, blocks=b), want)
        _equal(k7.hs_solve_skewed(j1, j2, 0.5, 29, "hs_cube", u0, v0, band=1, blocks=b),
               want)


@pytest.mark.parametrize("s", range(1, K6_K7_MAX_S + 1))
def test_bf16_builds_have_no_spills(dev, s):
    geos = (k2.k2_geometry(dev, s, dtype=BF16), k6.k6_geometry(dev, s, BF16),
            k7.k7_geometry(dev, 2160, 3840, s, dtype=BF16))
    for geo in geos:
        assert (geo["tile_h"], geo["tile_w"]) == k2.k2_tile(s)[:2]
        assert geo["threads"] == k2.K2_THREADS and geo["spill_bytes"] == 0
        assert 0 < geo["registers"] <= 65536 // k2.K2_THREADS
        assert geo["blocks_per_sm"] >= 1
    assert geos[0]["smem_bytes"] == geos[1]["smem_bytes"] == k2.K2_SMEM_BYTES // 2
    assert geos[2]["smem_bytes"] == 4 * k2.K2_SMEM_BYTES // 6


def test_bf16_launch_counts_and_routes_are_float32s(dev):
    i1, i2 = _rand((96, 128), dev, 112)
    counters = (k1.hs_derivatives, k2.jacobi_sweeps, k6.hs_solve_fused, k7.hs_solve_skewed)
    cfg = HSConfig(alpha=0.5, iters=100)
    big = _rand((2160, 3840), dev, 113)
    cases = [(lambda c: hs_solve(i1, i2, c), cfg),
             (lambda c: hs_pyramid(i1, i2, c, PyramidConfig(levels=3)), cfg),
             (lambda c: hs_solve_batched(torch.stack([i1, i2, i1]), torch.stack([i2, i1, i2]),
                                         c), cfg),
             (lambda c: hs_solve(*big, c), HSConfig(alpha=0.5, iters=64)),
             (lambda c: hs_solve(*big[:1], big[1], c),
              HSConfig(alpha=0.5, iters=64, deriv_variant="central"))]
    for run, c32 in cases:
        counts = []
        for c in (c32, dataclasses.replace(c32, dtype="bfloat16")):
            for k in counters:
                k.launches = 0
            got = run(c)
            counts.append(tuple(k.launches for k in counters))
            assert got.u.dtype == (BF16 if c.dtype == "bfloat16" else torch.float32)
            _equal(got, run(dataclasses.replace(c, backend="torch")))
        assert counts[0] == counts[1], counts


def test_bf16_entry_points_equal_the_plain_route(dev):
    rng = np.random.default_rng(114)
    frames = torch.from_numpy(rng.uniform(0, 1, (5, 72, 96)).astype(np.float32)).to(dev)
    cfg = HSConfig(alpha=0.5, iters=30, dtype="bfloat16")
    plain = dataclasses.replace(cfg, backend="torch")
    i1, i2 = frames[0], frames[1]
    pyr = PyramidConfig(levels=2)
    for c, p in ((cfg, plain), (dataclasses.replace(cfg, tol=1e-3, block_sweeps=4),
                                dataclasses.replace(plain, tol=1e-3, block_sweeps=4))):
        _equal(hs_solve(i1, i2, c), hs_solve(i1, i2, p))
        _equal(hs_solve_batched(frames[:-1], frames[1:], c),
               hs_solve_batched(frames[:-1], frames[1:], p))
        _equal(hs_solve_batched(frames[:-1], frames[1:], c, pyr),
               hs_solve_batched(frames[:-1], frames[1:], p, pyr))
    _equal(hs_pyramid(i1, i2, cfg, pyr), hs_pyramid(i1, i2, plain, pyr))
    for a, b in zip(flow_stream(frames, cfg, chunk=2), flow_stream(frames, plain, chunk=2)):
        assert a.u.dtype == BF16
        _equal(a, b)
    for prior in (False, True):
        for a, b in zip(flow_stream_warm(frames, cfg, warp_prior=prior),
                        flow_stream_warm(frames, plain, warp_prior=prior)):
            _equal(a, b)
    for (a, ma), (b, mb) in zip(flow_stream_occlusion(frames, cfg, chunk=2, a=0.0, b=1e-4),
                                flow_stream_occlusion(frames, plain, chunk=2, a=0.0, b=1e-4)):
        _equal(a, b)
        assert torch.equal(ma, mb)
    for a, b in zip(solve_bidirectional(i1, i2, cfg), solve_bidirectional(i1, i2, plain)):
        _equal(a, b)


@pytest.mark.parametrize("shape,name", [(s, n) for s in _GRAD_SHAPES for n in (
    "K1", "K2", "K1 + K2 zero", "K1 + K2 warm", "K1 + K6 zero", "K1 + K6 warm",
    "K1 + K7 zero", "K1 + K7 warm")])
def test_bf16_entries_differentiate_as_their_plain_twins(dev, shape, name):
    inputs, call, twin = _grad_entries(dev, shape)[name]
    inputs = [t.to(BF16).requires_grad_() for t in inputs]
    if name == "K2":  # the fields in bfloat16, from bfloat16 frames
        i1, i2 = _rand16(shape, dev, 66)
        inputs = inputs[:2] + [f.requires_grad_() for f in k1.derivatives_plain(i1, i2, 0.5)]
    counters = counted_wrappers().values()
    for c in counters:
        c.launches = 0
    outs, grads = _weighted_grads(call, inputs)
    fwd = sum(c.launches for c in counters)
    assert fwd > 0 and all(o.grad_fn is not None and o.dtype == BF16 for o in outs), name
    want_outs, want = _weighted_grads(twin, inputs)
    assert sum(c.launches for c in counters) == fwd
    _equal([o.detach() for o in outs], [o.detach() for o in want_outs])
    _equal(grads, want)


def test_bf16_is_refused_where_no_build_exists(dev):
    # Every kernel, K1-K12, has a bfloat16 build, and the tiled solves run
    # in bfloat16 (below), tvl1_solve_tiled too (once refused: = the untiled
    # bf16 solve); what is refused: arrays of two dtypes.
    u, v, i1, i2 = _rand16((40, 56), dev, 115, n=4)
    f = k1.derivatives_plain(i1, i2, 0.5)
    cfg = TVL1Config(warps=1, iters=8, dtype="bfloat16")
    _equal(tv.tvl1_solve_tiled(i1, i2, cfg, mesh=make_mesh(MeshConfig(y=2, x=2), [dev] * 4)),
           tvl1_solve(i1, i2, cfg))
    org = k9.origin_table(u[None], 0, 0)
    with pytest.raises(ValueError, match="dtype"):
        k9.tile_sweeps(u[None], v[None].float(), *(a[None] for a in f), 2, org, 40, 56)
    with pytest.raises(ValueError, match="dtype"):
        k9.sor_tile_sweeps(u[None], v[None], *(a[None].float() for a in f), 2, 1.6, org, 40, 56)
    with pytest.raises(ValueError, match="float32|bfloat16"):
        k1.hs_derivatives(i1, i2.float(), 0.5)  # one dtype across the arrays
    with pytest.raises(ValueError, match="float32|bfloat16"):
        k3.sor_sweeps(u, v.float(), *f, 5, 1.6)
    assert k3.k3_geometry(dev, 4, shard=True, dtype=BF16)["spill_bytes"] == 0
    cfg = HSConfig(iters=6, dtype="bfloat16")
    got = hs_solve_tiled(i1, i2, cfg, make_mesh(MeshConfig(y=2, x=1), [dev] * 2))
    assert got.u.dtype == BF16
    _equal(got, hs_solve(i1, i2, cfg))


# -- bfloat16: K3, K4 (freeze and sweeps) and K8's bfloat16 builds ---------------
#
# SOR rounds u and v once a sweep (the warps exchange rows in float32 inside
# a sweep), IRLS wd and ws at each freeze and u and v once a sweep: the
# bfloat16 builds equal the plain bfloat16 twins bitwise with the float32
# plan's launches, at K3's and K4's own edge shapes, every s, stacks, zero
# and warm starts, and on views that take the 2-, 8- and 16-byte paths.

BF16_WIDE_SHAPES_SOR = [(70, 248), (40, 136)]


def _wide_views(dev, h, w, off, seed, b=1):
    """Four (b, h, w) bfloat16 views `off` elements into their storage: 1
    takes the 2-byte loads, 4 the 8-byte copies, 8 the 16-byte copies where
    w is a multiple of 8."""
    flat = [torch.from_numpy(np.random.default_rng(seed + k).normal(0, 0.5, off + b * h * w)
                             .astype(np.float32)).to(dev).to(BF16) for k in range(4)]
    return [f[off:].view(b, h, w) for f in flat]


@pytest.mark.parametrize("shape", SHAPES + BF16_WIDE_SHAPES_SOR)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n,s", [(1, 0), (5, 2), (9, 1), (13, 0), (7, 3), (6, 4), (23, 11),
                                 (17, 8), (12, 5)])
def test_k3_bf16_equals_plain(dev, shape, b, n, s):
    i1, i2 = _rand16((b,) + shape, dev, 120)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand16((b,) + shape, dev, 121, normal=True)
    keep = (u0.clone(), v0.clone())
    k3.sor_sweeps.launches = 0
    got = k3.sor_sweeps(u0, v0, *fields, n, 1.7, block_sweeps=s)
    assert k3.sor_sweeps.launches == _k3_launches(u0.shape, n, s, dev)
    assert got[0].dtype == BF16
    _equal(got, k3.sor_sweeps_plain(u0, v0, *fields, n, 1.7))
    _equal((u0, v0), keep)
    for k in range(b):
        one = k3.sor_sweeps(u0[k], v0[k], *(f[k] for f in fields), n, 1.7, block_sweeps=s)
        _equal([g[k] for g in got], one)


@pytest.mark.parametrize("s", range(1, k3.K3_MAX_SWEEPS + 1))
@pytest.mark.parametrize("kind", ["one-", "one+", "two-", "two+", "wide"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k3_bf16_tile_edge_shapes_equal_plain(dev, s, kind, b, warm):
    th, tw, _, _ = k3.k3_tile(s)
    shape = (2 * th + 1, 2 * tw + 8) if kind == "wide" else _k3_edge_shape(s, kind)
    full = (b,) + shape
    i1, i2 = _rand16(full, dev, 122 + s)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = (_rand16(full, dev, 123, normal=True) if warm
              else (torch.zeros(full, device=dev, dtype=BF16),) * 2)
    n = 2 * s + 1
    k3.sor_sweeps.launches = 0
    got = k3.sor_sweeps(u0, v0, *fields, n, 1.7, block_sweeps=s)
    assert k3.sor_sweeps.launches == k3.launches(n, s)
    _equal(got, k3.sor_sweeps_plain(u0, v0, *fields, n, 1.7))


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 8, k3.K3_MAX_SWEEPS])
@pytest.mark.parametrize("w,off", [(93, 1), (96, 4), (248, 4), (248, 8)])
def test_k3_bf16_unaligned_views_equal_plain(dev, s, w, off):
    u0, v0, i1, i2 = _wide_views(dev, 50, w, off, 124, b=2)
    fields = k1.derivatives_plain(i1.abs(), i2.abs(), 0.5)
    n = s + 2
    _equal(k3.sor_sweeps(u0, v0, *fields, n, 1.7, block_sweeps=s),
           k3.sor_sweeps_plain(u0, v0, *fields, n, 1.7))


@pytest.mark.parametrize("shape", [(67, 93), (200, 336)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
def test_sor_driver_bf16_equals_plain(dev, shape, b, warm, variant):
    i1, i2 = _rand16((b,) + shape, dev, 125)
    init = _rand16((b,) + shape, dev, 126, normal=True) if warm else (None, None)
    k1.hs_derivatives.launches = 0
    k3.sor_sweeps.launches = 0
    got = sr.hs_solve_resident_sor(i1, i2, 0.5, 11, 1.6, variant, *init)
    assert (k1.hs_derivatives.launches, k3.sor_sweeps.launches) == (
        1, _k3_launches(i1.shape, 11, 0, dev))
    _equal(got, sr.hs_solve_resident_sor_plain(i1, i2, 0.5, 11, 1.6, variant, *init))


@pytest.mark.parametrize("shape", SHAPES + BF16_WIDE_SHAPES_SOR)
@pytest.mark.parametrize("b", [1, 3])
def test_k4_freeze_bf16_equals_plain(dev, shape, b):
    i1, i2 = _rand16((b,) + shape, dev, 127)
    ex, ey, et, _ = k1.derivatives_plain(i1, i2, 0.4)
    u, v = _rand16((b,) + shape, dev, 128, normal=True)
    for eps in ((0.05, 0.05), (0.01, 0.2)):
        got = k4.freeze_weights(u, v, ex, ey, et, *eps)
        assert got[0].dtype == BF16
        _equal(got, robust.charbonnier_weights(u, v, ex, ey, et, *eps))


@pytest.mark.parametrize("shape", SHAPES + BF16_WIDE_SHAPES_SOR)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n,s", [(1, 0), (5, 2), (13, 0), (17, 10), (9, 1), (20, 0),
                                 (29, k4.K4_MAX_SWEEPS), (16, k4.K4_MAX_SWEEPS + 1)])
def test_k4_sweeps_bf16_equal_plain(dev, shape, b, n, s):
    i1, i2 = _rand16((b,) + shape, dev, 129)
    ex, ey, et, _ = k1.derivatives_plain(i1, i2, 0.4)
    u0, v0 = _rand16((b,) + shape, dev, 130, normal=True)
    wd, ws = robust.charbonnier_weights(u0, v0, ex, ey, et, 0.05, 0.05)
    keep = (u0.clone(), v0.clone())
    k4.frozen_sweeps.launches = 0
    got = k4.frozen_sweeps(u0, v0, ex, ey, et, wd, ws, 0.3, n, block_sweeps=s)
    assert k4.frozen_sweeps.launches == _k4_launches(u0.shape, n, s, dev)
    assert got[0].dtype == BF16
    _equal(got, _robust_plain(u0, v0, ex, ey, et, wd, ws, n))
    _equal((u0, v0), keep)
    for k in range(b):
        one = k4.frozen_sweeps(u0[k], v0[k], ex[k], ey[k], et[k], wd[k], ws[k], 0.3, n,
                               block_sweeps=s)
        _equal([g[k] for g in got], one)


@pytest.mark.parametrize("s", range(1, k4.K4_MAX_SWEEPS + 1))
@pytest.mark.parametrize("kind", ["one-", "one+", "two-", "two+", "wide"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k4_bf16_tile_edge_shapes_equal_plain(dev, s, kind, b, warm):
    th, tw, _ = k4.k4_tile(s)
    shape = (2 * th + 1, 2 * tw + 8) if kind == "wide" else _k4_edge_shape(s, kind)
    full = (b,) + shape
    i1, i2 = _rand16(full, dev, 131 + s)
    ex, ey, et, _ = k1.derivatives_plain(i1, i2, 0.4, "central" if s % 2 else "hs_cube")
    u0, v0 = (_rand16(full, dev, 132, normal=True) if warm
              else (torch.zeros(full, device=dev, dtype=BF16),) * 2)
    wd, ws = robust.charbonnier_weights(u0, v0, ex, ey, et, 0.05, 0.05)
    n = 2 * s + 1
    k4.frozen_sweeps.launches = 0
    got = k4.frozen_sweeps(u0, v0, ex, ey, et, wd, ws, 0.3, n, block_sweeps=s)
    assert k4.frozen_sweeps.launches == k4.launches(n, s)
    _equal(got, _robust_plain(u0, v0, ex, ey, et, wd, ws, n))


@pytest.mark.parametrize("s", [1, 2, 3, 5, 7, k4.K4_MAX_SWEEPS])
@pytest.mark.parametrize("w,off", [(93, 1), (96, 4), (248, 4), (248, 8)])
def test_k4_bf16_unaligned_views_equal_plain(dev, s, w, off):
    u0, v0, i1, i2 = _wide_views(dev, 40, w, off, 133, b=2)
    ex, ey, et, _ = k1.derivatives_plain(i1.abs(), i2.abs(), 0.4)
    wd, ws = robust.charbonnier_weights(u0, v0, ex, ey, et, 0.05, 0.05)
    n = s + 2
    _equal(k4.frozen_sweeps(u0, v0, ex, ey, et, wd, ws, 0.3, n, block_sweeps=s),
           _robust_plain(u0, v0, ex, ey, et, wd, ws, n))
    _equal(k4.freeze_weights(u0, v0, ex, ey, et, 0.05, 0.05), (wd, ws))


@pytest.mark.parametrize("shape", [(67, 93), (200, 336)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("iters,k", [(13, 1), (13, 5), (25, 20), (100, 20)])
@pytest.mark.parametrize("warm", [False, True])
def test_robust_driver_bf16_equals_plain(dev, shape, b, iters, k, warm):
    i1, i2 = _rand16((b,) + shape, dev, 134)
    init = _rand16((b,) + shape, dev, 135, normal=True) if warm else (None, None)
    cfg = HSConfig(alpha=0.3, iters=iters, solver="robust", robust_update_every=k)
    k1.hs_derivatives.launches = 0
    k4.freeze_weights.launches = 0
    k4.frozen_sweeps.launches = 0
    got = k4.hs_solve_robust_resident(i1, i2, cfg, *init)
    blocks = robust.refreeze_blocks(iters, k)
    assert (k1.hs_derivatives.launches, k4.freeze_weights.launches,
            k4.frozen_sweeps.launches) == (
        1, len(blocks), sum(_k4_launches(i1.shape, m, 0, dev) for m in blocks))
    _equal(got, k4.hs_solve_robust_resident_plain(i1, i2, cfg, *init))


@pytest.mark.parametrize("shape", PLANES_SHAPES + [(40, 136)])
@pytest.mark.parametrize("n", [1, 4, 7])
@pytest.mark.parametrize("warm", [False, True])
def test_k8_bf16_equals_plain_and_the_k3_chain(dev, shape, n, warm):
    i1, i2 = _rand16(shape, dev, 136)
    init = _rand16(shape, dev, 137, normal=True) if warm else (None, None)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    k8.sor_planes.launches = 0
    got = k8.sor_planes(*init, *fields, n, 1.7)
    assert k8.sor_planes.launches == 1 and got[0].dtype == BF16
    _equal(got, k8.sor_planes_plain(*init, *fields, n, 1.7))
    z = torch.zeros_like(i1)
    _equal(got, k3.sor_sweeps_plain(*(init if warm else (z, z)), *fields, n, 1.7))
    whole = k8.hs_solve_sor_planes(i1, i2, 0.5, n, 1.7, "hs_cube", *init)
    _equal(whole, sr.hs_solve_resident_sor(i1, i2, 0.5, n, 1.7, "hs_cube", *init))
    _equal(whole, got)


@pytest.mark.parametrize("shape", [(39, 111), (41, 113), (80, 224), (1, 1)])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 7, k3.K3_MAX_SWEEPS])
@pytest.mark.parametrize("blocks", [0, 1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k8_bf16_every_s_and_small_grids_equal_plain(dev, shape, s, blocks, warm):
    i1, i2 = _rand16(shape, dev, 138)
    init = _rand16(shape, dev, 139, normal=True) if warm else (None, None)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    n = 3 * s + 2
    got = k8.sor_planes(*init, *fields, n, 1.7, block_sweeps=s, blocks=blocks)
    z = torch.zeros_like(i1)
    start = init if warm else (z, z)
    _equal(got, k3.sor_sweeps_plain(*start, *fields, n, 1.7))
    _equal(got, k3.sor_sweeps(*start, *fields, n, 1.7, block_sweeps=s))


@pytest.mark.parametrize("w,off", [(93, 1), (96, 4), (248, 4), (248, 8)])
@pytest.mark.parametrize("blocks", [0, 1, 3])
def test_k8_bf16_unaligned_views_equal_plain(dev, w, off, blocks):
    u0, v0, i1, i2 = (a[0] for a in _wide_views(dev, 70, w, off, 140))
    fields = k1.derivatives_plain(i1.abs(), i2.abs(), 0.5)
    for init in ((u0, v0), (None, None)):
        z = torch.zeros_like(u0)
        want = k3.sor_sweeps_plain(*(init if init[0] is not None else (z, z)), *fields, 13, 1.7)
        _equal(k8.sor_planes(*init, *fields, 13, 1.7, block_sweeps=4, blocks=blocks), want)


@pytest.mark.parametrize("s", range(1, k4.K4_MAX_SWEEPS + 1))
def test_k3_k4_k8_bf16_geometry_has_no_spills(dev, s):
    if s <= k3.K3_MAX_SWEEPS:
        for geo in (k3.k3_geometry(dev, s, dtype=BF16), k8.k8_geometry(dev, s, BF16)):
            assert (geo["tile_h"], geo["tile_w"]) == k3.k3_tile(s)[:2]
            assert geo["threads"] == k3.K3_THREADS
            assert geo["smem_bytes"] == k3.K3_SMEM_BYTES // 2 + k3.K3_SMEM_BYTES // 4
            assert geo["spill_bytes"] == 0 and 0 < geo["registers"] <= 65536 // k3.K3_THREADS
            assert geo["blocks_per_sm"] == 1
    geo = k4.k4_geometry(dev, s, BF16)
    assert (geo["tile_h"], geo["tile_w"], geo["left_halo"]) == k4.k4_tile(s)
    assert geo["threads"] == k4.K4_THREADS and geo["spill_bytes"] == 0
    assert 0 < geo["registers"] <= min(255, 65536 // k4.K4_THREADS)
    assert geo["blocks_per_sm"] == 1


def test_sor_and_robust_bf16_entry_points_run_the_kernels_as_float32(dev):
    i1, i2 = _rand((3, 96, 128), dev, 141)
    counters = (k1.hs_derivatives, k3.sor_sweeps, k4.freeze_weights, k4.frozen_sweeps)
    for kw in (dict(solver="sor", omega=1.6), dict(solver="robust", robust_update_every=7),
               dict(solver="sor", omega=1.6, tol=1e-3, block_sweeps=4),
               dict(solver="robust", tol=1e-3, block_sweeps=6), dict(solver="sor", omega=0.0)):
        c32 = HSConfig(alpha=0.5, iters=20, **kw)
        c16 = dataclasses.replace(c32, dtype="bfloat16")
        plain = dataclasses.replace(c16, backend="torch")
        pyr = PyramidConfig(levels=2, warp="checked")
        runs = (lambda c: hs_solve(i1[0], i2[0], c), lambda c: hs_pyramid(i1[0], i2[0], c, pyr),
                lambda c: hs_solve_batched(i1, i2, c),
                lambda c: hs_solve_batched(i1, i2, c, pyr))
        if kw.get("omega") == 0.0:  # tuned on a single pair only, as the reference
            runs = runs[:2]
        for run in runs:
            counts = []
            for c in (c32, c16):
                for k in counters:
                    k.launches = 0
                got = run(c)
                counts.append(tuple(k.launches for k in counters))
            if not kw.get("tol"):  # to tol the blocks follow the (rounded) updates
                assert counts[0] == counts[1], (kw, counts)
            assert sum(counts[1]) > 0, (kw, counts)
            assert got.u.dtype == BF16
            _equal(got, run(plain))
        if kw.get("omega") == 0.0:
            continue
        for a, b in zip(solve_bidirectional(i1[0], i2[0], c16),
                        solve_bidirectional(i1[0], i2[0], plain)):
            _equal(a, b)
        for a, b in zip(flow_stream_warm(i1, c16, warp_prior=True),
                        flow_stream_warm(i1, plain, warp_prior=True)):
            _equal(a, b)
        for a, b in zip(flow_stream(i1, c16, chunk=2), flow_stream(i1, plain, chunk=2)):
            _equal(a, b)
        for (a, ma), (b, mb) in zip(flow_stream_occlusion(i1, c16, chunk=2, a=0.0, b=1e-4),
                                    flow_stream_occlusion(i1, plain, chunk=2, a=0.0, b=1e-4)):
            _equal(a, b)
            assert torch.equal(ma, mb)


def test_tune_omega_bf16_on_the_card_equals_plain(dev):
    i1, i2 = _rand((96, 128), dev, 142)
    for alpha in (0.1, 1.0):
        c = HSConfig(alpha=alpha, dtype="bfloat16")
        k2.jacobi_sweeps.launches = 0
        om = tune_omega(i1, i2, c, power_iters=60)
        assert k2.jacobi_sweeps.launches == 60
        assert om == tune_omega(i1, i2, dataclasses.replace(c, backend="torch"),
                                power_iters=60)


@pytest.mark.parametrize("shape,name", [(s, n) for s in _GRAD_SHAPES for n in (
    "K3", "K4 robust_sweeps", "K1 + K3 zero", "K1 + K3 warm", "K1 + K4 zero",
    "K1 + K4 warm")] + [((40, 56), n) for n in ("K8", "K1 + K8 zero", "K1 + K8 warm")])
def test_bf16_sor_robust_entries_differentiate_as_their_plain_twins(dev, shape, name):
    inputs, call, twin = _grad_entries(dev, shape)[name]
    inputs = [t.to(BF16).requires_grad_() for t in inputs]
    if name in ("K3", "K4 robust_sweeps", "K8"):  # the fields from bfloat16 frames
        i1, i2 = _rand16(shape, dev, 66)
        f = k1.derivatives_plain(i1, i2, 0.5)
        inputs = inputs[:2] + [a.requires_grad_() for a in f[:len(inputs) - 2]]
    counters = counted_wrappers().values()
    for c in counters:
        c.launches = 0
    outs, grads = _weighted_grads(call, inputs)
    fwd = sum(c.launches for c in counters)
    assert fwd > 0 and all(o.grad_fn is not None and o.dtype == BF16 for o in outs), name
    want_outs, want = _weighted_grads(twin, inputs)
    assert sum(c.launches for c in counters) == fwd
    _equal([o.detach() for o in outs], [o.detach() for o in want_outs])
    _equal(grads, want)


# -- bfloat16: K5's bfloat16 build, TV-L1, multigrid and LK -----------------------
#
# K5 rounds u1 and u2 where the u-step stores them and the duals where the
# p-step does, in its float32 window, so its bfloat16 build equals the plain
# bfloat16 twin bitwise with the float32 plan's launches, at K5's edge shapes,
# every s, stacks, and on views that take the 2- and 8-byte paths. Multigrid
# (K1, then plain V-cycles) and LK (plain torch) run in bfloat16 on the card
# as on the plain route.


def _tvl1_fields16(shape, dev, seed):
    """_tvl1_fields from bfloat16 frames and flow: the fields as the bfloat16
    warp iteration forms them (each rounded once)."""
    i1, i2 = (255.0 * a for a in _rand16(shape, dev, seed))
    u1, u2 = _rand16(shape, dev, seed + 1, normal=True)
    cfg = TVL1Config(dtype="bfloat16")
    return u1, u2, tv.inner_fields(i1, i2, u1, u2, cfg), tv.inner_scalars(cfg)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("iters", [1, 7])
def test_k5_bf16_equals_plain(dev, shape, b, iters):
    u1, u2, fields, scalars = _tvl1_fields16((b,) + shape, dev, 150)
    assert all(f.dtype == BF16 for f in fields)
    keep = (u1.clone(), u2.clone())
    k5.tvl1_inner.launches = 0
    got = k5.tvl1_inner(u1, u2, *fields, iters, *scalars)
    assert k5.tvl1_inner.launches == k5.k5_geometry(dev, 0, u1.shape, iters)["launches"]
    assert got[0].dtype == got[1].dtype == BF16
    _equal(got, k5.tvl1_inner_plain(u1, u2, *fields, iters, *scalars))
    _equal((u1, u2), keep)
    for k in range(b):
        one = k5.tvl1_inner(u1[k], u2[k], *(f[k] for f in fields), iters, *scalars)
        _equal([g[k] for g in got], one)


@pytest.mark.parametrize("shape", K5_EDGE_SHAPES + [(67, 93), (33, 248)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("s", range(1, k5.K5_MAX_ITERS + 1))
def test_k5_bf16_edge_shapes_equal_plain(dev, shape, b, s):
    full = shape if b == 1 else (b,) + shape
    u1, u2, fields, scalars = _tvl1_fields16(full, dev, 151)
    for iters in sorted({1, 7, 2 * s + 1}):  # s does not divide 2s + 1
        k5.tvl1_inner.launches = 0
        got = k5.tvl1_inner(u1, u2, *fields, iters, *scalars, block_iters=s)
        assert k5.tvl1_inner.launches == -(-iters // s)
        _equal(got, k5.tvl1_inner_plain(u1, u2, *fields, iters, *scalars))


@pytest.mark.parametrize("w", [64, 93])
@pytest.mark.parametrize("off", [1, 2, 4])
def test_k5_bf16_unaligned_views_equal_plain(dev, w, off):
    # Views 2 or 4 bytes off an 8-byte boundary take the 2-byte loads; 8
    # bytes off (off 4) keep the 8-byte copies where w is a multiple of 4.
    def view(t):
        v = torch.empty(off + t.numel(), device=dev, dtype=BF16)[off:].view(t.shape)
        v.copy_(t)
        return v

    u1, u2, fields, scalars = _tvl1_fields16((50, w), dev, 152)
    args = [view(t) for t in (u1, u2, *fields)]
    for s in (0, 3):
        _equal(k5.tvl1_inner(*args, 11, *scalars, block_iters=s),
               k5.tvl1_inner_plain(*args, 11, *scalars))


@pytest.mark.parametrize("s", [0] + list(range(1, k5.K5_MAX_ITERS + 1)))
@pytest.mark.parametrize("shape", [(1088, 1920), (544, 960), (272, 480), (8, 1088, 1920)])
def test_k5_bf16_geometry_is_float32s(dev, s, shape):
    g16 = k5.k5_geometry(dev, s, shape, 100, BF16)
    g32 = k5.k5_geometry(dev, s, shape, 100)
    assert g16["spill_bytes"] == 0 and 0 < g16["registers"] <= 65536 // g16["threads"]
    assert {k: v for k, v in g16.items() if k != "registers"} == {
        k: v for k, v in g32.items() if k != "registers"}


def test_tvl1_entry_points_run_k5_bf16(dev):
    i1, i2 = _rand((3, 96, 128), dev, 153)
    i2 = 0.8 * i1 + 0.2 * i2
    c32 = TVL1Config(warps=2, iters=10)
    cfg = dataclasses.replace(c32, dtype="bfloat16")
    plain = dataclasses.replace(cfg, backend="torch")
    pyr = PyramidConfig(levels=2)
    counts = []
    for c in (c32, cfg):
        k5.tvl1_inner.launches = 0
        got = tvl1_solve(i1[0], i2[0], c, pyr)
        counts.append(k5.tvl1_inner.launches)
    assert counts[0] == counts[1] > 0
    assert got.u.dtype == BF16
    _equal(got, tvl1_solve(i1[0], i2[0], plain, pyr))
    stack = tvl1_solve_batched(i1, i2, cfg)
    _equal(stack, tvl1_solve_batched(i1, i2, plain))
    for k in range(3):
        _equal([a[k] for a in stack], tvl1_solve(i1[k], i2[k], cfg))
    vid = torch.cat([i1, i2[-1:]])
    for a, b in zip(flow_stream(vid, tvl1=cfg, chunk=2), flow_stream(vid, tvl1=plain, chunk=2)):
        assert a.u.dtype == BF16
        _equal(a, b)
    (f, m), (fp, mp) = (next(flow_stream_occlusion(vid, tvl1=c, chunk=3)) for c in (cfg, plain))
    _equal(f, fp)
    assert torch.equal(m, mp)
    for a, b in zip(solve_bidirectional(i1[0], i2[0], tvl1=cfg),
                    solve_bidirectional(i1[0], i2[0], tvl1=plain)):
        _equal(a, b)


def test_multigrid_and_lk_bf16_on_the_card_equal_the_plain_route(dev):
    rng = np.random.default_rng(154)
    frames = torch.from_numpy(rng.uniform(0, 1, (4, 72, 96)).astype(np.float32)).to(dev)
    i1, i2 = frames[0], frames[1]
    mg = HSConfig(alpha=0.5, iters=2, solver="multigrid", dtype="bfloat16")
    mgp = dataclasses.replace(mg, backend="torch")
    k1.hs_derivatives.launches = 0
    got = hs_solve(i1, i2, mg)
    assert k1.hs_derivatives.launches == 1 and got.u.dtype == BF16
    _equal(got, hs_solve(i1, i2, mgp))
    for c, p in ((dataclasses.replace(mg, tol=1e-3, iters=4),
                  dataclasses.replace(mgp, tol=1e-3, iters=4)), (mg, mgp)):
        _equal(hs_solve_batched(frames[:-1], frames[1:], c),
               hs_solve_batched(frames[:-1], frames[1:], p))
    _equal(hs_pyramid(i1, i2, mg, PyramidConfig(levels=2)),
           hs_pyramid(i1, i2, mgp, PyramidConfig(levels=2)))
    for a, b in zip(flow_stream_warm(frames, mg, warp_prior=True),
                    flow_stream_warm(frames, mgp, warp_prior=True)):
        _equal(a, b)
    lk = LKConfig(dtype="bfloat16")
    got = lk_solve(i1, i2, lk, PyramidConfig(levels=2, iters_per_level=()))
    assert got.u.dtype == BF16
    _equal_cpu(got, lk_solve(i1.cpu(), i2.cpu(), lk, PyramidConfig(levels=2, iters_per_level=())))
    _equal_cpu(lk_solve_batched(frames[:-1], frames[1:], lk),
               lk_solve_batched(frames[:-1].cpu(), frames[1:].cpu(), lk))
    for a, b in zip(flow_stream(frames, lk=lk, chunk=2), flow_stream(frames.cpu(), lk=lk, chunk=2)):
        _equal_cpu(a, b)


@pytest.mark.parametrize("shape", _GRAD_SHAPES)
def test_k5_bf16_differentiates_as_its_plain_twin(dev, shape):
    inputs, call, twin = _grad_entries(dev, shape)["K5"]
    u1, u2, fields, _ = _tvl1_fields16(shape, dev, 155)
    inputs = [t.requires_grad_() for t in (u1, u2, *fields)]
    k5.tvl1_inner.launches = 0
    outs, grads = _weighted_grads(call, inputs)
    fwd = k5.tvl1_inner.launches
    assert fwd > 0 and all(o.grad_fn is not None and o.dtype == BF16 for o in outs)
    want_outs, want = _weighted_grads(twin, inputs)
    assert k5.tvl1_inner.launches == fwd
    _equal([o.detach() for o in outs], [o.detach() for o in want_outs])
    _equal(grads, want)


# -- bfloat16: K9-K12's bfloat16 builds and the tiled solver in bfloat16 -------
#
# K9 runs K2's and K3's bfloat16 walks on shards, K11 and K12 K2's with the
# pairs in bfloat16, K10 moves 2-byte values: each equals its plain
# bfloat16 twin bitwise, with float32's geometry, s and launches, at the
# float32 cases' shapes, with rows that take the 2-, 8- and 16-byte paths.


def _tile_problem16(dev, shape, seed, stack=0):
    full = (stack,) + shape if stack else shape
    i1, i2 = _rand16(full, dev, seed)
    fields = k1.derivatives_plain(i1, i2, 0.5)
    u0, v0 = _rand16(full, dev, seed + 1, normal=True)
    return u0, v0, fields


def _k9_pair(sor, u0, v0, fields, n, rows, cols, h, w, **kw):
    """K9 on CUDA shards and its plain twin, (got, want)."""
    org = k9.origin_table(u0, rows, cols)
    if sor:
        return (k9.sor_tile_sweeps(u0, v0, *fields, n, 1.6, org, h, w, **kw),
                k9.sor_tile_sweeps_plain(u0, v0, *fields, n, 1.6, rows, cols, h, w))
    return (k9.tile_sweeps(u0, v0, *fields, n, org, h, w, **kw),
            k9.tile_sweeps_plain(u0, v0, *fields, n, rows, cols, h, w))


@pytest.mark.parametrize("shape", [(67, 93), (131, 130), (70, 248)])
@pytest.mark.parametrize("corner", list(_CORNERS))
@pytest.mark.parametrize("sor", [False, True])
def test_k9_bf16_equals_plain(dev, shape, corner, sor):
    u0, v0, fields = _tile_problem16(dev, shape, 170)
    r0, c0 = _CORNERS[corner](*shape)
    for n in (7, 13):
        got, want = _k9_pair(sor, u0, v0, fields, n, r0, c0, 300, 400)
        assert got[0].dtype == BF16
        _equal(got, want)  # every element of the padded shard, halo included


@pytest.mark.parametrize("s", [1, 3, 4, 8])
@pytest.mark.parametrize("shape", [(37, 45), (60, 140), (60, 136)])
def test_k9_bf16_true_edges_at_warp_and_lane_boundaries(dev, s, shape):
    rows, cols = _k2_edge_origins(s)
    h, w = 70, 150
    rows = rows + [h - shape[0] + 2, h - shape[0] + 5]
    cols = cols + [w - shape[1] + 3, w - shape[1] + 4]
    u0, v0, fields = _tile_problem16(dev, shape, 176, stack=len(rows))
    k9.tile_sweeps.launches = 0
    got, want = _k9_pair(False, u0, v0, fields, 2 * s + 1, rows, cols, h, w, block_sweeps=s)
    assert k9.tile_sweeps.launches == 3
    _equal(got, want)


@pytest.mark.parametrize("sor", [False, True])
def test_k9_bf16_stack_of_shards_is_one_launch(dev, sor):
    u0, v0, fields = _tile_problem16(dev, (67, 93), 172, stack=3)
    rows, cols = [-4, 117, 300 - 67 + 3], [-3, 33, 400 - 93 + 4]
    counter = k9.sor_tile_sweeps if sor else k9.tile_sweeps
    counter.launches = 0
    got, want = _k9_pair(sor, u0, v0, fields, 4, rows, cols, 300, 400)
    assert counter.launches == 1
    _equal(got, want)


@pytest.mark.parametrize("s", range(1, k3.K3_MAX_SWEEPS + 1))
@pytest.mark.parametrize("pw", [150, 136])
def test_k9_sor_bf16_at_odd_and_even_origins_equals_plain(dev, s, pw):
    ph = 37
    rows = [-4, -3, 117, 116, 5, 300 - ph + 3, 300 - ph + 4]
    cols = [-3, -4, 33, 32, -8, 400 - pw + 4, 400 - pw + 5]
    u0, v0, fields = _tile_problem16(dev, (ph, pw), 204, stack=len(rows))
    k9.sor_tile_sweeps.launches = 0
    got, want = _k9_pair(True, u0, v0, fields, 2 * s + 1, rows, cols, 300, 400, block_sweeps=s)
    assert k9.sor_tile_sweeps.launches == k3.launches(2 * s + 1, s)
    _equal(got, want)


@pytest.mark.parametrize("w", [64, 93])
@pytest.mark.parametrize("off", [1, 4, 8])
@pytest.mark.parametrize("sor", [False, True])
def test_k9_bf16_unaligned_views_equal_plain(dev, w, off, sor):
    # Views 2, 8 and 16 bytes into their storage: the 2-byte loads, the
    # 8-byte copies, and the 16-byte copies where w is a multiple of 8.
    u0, v0, i1, i2 = _wide_views(dev, 45, w, off, 260, b=2)
    fields = [f.contiguous() for f in k1.derivatives_plain(i1, i2, 0.5)]
    views = []
    for f in fields:
        buf = torch.empty(off + f.numel(), dtype=BF16, device=dev)
        buf[off:] = f.flatten()
        views.append(buf[off:].view(f.shape))
    got, want = _k9_pair(sor, u0, v0, views, 9, [-3, 20], [-2, 5], 80, w + 9)
    _equal(got, want)


@pytest.mark.parametrize("w", [40, 36, 37, 39])
@pytest.mark.parametrize("halo", [1, 10])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("stack", [0, 3])
def test_k10_bf16_row_paths_equal_plain(dev, w, halo, n_shards, stack):
    # 16-byte rows (w % 8 == 0) and 2-byte rows, halos of one row and of
    # the whole shard, rings of 1, 2 and 4 shards, single and stacked.
    tiles = [_rand16(((stack,) if stack else ()) + (10, w), dev, 185 + k, n=1)[0]
             for k in range(n_shards)]
    ring.ring_halo_exchange.launches = 0
    got = ring.ring_halo_exchange(tiles, halo)
    assert ring.ring_halo_exchange.launches == 1
    for g, r in zip(got, ring.ring_halo_exchange_plain(tiles, halo)):
        assert g.dtype == BF16 and torch.equal(g, r)


@pytest.mark.parametrize("off", [1, 4])
@pytest.mark.parametrize("halo", [1, 5, 12])
def test_k10_bf16_unaligned_views_equal_plain(dev, off, halo):
    h, w = 12, 64
    tiles = [v[0] for v in _wide_views(dev, h, w, off, 188)]
    assert tiles[0].data_ptr() % 16 != 0
    got = ring.ring_halo_exchange(tiles, halo)
    for g, r in zip(got, ring.ring_halo_exchange_plain(tiles, halo)):
        assert torch.equal(g, r)


def _ring_rings16(dev, my, mx, s, seed, **kw):
    """_ring_rings in bfloat16 (the same values rounded once)."""
    rings, h, w = _ring_rings(dev, my, mx, s, seed, **kw)
    for row in rings[0]:
        for k, sh in enumerate(row):
            row[k] = ring.Shard(sh.u.to(BF16), sh.v.to(BF16),
                                tuple(f.to(BF16) for f in sh.fields), sh.row0, sh.col0)
    return rings, h, w


@pytest.mark.parametrize("s", range(1, ring.MAX_RING_SWEEPS + 1))
@pytest.mark.parametrize("my,mx", RING_MESHES)
def test_k11_k12_bf16_equal_plain_at_every_block_depth(dev, my, mx, s):
    # sx = s: column halos of s take the 2-byte exchange (the 16-byte one
    # needs s and the width multiples of 8).
    rings, h, w = _ring_rings16(dev, my, mx, s, 300 + s)
    _ring_equal(rings, 2 * s + 1, s, h, w)


@pytest.mark.parametrize("my,mx", RING_MESHES)
@pytest.mark.parametrize("stack", [0, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k11_k12_bf16_stacks_and_starts_equal_plain(dev, my, mx, stack, warm):
    rings, h, w = _ring_rings16(dev, my, mx, 4, 330, stack=stack, warm=warm)
    _ring_equal(rings, 13, 4, h, w)


@pytest.mark.parametrize("my,mx", [(4, 0), (2, 2), (1, 4)])
@pytest.mark.parametrize("blocks", [0, 1, 3])
def test_k11_k12_bf16_wide_rows_equal_plain(dev, my, mx, blocks):
    # s = 8 and widths multiples of 8: 16-byte staging and, in both
    # exchange phases, 16-byte rectangles.
    rings, h, w = _ring_rings16(dev, my, mx, 8, 340, th=70, tw=48 if mx else 64)
    assert rings[0][0][0].fields[0].shape[-1] % 8 == 0
    _ring_equal(rings, 21, 8, h, w, blocks=blocks)


@pytest.mark.parametrize("mx", [0, 1])
@pytest.mark.parametrize("off", [1, 4])
def test_k11_k12_bf16_unaligned_views_equal_plain(dev, mx, off):
    s, th, tw = 4, 50, 64
    sx = s if mx else 0
    eh, ew = th + 2 * s, tw + 2 * sx
    i1, i2 = (v[0] for v in _wide_views(dev, eh, ew, off, 350, b=1)[:2])
    views = []
    for f in k1.derivatives_plain(i1.contiguous(), i2.contiguous(), 0.5):
        buf = torch.empty(off + eh * ew, dtype=BF16, device=dev)
        buf[off:] = f.flatten()
        views.append(buf[off:].view(eh, ew))
    assert views[0].data_ptr() % 16 != 0
    u0, v0 = _rand16((th, tw), dev, 352, normal=True)
    rings = [[[ring.Shard(u0, v0, tuple(views), 0, 0)]]]
    _ring_equal(rings, 15, s, th - 1, tw - 2)


@pytest.mark.parametrize("s", range(1, ring.MAX_RING_SWEEPS + 1))
def test_k9_k11_k12_bf16_geometry_is_float32s(dev, s):
    for f32, b16 in ((k2.k2_geometry(dev, s, shard=True),
                      k2.k2_geometry(dev, s, shard=True, dtype=BF16)),
                     (ring.ring_geometry(dev, s), ring.ring_geometry(dev, s, dtype=BF16)),
                     (ring.ring_geometry(dev, s, True), ring.ring_geometry(dev, s, True, BF16))):
        assert (b16["tile_h"], b16["tile_w"], b16["threads"]) == (
            f32["tile_h"], f32["tile_w"], f32["threads"])
        assert b16["smem_bytes"] == f32["smem_bytes"] // 2 == k2.K2_SMEM_BYTES // 2
        assert b16["spill_bytes"] == 0 and 0 < b16["registers"] <= 65536 // k2.K2_THREADS
    if s <= k3.K3_MAX_SWEEPS:
        geo = k3.k3_geometry(dev, s, shard=True, dtype=BF16)
        f32 = k3.k3_geometry(dev, s, shard=True)
        assert (geo["tile_h"], geo["tile_w"]) == (f32["tile_h"], f32["tile_w"])
        assert geo["spill_bytes"] == 0
    assert ring.resident_blocks(0, BF16) >= ring.resident_blocks(0)


@pytest.mark.parametrize("my,mx", [(1, 1), (2, 2), (4, 4), (1, 4), (4, 1)])
@pytest.mark.parametrize("s", [1, 4])
def test_tiled_solve_bf16_on_a_virtual_mesh_equals_untiled(dev, my, mx, s):
    i1, i2 = _rand((130, 197), dev, 160)
    mesh = make_mesh(MeshConfig(y=my, x=mx), [dev] * (my * mx))
    kernels = (k9.tile_sweeps, k9.sor_tile_sweeps, ring.ring_fused_sweeps,
               ring.ring_fused_sweeps_2d)
    cases = [dict(iters=23), dict(iters=23, halo_impl="rdma")]
    if 130 // my > 4 * s and 197 // mx > 4 * s:
        cases.append(dict(iters=9, solver="sor", omega=1.6))
    for kw in cases:
        impl = kw.pop("halo_impl", "ppermute")
        counts = []
        for dtype in ("float32", "bfloat16"):
            cfg = HSConfig(alpha=0.5, dtype=dtype, **kw)
            for k in kernels:
                k.launches = 0
            got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=s, halo_impl=impl)
            counts.append(tuple(k.launches for k in kernels))
            assert got.u.dtype == (BF16 if dtype == "bfloat16" else torch.float32)
            _equal(got, hs_solve(i1, i2, cfg))
        assert counts[0] == counts[1] and sum(counts[0]) > 0, counts


def test_tiled_bf16_stack_tol_and_pyramid_on_a_virtual_mesh(dev):
    i1, i2 = _rand((4, 64, 96), dev, 161)
    i2[1] = i1[1]  # converges at the first check
    mesh = make_mesh(MeshConfig(batch=2, y=2, x=2), [dev] * 8)
    for cfg in (HSConfig(alpha=0.5, iters=20, dtype="bfloat16"),
                HSConfig(alpha=0.5, iters=40, tol=1e-3, block_sweeps=3, dtype="bfloat16")):
        got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=3)
        _equal(got, hs_solve_batched(i1, i2, cfg))
    cfg = HSConfig(alpha=0.5, iters=20, dtype="bfloat16")
    _equal(hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=3, halo_impl="rdma"),
           hs_solve_batched(i1, i2, cfg))
    from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled

    mesh = make_mesh(MeshConfig(y=2, x=2), [dev] * 4)
    pyr = PyramidConfig(levels=2)
    _equal(hs_pyramid_tiled(i1[0], i2[0], cfg, pyr, mesh, halo_sweeps=2),
           hs_pyramid(i1[0], i2[0], cfg, pyr))


@pytest.mark.parametrize("k", range(5))
def test_dist_bf16_kernel_entries_refuse_frames_that_require_grad(dev, k):
    base, call = _dist_guarded(dev, BF16)[k]
    a = base.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="does not differentiate.*no_grad"):
        call(a)
    with torch.no_grad():
        call(a)


# -- the GSPMD routes on a virtual mesh of one card (dist/gspmd.py) ---------------------


_ROUTE_KERNELS = ("K1 hs_derivatives", "K4 hs_robust_freeze", "K4 hs_robust_sweeps",
                  "K5 hs_tvl1_inner")


def _counted(fn):
    """fn()'s result and the K1, K4 and K5 launches it made."""
    ks = [counted_wrappers()[name] for name in _ROUTE_KERNELS]
    for k in ks:
        k.launches = 0
    out = fn()
    return out, tuple(k.launches for k in ks)


def _vmesh(dev, b=1, y=1, x=1):
    return make_mesh(MeshConfig(batch=b, y=y, x=x), [dev] * (b * y * x))


GSPMD_CFGS = {"robust": dict(solver="robust", alpha=0.3, iters=30, robust_update_every=10),
              "robust-tol": dict(solver="robust", alpha=0.3, iters=60, robust_update_every=10,
                                 tol=1e-3, block_sweeps=5),
              "multigrid": dict(solver="multigrid", alpha=1.0, iters=2),
              "multigrid-tol": dict(solver="multigrid", alpha=1.0, iters=4, tol=1e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GSPMD_CFGS))
def test_tiled_gspmd_routes_equal_untiled_on_a_virtual_mesh(dev, name, dtype):
    from opticalflowhs_tpu_torch.dist import hs_pyramid_tiled

    cfg = HSConfig(dtype=dtype, **GSPMD_CFGS[name])
    i1, i2 = _rand((131, 130), dev, 171)
    got, n_got = _counted(lambda: hs_solve_tiled(i1, i2, cfg, _vmesh(dev, y=2, x=2)))
    want, n_want = _counted(lambda: hs_solve(i1, i2, cfg))
    _equal(got, want)
    assert n_got == n_want and n_got[0] == 1, (n_got, n_want)
    s1, s2 = _rand((4, 67, 93), dev, 172)
    got, n_got = _counted(lambda: hs_solve_tiled(s1, s2, cfg, _vmesh(dev, 2, 2, 1)))
    want = hs_solve_batched(s1, s2, cfg)
    _, n_groups = _counted(lambda: [hs_solve_batched(s1[g:g + 2], s2[g:g + 2], cfg)
                                    for g in (0, 2)])
    _equal(got, want)
    assert n_got == n_groups and n_got[0] == 2, (n_got, n_groups)
    pyr = PyramidConfig(levels=2)
    got, n_got = _counted(lambda: hs_pyramid_tiled(i1, i2, cfg, pyr, _vmesh(dev, y=2, x=2)))
    want, n_want = _counted(lambda: hs_pyramid(i1, i2, cfg, pyr))
    _equal(got, want)
    assert n_got == n_want, (n_got, n_want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["hs", "sor", "robust", "multigrid", "lk", "tvl1"])
def test_mesh_stacks_equal_untiled_on_a_virtual_mesh(dev, family, dtype):
    # mesh= on the batched entries: each group through the untiled entry,
    # the launches those calls make; the streams = the unsharded streams.
    a, b = _rand((4, 67, 93), dev, 173)
    mesh = _vmesh(dev, 2)
    hs = {"hs": dict(iters=20), "sor": dict(solver="sor", omega=1.7, iters=10),
          "robust": dict(GSPMD_CFGS["robust"]), "multigrid": dict(GSPMD_CFGS["multigrid"])}
    if family in hs:
        cfg = HSConfig(dtype=dtype, **hs[family])
        entry, fam = (lambda x, y, m=None: hs_solve_batched(x, y, cfg, mesh=m)), dict(cfg=cfg)
    elif family == "lk":
        cfg = LKConfig(dtype=dtype)
        entry, fam = (lambda x, y, m=None: lk_solve_batched(x, y, cfg, mesh=m)), dict(lk=cfg)
    else:
        cfg = TVL1Config(warps=2, iters=10, dtype=dtype)
        entry, fam = (lambda x, y, m=None: tvl1_solve_batched(x, y, cfg, mesh=m)), dict(tvl1=cfg)
    got, n_got = _counted(lambda: entry(a, b, mesh))
    _, n_groups = _counted(lambda: [entry(a[g:g + 2], b[g:g + 2]) for g in (0, 2)])
    _equal(got, entry(a, b))
    assert n_got == n_groups, (n_got, n_groups)
    frames = torch.cat([a, b[-1:]])
    cfg_kw = dict(fam)
    hs_cfg = cfg_kw.pop("cfg", HSConfig())
    got = list(flow_stream(frames, hs_cfg, chunk=2, mesh=mesh, **cfg_kw))
    for g, w in zip(got, flow_stream(frames, hs_cfg, chunk=2, **cfg_kw)):
        _equal(g, w)
    got = list(flow_stream_occlusion(frames, hs_cfg, chunk=3, mesh=mesh, **cfg_kw))
    for (g, gm), (w, wm) in zip(got, flow_stream_occlusion(frames, hs_cfg, chunk=3, **cfg_kw)):
        _equal(g, w)
        assert torch.equal(gm, wm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["lk", "tvl1"])
def test_tiled_lk_and_tvl1_equal_untiled_on_a_virtual_mesh(dev, family, dtype):
    from opticalflowhs_tpu_torch.lucas_kanade import lk_solve_tiled

    i1, i2 = _rand((131, 130), dev, 174)
    pyr = PyramidConfig(levels=2, iters_per_level=())
    if family == "lk":
        cfg = LKConfig(dtype=dtype)
        tiled, untiled = lk_solve_tiled, lk_solve
    else:
        cfg = TVL1Config(warps=2, iters=12, dtype=dtype)
        tiled, untiled = tv.tvl1_solve_tiled, tvl1_solve
    got, n_got = _counted(lambda: tiled(i1, i2, cfg, pyr, mesh=_vmesh(dev, y=2, x=2)))
    want, n_want = _counted(lambda: untiled(i1, i2, cfg, pyr))
    _equal(got, want)
    assert n_got == n_want and (family == "lk") == (n_got[3] == 0), n_got
    # consistency on the spatial mesh: the tiled entry once a direction
    fam = {family: cfg}
    got = flow_with_occlusion(i1, i2, pyr=pyr, mesh=_vmesh(dev, y=2, x=2), **fam)
    want = flow_with_occlusion(i1, i2, pyr=pyr, **fam)
    _equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_spatial_hs_occlusion_and_gspmd_gradient_on_a_virtual_mesh(dev):
    # flow_with_occlusion on a spatial mesh: one batch-2 tiled pyramid (K9),
    # halo_sweeps reaching it; and the gradient of a tiled robust solve (the
    # untiled entry's kernel forward, its plain twin's backward) = untiled.
    i1, i2 = _rand((131, 130), dev, 175)
    cfg = HSConfig(alpha=0.5, iters=30)
    got = flow_with_occlusion(i1, i2, cfg, mesh=_vmesh(dev, y=2, x=2), halo_sweeps=4)
    want = flow_with_occlusion(i1, i2, cfg)
    _equal(got[0], want[0])
    assert torch.equal(got[1], want[1])

    def grad(fn):
        x = i2.clone().requires_grad_()
        f = fn(i1, x)
        (f.u.pow(2).mean() + f.v.pow(2).mean()).backward()
        return x.grad

    rcfg = HSConfig(**GSPMD_CFGS["robust"])
    _equal([grad(lambda a, b: hs_solve_tiled(a, b, rcfg, _vmesh(dev, y=2, x=2)))],
           [grad(lambda a, b: hs_solve(a, b, rcfg))])
