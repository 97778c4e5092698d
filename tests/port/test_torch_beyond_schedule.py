"""K7's band/pencil schedule and the beyond-resident routing on the CPU:
`skewed_schedule_plain` (K2 windows on bands of K2 tiles) against the
plain whole solve at K2's own window, the port's class functions against
the reference's, K7's plan (tile, m, band, bands) and its cost rule, and
the K6/K7 wrappers on CPU tensors (the plain solve, no launch).
test_torch_whole_solve_schedule.py walks both schedules at small windows;
test_torch_beyond_resident.py holds the plain solves against the
reference's interpret-mode kernels.

Tolerances: the schedule equals the plain whole solve bitwise (0.0; the
same plain ops per pixel, only the window a pixel is computed in
changes), and the class functions return the reference's decisions and
geometries exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.kernels.solve_fused as ref_fused
import opticalflowhs_tpu.kernels.solve_resident as ref_resident
import opticalflowhs_tpu.kernels.solve_skewed as ref_skewed
import opticalflowhs_tpu.solver as ref_solver
from opticalflowhs_tpu_torch.kernels import derivatives as k1
from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import solve_fused as k6
from opticalflowhs_tpu_torch.kernels import solve_resident as sr
from opticalflowhs_tpu_torch.kernels import solve_skewed as k7
from opticalflowhs_tpu_torch.solver import whole_solve_route

torch.set_num_threads(1)

# Every |diff| a test measures, recorded as the junit property
# `max_abs_diff` (as in test_torch_batch.py).
_DIFFS: list[float] = []


@pytest.fixture(autouse=True)
def _report_max_diff(record_property):
    _DIFFS.clear()
    yield
    if _DIFFS:
        record_property("max_abs_diff", max(_DIFFS))


def _max_diff(got, want):
    d = max(float((g - w).abs().max()) for g, w in zip(got, want))
    _DIFFS.append(d)
    return d


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (h, w)).astype(np.float32) for _ in range(2)]


def _normal(h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (h, w)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("shape", [(48, 128), (53, 120), (67, 93), (131, 130), (1, 9), (9, 1)])
@pytest.mark.parametrize("s,band", [(1, 1), (3, 8), (4, 16), (8, 8), (8, 64), (10, 24)])
@pytest.mark.parametrize("n", [1, 9, 23])
def test_skewed_schedule_equals_plain_solve(shape, s, band, n):
    i1, i2 = _t(_frames(*shape, seed=2))
    u0, v0 = _t(_normal(*shape, seed=4))
    for variant, init in (("hs_cube", (None, None)), ("central", (u0, v0))):
        want = k7.hs_solve_skewed_plain(i1, i2, 0.7, n, variant, *init)
        got = k7.skewed_schedule_plain(i1, i2, 0.7, n, variant, *init, s=s, band=band)
        assert _max_diff(got, want) == 0.0, (shape, s, band, n, variant)
    assert torch.equal(u0, _t(_normal(*shape, seed=4))[0])  # the start is not written


def test_skewed_schedule_of_a_stack_and_its_limits():
    rng = np.random.default_rng(5)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, (3, 40, 50)).astype(np.float32))
              for _ in range(2))
    got = k7.skewed_schedule_plain(i1, i2, 0.5, 13, "central", s=4, band=9)
    assert _max_diff(got, k7.hs_solve_skewed_plain(i1, i2, 0.5, 13, "central")) == 0.0
    with pytest.raises(ValueError, match="band"):
        k7.skewed_schedule_plain(i1, i2, 0.5, 13, s=8, band=-4)
    with pytest.raises(ValueError, match="K2 tile"):
        k7.skewed_schedule_plain(i1, i2, 0.5, 13, s=8, window=(16, 24))
    with pytest.raises(ValueError, match="wide"):
        k7.skewed_schedule_plain(i1, i2, 0.5, 13, s=4, blocks=1, window=(12, 16))


# -- routing: the reference's classes --------------------------------------------

SIZES = [(1088, 1920), (1440, 2560), (1600, 2560), (1800, 3200), (2160, 3840),
         (2160, 4096), (2880, 5120), (4320, 7680)]


def _ref_route(h, w, iters, variant):
    """The reference's solve_level chain (opticalflowhs_tpu/solver.py:344-405)
    for a fixed-count float32 Jacobi solve, by its own class functions."""
    frame = jax.ShapeDtypeStruct((h, w), jnp.float32)
    if (ref_solver.resident_solve_enabled(iters)
            and ref_resident.applicable(frame, iters, variant) is not None):
        return "resident"
    if ref_solver.skewed_solve_enabled(iters) and ref_skewed.applicable(frame, iters) is not None:
        return "skewed"
    if (ref_solver.fused_solve_enabled(iters)
            and ref_fused.applicable(frame, iters, ref_fused._MAX_S) is not None):
        return "fused"
    return "chain"


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("variant", ["hs_cube", "central"])
@pytest.mark.parametrize("iters", [50, 100])
@pytest.mark.parametrize("start", ["zero", "warm"])
def test_routing_matches_reference(shape, variant, iters, start, monkeypatch):
    # The class tests take no start in either package: a warm start takes
    # the same route (the reference passes u0/v0 through the same call).
    for var in ("HSFLOW_RESIDENT_SOLVE", "HSFLOW_SKEWED_SOLVE", "HSFLOW_FUSED_SOLVE"):
        monkeypatch.delenv(var, raising=False)
    h, w = shape
    frame = jax.ShapeDtypeStruct(shape, jnp.float32)
    assert whole_solve_route(h, w, iters, variant) == _ref_route(h, w, iters, variant)
    assert sr.applicable(h, w, iters, variant) == ref_resident.applicable(frame, iters, variant)
    assert k7.applicable(h, w, iters) == ref_skewed.applicable(frame, iters)
    assert k6.applicable(h, w, iters, 32) == ref_fused.applicable(frame, iters, 32)


def test_routes_of_the_classes():
    # The table the routing follows (the reference's classes at i100).
    assert [whole_solve_route(h, w, 100, "hs_cube") for h, w in SIZES] == [
        "resident", "resident", "fused", "fused", "skewed", "skewed", "fused", "fused"]
    assert whole_solve_route(1088, 1920, 100, "central") == "fused"
    assert whole_solve_route(2160, 3840, 63, "hs_cube") == "chain"
    assert whole_solve_route(67, 93, 100, "central") == "chain"
    # block_sweeps caps the fused pipeline's s as the reference's s_cap does:
    # below 8 no geometry, so the K1 + K2 chain.
    assert whole_solve_route(4320, 7680, 100, "hs_cube", block_sweeps=4) == "chain"
    assert whole_solve_route(4320, 7680, 100, "hs_cube", block_sweeps=9) == "fused"
    frame = jax.ShapeDtypeStruct((4320, 7680), jnp.float32)
    for s_cap in (4, 9, 16):
        assert k6.applicable(4320, 7680, 100, s_cap) == ref_fused.applicable(frame, 100, s_cap)


# -- the wrappers on the CPU ------------------------------------------------------


def test_cpu_tensors_take_the_plain_solve_and_launch_nothing():
    i1, i2 = _t(_frames(40, 56, seed=6))
    u0, v0 = _t(_normal(40, 56, seed=8))
    counts = (k1.hs_derivatives.launches, k2.jacobi_sweeps.launches,
              k6.hs_solve_fused.launches, k7.hs_solve_skewed.launches)
    want = sr.hs_solve_resident_plain(i1, i2, 0.5, 17, "hs_cube", u0, v0)
    for solve in (k6.hs_solve_fused, k7.hs_solve_skewed):
        assert _max_diff(solve(i1, i2, 0.5, 17, "hs_cube", u0, v0), want) == 0.0
        zero = solve(i1, i2, 0.5, 0)
        assert not zero[0].any() and not zero[1].any()
    stack = [torch.stack([a, a.flip(0)]) for a in (i1, i2)]
    want = sr.hs_solve_resident_batched_plain(*stack, 0.5, 9)
    for solve in (k6.hs_solve_fused_batched, k7.hs_solve_skewed_batched):
        assert _max_diff(solve(*stack, 0.5, 9), want) == 0.0
        with pytest.raises(ValueError, match="B, H, W"):
            solve(i1, i2, 0.5, 9)
    with pytest.raises(ValueError, match="together"):
        k7.hs_solve_skewed(i1, i2, 0.5, 9, u0=u0)
    with pytest.raises(ValueError):
        k6.hs_solve_fused(i1.double(), i2.double(), 0.5, 9)
    assert counts == (k1.hs_derivatives.launches, k2.jacobi_sweeps.launches,
                      k6.hs_solve_fused.launches, k7.hs_solve_skewed.launches)


# (h, w, s, blocks, band) -> K7's plan (tile_h, tile_w, m, band rows, bands).
K7_PLANS = [
    # 4K on 132 resident blocks: 35 x 68 tiles of 32 x 112; 3 tiles a block,
    # 11 tile rows a band (385 of the 396 it could hold): 6 bands of 3 tiles
    # a block and a last one of 2 tile rows, 1 a block.
    ((2160, 3840, 8, 132, 0), (32, 112, 3, 352, 7)),
    # 1080p: 18 x 34 tiles; 22 tile rows a band, 3 a block: 2 bands (the
    # cost rule's tie with 3 bands of 14 rows, 2 a block, goes to fewer).
    ((1088, 1920, 8, 132, 0), (32, 112, 3, 704, 2)),
    # 8K: 69 tiles across, 5 tile rows a band at m = 3, 27 bands.
    ((4320, 7680, 8, 132, 0), (32, 112, 3, 160, 27)),
    # a forced band is rounded up to whole tile rows; m follows from it.
    ((2160, 3840, 8, 132, 64), (32, 112, 1, 64, 34)),
    ((2160, 3840, 8, 132, 100), (32, 112, 2, 128, 17)),
    ((2160, 3840, 8, 132, 1), (32, 112, 1, 32, 68)),
    # the remainder's and other s's tiles: K2's at s.
    ((2160, 3840, 4, 132, 0), (40, 120, 3, 480, 5)),
    ((2160, 3840, 1, 132, 0), (46, 120, 3, 552, 4)),
    # small frames: one band of every tile row.
    ((67, 93, 10, 4, 4), (28, 104, 1, 28, 3)),
    ((67, 93, 8, 132, 0), (32, 112, 1, 96, 1)),
    # a band row of 33,792 px (132 tiles of 256 before): 302 K2 tiles across.
    ((600, 33792, 8, 132, 0), (32, 112, 3, 32, 19)),
    ((600, 9000, 8, 132, 0), (32, 112, 2, 96, 7)),
]


@pytest.mark.parametrize("args,plan", K7_PLANS)
def test_k7_geometry(args, plan):
    h, w, s, blocks, band = args
    got = k7.geometry(h, w, s, blocks, band)
    assert got == plan
    th, tw, m, band_rows, bands = got
    assert (th, tw) == k2.k2_tile(s)[:2] and band_rows % th == 0
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    band_ty = band_rows // th
    assert 1 <= m <= k7.MAX_TILES and min(band_ty, tiles_y) * tiles_x <= m * blocks
    assert bands == -(-tiles_y // band_ty) and (bands - 1) * band_ty < tiles_y


def test_k7_geometry_cost_rule_and_refusals():
    # The cost rule: the sum over the bands of (the most tiles a block has
    # in the band + a barrier's share), fewer than 3 bands one barrier more;
    # no other band of the same frame costs less.
    def cost(h, w, band_rows):
        th, tw, _ = k2.k2_tile(8)
        tiles_x, tiles_y, band_ty = -(-w // tw), -(-h // th), band_rows // th
        ms = [-(-min(band_ty, tiles_y - r) * tiles_x // 132) for r in range(0, tiles_y, band_ty)]
        return sum(ms) + k7._STEP_COST * (len(ms) + (len(ms) < 3))

    for h, w in ((2160, 3840), (1088, 1920), (4320, 7680), (600, 9000), (2880, 5120)):
        best = k7.geometry(h, w, 8, 132)
        th = best[0]
        for rows in range(1, -(-h // th) + 1):
            try:
                other = k7.geometry(h, w, 8, 132, band=rows * th)
            except ValueError:
                continue
            assert cost(h, w, best[3]) <= cost(h, w, other[3]) + 1e-9, (h, w, rows)
    with pytest.raises(ValueError, match="wide"):
        k7.geometry(100, 3 * 132 * 112 + 1, 8, 132)
    with pytest.raises(ValueError, match="resident blocks"):
        k7.geometry(2160, 3840, 8, 132, band=384)  # 12 tile rows x 35 > 396
    with pytest.raises(ValueError, match="resident blocks"):
        k7.geometry(131, 130, 8, 2, band=128)  # 5 tile rows x 2 > 6
