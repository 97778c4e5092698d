"""K3's schedule (csrc/sor.cu) walked in plain torch against the plain SOR
sweeps, bitwise.

`sor.k3_launch_schedule_plain` cuts each image into K3's tiles (the 48 x
128 window less 2s rows above and below and 4s columns on each side),
stages each tile's window with NaN outside the array, runs each sweep as
two halves (the global-even rows' two color stages in place, then the odd
rows') on the rows of the warps that meet the rows still needed, puts NaN
wherever the kernel reads beside its window (its first and last rows, the
shuffles at lanes 0 and 31), clamps at the array's edges and, on K9's
shards, at the true image edges with the colors by global parity, and
writes only the owned tile. These tests hold it equal to
`sor_sweeps_plain` (and K9's `sor_tile_sweeps_plain`) with max |diff| 0.0
at every s up to K3_MAX_SWEEPS, at frames one pixel below and above one and
two tiles, on stacks, at widths that are not a multiple of 4 and at odd and
even shard origins; and show that a halo one row or one column smaller
lets a wrong value into the tile. They also hold K3's geometry and its cost
rule (`sweeps_per_launch`).
"""

import numpy as np
import pytest
import torch

from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import sor as k3
from opticalflowhs_tpu_torch.kernels import tile as k9
from opticalflowhs_tpu_torch.kernels.derivatives import derivatives_plain

OMEGA = 1.7
SWEEPS = range(1, k3.K3_MAX_SWEEPS + 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _problem(shape, seed):
    rng = np.random.default_rng(seed)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)) for _ in range(2))
    fields = derivatives_plain(i1, i2, 0.5)
    u0, v0 = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)) for _ in range(2))
    return u0, v0, fields


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().nan_to_num(float("inf")).max())


def _shape(s, kind):
    """Frames one pixel below and above one and two tiles of s sweeps."""
    th, tw, _, _ = k3.k3_tile(s)
    return {"one-": (th - 1, tw - 1), "one+": (th + 1, tw + 1),
            "two-": (2 * th - 1, 2 * tw - 1), "two+": (2 * th + 1, 2 * tw + 1)}[kind]


# -- geometry and plan --------------------------------------------------------


@pytest.mark.parametrize("s", SWEEPS)
def test_k3_tile_fits_its_window(s):
    th, tw, hr, hc = k3.k3_tile(s)
    assert (hr, hc) == (2 * s, 4 * s)
    assert th + 2 * hr == k3.K3_WINDOW_H and tw + 2 * hc == k3.K3_WINDOW_W
    assert th >= k3.K3_THREAD_ROWS and th % 2 == 0  # tiles keep the row parity
    assert tw % k3.K3_LANE_COLS == 0 and hc % k3.K3_LANE_COLS == 0
    assert k3.K3_WINDOW_H == k3.K3_THREADS // 32 * k3.K3_THREAD_ROWS
    assert k3.K3_WINDOW_W == 32 * k3.K3_LANE_COLS
    assert k3.K3_SMEM_BYTES <= k2.SMEM_BYTES


def test_k3_max_sweeps_is_the_last_tile():
    assert k3.K3_MAX_SWEEPS == 11
    assert k3.k3_tile(k3.K3_MAX_SWEEPS)[:2] == (4, 40)
    assert k3.k3_tile(k3.K3_MAX_SWEEPS + 1)[0] <= 0
    u0, v0, fields = _problem((9, 9), 0)
    with pytest.raises(ValueError, match="no K3 tile"):
        k3.k3_launch_schedule_plain(u0, v0, *fields, k3.K3_MAX_SWEEPS + 1, OMEGA)


def test_k3_default_tile_and_tiles():
    assert k3.k3_tile(4) == (32, 96, 8, 16)
    assert k3.k3_tiles((1088, 1920), 4) == 34 * 20
    assert k3.k3_tiles((8, 1088, 1920), 4) == 8 * 34 * 20
    assert k3.k3_tiles((16, 572, 992), 4) == 16 * 18 * 11


@pytest.mark.parametrize("block", [1, 4, 7, 11, 12, 50])
def test_block_sweeps_are_capped(block):
    assert k3.sweeps_per_launch(block, (1088, 1920), 50) == min(block, k3.K3_MAX_SWEEPS)
    with pytest.raises(ValueError):
        k3.sweeps_per_launch(-1, (1088, 1920), 50)


def _brute_cost(shape, n, s, blocks):
    cost, left = 0, n
    while left > 0:
        k = min(s, left)
        cost += k3.K3_LAUNCH_COST + -(-k3.k3_tiles(shape, k) // blocks) * (k + k3.K3_STAGE_COST)
        left -= k
    return cost


@pytest.mark.parametrize("shape", [(1088, 1920), (8, 1088, 1920), (4, 1080, 1920),
                                   (16, 572, 992), (544, 960), (272, 480), (67, 93),
                                   (3, 200, 333)])
@pytest.mark.parametrize("n", [1, 3, 4, 11, 50])
def test_plan_is_the_least_cost_even_s(shape, n):
    s = k3.sweeps_per_launch(0, shape, n, 132)
    costs = {c: _brute_cost(shape, n, c, 132) for c in range(2, k3.K3_MAX_SWEEPS + 1, 2)}
    best = max(c for c, v in costs.items() if v == min(costs.values()))
    assert s == min(best, n)
    assert 1 <= s <= k3.K3_MAX_SWEEPS
    assert k3.launches(n, s) == -(-n // s)


def test_plan_at_the_paths_shapes():
    # S1 and the SOR stacks run 4 sweeps a launch: 13 launches of i50; D4's
    # halo block of 4 sweeps over its 16 shards is one launch.
    assert k3.sweeps_per_launch(0, (1088, 1920), 50) == 4
    assert k3.sweeps_per_launch(0, (8, 1088, 1920), 50) == 4
    assert k3.sweeps_per_launch(0, (4, 1080, 1920), 50) == 4
    assert k3.sweeps_per_launch(0, (16, 572, 992), 4) == 4
    assert k3.launches(50, 4) == 13


# -- the schedule against the plain sweeps -------------------------------------


@pytest.mark.parametrize("s", SWEEPS)
@pytest.mark.parametrize("kind", ["one-", "one+", "two-", "two+"])
def test_schedule_equals_plain(s, kind):
    shape = _shape(s, kind)
    u0, v0, fields = _problem(shape, 10 + s)
    n = 2 * s + 1  # s does not divide n
    _equal(k3.k3_sweeps_schedule_plain(u0, v0, *fields, n, s, OMEGA),
           k3.sor_sweeps_plain(u0, v0, *fields, n, OMEGA))


@pytest.mark.parametrize("s,shape", [(s, shape) for s in (1, 2, 4, k3.K3_MAX_SWEEPS)
                                     for shape in ((5, 9), (37, 45), (50, 130))
                                     if s < k3.K3_MAX_SWEEPS or shape[0] < 50])
def test_schedule_on_stacks_equals_plain(s, shape):
    u0, v0, fields = _problem((3,) + shape, 30 + s)
    got = k3.k3_sweeps_schedule_plain(u0, v0, *fields, s + 2, s, OMEGA)
    _equal(got, k3.sor_sweeps_plain(u0, v0, *fields, s + 2, OMEGA))
    for k in range(3):
        one = k3.k3_sweeps_schedule_plain(u0[k], v0[k], *(f[k] for f in fields), s + 2, s,
                                          OMEGA)
        _equal((got[0][k], got[1][k]), one)


def _origins(ph, pw):
    """Shard origins in a 300 x 400 image: even and odd, negative, at the
    corners (the shard holds true edges) and inside."""
    return [(-4, -3), (-3, -4), (117, 33), (116, 32), (5, -6), (300 - ph + 3, 400 - pw + 4),
            (300 - ph + 4, 400 - pw + 5)]


@pytest.mark.parametrize("s", [1, 2, 3, 4, k3.K3_MAX_SWEEPS])
def test_schedule_at_shard_origins_equals_k9_plain(s):
    shape = (67, 150) if s < k3.K3_MAX_SWEEPS else (13, 50)
    origins = _origins(*shape)
    u0, v0, fields = _problem((len(origins),) + shape, 50 + s)
    rows, cols = [o[0] for o in origins], [o[1] for o in origins]
    n = s + 1
    got = k3.k3_sweeps_schedule_plain(u0, v0, *fields, n, s, OMEGA, origins=origins,
                                      img_hw=(300, 400))
    _equal(got, k9.sor_tile_sweeps_plain(u0, v0, *fields, n, OMEGA, rows, cols, 300, 400))


# -- a halo one row or one column smaller lets the window's edge in -------------


@pytest.mark.parametrize("s", [1, 2, 4, 6])
@pytest.mark.parametrize("cut", ["row", "column"])
def test_a_smaller_halo_differs_from_plain(s, cut):
    _, _, hr, hc = k3.k3_tile(s)
    halo = (hr - 1, hc) if cut == "row" else (hr, hc - 1)
    # Frames with windows wholly inside the array, whose edges are not clamps.
    u0, v0, fields = _problem((k3.K3_WINDOW_H + 20, k3.K3_WINDOW_W + 90), 70 + s)
    got = k3.k3_launch_schedule_plain(u0, v0, *fields, s, OMEGA, halo=halo)
    want = k3.sor_sweeps_plain(u0, v0, *fields, s, OMEGA)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))
    # The full halo on the same frames is exact.
    _equal(k3.k3_launch_schedule_plain(u0, v0, *fields, s, OMEGA), want)
