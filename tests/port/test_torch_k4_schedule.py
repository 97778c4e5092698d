"""K4's sweep schedule (csrc/robust.cu) walked in plain torch against chains
of `robust.robust_step`, bitwise.

`solve_robust.k4_launch_schedule_plain` cuts each image into K4's tiles
(the window less s rows above and below, s columns rounded up to 4 on the
left and at least s on the right), stages each tile's window of u, v and
the five fields with NaN outside the array, forms the ten frozen
coefficients once from the staged window, runs sweep k on the rows of the
warps that meet the window's rows shrunk by k (cut at the array's edges),
puts NaN wherever the kernel reads beside its window (the rows above and
below it, the shuffles at lanes 0 and 31), clamps at the array's edges, and
writes only the owned tile. These tests hold it equal to the plain chain
with max |diff| 0.0 at every s up to K4_MAX_SWEEPS, at frames one pixel
below and above one and two tiles, on stacks, at widths that are not a
multiple of 4, from zero and warm starts; show that a halo one row or one
column smaller lets a NaN into the tile; and hold K4's geometry and its
cost rule (`sweeps_per_launch`).
"""

import numpy as np
import pytest
import torch

from opticalflowhs_tpu_torch import HSConfig, robust
from opticalflowhs_tpu_torch.kernels import solve_robust as k4
from opticalflowhs_tpu_torch.kernels.derivatives import derivatives_plain

ALPHA = 0.3
SWEEPS = range(1, k4.K4_MAX_SWEEPS + 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _problem(shape, seed, warm=True):
    """u0, v0 and the five fields; the weights frozen at a warm flow (or at
    zero for a zero start)."""
    rng = np.random.default_rng(seed)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)) for _ in range(2))
    ex, ey, et, _ = derivatives_plain(i1, i2, 0.4)
    if warm:
        u0, v0 = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32))
                  for _ in range(2))
    else:
        u0, v0 = torch.zeros(shape), torch.zeros(shape)
    wd, ws = robust.charbonnier_weights(u0, v0, ex, ey, et, 0.05, 0.05)
    return u0, v0, (ex, ey, et, wd, ws)


def _plain(u, v, fields, n):
    for _ in range(n):
        u, v = robust.robust_step(u, v, *fields, ALPHA)
    return u, v


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().nan_to_num(float("inf")).max())


def _shape(s, kind):
    """Frames one pixel below and above one and two tiles of s sweeps."""
    th, tw, _ = k4.k4_tile(s)
    return {"one-": (th - 1, tw - 1), "one+": (th + 1, tw + 1),
            "two-": (2 * th - 1, 2 * tw - 1), "two+": (2 * th + 1, 2 * tw + 1)}[kind]


# -- geometry and plan --------------------------------------------------------


@pytest.mark.parametrize("s", SWEEPS)
def test_k4_tile_fits_its_window(s):
    th, tw, lh = k4.k4_tile(s)
    assert th + 2 * s == k4.K4_WINDOW_H and th >= k4.K4_THREAD_ROWS
    assert lh >= s and lh % k4.K4_LANE_COLS == 0 and lh - s < k4.K4_LANE_COLS
    assert tw % k4.K4_LANE_COLS == 0 and k4.K4_WINDOW_W - lh - tw >= s
    assert k4.K4_WINDOW_H == k4.K4_THREADS // 32 * k4.K4_THREAD_ROWS
    assert k4.K4_WINDOW_W == 32 * k4.K4_LANE_COLS
    assert k4.K4_SMEM_BYTES <= 232_448


def test_k4_max_sweeps_is_the_last_tile():
    assert k4.K4_MAX_SWEEPS == 14
    assert k4.k4_tile(k4.K4_MAX_SWEEPS) == (4, 96, 16)
    assert k4.k4_tile(8) == (16, 112, 8)
    assert k4.k4_tiles((1088, 1920), 8) == 68 * 18
    assert k4.k4_tiles((8, 1088, 1920), 5) == 8 * 50 * 18
    u0, v0, fields = _problem((9, 9), 0)
    with pytest.raises(ValueError, match="no K4 tile"):
        k4.k4_launch_schedule_plain(u0, v0, *fields, k4.K4_WINDOW_H // 2, ALPHA)


@pytest.mark.parametrize("block", [1, 4, 8, 13, 14, 15, 20, 50])
def test_explicit_block_sweeps_are_cut_not_refused(block):
    # HSConfig.block_sweeps is shared with the Jacobi path: too many is cut.
    for shape, n in (((1088, 1920), 20), ((3, 67, 93), 7)):
        assert k4.sweeps_per_launch(block, shape, n, 132) == min(block, k4.K4_MAX_SWEEPS)
    with pytest.raises(ValueError):
        k4.sweeps_per_launch(-1, (1088, 1920), 20, 132)


def test_sweep_slots_follow_the_live_warps():
    # Sweeps 1-3 run all 8 warps, 4-7 warps 1-6, 8-11 warps 2-5 and 12-14
    # warps 3 and 4; warp j issues on scheduler j % 4, so a sweep takes 2
    # slots while warps j and j + 4 both run, else 1.
    per_sweep = [2] * 7 + [1] * 7
    assert [k4.k4_sweep_slots(s) for s in SWEEPS] == [
        sum(per_sweep[:s]) for s in SWEEPS]


def _brute_cost(shape, n, s, blocks):
    cost, left = 0.0, n
    while left > 0:
        k = min(s, left)
        th, tw, _ = k4.k4_tile(k)
        b, h, w = (1,) * (3 - len(shape)) + tuple(shape)
        tiles = b * -(-h // th) * -(-w // tw)
        cost += k4.K4_LAUNCH_US + -(-tiles // blocks) * max(
            k4.K4_ROUND_FLOOR_US, k4.K4_TILE_US + k4.K4_SWEEP_US * k4.k4_sweep_slots(k))
        left -= k
    return cost


@pytest.mark.parametrize("shape", [(1088, 1920), (8, 1088, 1920), (4, 1080, 1920),
                                   (544, 960), (272, 480), (67, 93), (3, 200, 333)])
@pytest.mark.parametrize("n", [1, 3, 5, 8, 13, 20, 100])
def test_plan_is_the_least_cost_s(shape, n):
    s = k4.sweeps_per_launch(0, shape, n, 132)
    costs = {c: _brute_cost(shape, n, c, 132) for c in range(1, min(n, k4.K4_MAX_SWEEPS) + 1)}
    # Least cost; ties to an s that divides n, then to the larger s.
    best = min(costs, key=lambda c: (costs[c], n % c != 0, -c))
    assert s == best and 1 <= s <= min(n, k4.K4_MAX_SWEEPS)
    assert k4.plan_cost(shape, n, s, 132) == costs[s]
    assert k4.launches(n, s) == -(-n // s)


# A block of 20 sweeps at 1088x1920 at each s, in ms (NVIDIA H100 80GB
# HBM3, 700 W, tools/torch_whole_solve_timing.py --k4 --scan, 30 repeats).
R1_BLOCK20_MS = {1: 0.7235, 2: 0.3792, 3: 0.3069, 4: 0.2223, 5: 0.2060, 6: 0.2312,
                 7: 0.2167, 8: 0.2214, 9: 0.2562, 10: 0.2627, 11: 0.2624, 12: 0.2806,
                 13: 0.3508, 14: 0.4763}


def test_plan_of_r1_refreeze_blocks():
    # R1 (1088x1920, i100, k 20): five blocks of 20, each planned at the s
    # measured fastest on the card, which divides 20.
    blocks = robust.refreeze_blocks(100, 20)
    assert blocks == [20] * 5
    s = k4.sweeps_per_launch(0, (1088, 1920), 20, 132)
    assert s == min(R1_BLOCK20_MS, key=R1_BLOCK20_MS.get) and 20 % s == 0
    # A remainder block plans on its own.
    assert k4.sweeps_per_launch(0, (1088, 1920), 3, 132) <= 3


# -- the schedule against the plain sweeps -------------------------------------


@pytest.mark.parametrize("s", SWEEPS)
@pytest.mark.parametrize("kind", ["one-", "one+", "two-", "two+"])
def test_schedule_equals_plain(s, kind):
    shape = _shape(s, kind)
    u0, v0, fields = _problem(shape, 10 + s)
    n = s + 2  # s does not divide n (but at s = 1, 2)
    _equal(k4.k4_sweeps_schedule_plain(u0, v0, *fields, n, s, ALPHA),
           _plain(u0, v0, fields, n))


@pytest.mark.parametrize("s", [1, 3, 5, 8, k4.K4_MAX_SWEEPS])
@pytest.mark.parametrize("warm", [False, True])
def test_schedule_on_stacks_equals_plain(s, warm):
    shape = (3,) + ((5, 9), (37, 45), (20, 130))[s % 3]
    u0, v0, fields = _problem(shape, 30 + s, warm)
    got = k4.k4_sweeps_schedule_plain(u0, v0, *fields, s + 1, s, ALPHA)
    _equal(got, _plain(u0, v0, fields, s + 1))
    for k in range(3):
        one = k4.k4_sweeps_schedule_plain(u0[k], v0[k], *(f[k] for f in fields), s + 1, s,
                                          ALPHA)
        _equal((got[0][k], got[1][k]), one)


@pytest.mark.parametrize("s", [1, 4, 7, 8, 12])
@pytest.mark.parametrize("w", [93, 130, 229])
def test_schedule_at_widths_not_a_multiple_of_four(s, w):
    u0, v0, fields = _problem((k4.k4_tile(s)[0] + 3, w), 40 + s)
    _equal(k4.k4_sweeps_schedule_plain(u0, v0, *fields, 2 * s, s, ALPHA),
           _plain(u0, v0, fields, 2 * s))


@pytest.mark.parametrize("warm", [False, True])
def test_robust_chain_through_the_schedule_equals_plain(warm):
    # A refrozen IRLS run (k 5, 13 sweeps) with each block's sweeps walked
    # as the plan's launches: the whole-path twin of `robust_sweeps`.
    shape = (2, 40, 150)
    u, v, (ex, ey, et, _, _) = _problem(shape, 60, warm)
    cfg = HSConfig(alpha=ALPHA, iters=13, solver="robust", robust_update_every=5)
    want = robust.robust_sweeps(u, v, ex, ey, et, 13, cfg)
    for m in robust.refreeze_blocks(13, 5):
        wd, ws = robust.charbonnier_weights(u, v, ex, ey, et, cfg.robust_eps_d,
                                            cfg.robust_eps_s)
        s = k4.sweeps_per_launch(0, shape, m, 132)
        u, v = k4.k4_sweeps_schedule_plain(u, v, ex, ey, et, wd, ws, m, s, ALPHA)
    _equal((u, v), want)


# -- a halo one row or one column smaller lets the window's edge in -------------


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("cut", ["row", "column"])
def test_a_smaller_halo_lets_a_nan_into_the_tile(s, cut):
    _, _, lh = k4.k4_tile(s)
    halo = (s - 1, lh) if cut == "row" else (s, s - 1)
    # Frames with windows wholly inside the array, whose edges are not clamps.
    u0, v0, fields = _problem((k4.K4_WINDOW_H + 20, k4.K4_WINDOW_W + 90), 70 + s)
    got = k4.k4_launch_schedule_plain(u0, v0, *fields, s, ALPHA, halo=halo)
    want = _plain(u0, v0, fields, s)
    assert any(bool(torch.isnan(g).any()) for g in got)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))
    # The full halo on the same frames is exact.
    _equal(k4.k4_launch_schedule_plain(u0, v0, *fields, s, ALPHA), want)
