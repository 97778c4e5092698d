"""K2's schedule (csrc/jacobi.cu) walked in plain torch against the plain
sweeps, bitwise.

`jacobi.k2_launch_schedule_plain` cuts each image into K2's tiles, stages
each tile's window with NaN outside the array, sweeps every row of the warps
that meet the shrinking exact region on all of the window's columns, takes
t(j-1) and t(j+1) as the warp shuffles give them (the window's first and last
columns from the edge lanes' own values), clamps at the array's edges and, on
K9's shards, at the true image edges, and writes only the owned tile. These
tests hold it equal to `jacobi_sweeps_plain` (and K9's `tile_sweeps_plain`)
with max |diff| 0.0: no NaN of the halo, no shuffled edge value and no stale
row reaches an owned pixel, at odd geometries, on stacks and at shard
origins that put true edges inside a warp's rows, at its boundary, inside a
lane's four columns and at a lane's first or last column. Besides K2's own
48 x 128 window they use small windows, so that small frames hold many
tiles.
"""

import numpy as np
import pytest
import torch

from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import tile as k9
from opticalflowhs_tpu_torch.kernels.derivatives import derivatives_plain

# K2's window, and small ones: (window, lane columns, warp rows).
GEOMETRIES = {
    "k2": ((k2.K2_WINDOW_H, k2.K2_WINDOW_W), k2.K2_LANE_COLS, k2.K2_WARP_ROWS),
    "12x16": ((12, 16), 4, 3),
    "16x24": ((16, 24), 4, 2),
}


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


def _max_sweeps(geometry):
    window, lane_cols, _ = geometry
    s = 1
    while True:
        th, tw, _ = k2.k2_tile(s + 1, window, lane_cols)
        if th < 1 or tw < lane_cols or s + 1 > k2.K2_MAX_SWEEPS:
            return s
        s += 1


@pytest.mark.parametrize("s", range(1, k2.K2_MAX_SWEEPS + 1))
def test_k2_tile_fits_its_window(s):
    th, tw, lh = k2.k2_tile(s)
    assert th >= 1 and tw >= k2.K2_LANE_COLS
    assert tw % k2.K2_LANE_COLS == 0 and lh % k2.K2_LANE_COLS == 0
    assert lh >= s and k2.K2_WINDOW_W - lh - tw >= s  # s halo columns each side
    assert th + 2 * s == k2.K2_WINDOW_H
    assert k2.K2_SMEM_BYTES <= k2.SMEM_BYTES
    assert k2.K2_WINDOW_H == k2.K2_THREADS // 32 * k2.K2_WARP_ROWS
    assert k2.K2_WINDOW_W == 32 * k2.K2_LANE_COLS


def test_k2_default_tile():
    assert k2.k2_tile(k2.sweeps_per_launch(0)) == (32, 112, 8)
    # The contract's cap: sweeps_per_launch cuts 11 and 12 to 10, which K2's window takes.
    assert k2.sweeps_per_launch(12) == 10 <= k2.K2_MAX_SWEEPS


# Widths around a lane (4), a warp (128) and K2's tile (112 at s = 8; w = 113
# leaves a last tile of one column); heights of 1-3 rows and around K2's tile.
SHAPES = [(1, 1), (1, 7), (2, 31), (3, 32), (1, 33), (5, 63), (4, 65), (7, 129),
          (33, 113), (67, 93)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_schedule_equals_plain(shape, geometry):
    window, lane_cols, warp_rows = GEOMETRIES[geometry]
    u0, v0, fields = _problem(shape, 1)
    smax = _max_sweeps(GEOMETRIES[geometry])
    for s in sorted({1, 2, 3, 8, smax} & set(range(1, smax + 1))):
        n = s + s // 2 + 1  # s does not divide n
        got = k2.k2_sweeps_schedule_plain(u0, v0, *fields, n, s, window=window,
                                          lane_cols=lane_cols, warp_rows=warp_rows)
        _equal(got, k2.jacobi_sweeps_plain(u0, v0, *fields, n))


@pytest.mark.parametrize("shape", [(5, 9), (40, 130), (9, 300)])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_schedule_on_stacks_equals_plain(shape, geometry):
    window, lane_cols, warp_rows = GEOMETRIES[geometry]
    u0, v0, fields = _problem((3,) + shape, 2)
    got = k2.k2_sweeps_schedule_plain(u0, v0, *fields, 7, 4, window=window,
                                      lane_cols=lane_cols, warp_rows=warp_rows)
    _equal(got, k2.jacobi_sweeps_plain(u0, v0, *fields, 7))


def _edge_origins(geometry, s):
    """Shard origins whose true top (left) edge falls inside a warp's rows
    and at a warp's first row, and inside a lane's columns and at a lane's
    first and last column, of the first window; and negative, odd ones."""
    window, lane_cols, warp_rows = geometry
    _, _, lh = k2.k2_tile(s, window, lane_cols)
    rows = [-(warp_rows * m - s) for m in (2, 3) if warp_rows * m > s]  # window row at a warp start
    rows += [r - 1 for r in rows] + [-1, 0, 3]
    cols = [-(lane_cols * m - lh) for m in (2, 3) if lane_cols * m > lh]  # a lane's first column
    cols += [c - 1 for c in cols] + [c - 2 for c in cols] + [0, 5]
    return rows, cols


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("s", [1, 3, 4])
def test_schedule_at_shard_origins_equals_k9_plain(geometry, s):
    rows, cols = _edge_origins(GEOMETRIES[geometry], s)
    window, lane_cols, warp_rows = GEOMETRIES[geometry]
    n_img = max(len(rows), len(cols))
    rows = (rows * n_img)[:n_img]
    cols = (cols * n_img)[:n_img]
    ph, pw = 23, 37
    u0, v0, fields = _problem((n_img, ph, pw), 3)
    # A 29 x 41 image: the shards also hold its bottom and right edges.
    h, w = 29, 41
    got = k2.k2_sweeps_schedule_plain(u0, v0, *fields, 2 * s + 1, s,
                                      origins=list(zip(rows, cols)), img_hw=(h, w),
                                      window=window, lane_cols=lane_cols, warp_rows=warp_rows)
    _equal(got, k9.tile_sweeps_plain(u0, v0, *fields, 2 * s + 1, rows, cols, h, w))


@pytest.mark.parametrize("corner", [(-4, -3), (-3, 400 - 93 + 5), (300 - 67 + 3, -5),
                                    (300 - 67 + 4, 400 - 93 + 3), (117, 33)])
def test_schedule_at_phase_15_corners_equals_k9_plain(corner):
    u0, v0, fields = _problem((67, 93), 4)
    r0, c0 = corner
    got = k2.k2_sweeps_schedule_plain(u0, v0, *fields, 13, 8, origins=[corner],
                                      img_hw=(300, 400))
    _equal(got, k9.tile_sweeps_plain(u0, v0, *fields, 13, r0, c0, 300, 400))


def test_schedule_rejects_a_window_too_small():
    u0, v0, fields = _problem((8, 8), 5)
    with pytest.raises(ValueError):
        k2.k2_launch_schedule_plain(u0, v0, *fields, 6, window=(12, 16))
