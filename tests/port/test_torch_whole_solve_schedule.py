"""K6's and K7's schedules (csrc/solve_fused.cu, csrc/solve_skewed.cu) walked
in plain torch against the plain whole solve, bitwise.

`solve_fused.fused_schedule_plain` runs K6's sweep blocks, each one K2
launch's walk (`jacobi.k2_launch_schedule_plain`: K2 tiles, NaN-staged
windows), the remainder at its own tile, from zeros or a warm start.
`solve_skewed.skewed_schedule_plain` runs K7's in-place band steps: K2
windows on bands of whole tile rows, m tiles a block, rows above a band
from the pencil the band before saved, and each band's windows staged while
the band before is in flight, from a u/v whose in-flight rows are NaN. Both
must equal `hs_solve_resident_plain` with max |diff| 0.0 (the same plain
ops per pixel; only the window a pixel is computed in changes): no NaN of
the halo, of an in-flight band or of an unsaved pencil row reaches an owned
pixel. Besides K2's 48 x 128 window they use small windows, so that small
frames hold many tiles, many bands, and m = 1, 2 and 3 on small grids.
"""

import numpy as np
import pytest
import torch

from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import solve_fused as k6
from opticalflowhs_tpu_torch.kernels import solve_skewed as k7
from opticalflowhs_tpu_torch.kernels.solve_resident import hs_solve_resident_plain

# (window, lane columns, warp rows): K2's and two small ones.
WINDOWS = {
    "k2": ((k2.K2_WINDOW_H, k2.K2_WINDOW_W), k2.K2_LANE_COLS, k2.K2_WARP_ROWS),
    "16x24": ((16, 24), 4, 2),
    "12x16": ((12, 16), 4, 3),
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
    u0, v0 = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)) for _ in range(2))
    return i1, i2, u0, v0


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), float((g - w).abs().nan_to_num(float("inf")).max())


def _geo(name):
    window, lane_cols, warp_rows = WINDOWS[name]
    return dict(window=window, lane_cols=lane_cols, warp_rows=warp_rows)


# -- K6 ----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(67, 93), (30, 41), (1, 9), (9, 1), (2, 25, 31)])
@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("n,s", [(1, 1), (7, 3), (9, 4), (13, 5)])
@pytest.mark.parametrize("warm", [False, True])
def test_fused_schedule_equals_plain_solve(shape, window, n, s, warm):
    i1, i2, u0, v0 = _problem(shape, 10)
    init = (u0, v0) if warm else (None, None)
    if window == "12x16" and s > 3:
        s = 3  # the 12-row window's tile holds at most 3 sweeps
    got = k6.fused_schedule_plain(i1, i2, 0.5, n, "hs_cube", *init, s=s, **_geo(window))
    _equal(got, hs_solve_resident_plain(i1, i2, 0.5, n, "hs_cube", *init))


def test_fused_schedule_at_k2_s_and_its_remainder():
    # The chain's s = 8 on K2's window, n = 100: 12 blocks of 8 and a last
    # block of 4 at its own 40 x 120 tile; central differences.
    i1, i2, u0, v0 = _problem((75, 130), 11)
    for init in ((None, None), (u0, v0)):
        got = k6.fused_schedule_plain(i1, i2, 0.5, 100, "central", *init, s=8)
        _equal(got, hs_solve_resident_plain(i1, i2, 0.5, 100, "central", *init))


# -- K7 ----------------------------------------------------------------------------

# (shape, window, s, blocks, band rows): bands of 1, 2 and >= 3 tile rows,
# m = 1, 2 and 3 (small grids), tile rows that end on the frame's edge or
# past it, and frames of one band.
K7_CASES = [
    ((30, 41), "16x24", 3, 6, 0),     # m 1 (3 tiles across, 6 blocks)
    ((30, 41), "16x24", 3, 2, 0),     # m 2 or 3 on 2 blocks
    ((30, 41), "16x24", 3, 1, 0),     # m 3 on 1 block
    ((30, 41), "16x24", 3, 3, 10),    # a forced band of one tile row (10 rows): 3 bands
    ((40, 41), "16x24", 3, 3, 20),    # two tile rows a band: 2 bands
    ((20, 41), "16x24", 3, 3, 10),    # 2 bands of one tile row each
    ((10, 41), "16x24", 3, 3, 10),    # 1 band
    ((27, 33), "16x24", 5, 4, 0),     # s 5: 6 x 8 tiles
    ((27, 33), "16x24", 2, 4, 1),     # s 2: 12-row tiles
    ((25, 17), "12x16", 3, 2, 0),     # tile rows of 6, the last one cut
    ((25, 17), "12x16", 2, 1, 8),     # 8-row tiles: bands of one tile row
    ((24, 16), "12x16", 1, 2, 20),    # the band boundary on the frame's edge
    ((67, 93), "k2", 8, 132, 0),      # K2's window: one band
    ((131, 130), "k2", 4, 2, 1),      # K2's window, 40-row tiles: 4 bands
]


@pytest.mark.parametrize("shape,window,s,blocks,band", K7_CASES)
@pytest.mark.parametrize("n", [1, 7, 12])
@pytest.mark.parametrize("warm", [False, True])
def test_skewed_schedule_at_small_windows_equals_plain_solve(shape, window, s, blocks,
                                                             band, n, warm):
    i1, i2, u0, v0 = _problem(shape, 12)
    init = (u0, v0) if warm else (None, None)
    got = k7.skewed_schedule_plain(i1, i2, 0.5, n, "hs_cube", *init, s=s, band=band,
                                   blocks=blocks, **_geo(window))
    _equal(got, hs_solve_resident_plain(i1, i2, 0.5, n, "hs_cube", *init))


@pytest.mark.parametrize("band,bands", [(10, 3), (20, 2), (30, 1)])
def test_skewed_schedule_stages_the_next_sweep_block_only_after_its_rows(band, bands):
    # 30 x 41 at s 3 in the 16 x 24 window: 10-row tiles, 3 tile rows. Band 0
    # of the next sweep block reads rows of bands 0 and 1; with 3 bands they
    # are complete at the last band's barrier, so it is staged behind the last
    # band's sweeps. With 1 or 2 it must wait for one more barrier: staging it
    # early reads the in-flight rows (NaN in the twin).
    i1, i2, u0, v0 = _problem((30, 41), 13)
    geo = _geo("16x24")
    assert k7.geometry(30, 41, 3, 3, band, geo["window"], geo["lane_cols"])[4] == bands
    want = hs_solve_resident_plain(i1, i2, 0.5, 9, "hs_cube", u0, v0)
    _equal(k7.skewed_schedule_plain(i1, i2, 0.5, 9, "hs_cube", u0, v0, s=3, band=band,
                                    blocks=3, **geo), want)
    early = k7.skewed_schedule_plain(i1, i2, 0.5, 9, "hs_cube", u0, v0, s=3, band=band,
                                     blocks=3, early_block_staging=True, **geo)
    assert all(torch.equal(g, w) for g, w in zip(early, want)) == (bands >= 3)


@pytest.mark.parametrize("window", ["16x24", "k2"])
def test_skewed_schedule_of_stacks_equals_singles(window):
    # Images one after another; the next image's first band is staged behind
    # the last band of the image before (no rows in common).
    i1, i2, _, _ = _problem((3, 29, 37), 14)
    geo = _geo(window)
    s = 3 if window != "k2" else 8
    got = k7.skewed_schedule_plain(i1, i2, 0.5, 11, "central", s=s, blocks=2, band=1, **geo)
    _equal(got, hs_solve_resident_plain(i1, i2, 0.5, 11, "central"))
    for k in range(3):
        one = k7.skewed_schedule_plain(i1[k], i2[k], 0.5, 11, "central", s=s, blocks=2,
                                       band=1, **geo)
        _equal([g[k] for g in got], one)
