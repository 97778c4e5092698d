"""K5's schedule (csrc/tvl1.cu) walked in plain torch against the plain
inner loop, bitwise.

`tvl1_inner.k5_launch_schedule_plain` cuts each image into K5's tiles,
stages each tile's window with NaN outside the array, runs s in-place
two-pass alternations on the rows of the shrinking exact region (a warp
a row) and on all of the window's columns, takes the column
neighbours as the warp shuffles give them (the window's first and last
columns from the edge lanes' own values), applies the edge rules at the
array's first and last rows and columns, and writes only the owned tile.
`k5_iters_schedule_plain` chains ceil(iters/s) such launches, the first from
zero duals and the last writing u only. These tests hold the chain equal to
`tvl1_inner_plain` with max |diff| 0.0 (no NaN of the halo and no garbage
row or column reaches an owned pixel) at odd shapes, on stacks, at every s
from 1 to K5_MAX_ITERS, on frames just past the tiles of each s, with iters
that s does not divide, and with small windows, so that tiles meet every
edge; and once against the JAX reference's Pallas kernel in interpret mode,
within its 2e-6 bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowhs_tpu.kernels.tvl1_inner as ref_k5
from opticalflowhs_tpu_torch import TVL1Config
from opticalflowhs_tpu_torch import tvl1 as tv
from opticalflowhs_tpu_torch.data.synthetic import translation_pair
from opticalflowhs_tpu_torch.kernels import tvl1_inner as k5

INNER_TOL = 2e-6  # the reference's kernel-vs-oracle bar

# K5's window, and small ones (a warp a row, 4 columns a lane, as K5).
GEOMETRIES = {
    "k5": (k5.K5_WINDOW_H, k5.K5_WINDOW_W),
    "8x16": (8, 16),
    "12x16": (12, 16),
    "16x24": (16, 24),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _problem(shape, seed):
    """Warm (u1, u2) and the inner loop's fields from translation pairs
    rescaled to [0, 255] (one a stack image), where all three cases of the
    data term fire."""
    b = shape[0] if len(shape) == 3 else 0
    made = [translation_pair(*shape[-2:], 0.7, -0.3, key=seed + k) for k in range(max(b, 1))]
    i1, i2 = (torch.from_numpy(np.stack([m[j] for m in made])) for j in (0, 1))
    if not b:
        i1, i2 = i1[0], i2[0]
    i1, i2 = tv.rescale_pair(i1, i2)
    rng = np.random.default_rng(seed)
    u1, u2 = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)) for _ in range(2))
    fields = tv.inner_fields(i1, i2, u1, u2, TVL1Config())
    rho0, gx, gy, _, th = fields
    rho = rho0 + u1 * gx + u2 * gy
    assert min(float((rho < -th).float().mean()), float((rho > th).float().mean()),
               float((rho.abs() <= th).float().mean())) > 0
    return u1, u2, fields, tv.inner_scalars(TVL1Config())


def _diff(got, want) -> float:
    return max(float((g - w).abs().nan_to_num(float("inf")).max()) for g, w in zip(got, want))


def _max_iters(window):
    s = 1
    while s < k5.K5_MAX_ITERS:
        th, tw, _ = k5.k5_tile(s + 1, window)
        if th < 1 or tw < k5.K5_LANE_COLS:
            break
        s += 1
    return s


@pytest.mark.parametrize("s", range(1, k5.K5_MAX_ITERS + 1))
def test_k5_tile_fits_its_window(s):
    th, tw, lh = k5.k5_tile(s)
    assert th >= 1 and tw >= k5.K5_LANE_COLS
    assert tw % k5.K5_LANE_COLS == 0 and lh % k5.K5_LANE_COLS == 0
    assert lh >= s and k5.K5_WINDOW_W - lh - tw >= s  # s halo columns each side
    assert th + 2 * s == k5.K5_WINDOW_H
    # 11 arrays of the window and 3 of the next one, within a block's 227 KB.
    assert k5.K5_SMEM_BYTES == 14 * 4 * k5.K5_WINDOW_H * k5.K5_WINDOW_W <= 232_448
    assert k5.K5_WINDOW_H == k5.K5_THREADS // 32  # a warp a window row
    assert k5.K5_WINDOW_W == 32 * k5.K5_LANE_COLS


def test_k5_block_iters_bounds():
    assert k5.k5_tile(4) == (24, 120, 4)
    assert k5.k5_tile(k5.K5_MAX_ITERS) == (16, 112, 8)  # the auto rule's largest s
    u1, u2, fields, sc = _problem((16, 16), 7)
    for bad in (-1, k5.K5_MAX_ITERS + 1):
        with pytest.raises(ValueError, match="block_iters"):
            k5.tvl1_inner(u1, u2, *fields, 3, *sc, block_iters=bad)


# Odd shapes; K5's window meets every edge of them, the small windows make
# many tiles. 25 x 121 and 49 x 241 lie one row and column past one and two
# tiles of s = 4 (24 x 120), the auto s at 1088x1920.
@pytest.mark.parametrize("shape", [(37, 53), (67, 93), (131, 130), (25, 121), (49, 241)])
@pytest.mark.parametrize("iters", [1, 7, 30])
def test_schedule_at_k5_window_equals_plain(shape, iters):
    u1, u2, fields, sc = _problem(shape, 1)
    want = k5.tvl1_inner_plain(u1, u2, *fields, iters, *sc)
    for s in sorted({1, 4, k5.K5_MAX_ITERS, min(iters, k5.K5_MAX_ITERS)}):
        got = k5.k5_iters_schedule_plain(u1, u2, *fields, iters, s, *sc)
        assert _diff(got, want) == 0.0, s


@pytest.mark.parametrize("s", range(1, k5.K5_MAX_ITERS + 1))
def test_schedule_at_every_s_equals_plain(s):
    u1, u2, fields, sc = _problem((2, 37, 53), 8)
    iters = s + s // 2 + 1  # s does not divide it
    got = k5.k5_iters_schedule_plain(u1, u2, *fields, iters, s, *sc)
    assert _diff(got, k5.tvl1_inner_plain(u1, u2, *fields, iters, *sc)) == 0.0


@pytest.mark.parametrize("s", range(1, k5.K5_MAX_ITERS + 1))
def test_schedule_past_the_tiles_of_s_equals_plain(s):
    # A frame one row past two of s's tiles and one column past one, so that
    # the last tile row and column hold a single pixel.
    th, tw, _ = k5.k5_tile(s)
    u1, u2, fields, sc = _problem((2 * th + 1, tw + 1), 9)
    iters = 2 * s + 1
    got = k5.k5_iters_schedule_plain(u1, u2, *fields, iters, s, *sc)
    assert _diff(got, k5.tvl1_inner_plain(u1, u2, *fields, iters, *sc)) == 0.0


@pytest.mark.parametrize("geometry", ["8x16", "12x16", "16x24"])
@pytest.mark.parametrize("shape", [(37, 53), (3, 21, 37)])
def test_schedule_at_small_windows_equals_plain(geometry, shape):
    window = GEOMETRIES[geometry]
    u1, u2, fields, sc = _problem(shape, 2)
    iters = 7
    want = k5.tvl1_inner_plain(u1, u2, *fields, iters, *sc)
    for s in range(1, _max_iters(window) + 1):
        got = k5.k5_iters_schedule_plain(u1, u2, *fields, iters, s, *sc, window=window)
        assert _diff(got, want) == 0.0, s


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("s", [2, 4])
def test_schedule_on_stacks_equals_plain(b, s):
    shape = (b, 29, 41) if b > 1 else (29, 41)
    u1, u2, fields, sc = _problem(shape, 3)
    got = k5.k5_iters_schedule_plain(u1, u2, *fields, 11, s, *sc, window=(12, 16))
    assert _diff(got, k5.tvl1_inner_plain(u1, u2, *fields, 11, *sc)) == 0.0


def test_a_launch_returns_the_duals_of_the_plain_loop():
    # A launch that is not the call's last writes the duals too: after the
    # first launch they are the plain loop's duals after s alternations.
    u1, u2, fields, sc = _problem((23, 31), 4)
    got = k5.k5_launch_schedule_plain(u1, u2, None, *fields, 3, *sc, last=False,
                                      window=(12, 16))
    # The plain loop (tvl1_inner_plain) written out, keeping its duals.
    theta, sigma, lam_theta = sc
    rho0, gx, gy, inv_g2, th = fields
    a1, a2 = u1, u2
    p1x = p1y = p2x = p2y = torch.zeros_like(u1)
    for _ in range(3):
        rho = rho0 + a1 * gx + a2 * gy
        step = torch.where(rho < -th, lam_theta,
                           torch.where(rho > th, -lam_theta, -rho * inv_g2))
        a1 = a1 + step * gx + theta * tv.divergence(p1x, p1y)
        a2 = a2 + step * gy + theta * tv.divergence(p2x, p2y)
        d1x, d1y = tv.grad_forward(a1)
        d2x, d2y = tv.grad_forward(a2)
        n1 = 1.0 + sigma * tv._safe_norm(d1x, d1y)
        n2 = 1.0 + sigma * tv._safe_norm(d2x, d2y)
        p1x, p1y = tv._mask_dual((p1x + sigma * d1x) / n1, (p1y + sigma * d1y) / n1)
        p2x, p2y = tv._mask_dual((p2x + sigma * d2x) / n2, (p2y + sigma * d2y) / n2)
    assert _diff(got[:2], (a1, a2)) == 0.0
    assert _diff(got[2], (p1x, p1y, p2x, p2y)) == 0.0


def test_schedule_rejects_a_window_too_small():
    u1, u2, fields, sc = _problem((16, 16), 5)
    with pytest.raises(ValueError):
        k5.k5_launch_schedule_plain(u1, u2, None, *fields, 6, *sc, window=(12, 16))


def test_schedule_matches_reference_kernel(monkeypatch):
    u1, u2, fields, sc = _problem((67, 93), 6)
    got = k5.k5_iters_schedule_plain(u1, u2, *fields, 7, 3, *sc)
    assert _diff(got, k5.tvl1_inner_plain(u1, u2, *fields, 7, *sc)) == 0.0
    args = [jnp.asarray(a.numpy()) for a in (u1, u2, *fields)]
    monkeypatch.setattr(ref_k5, "_FORCE_NB", 2)  # the Pallas kernel in interpret mode
    ref = ref_k5.tvl1_inner(*args, 7, *sc)
    assert _diff(got, [torch.from_numpy(np.array(r)) for r in ref]) <= INNER_TOL
