"""The ring kernels' plain versions (kernels/ring.py: K10's exchange, K11's
and K12's fused ring solves) on the CPU: against the reference's CPU logic
twin of its fused ring kernel on the 1-shard ring, against plain wrapped
concatenation for the exchange, and on n-shard 1-D and 2-D meshes against
the untiled sweeps (tiled == untiled). K11's and K12's schedule walked in
plain torch (`ring.ring_schedule_plain`: the exchange into extended pairs,
K2's windows over the owned tiles only, NaN wherever nothing was written)
equals the plain solve bitwise on those meshes, at sweep blocks from 1 to
K2's 16, with owned heights that K2's tile rows do not divide and true
image edges inside the shards, and at deeper blocks, which run as passes of
K2's walk over the owned rectangle grown into the halo (`ring.ring_passes`).

Tolerances: 2e-6 against the reference's logic twin (its Pallas kernel in
interpret mode; same ops, XLA:CPU may round the last ulp of a fused chain
differently). Against the untiled plain sweeps and for the exchange,
bitwise: the same ops on the same values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowhs_tpu.kernels.rdma_halo import ring_fused_sweeps_logic_twin
from opticalflowhs_tpu.ops import stencils as ref_st
from opticalflowhs_tpu_torch import HSConfig, hs_solve
from opticalflowhs_tpu_torch.config import MeshConfig
from opticalflowhs_tpu_torch.dist import hs_solve_tiled, make_mesh
from opticalflowhs_tpu_torch.kernels import jacobi as k2
from opticalflowhs_tpu_torch.kernels import ring
from opticalflowhs_tpu_torch.kernels.derivatives import derivatives_plain
from opticalflowhs_tpu_torch.ops import stencils

torch.set_num_threads(1)

TWIN_TOL = 2e-6


def _problem(shape, seed, alpha=0.5):
    rng = np.random.default_rng(seed)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)) for _ in range(2))
    u0, v0 = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)) for _ in range(2))
    return (u0, v0), derivatives_plain(i1, i2, alpha)


def _untiled(uv, fields, n):
    u, v = uv
    for _ in range(n):
        u, v = stencils.jacobi_step(u, v, *fields)
    return u, v


def _wrap(a: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """The periodic extension of the whole field: what the ring hands a
    shard beyond the image's top/bottom (and left/right) edges."""
    a = torch.cat([a[..., -sy:, :], a, a[..., :sy, :]], dim=-2) if sy else a
    return torch.cat([a[..., :, -sx:], a, a[..., :, :sx]], dim=-1) if sx else a


def _shards(a: torch.Tensor, my: int, mx: int, sy: int, sx: int):
    """Owned shards (sy = sx = 0) or extended ones of a whole field."""
    h, w = a.shape[-2:]
    th, tw = h // my, w // mx
    e = _wrap(a, sy, sx)
    return [[e[..., i * th:(i + 1) * th + 2 * sy, j * tw:(j + 1) * tw + 2 * sx].contiguous()
             for j in range(mx)] for i in range(my)]


def _rings(uv, fields, my, mx, sy, sx):
    """One ring of `Shard`s cut from whole fields (sx = 0: a 1-D ring)."""
    h, w = uv[0].shape[-2:]
    us, vs = (_shards(a, my, mx, 0, 0) for a in uv)
    fs = [_shards(f, my, mx, sy, sx) for f in fields]
    return [[[ring.Shard(us[i][j], vs[i][j], tuple(f[i][j] for f in fs), i * (h // my),
                         j * (w // mx)) for j in range(mx)] for i in range(my)]]


def _schedule_equals_plain(rings, n, s, h, w):
    got = ring.ring_schedule_plain(rings, n, s, h, w)
    want = ring.ring_solve_plain(rings, n, s, h, w)
    for g_row, w_row in zip(got[0], want[0]):
        for g, r in zip(g_row, w_row):
            assert torch.equal(g[0], r[0]) and torch.equal(g[1], r[1])


@pytest.mark.parametrize("n,s", [(12, 4), (13, 8), (7, 16), (16, 8)])
def test_one_ring_matches_reference_logic_twin(n, s, record_property):
    # The reference's own case (tests/unit/test_rdma_logic_twin.py): 64 x
    # 96 from zero, fields with a sigma-row wrapped halo, sigma = s rounded
    # up to 8 (the TPU's sublanes), the same owned rows.
    h, w = 64, 96
    rng = np.random.default_rng(0)
    i1, i2 = (rng.uniform(0, 1, (h, w)).astype(np.float32) for _ in range(2))
    ex, ey, et = ref_st.derivatives(jnp.asarray(i1), jnp.asarray(i2))
    ivd = 1.0 / (0.25 + ex * ex + ey * ey)
    sigma = ((min(s, n) + 7) // 8) * 8
    ext = [jnp.concatenate([a[-sigma:], a, a[:sigma]], axis=0) for a in (ex, ey, et, ivd)]
    z = jnp.zeros((h, w), jnp.float32)
    want = ring_fused_sweeps_logic_twin(z, z, *ext, n, s, 0, h, w)
    zt = torch.zeros(h, w)
    got = ring.ring_fused_sweeps([zt], [zt.clone()], [tuple(torch.from_numpy(np.array(a))
                                                           for a in ext)], n, s, [0], h, w)
    d = max(float(np.abs(got[k][0].numpy() - np.asarray(want[k])).max()) for k in (0, 1))
    record_property("max_abs_diff", d)
    assert d <= TWIN_TOL


@pytest.mark.parametrize("s", [17, 34])
def test_plain_ring_takes_blocks_deeper_than_the_kernels(s, record_property):
    # The reference takes any block depth its halo allows, and so does the
    # plain version that CPU shards run: against the reference's logic twin
    # on its own case, and tiled == untiled on a 2-shard ring. On the card
    # K11/K12 take them too, as passes of K2's walk; only a block deeper
    # than the fields' halo is refused, as the reference refuses it.
    h, w, n = 64, 96, s + 3  # a block of s, then one of 3
    rng = np.random.default_rng(1)
    i1, i2 = (rng.uniform(0, 1, (h, w)).astype(np.float32) for _ in range(2))
    ex, ey, et = ref_st.derivatives(jnp.asarray(i1), jnp.asarray(i2))
    ivd = 1.0 / (0.25 + ex * ex + ey * ey)
    sigma = ((s + 7) // 8) * 8
    ext = [jnp.concatenate([a[-sigma:], a, a[:sigma]], axis=0) for a in (ex, ey, et, ivd)]
    z = jnp.zeros((h, w), jnp.float32)
    want = ring_fused_sweeps_logic_twin(z, z, *ext, n, s, 0, h, w)
    zt = torch.zeros(h, w)
    got = ring.ring_fused_sweeps([zt], [zt.clone()], [tuple(torch.from_numpy(np.array(a))
                                                           for a in ext)], n, s, [0], h, w)
    d = max(float(np.abs(got[k][0].numpy() - np.asarray(want[k])).max()) for k in (0, 1))
    record_property("max_abs_diff", d)
    assert d <= TWIN_TOL

    uv, fields = _problem((80, 37), 40 + s)
    us, vs = (_shards(a, 2, 1, 0, 0) for a in uv)
    fs = [_shards(f, 2, 1, s, 0) for f in fields]
    got = ring.ring_fused_sweeps([r[0] for r in us], [r[0] for r in vs],
                                 [tuple(f[i][0] for f in fs) for i in range(2)],
                                 n, s, [0, 40], 80, 37)
    want = _untiled(uv, fields, n)
    assert torch.equal(torch.cat(got[0]), want[0]) and torch.equal(torch.cat(got[1]), want[1])
    assert ring._block_sweeps(n, s, sigma, 0) == s
    with pytest.raises(ValueError, match="narrower than a block"):
        ring._block_sweeps(sigma + 1, sigma + 1, sigma, 0)


@pytest.mark.parametrize("my", [1, 2, 4, 5])
@pytest.mark.parametrize("n,s", [(7, 4), (12, 4), (13, 8), (9, 1)])
def test_1d_ring_equals_untiled(my, n, s):
    h, w, sy = 60, 37, 8
    uv, fields = _problem((h, w), 20 + my)
    us, vs = (_shards(a, my, 1, 0, 0) for a in uv)
    fs = [_shards(f, my, 1, sy, 0) for f in fields]
    got = ring.ring_fused_sweeps([r[0] for r in us], [r[0] for r in vs],
                                 [tuple(f[i][0] for f in fs) for i in range(my)],
                                 n, s, [i * (h // my) for i in range(my)], h, w)
    want = _untiled(uv, fields, n)
    assert torch.equal(torch.cat(got[0]), want[0]) and torch.equal(torch.cat(got[1]), want[1])
    _schedule_equals_plain(_rings(uv, fields, my, 1, sy, 0), n, s, h, w)


@pytest.mark.parametrize("my,mx", [(1, 1), (2, 2), (1, 4), (4, 1), (3, 2)])
@pytest.mark.parametrize("n,s", [(7, 4), (13, 8)])
def test_2d_ring_equals_untiled(my, mx, n, s):
    h, w, sg = 48, 60, 8
    uv, fields = _problem((2, h, w), 30 + my * mx)  # a stack: one ring an image
    us, vs = (_shards(a, my, mx, 0, 0) for a in uv)
    fs = [_shards(f, my, mx, sg, sg) for f in fields]
    grid_f = [[tuple(f[i][j] for f in fs) for j in range(mx)] for i in range(my)]
    origins = [[(i * (h // my), j * (w // mx)) for j in range(mx)] for i in range(my)]
    gu, gv = ring.ring_fused_sweeps_2d(us, vs, grid_f, n, s, origins, h, w)
    want = _untiled(uv, fields, n)
    for got, ref in ((gu, want[0]), (gv, want[1])):
        assert torch.equal(torch.cat([torch.cat(row, dim=-1) for row in got], dim=-2), ref)
    _schedule_equals_plain(_rings(uv, fields, my, mx, sg, sg), n, s, h, w)


# Meshes of K11's and K12's schedule: (my, 0) is a 1-D ring of my shards.
RING_MESHES = [(1, 0), (2, 0), (4, 0), (5, 0), (1, 1), (2, 2), (1, 4), (4, 1), (3, 2)]


@pytest.mark.parametrize("s", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("my,mx", RING_MESHES)
def test_schedule_equals_plain_at_every_block_depth(my, mx, s):
    # Two K2 tile rows a shard, the second one cut short (owned heights
    # that K2's tile rows do not divide), a halo exactly s deep (a sweep
    # block exhausts it), n = 2s + 1 (three blocks, the last one short),
    # and the true image ending inside the last shards.
    th = (k2.K2_WINDOW_H - 2 * s) + 7
    tw = 37 if mx == 0 else s + 21
    uv, fields = _problem((my * th, max(mx, 1) * tw), 50 + s)
    rings = _rings(uv, fields, my, max(mx, 1), s, s if mx else 0)
    _schedule_equals_plain(rings, 2 * s + 1, s, my * th - 2, max(mx, 1) * tw - 3)


@pytest.mark.parametrize("s", [17, 20, 32, 33])
@pytest.mark.parametrize("my,mx", [(2, 0), (4, 0), (2, 2), (3, 2)])
def test_schedule_equals_plain_at_deep_blocks(my, mx, s):
    # Blocks deeper than one pass of K2's walk: shards taller and wider than
    # the halo of exactly s, n = 2s + s // 2 + 1 (two full blocks, then a
    # remainder of 9-17 sweeps: one pass, or two at s 32 and 33), and the
    # true image ending inside the last shards.
    th = s + 7
    tw = 37 if mx == 0 else s + 9
    uv, fields = _problem((my * th, max(mx, 1) * tw), 90 + s)
    rings = _rings(uv, fields, my, max(mx, 1), s, s if mx else 0)
    _schedule_equals_plain(rings, 2 * s + s // 2 + 1, s, my * th - 2, max(mx, 1) * tw - 3)


def test_ring_passes_and_barriers():
    # The fewest passes of at most 16 sweeps; all but the first a multiple
    # of 4 (the grown rectangles keep the columns' 16-byte alignment).
    for s in range(1, 300):
        p = ring.ring_passes(s)
        assert sum(p) == s and len(p) == -(-s // 16) and 1 <= p[0] <= 16
        assert all(q == p[-1] and q % 4 == 0 and q <= 16 for q in p[1:])
    assert ring.ring_passes(16) == [16] and ring.ring_passes(17) == [9, 8]
    assert ring.ring_passes(20) == [8, 12] and ring.ring_passes(33) == [9, 12, 12]
    assert ring.ring_passes(100) == [4] + [16] * 6
    # K11: a barrier after each pass but the last; K12: and after each
    # exchange. At s <= 16 that is the one-pass kernel's count.
    assert ring.ring_barriers(100, 4, False) == 24 and ring.ring_barriers(100, 4, True) == 49
    assert ring.ring_barriers(100, 100, False) == 6 and ring.ring_barriers(100, 100, True) == 7
    assert ring.ring_barriers(100, 32, False) == 3 * 2 + 1 - 1  # 32, 32, 32 and 4
    # The grid: the most tiles of any pass. At s 4, K2's 40 x 120 tiles of
    # config 5's 4 x 540x3840; at s 20, 8 + 12 sweeps: the first pass's 32 x
    # 112 tiles over the 40 x 40 rectangle grown by 12, 64 x 64 (2 tiles),
    # then 24 x 104 tiles over 40 x 40 (2 tiles).
    assert ring.ring_tiles(4, 540, 3840, False, 100, 4) == 4 * 14 * 32
    assert ring.ring_tiles(1, 40, 40, True, 40, 20) == 2
    assert ring.ring_tiles(1, 90, 40, False, 40, 20) == 4  # 114 / 32; 90 / 24


@pytest.mark.parametrize("my,mx", [(4, 1), (2, 2)])
def test_tiled_rdma_deep_blocks_on_cpu_shards_equal_untiled(my, mx):
    # halo_sweeps 20 (blocks of 20, 20, 5) on CPU shards of 24 x 100 and
    # 48 x 50: the ring's plain version, = the untiled solve bitwise.
    rng = np.random.default_rng(95)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 1, (96, 100)).astype(np.float32))
              for _ in range(2))
    cfg = HSConfig(alpha=0.5, iters=45)
    mesh = make_mesh(MeshConfig(y=my, x=mx), ["cpu"] * (my * mx))
    got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=20, halo_impl="rdma")
    want = hs_solve(i1, i2, cfg)
    assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)


@pytest.mark.parametrize("s", [3, 4])
@pytest.mark.parametrize("dy,dx", [(0, 0), (1, 1), (2, 3), (3, 2), (4, 4)])
def test_schedule_true_edges_at_warp_and_lane_boundaries(s, dy, dx):
    # A 2 x 2 mesh of a (2, 70, 150) stack whose true image ends dy rows and
    # dx columns before the shards do: the bottom edge at a warp's last row
    # and inside a warp's rows, the right edge at a lane's last column and
    # inside a lane; the top and left edges sit at window row s and column
    # lh, a warp's first row for s = 3 and inside one for s = 4.
    uv, fields = _problem((2, 70, 150), 60 + dy)
    _schedule_equals_plain(_rings(uv, fields, 2, 2, s, s), 3 * s - 1, s, 70 - dy, 150 - dx)


def test_schedule_of_several_wide_tiles():
    # A 1 x 1 mesh over 3 x 3 K2 tiles at s = 4 (40 x 120 each, the last
    # cut short) and a 1-D ring of two shards, each three tiles wide.
    uv, fields = _problem((100, 300), 70)
    _schedule_equals_plain(_rings(uv, fields, 1, 1, 4, 4), 9, 4, 100, 300)
    _schedule_equals_plain(_rings(uv, fields, 2, 1, 4, 0), 9, 4, 100, 300)
    # A sweep block writes the owned rectangle and nothing else: never a
    # halo row or column, which a neighbour may be storing into.
    ext = [_wrap(a, 4, 5) for a in (*uv, *fields)]
    u, v = k2.k2_launch_schedule_plain(*ext, 4, origins=[(-4, -5)], img_hw=(100, 300),
                                       owned=(4, 5))
    inside = torch.zeros(108, 310, dtype=torch.bool)
    inside[4:104, 5:305] = True
    for a in (u, v):
        assert bool(torch.isfinite(a[inside]).all()) and bool(torch.isnan(a[~inside]).all())


def test_ring_solve_of_several_rings_equals_each_alone():
    # The tiled solver hands every batch group's ring to one call.
    h, w = 40, 30
    rings, alone = [], []
    for k in range(3):
        uv, fields = _problem((h, w), 40 + k)
        us, vs = (_shards(a, 2, 1, 0, 0) for a in uv)
        fs = [_shards(f, 2, 1, 4, 0) for f in fields]
        rings.append([[ring.Shard(us[i][0], vs[i][0], tuple(f[i][0] for f in fs), i * 20)]
                      for i in range(2)])
        alone.append(_untiled(uv, fields, 9))
    res = ring.ring_solve(rings, 9, 4, h, w)
    for r, (u, v) in zip(res, alone):
        assert torch.equal(torch.cat([r[0][0][0], r[1][0][0]]), u)
        assert torch.equal(torch.cat([r[0][0][1], r[1][0][1]]), v)


@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("halo", [1, 5, 12])
def test_halo_exchange_plain_matches_wrapped_concatenation(n_shards, halo):
    rng = np.random.default_rng(n_shards)
    tiles = [rng.normal(0, 1, (12, 17)).astype(np.float32) for _ in range(n_shards)]
    got = ring.ring_halo_exchange([torch.from_numpy(t) for t in tiles], halo)
    for i, g in enumerate(got):
        up, dn = tiles[(i - 1) % n_shards], tiles[(i + 1) % n_shards]
        want = jnp.concatenate([jnp.asarray(up)[-halo:], jnp.asarray(tiles[i]),
                                jnp.asarray(dn)[:halo]], axis=0)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_ring_errors():
    t = torch.zeros(8, 12)
    with pytest.raises(ValueError, match="exceeds tile height"):
        ring.ring_halo_exchange([t, t], 9)
    with pytest.raises(ValueError, match="halo must be >= 1"):
        ring.ring_halo_exchange([t], 0)
    with pytest.raises(ValueError, match="differ in shape"):
        ring.ring_halo_exchange([t, torch.zeros(8, 13)], 2)
    f = tuple(torch.zeros(12, 12) for _ in range(4))  # a 2-row halo
    with pytest.raises(ValueError, match="narrower than a block"):
        ring.ring_fused_sweeps([t], [t], [f], 8, 4, [0], 8, 12)
    f2 = tuple(torch.zeros(12, 16) for _ in range(4))
    with pytest.raises(ValueError, match="row halo only"):
        ring.ring_fused_sweeps([t], [t], [f2], 2, 2, [0], 8, 12)
    with pytest.raises(ValueError, match="column halo too"):
        ring.ring_fused_sweeps_2d([[t]], [[t]], [[f]], 2, 2, [[(0, 0)]], 8, 12)
    # A sweep block takes any depth the fields' halo allows, on the card as
    # passes of at most K2's 16 sweeps; a block deeper than the halo (rows,
    # or columns on a 2-D mesh) is refused.
    assert ring.RING_PASS_SWEEPS == k2.K2_MAX_SWEEPS == 16
    assert ring._block_sweeps(40, 16, 16, 16) == 16
    assert ring._block_sweeps(40, 17, 17, 0) == 17 == ring._block_sweeps(17, 40, 17, 17)
    with pytest.raises(ValueError, match="narrower than a block"):
        ring._block_sweeps(40, 18, 17, 0)
    with pytest.raises(ValueError, match="narrower than a block"):
        ring._block_sweeps(40, 17, 17, 16)


def test_device_stacks_are_views_of_consecutive_shards():
    # The tiled solver hands a device's fields as consecutive slices of one
    # stack: the kernel takes that stack as it is; anything else is copied.
    base = torch.arange(4 * 6 * 5, dtype=torch.float32).reshape(4, 6, 5)
    parts = [base.reshape(2, 2, 6, 5)[k] for k in range(2)]
    got = ring._stacked(parts, (6, 5))
    assert got.data_ptr() == base.data_ptr() and torch.equal(got, base)
    swapped = ring._stacked(parts[::-1], (6, 5))
    assert swapped.data_ptr() != base.data_ptr()
    assert torch.equal(swapped, torch.cat([base[2:], base[:2]]))
    one = base[1]
    assert ring._stacked([one], (6, 5)).data_ptr() == one.data_ptr()


def test_unreachable_peer_raises(monkeypatch):
    # Two cards that cannot reach each other refuse the ring kernels; the
    # C helper's error comes back as RuntimeError, never as a fallback.
    class Lib:
        @staticmethod
        def hs_enable_peer(device, peer):
            return 217  # cudaErrorPeerAccessUnsupported

        @staticmethod
        def hs_error_string(err):
            return b"peer access is not supported between these two devices"

    monkeypatch.setattr(ring._build, "library", lambda: Lib)
    monkeypatch.setattr(ring, "_PEERS", set())
    with pytest.raises(RuntimeError, match="cannot store into cuda:1"):
        ring.enable_peer(0, 1)
    ring.enable_peer(0, 0)  # a card and itself need no peer access
