"""The ring kernels' plain versions (kernels/ring.py: K10's exchange, K11's
and K12's fused ring solves) on the CPU: against the reference's CPU logic
twin of its fused ring kernel on the 1-shard ring, against plain wrapped
concatenation for the exchange, and on n-shard 1-D and 2-D meshes against
the untiled sweeps (tiled == untiled).

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
    assert ring.max_ring_sweeps() >= 8


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
