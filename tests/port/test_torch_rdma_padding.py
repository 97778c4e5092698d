"""halo_impl="rdma" pads a frame as the reference's rdma route pads it
(dist/tiled_solver.py `rdma_padded_shape`) on CPU shards, where the ring
kernels run their plain versions.

The reference's rdma raises off the TPU before its tile check
(opticalflowhs_tpu/dist/tiled_solver.py:429-432), so its rule is computed
here from its formula (:442-456): h rounded up to my * 8 and, on a mesh
that splits x, w to mx * 128; the tile must then be deeper and wider than
the halo. The port tries the mesh-grid tile first and pads only a frame
that tile would refuse, so it takes a shape exactly when that rule does,
and a shape it took before keeps its tile.

Bars: against the port's untiled solve, bitwise (the same ops on the same
values; the clamps fire at the true edges, and shards wholly in the pad
compute values no true pixel reads). Against the reference's untiled
hs_solve, 2e-6 (the Jacobi kernel-vs-oracle bar; XLA:CPU may round the last
ulp of a fused chain differently).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowhs_tpu.config import HSConfig as RefHS
from opticalflowhs_tpu.solver import hs_solve as ref_hs_solve
from opticalflowhs_tpu_torch import HSConfig, hs_solve
from opticalflowhs_tpu_torch.batch import hs_solve_batched
from opticalflowhs_tpu_torch.config import MeshConfig
from opticalflowhs_tpu_torch.dist import hs_solve_tiled, make_mesh
from opticalflowhs_tpu_torch.dist.tiled_solver import rdma_padded_shape
from opticalflowhs_tpu_torch.kernels import ring

torch.set_num_threads(1)

SOLVE_TOL = 2e-6


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def reference_takes(h: int, w: int, my: int, mx: int, s: int) -> bool:
    """The reference's rdma tile check (tiled_solver.py:442-456, Jacobi:
    a halo of s)."""
    hp = _up(h, my * 8)
    wp = _up(w, mx * 128) if mx > 1 else _up(w, mx)
    return hp // my > s and wp // mx > s


def mesh_grid_takes(h: int, w: int, my: int, mx: int, s: int) -> bool:
    """The check rdma made before it padded as the reference: the tile of
    the frame rounded up to the mesh grid."""
    return _up(h, my) // my > s and _up(w, mx) // mx > s


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)) for _ in range(2)]


def _equal(got, want):
    assert got.u.shape == want.u.shape and got.u.dtype == want.u.dtype
    assert torch.equal(got.u, want.u) and torch.equal(got.v, want.v)


def _wholly_padded(h, w, my, mx, s) -> bool:
    """Whether some shard of the padded frame owns no true pixel."""
    hp, wp = rdma_padded_shape(h, w, my, mx, s)
    return (hp // my) * (my - 1) >= h or (wp // mx) * (mx - 1) >= w


def test_the_cases_hold_wholly_padded_shards():
    assert [p[:2] for p in PADDED if _wholly_padded(*p)] == [(200, 60), (10, 30), (20, 60)]


# -- which shapes rdma takes -----------------------------------------------------------------

GRID_H = (5, 10, 17, 34, 61)
GRID_W = (9, 40, 60, 130)
GRID_S = (1, 3, 5, 9, 17, 40)
MESHES = [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (3, 2), (2, 4)]


@pytest.mark.parametrize("my,mx", MESHES)
def test_rdma_takes_exactly_the_reference_shapes(my, mx):
    # Every (h, w, s) of the grid on the mesh: taken (and solved) exactly
    # when the reference's rule takes it, refused with its tile otherwise.
    mesh = make_mesh(MeshConfig(y=my, x=mx), ["cpu"] * (my * mx))
    cfg = HSConfig(alpha=0.5, iters=1)
    taken = refused = 0
    for h, w, s in itertools.product(GRID_H, GRID_W, GRID_S):
        i1, i2 = _frames((h, w), h * w + s)
        if reference_takes(h, w, my, mx, s):
            got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=s, halo_impl="rdma")
            assert got.u.shape == (h, w)
            taken += 1
        else:
            hp, wp = rdma_padded_shape(h, w, my, mx, s)
            with pytest.raises(ValueError, match=f"tile {hp // my}x{wp // mx} too small"):
                hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=s, halo_impl="rdma")
            refused += 1
    assert taken and refused


@pytest.mark.parametrize("my,mx", MESHES)
def test_shapes_taken_before_keep_their_tile(my, mx):
    # Where the mesh-grid tile was taken, the padded frame is the mesh grid
    # (the launches and tiles of those shapes do not change); where it was
    # refused, it is the reference's frame.
    for h, w, s in itertools.product(GRID_H, GRID_W, GRID_S):
        got = rdma_padded_shape(h, w, my, mx, s)
        if mesh_grid_takes(h, w, my, mx, s):
            assert got == (_up(h, my), _up(w, mx))
        else:
            assert got == (_up(h, my * 8), _up(w, mx * 128) if mx > 1 else w)
    # Config 5's D3 shards keep theirs; at s 541 they take the reference's.
    assert rdma_padded_shape(2160, 3840, 4, 1, 4) == (2160, 3840)
    assert rdma_padded_shape(2160, 3840, 2, 2, 100) == (2160, 3840)
    assert rdma_padded_shape(2160, 3840, 4, 1, 541) == (2176, 3840)
    assert rdma_padded_shape(2160, 3840, 4, 4, 541) == (2176, 4096)


def test_ppermute_check_is_unchanged():
    # The ppermute route still checks the mesh-grid tile.
    i1, i2 = _frames((10, 30), 3)
    mesh = make_mesh(MeshConfig(y=4, x=1), ["cpu"] * 4)
    with pytest.raises(ValueError, match="tile 3x30 too small"):
        hs_solve_tiled(i1, i2, HSConfig(iters=4), mesh, halo_sweeps=3)


# -- what it computes ------------------------------------------------------------------------

# (h, w, my, mx, s): the two shapes the mesh-grid check refused and the
# reference takes (34 x 40 on 2 x 1 at s 17: 24 x 40 tiles; 200 x 60 on 2 x 2
# at s 40: 104 x 128, the second column of shards wholly right of w), 10 x 30
# on 4 x 1 at s 3 (8-row tiles: shards 2 and 3 wholly below h), and 20 x 60
# on 2 x 2 at s 12 (the second column of shards wholly right of w), 12 x 140
# on 1 x 2 at s 12 (16 x 256: both shards partly true).
PADDED = [(34, 40, 2, 1, 17), (200, 60, 2, 2, 40), (10, 30, 4, 1, 3), (20, 60, 2, 2, 12),
          (12, 140, 1, 2, 12)]


@pytest.mark.parametrize("h,w,my,mx,s", PADDED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stack", [False, True])
def test_padded_rdma_equals_untiled(h, w, my, mx, s, dtype, stack):
    assert reference_takes(h, w, my, mx, s) and not mesh_grid_takes(h, w, my, mx, s)
    shape = (2, h, w) if stack else (h, w)
    i1, i2 = _frames(shape, 7 + s)
    mesh = make_mesh(MeshConfig(y=my, x=mx), ["cpu"] * (my * mx))
    cfg = HSConfig(alpha=0.5, iters=2 * s + 3, dtype=dtype)
    got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=s, halo_impl="rdma")
    _equal(got, (hs_solve_batched if stack else hs_solve)(i1, i2, cfg))


def test_padded_stack_over_batch_groups_equals_untiled():
    # A (4, 10, 30) stack over 2 batch groups of a (2, 4, 1) mesh at s 3.
    i1, i2 = _frames((4, 10, 30), 11)
    mesh = make_mesh(MeshConfig(batch=2, y=4, x=1), ["cpu"] * 8)
    cfg = HSConfig(alpha=0.5, iters=10)
    got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=3, halo_impl="rdma")
    _equal(got, hs_solve_batched(i1, i2, cfg))


@pytest.mark.parametrize("h,w,my,mx,s", [p for p in PADDED if p[4] <= 17])
def test_padded_rdma_through_the_kernels_schedule(h, w, my, mx, s, monkeypatch):
    # The ring's schedule as K11 and K12 walk it (`ring_schedule_plain`:
    # K2's windows over the owned tiles, NaN wherever nothing was written)
    # in place of the plain ring, on padded shards (wholly in the pad at
    # 10 x 30 and 20 x 60): = the untiled solve bitwise, so the kernels'
    # true-edge clamps and the exchange agree with the plain masks there.
    monkeypatch.setattr(ring, "ring_solve_plain", ring.ring_schedule_plain)
    i1, i2 = _frames((h, w), 17 + s)
    mesh = make_mesh(MeshConfig(y=my, x=mx), ["cpu"] * (my * mx))
    cfg = HSConfig(alpha=0.5, iters=2 * s + 3)
    got = hs_solve_tiled(i1, i2, cfg, mesh, halo_sweeps=s, halo_impl="rdma")
    _equal(got, hs_solve(i1, i2, cfg))


def test_padded_rdma_matches_reference(record_property):
    # 10 x 30 on 4 x 1 at s 3 against the reference's untiled solve (its
    # rdma route does not run off the TPU).
    i1, i2 = _frames((10, 30), 21)
    mesh = make_mesh(MeshConfig(y=4, x=1), ["cpu"] * 4)
    got = hs_solve_tiled(i1, i2, HSConfig(alpha=0.5, iters=20), mesh, halo_sweeps=3,
                         halo_impl="rdma")
    want = ref_hs_solve(jnp.asarray(i1.numpy()), jnp.asarray(i2.numpy()),
                        RefHS(alpha=0.5, iters=20, backend="jnp"))
    d = max(float(np.abs(got.u.numpy() - np.asarray(want.u)).max()),
            float(np.abs(got.v.numpy() - np.asarray(want.v)).max()))
    record_property("max_abs_diff", d)
    assert d <= SOLVE_TOL


def test_refusals_under_rdma_are_unchanged():
    # SOR and tol > 0 stay refused under rdma, whatever the padding.
    i1, i2 = _frames((10, 30), 5)
    mesh = make_mesh(MeshConfig(y=4, x=1), ["cpu"] * 4)
    with pytest.raises(ValueError, match="solver='jacobi' only"):
        hs_solve_tiled(i1, i2, HSConfig(solver="sor", omega=1.5), mesh, halo_sweeps=3,
                       halo_impl="rdma")
    with pytest.raises(ValueError, match="ppermute halo path"):
        hs_solve_tiled(i1, i2, HSConfig(tol=1e-3), mesh, halo_sweeps=3, halo_impl="rdma")
