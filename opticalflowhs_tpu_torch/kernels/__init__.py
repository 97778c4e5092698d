"""Hand-written Hopper kernels (CUDA C++ in ../csrc) with their wrappers.

  derivatives.py     K1 hs_derivatives: Ex, Ey, Et, 1/den (+ zero-start sweep)
  jacobi.py          K2 hs_jacobi_sweeps: temporally blocked Jacobi sweeps
                     (persistent 48 x 128 windows, fields in registers)
  sor.py             K3 hs_sor_sweeps: temporally blocked 4-color SOR sweeps
                     (persistent 48 x 128 windows, u, v and fields in
                     registers, two barriers a sweep)
  solve_robust.py    K4 hs_robust_freeze/_sweeps: the IRLS solve
  solve_resident.py  the whole-solve drivers: K1, then a chain of K2 or K3
  tvl1_inner.py      K5 hs_tvl1_inner: the TV-L1 inner loop (u- and p-steps)
  solve_fused.py     K6 hs_solve_fused_sweeps: all n Jacobi sweeps in one
                     persistent cooperative launch (u/v ping-pong)
  solve_skewed.py    K7 hs_solve_skewed_sweeps: the same with u and v in
                     place, time-skewed over row bands
  sor_planes.py      K8 hs_sor_planes: the whole 4-color SOR solve in one
                     persistent cooperative launch on K3's window walk (the
                     reference's parity planes kept as its plain schedule);
                     not routed, as in the reference
  tile.py            K9 hs_tile_sweeps / hs_sor_tile_sweeps: K2's and K3's
                     sweeps on halo-padded shards keyed to a global origin
                     (the tiled solver, dist/)
  ring.py            K10 hs_ring_halo_exchange, K11/K12 hs_ring_fused_sweeps:
                     the ring exchange, and the whole solve of a mesh of
                     shards with the halo exchange inside one launch a device
  autodiff.py        the autograd scheme of K1-K8 and the whole-solve
                     drivers: the kernel forward, the plain twin's VJP
                     backward (the reference's custom_vjp)
  _build.py          nvcc build at first use, ctypes binding

Importing these modules builds nothing: the library is built and loaded at
the first launch on a CUDA tensor.
"""

from opticalflowhs_tpu_torch.kernels.jacobi import jacobi_sweeps
from opticalflowhs_tpu_torch.kernels.solve_fused import (
    hs_solve_fused,
    hs_solve_fused_batched,
)
from opticalflowhs_tpu_torch.kernels.solve_skewed import (
    hs_solve_skewed,
    hs_solve_skewed_batched,
)
from opticalflowhs_tpu_torch.kernels.sor_planes import hs_solve_sor_planes


def counted_wrappers() -> dict:
    """Every kernel wrapper that counts its launches in `.launches` (K1-K12),
    by kernel name: the wrappers add one where they launch, and nowhere
    else."""
    from opticalflowhs_tpu_torch.kernels import (
        derivatives,
        jacobi,
        ring,
        solve_fused,
        solve_robust,
        solve_skewed,
        sor,
        sor_planes,
        tile,
        tvl1_inner,
    )
    return {"K1 hs_derivatives": derivatives.hs_derivatives,
            "K2 hs_jacobi_sweeps": jacobi.jacobi_sweeps,
            "K3 hs_sor_sweeps": sor.sor_sweeps,
            "K4 hs_robust_freeze": solve_robust.freeze_weights,
            "K4 hs_robust_sweeps": solve_robust.frozen_sweeps,
            "K5 hs_tvl1_inner": tvl1_inner.tvl1_inner,
            "K6 hs_solve_fused": solve_fused.hs_solve_fused,
            "K7 hs_solve_skewed": solve_skewed.hs_solve_skewed,
            "K8 hs_sor_planes": sor_planes.sor_planes,
            "K9 hs_tile_sweeps": tile.tile_sweeps,
            "K9 hs_sor_tile_sweeps": tile.sor_tile_sweeps,
            "K10 hs_ring_halo_exchange": ring.ring_halo_exchange,
            "K11 hs_ring_fused_sweeps": ring.ring_fused_sweeps,
            "K12 hs_ring_fused_sweeps_2d": ring.ring_fused_sweeps_2d}


__all__ = [
    "counted_wrappers",
    "hs_solve_fused",
    "hs_solve_fused_batched",
    "hs_solve_skewed",
    "hs_solve_skewed_batched",
    "hs_solve_sor_planes",
    "jacobi_sweeps",
]
