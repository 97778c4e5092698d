"""Hand-written Hopper kernels (CUDA C++ in ../csrc) with their wrappers.

  derivatives.py     K1 hs_derivatives: Ex, Ey, Et, 1/den (+ zero-start sweep)
  jacobi.py          K2 hs_jacobi_sweeps: temporally blocked Jacobi sweeps
  solve_resident.py  the whole-solve driver: K1, then a chain of K2 launches
  _build.py          nvcc build at first use, ctypes binding

Importing these modules builds nothing: the library is built and loaded at
the first launch on a CUDA tensor.
"""
