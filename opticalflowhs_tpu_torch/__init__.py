"""opticalflowhs_tpu_torch — Horn-Schunck dense optical flow in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch port of `opticalflowhs_tpu` (the JAX package, which stays the
reference). It imports torch and numpy and never JAX. Module names mirror
the reference's:

  config        HSConfig, PyramidConfig, from_reference
  ops/          plain PyTorch stencils (the versions the kernels are held to)
  kernels/      K1 derivatives and K2 Jacobi sweeps (CUDA C++ in csrc/),
                the whole-solve driver, the nvcc build
  solver        Flow, hs_solve, solve_level, precompute, sweeps
  pyramid       hs_pyramid, downsample, flow upsampling, warps
  data/, io/, metrics   synthetic pairs, .flo files, EPE

Frames are (H, W) float32 tensors; the solve runs on their device.
"""

from opticalflowhs_tpu_torch.config import HSConfig, PyramidConfig, from_reference
from opticalflowhs_tpu_torch.pyramid import hs_pyramid
from opticalflowhs_tpu_torch.solver import Flow, hs_solve

__version__ = "0.1.0"

__all__ = [
    "HSConfig",
    "PyramidConfig",
    "Flow",
    "from_reference",
    "hs_solve",
    "hs_pyramid",
    "__version__",
]
