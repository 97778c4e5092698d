"""opticalflowhs_tpu_torch — Horn-Schunck, Lucas-Kanade and TV-L1 dense
optical flow in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch port of `opticalflowhs_tpu` (the JAX package, which stays the
reference). It imports torch and numpy and never JAX. Module names mirror
the reference's:

  config        HSConfig, PyramidConfig, LKConfig, TVL1Config, MeshConfig,
                RunConfig, load_config, config_hash, from_reference
  ops/          plain PyTorch stencils (the versions the kernels are held to)
  kernels/      K1 derivatives, K2 Jacobi sweeps, K3 4-color SOR sweeps,
                K4 IRLS freeze and sweeps, K5 the TV-L1 inner loop, K6 and
                K7 the whole Jacobi solve in one sweep launch, K8 the whole
                SOR solve on parity planes, K9 the tiled solver's shard
                sweeps, K10-K12 the ring exchange and fused ring solves
                (CUDA C++ in csrc/), the whole-solve drivers, the nvcc
                build
  lucas_kanade  lk_solve, lk_solve_batched (dense pyramidal Lucas-Kanade,
                the second family; plain torch, no kernel, as the reference)
  tvl1          tvl1_solve, tvl1_solve_batched (TV-L1, the third family)
  solver        Flow, hs_solve, solve_level, precompute, sweeps,
                sweeps_until (solve to tolerance), tune_omega (SOR)
  checkpoint    hs_solve_checkpointed: chunked solve, save and resume
  robust        the plain Charbonnier IRLS solver (solver="robust")
  multigrid     V-cycles with 4-color Gauss-Seidel smoothing
                (solver="multigrid"; iters counts cycles)
  pyramid       hs_pyramid, downsample, flow upsampling, warps
  batch         hs_solve_batched on (B, H, W) stacks, the batched pyramid
  consistency   forward-backward test, flow_with_occlusion
  video         flow_stream, flow_stream_warm, flow_stream_occlusion,
                flow_video (prefetched windows)
  egomotion     estimate_egomotion: the 4-parameter rigid+zoom fit to a
                flow, with its focus of expansion
  dist/         make_mesh (meshes of devices in one process, virtual ones
                included), halo_pad, hs_solve_tiled, hs_pyramid_tiled
  data/, io/, metrics   synthetic pairs, .flo files, EPE, hs_energy

Frames are (H, W) float32 tensors, or (B, H, W) stacks, and the solve runs
on their device. numpy inputs go to the entry point's `device` keyword,
cuda:0 by default; without a CUDA device that default raises, so the CPU
runs only when asked for (`device="cpu"`, or CPU tensors).
"""

from opticalflowhs_tpu_torch.batch import hs_solve_batched
from opticalflowhs_tpu_torch.checkpoint import hs_solve_checkpointed
from opticalflowhs_tpu_torch.config import (
    HSConfig,
    LKConfig,
    MeshConfig,
    PyramidConfig,
    RunConfig,
    TVL1Config,
    from_reference,
)
from opticalflowhs_tpu_torch.consistency import flow_with_occlusion
from opticalflowhs_tpu_torch.lucas_kanade import lk_solve, lk_solve_batched
from opticalflowhs_tpu_torch.pyramid import hs_pyramid
from opticalflowhs_tpu_torch.solver import Flow, hs_solve
from opticalflowhs_tpu_torch.tvl1 import tvl1_solve, tvl1_solve_batched
from opticalflowhs_tpu_torch.video import flow_stream, flow_stream_warm, flow_video

__version__ = "0.1.0"

__all__ = [
    "HSConfig",
    "LKConfig",
    "MeshConfig",
    "PyramidConfig",
    "RunConfig",
    "TVL1Config",
    "Flow",
    "from_reference",
    "hs_solve",
    "hs_pyramid",
    "hs_solve_batched",
    "hs_solve_checkpointed",
    "lk_solve",
    "lk_solve_batched",
    "tvl1_solve",
    "tvl1_solve_batched",
    "flow_stream",
    "flow_stream_warm",
    "flow_video",
    "flow_with_occlusion",
    "__version__",
]
