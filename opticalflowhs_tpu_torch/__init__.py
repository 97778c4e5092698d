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
                included, or across processes after init_multihost: one
                process a card, torch.distributed; `python -m
                opticalflowhs_tpu_torch.dist.multihost`), halo_pad,
                hs_solve_tiled, hs_pyramid_tiled
                (every solver; robust and multigrid by the batch groups
                of gspmd.py), reshard (Sharded arrays, time_to_space,
                space_to_time, timesharded_pairs); mesh= on the batched
                entries, the streams and consistency, tvl1_solve_tiled,
                lk_solve_tiled, and axis_names= on estimate_egomotion and
                hs_energy come with it
  metrics       EPE, angular error, hs_energy
  data/         synthetic pairs with analytic flow; datasets: the
                Middlebury, Sintel and KITTI readers, evaluate
  io/           .flo and KITTI flow files (read_flow, write_flow), PNM and
                PNG frames (images, png16), the native libhsio binding
  viz           the Middlebury color wheel, needle plots
  logging_util  get_logger, log_metrics (JSON lines)
  bench         run_bench, run_scaling_bench: sweep throughput and latency
                against the card's roofline
  cli           the hsflow-torch command: run, video, eval, bench, viz,
                selftest, info (python -m opticalflowhs_tpu_torch.cli)

Frames are (H, W) float32 tensors, or (B, H, W) stacks, and the solve runs
on their device. numpy inputs go to the entry point's `device` keyword,
cuda:0 by default; without a CUDA device that default raises, so the CPU
runs only when asked for (`device="cpu"`, or CPU tensors).

bfloat16 (`HSConfig(dtype="bfloat16")` for every solver,
`TVL1Config(dtype="bfloat16")`, `LKConfig(dtype="bfloat16")`; untiled):
bfloat16 storage, float32 arithmetic. Every array the reference holds in
the config's dtype is a torch.bfloat16 tensor here: the frames after the
cast (made on the device), Ex, Ey, Et and 1/den, u and v after every
sweep, the pyramid's levels, upsampled flows and warped frames, and the
returned Flow. Each value is widened to float32, the arithmetic runs in
float32 in the float32 path's order, and each array result is rounded
once, to nearest even, where it is stored; 1/den is formed from the
rounded Ex and Ey. A 4-color SOR sweep runs its four color stages in
float32, each reading the earlier stages' float32 values, and rounds u
and v once, at the sweep's end; an IRLS freeze rounds wd and ws where it
stores them, and its sweeps form the frozen system in float32 from the
rounded arrays. Where each family stores:
  multigrid  each level's exx, exy, eyy and idet (formed from K1's rounded
             Ex and Ey, a coarser level from the rounded finer one), the
             right-hand side, residuals, restricted residuals, prolonged
             corrections and corrected flows; u and v once a smoother
             sweep, its four color stages in float32, as SOR;
  TV-L1      the rescaled frames (lo, hi and the scale float32), the five
             inner-loop fields, u1 and u2 where the u-step stores them,
             the four duals where the p-step does; rho, the step, v, the
             gradients and the norms are float32; median3 is exact;
  LK         the warped frame, Ex, Ey and Et, each window sum (the
             products float32), the flow after each refinement and each
             blur; the 2x2 solve is float32.
The kernels' bfloat16 builds (K1, K2, K6, K7; K3 and K8; K4's freeze and
sweeps; K5; K9-K12) round their state where it is stored, also inside a
launch, so they equal the plain twins (`ops.stencils.store`) bitwise and
the result does not depend on the sweeps or alternations a launch runs.
On dist/ the frames are cast first, the shards' derivatives and 1/den are
stored as K1 stores them, and the halos carry the stored values, so a
tiled solve equals the untiled one bitwise; the GSPMD routes (robust and
multigrid tiles, tvl1_solve_tiled, lk_solve_tiled, mesh= stacks) run the
untiled entries per batch group, so they take bfloat16 as those do.
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
