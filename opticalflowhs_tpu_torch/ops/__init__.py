"""Plain PyTorch stencil ops: the versions the CUDA kernels are held against."""

from opticalflowhs_tpu_torch.ops.stencils import derivatives, jacobi_step, neighbor_avg

__all__ = ["derivatives", "neighbor_avg", "jacobi_step"]
