"""Plain PyTorch stencil ops: the versions the CUDA kernels are held against."""
