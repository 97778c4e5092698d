// Host helpers for the persistent cooperative kernels K6 (solve_fused.cu) and
// K7 (solve_skewed.cu): how many blocks can be resident at once, and the
// launch. A grid-wide barrier (cooperative_groups::this_grid().sync()) is
// only safe when every block of the grid is resident; cudaLaunchCooperativeKernel
// refuses a larger grid (cudaErrorCooperativeLaunchTooLarge), and the entry
// points return that error instead of deadlocking. Grid sync needs no
// relocatable device code (-rdc) since CUDA 11, so the build flags stay
// those of every other kernel.

#pragma once

#include <cuda_runtime.h>

namespace hs_coop {

// Opts `kernel` into `smem` bytes of dynamic shared memory (needed above
// 48 KB) and writes the most blocks of `threads` threads that can be
// resident on the device at once to *blocks.
template <class Kernel>
cudaError_t max_blocks(Kernel kernel, size_t smem, int threads, int device,
                       int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// One cooperative launch of `grid` blocks; returns the launch's error. A
// refused launch's error is also cleared from the thread's last error, so
// that the next launch on it does not report it again.
template <class Kernel>
cudaError_t launch(Kernel kernel, int grid, int threads, size_t smem,
                   void** args, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(threads), args, smem,
                                    (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace hs_coop
