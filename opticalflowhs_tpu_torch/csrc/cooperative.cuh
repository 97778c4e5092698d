// Helpers for the persistent cooperative kernels K6 (solve_fused.cu), K7
// (solve_skewed.cu), K8 (sor_planes.cu), K11 and K12 (ring.cu): how many
// blocks can be resident at once, the launch, and their grid barrier. A
// grid-wide barrier is only safe when every block of the grid is resident;
// cudaLaunchCooperativeKernel refuses a larger grid
// (cudaErrorCooperativeLaunchTooLarge), and the entry points return that
// error instead of deadlocking. The barrier needs no relocatable device
// code (-rdc), so the build flags stay those of every other kernel.

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

// A barrier across the whole grid of a cooperative launch. `count` is zero
// at the launch's start (the entry point clears it on the stream) and
// counts the blocks' arrivals; the n-th barrier of the launch (n = 1, 2,
// ...) waits until every block has arrived n times. The count is a kernel
// parameter and n a value the caller holds anyway, so the barrier keeps
// nothing in registers across the code around it: K6, K7, K11 and K12 run
// K2's sweeps, which need all 128 registers a thread, and
// cooperative_groups' grid sync, which keeps its workspace live through the
// whole kernel, made them spill and run each tile slower on an H100. The block's
// writes, ordered before thread 0's by the first __syncthreads, are
// released by its fence and arrival, and acquired by every block after
// the wait.
__device__ __forceinline__ void grid_barrier(unsigned long long* count,
                                             unsigned long long n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1ull);
    const unsigned long long target = n * gridDim.x;
    while (*reinterpret_cast<volatile unsigned long long*>(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace hs_coop
