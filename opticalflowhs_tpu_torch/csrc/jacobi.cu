// K2 hs_jacobi_sweeps: `sweeps` Jacobi sweeps of Horn-Schunck per launch,
// temporally blocked in shared memory, over one frame or a (B, H, W) stack.
//
// Replaces these TPU sweep kernels of opticalflowhs_tpu/kernels/:
//   * jacobi.py, single frame: _vmem_kernel (line 184), _banded_kernel
//     (line 241) and _fused_banded_kernel (line 375), all through
//     _kernel_step/_navg (lines 144-178);
//   * jacobi.py, batched: the stacked (B*Hp, Wp) class of _vmem_kernel with
//     img_rows (lines 836-849), and _banded_kernel_b (line 631, called at
//     line 687 on a (B, bands) grid), the batched s-sweep bands that
//     jacobi_sweeps_batched and the tolerance block runner use;
//   * solve_resident.py, stage 2 of _resident_body (lines 257-331), in the
//     single-frame _resident_kernel and in the batched _resident_kernel_b
//     (line 394, called at line 519).
// On the TPU the whole 1080p solve stays in 128 MiB of VMEM; here the 8
// arrays (~67 MB a frame at 1088x1920) exceed the card's shared memory, so
// the solve streams through L2 and device memory once per launch, and each
// launch runs `sweeps` sweeps on chip.
//
// Batch: grid (ceil(w/tile_w), ceil(h/tile_h), B); blockIdx.z is the image,
// and image k starts k*h*w floats into every array (a 64-bit stride). The
// window, halo and clamp bookkeeping below is per image, in the image's own
// coordinates, so no window reads across an image seam. gridDim.z is at
// most 65535, so the entry point refuses larger batches.
//
// Bound: device memory, at 8 arrays read or written per launch (u, v and
// the four fields in, u and v out): 8 x B x h x w x 4 bytes, 66.8 MB x B
// at 1088x1920 float32, or 19.9 us x B at 3.35 TB/s, so the number of
// sweeps per launch sets the bytes per sweep. (One launch at 1088x1920
// measured ~5.7x that bound on an H100, PERF.md: the in-block work, not
// memory, limits it so far.) Each block owns a tile_h x tile_w output tile
// and runs the launch's sweeps on its shared-memory window
// (jacobi_tile.cuh, shared with K6 and K7); only the owned tile is written
// back.

#include <cuda_runtime.h>

#include "jacobi_tile.cuh"

namespace {

constexpr int kMaxBatch = 65535;  // gridDim.z limit

__global__ void jacobi_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ ex, const float* __restrict__ ey,
    const float* __restrict__ et, const float* __restrict__ invd,
    float* __restrict__ uo, float* __restrict__ vo,
    int h, int w, int sweeps, int tile_h, int tile_w) {
  extern __shared__ float smem[];
  // Move every array to image blockIdx.z; below, all indices are per image.
  const long long img = (long long)blockIdx.z * h * w;
  u += img;
  v += img;
  uo += img;
  vo += img;
  const hs_tile::Window win = hs_tile::make_window(
      blockIdx.y * tile_h, blockIdx.x * tile_w, tile_h, tile_w, sweeps, h, w);
  hs_tile::Buffers b = hs_tile::carve(smem, win);
  hs_tile::stage(b, win, ex + img, ey + img, et + img, invd + img, w,
                 [&](int, int, long long g, float& uu, float& vv) {
                   uu = u[g];
                   vv = v[g];
                 });
  __syncthreads();
  hs_tile::run_sweeps(b, win, h, w, sweeps);
  // su/sv now hold the last sweep; write back the owned tile only.
  hs_tile::write_tile(uo, vo, b, win, tile_h, tile_w, w);
}

}  // namespace

extern "C" int hs_jacobi_sweeps(const float* u, const float* v,
                                const float* ex, const float* ey,
                                const float* et, const float* invd, float* uo,
                                float* vo, int b, int h, int w,
                                int sweeps, int tile_h, int tile_w,
                                int threads, int device, void* stream) {
  if (b < 1 || b > kMaxBatch) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = hs_tile::smem_bytes(tile_h, tile_w, sweeps);
  if (smem > 48 * 1024) {
    // Above 48 KB, dynamic shared memory must be opted into per kernel.
    err = cudaFuncSetAttribute(jacobi_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, b);
  jacobi_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      u, v, ex, ey, et, invd, uo, vo, h, w, sweeps, tile_h, tile_w);
  return (int)cudaGetLastError();
}
