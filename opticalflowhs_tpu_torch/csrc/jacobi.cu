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
//
// K9 hs_tile_sweeps is the same kernel on the shards of the tiled solver
// (opticalflowhs_tpu_torch/dist/): it replaces the TPU kernel _tile_kernel
// of opticalflowhs_tpu/kernels/jacobi.py (line 855, called by tile_sweeps at
// line 920). Each image of the stack is a halo-padded shard whose element
// (0, 0) is the global pixel org[2k], org[2k+1] of an img_h x img_w image
// (the origin may be negative, and each slice has its own); the clamps fire
// at the true image edges from those global coordinates and at the shard's
// own edges, where the plain version's shifts clamp. One launch covers every
// shard of a device. Bound as K2: 8 arrays of the padded stack a launch.

#include <cuda_runtime.h>

#include "jacobi_tile.cuh"

namespace {

constexpr int kMaxBatch = 65535;  // gridDim.z limit

// kShard: the images are K9's shards, each at its own global origin (org);
// otherwise whole images, and K2's loop is the one K6 and K7 run.
template <bool kShard>
__global__ void jacobi_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ ex, const float* __restrict__ ey,
    const float* __restrict__ et, const float* __restrict__ invd,
    float* __restrict__ uo, float* __restrict__ vo, const int* __restrict__ org,
    int h, int w, int img_h, int img_w, int sweeps, int tile_h, int tile_w) {
  extern __shared__ float smem[];
  // Move every array to image blockIdx.z; below, all indices are per image.
  const long long img = (long long)blockIdx.z * h * w;
  u += img;
  v += img;
  uo += img;
  vo += img;
  // Global origin of this image's element (0, 0): zero for whole images.
  const int org_r = kShard ? org[2 * blockIdx.z] : 0;
  const int org_c = kShard ? org[2 * blockIdx.z + 1] : 0;
  const hs_tile::Window win = hs_tile::make_window_at(
      blockIdx.y * tile_h, blockIdx.x * tile_w, tile_h, tile_w, sweeps, h, w,
      org_r, org_c, img_h, img_w);
  hs_tile::Buffers b = hs_tile::carve(smem, win);
  hs_tile::stage(b, win, ex + img, ey + img, et + img, invd + img, w,
                 [&](int, int, long long g, float& uu, float& vv) {
                   uu = u[g];
                   vv = v[g];
                 });
  __syncthreads();
  hs_tile::run_sweeps<kShard>(b, win, h, w, sweeps);
  // su/sv now hold the last sweep; write back the owned tile only.
  hs_tile::write_tile(uo, vo, b, win, tile_h, tile_w, w);
}

int launch(const float* u, const float* v, const float* ex, const float* ey,
           const float* et, const float* invd, float* uo, float* vo,
           const int* org, int b, int h, int w, int img_h, int img_w,
           int sweeps, int tile_h, int tile_w, int threads, int device,
           void* stream) {
  if (b < 1 || b > kMaxBatch) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = org != nullptr ? jacobi_kernel<true> : jacobi_kernel<false>;
  const size_t smem = hs_tile::smem_bytes(tile_h, tile_w, sweeps);
  if (smem > 48 * 1024) {
    // Above 48 KB, dynamic shared memory must be opted into per kernel.
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, b);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      u, v, ex, ey, et, invd, uo, vo, org, h, w, img_h, img_w, sweeps, tile_h,
      tile_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_jacobi_sweeps(const float* u, const float* v,
                                const float* ex, const float* ey,
                                const float* et, const float* invd, float* uo,
                                float* vo, int b, int h, int w,
                                int sweeps, int tile_h, int tile_w,
                                int threads, int device, void* stream) {
  return launch(u, v, ex, ey, et, invd, uo, vo, nullptr, b, h, w, h, w, sweeps,
                tile_h, tile_w, threads, device, stream);
}

// K9: b halo-padded h x w shards; org holds 2b ints on the device, the
// global (row, column) of each shard's element (0, 0) in the img_h x img_w
// image.
extern "C" int hs_tile_sweeps(const float* u, const float* v, const float* ex,
                              const float* ey, const float* et,
                              const float* invd, float* uo, float* vo,
                              const int* org, int b, int h, int w, int img_h,
                              int img_w, int sweeps, int tile_h, int tile_w,
                              int threads, int device, void* stream) {
  if (org == nullptr) return (int)cudaErrorInvalidValue;
  return launch(u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w,
                sweeps, tile_h, tile_w, threads, device, stream);
}
