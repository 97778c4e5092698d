// K2 hs_jacobi_sweeps: `sweeps` Jacobi sweeps of Horn-Schunck per launch,
// temporally blocked on chip, over one frame or a (B, H, W) stack.
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
// arrays (~67 MB a frame at 1088x1920) exceed the card's on-chip memory, so
// the solve streams through L2 and device memory once per launch, and each
// launch runs `sweeps` sweeps on chip.
//
// Design: K2's window loop (k2_window.cuh), one persistent block of 512
// threads a streaming multiprocessor walking 48 x 128 windows (the tile
// grown by its decaying halo, 32 x 112 at s = 8): warp j owns window rows
// 3j..3j+2, lane l the 4 adjacent columns 4l..4l+3; the fields Ex, Ey, Et
// and invd of a thread's 12 pixels stay in registers (at most the launch
// bound's 128 a thread, no spills; 4 rows a thread at a 64-row window
// spilled and ran slower), shared memory holds only u and v; each column
// sum is computed once and passed to the neighbouring lanes by warp
// shuffles (27 float32 operations a pixel a sweep); interior windows run
// without clamps, their rows rolled in registers; the last sweep writes the
// owned tile from registers. While a block sweeps one tile, cp.async copies
// the next tile's u and v into a third shared u/v pair (16-byte copies
// where w is a multiple of 4 and the arrays are 16-byte aligned, else
// 4-byte): 147,456 bytes of shared memory. The fields are loaded at each
// tile's start (prefetching them into L2 a tile ahead did not pay).
//
// Batch: image k starts k*h*w floats into every array (a 64-bit stride);
// the window, halo and clamp bookkeeping is per image, in the image's own
// coordinates, so no window reads across an image seam. The entry point
// refuses batches beyond 65535, the limit the other kernels' grids keep.
//
// Bound: 8 arrays read or written once per launch (u, v and the four fields
// in, u and v out): 66.8 MB at 1088x1920 float32, 19.9 us at 3.35 TB/s;
// and 27 float32 operations a pixel a sweep, 451 M at s = 8, 13.5 us at the
// 33.5 T/s that unfused operations reach (--fmad=false). The halo adds
// 1.47x the tile's operations at s = 8 (rows shrink with the sweeps, the
// 128 columns do not) and re-reads 1.71x its input bytes, mostly from L2.
// Measured on an H100 at 700 W (PERF.md): 0.0635-0.0664 ms a launch of 8
// sweeps at 1088x1920, 30-31% of the byte bound (the shared-loop design
// before it: 0.1160),
// and 0.4247-0.4255 ms at 8 x 1088x1920, 38%. The sweep arithmetic holds it
// back: with no field loads and no staging (tools/torch_k2_limits.py) a
// launch still takes 0.0537 ms, 12.3 T float32 operations a second counted
// with the halo, 37% of the 33.5 T/s that unfused operations reach; the
// field loads add about 0.008 ms, the staging about 0.003.
//
// K9 hs_tile_sweeps is the same kernel on the shards of the tiled solver
// (opticalflowhs_tpu_torch/dist/): it replaces the TPU kernel _tile_kernel
// of opticalflowhs_tpu/kernels/jacobi.py (line 855, called by tile_sweeps at
// line 920). Each image of the stack is a halo-padded shard whose element
// (0, 0) is the global pixel org[2k], org[2k+1] of an img_h x img_w image
// (the origin may be negative, and each slice has its own); the clamps fire
// at the true image edges from those global coordinates and at the shard's
// own edges, where the plain version's shifts clamp. A true edge inside a
// warp's rows breaks the rolling rows (kShard). One launch covers every
// shard of a device. Bound as K2: 8 arrays of the padded stack a launch.
//
// bfloat16 (hs_jacobi_sweeps_bf16, single frame and stack; K9's
// hs_tile_sweeps_bf16 on shards): the same walk on bfloat16 arrays
// (k2_window.cuh's storage types), the fields widened into the same
// registers, u and v held in shared memory in bfloat16 (three pairs: 73,728
// bytes), each sweep's u and v rounded to nearest even where they are
// stored, the float32 geometry and s. Bound: 8 arrays of 2 bytes, 10.0 us
// at 1088x1920 (K9: 40.5 us at config 5's 16 shards of 548x968); 29
// operations a pixel a sweep with the two roundings.
//
// Exactness: the association order is that of ops/stencils.py
// (neighbor_avg, jacobi_step), the constants are the float32 values of
// 1/12 and 1/3, and the library is built with --fmad=false, so the output
// equals the plain PyTorch sweeps bitwise (in bfloat16, the plain sweeps of
// the storage rule).

#include <cuda_runtime.h>

#include "k2_window.cuh"

namespace {

using namespace hs_k2;

constexpr int kMaxBatch = 65535;
// Shared arrays of one window: three u/v pairs, two swept and one staged
// for the next tile.
constexpr int kPairs = 3;
constexpr size_t kSmemBytes = kPairs * kPairBytes;

// kShard: the images are K9's shards, each at its own global origin (org);
// otherwise whole images (K2).
template <bool kShard>
__global__ void __launch_bounds__(kThreads, 1) jacobi_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  walk_tiles<kShard, false>(smem, a, true);
}

// The bfloat16 build, K2 (kShard false) or K9.
constexpr size_t kSmemBytesBf16 = kPairs * pair_bytes<ArgsBf16>();

template <bool kShard>
__global__ void __launch_bounds__(kThreads, 1) jacobi_kernel_bf16(const ArgsBf16 a) {
  extern __shared__ __align__(16) float smem[];
  walk_tiles<kShard, false>(reinterpret_cast<__nv_bfloat16*>(smem), a, true);
}

// The kernel and shared bytes of a build: K2 (kShard false) or K9, in
// float or bfloat16.
template <class A, bool kShard>
auto build_kernel() {
  if constexpr (kIsFloat<A>)
    return jacobi_kernel<kShard>;
  else
    return jacobi_kernel_bf16<kShard>;
}

template <class A>
constexpr size_t build_smem() {
  return kIsFloat<A> ? kSmemBytes : kSmemBytesBf16;
}

template <class A, bool kShard>
cudaError_t configure(int device, int* grid_max) {
  // Per device: opt into the shared memory above 48 KB, and the number of
  // blocks that can be resident at once (the persistent grid).
  static int cached[64];
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *grid_max = cached[device];
    return cudaSuccess;
  }
  const auto kernel = build_kernel<A, kShard>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)build_smem<A>());
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, build_smem<A>());
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid_max = per_sm * sms;
  if (device >= 0 && device < 64) cached[device] = *grid_max;
  return cudaSuccess;
}

template <class A>
int launch(const typename A::Elem* u, const typename A::Elem* v,
           const typename A::Elem* ex, const typename A::Elem* ey,
           const typename A::Elem* et, const typename A::Elem* invd,
           typename A::Elem* uo, typename A::Elem* vo,
           const int* org, int b, int h, int w, int img_h, int img_w,
           int sweeps, int device, void* stream) {
  if (b < 1 || b > kMaxBatch || h < 1 || w < 1 || sweeps < 1 || sweeps > kMaxSweeps)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid_max = 0;
  err = org != nullptr ? configure<A, true>(device, &grid_max)
                       : configure<A, false>(device, &grid_max);
  if (err != cudaSuccess) return (int)err;
  const Geometry g = geometry(sweeps);
  A a;
  a.u = u; a.v = v; a.ex = ex; a.ey = ey; a.et = et; a.invd = invd;
  a.uo = uo; a.vo = vo; a.org = org;
  a.b = b; a.h = h; a.w = w; a.img_h = img_h; a.img_w = img_w; a.sweeps = sweeps;
  a.tiles_x = (w + g.tw - 1) / g.tw;
  a.tiles_y = (h + g.th - 1) / g.th;
  auto all_aligned = [&](unsigned long long n) {
    return aligned(u, n) && aligned(v, n) && aligned(ex, n) && aligned(ey, n) &&
           aligned(et, n) && aligned(invd, n) && aligned(uo, n) && aligned(vo, n);
  };
  // 16 bytes (4 floats) or 8 (4 bfloat16 values) a lane's load or store; 2:
  // bfloat16 rows also staged 16 bytes at a time (bf16_wide).
  a.vec = w % 4 == 0 && all_aligned(4 * sizeof(typename A::Elem));
  if (!kIsFloat<A> && a.vec && w % 8 == 0 && all_aligned(16)) a.vec = 2;
  const long long tiles = (long long)b * a.tiles_x * a.tiles_y;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < grid_max ? tiles : grid_max);
  const auto kernel = org != nullptr ? build_kernel<A, true>() : build_kernel<A, false>();
  kernel<<<grid, kThreads, build_smem<A>(), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_jacobi_sweeps(const float* u, const float* v,
                                const float* ex, const float* ey,
                                const float* et, const float* invd, float* uo,
                                float* vo, int b, int h, int w, int sweeps,
                                int device, void* stream) {
  return launch<Args>(u, v, ex, ey, et, invd, uo, vo, nullptr, b, h, w, h, w, sweeps,
                      device, stream);
}

// K2's bfloat16 build: the same arguments, every array bfloat16.
extern "C" int hs_jacobi_sweeps_bf16(const __nv_bfloat16* u, const __nv_bfloat16* v,
                                     const __nv_bfloat16* ex, const __nv_bfloat16* ey,
                                     const __nv_bfloat16* et, const __nv_bfloat16* invd,
                                     __nv_bfloat16* uo, __nv_bfloat16* vo, int b, int h,
                                     int w, int sweeps, int device, void* stream) {
  return launch<ArgsBf16>(u, v, ex, ey, et, invd, uo, vo, nullptr, b, h, w, h, w, sweeps,
                          device, stream);
}

// K9: b halo-padded h x w shards; org holds 2b ints on the device, the
// global (row, column) of each shard's element (0, 0) in the img_h x img_w
// image.
extern "C" int hs_tile_sweeps(const float* u, const float* v, const float* ex,
                              const float* ey, const float* et,
                              const float* invd, float* uo, float* vo,
                              const int* org, int b, int h, int w, int img_h,
                              int img_w, int sweeps, int device, void* stream) {
  if (org == nullptr) return (int)cudaErrorInvalidValue;
  return launch<Args>(u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w,
                      sweeps, device, stream);
}

// K9's bfloat16 build: the same arguments, every array bfloat16.
extern "C" int hs_tile_sweeps_bf16(const __nv_bfloat16* u, const __nv_bfloat16* v,
                                   const __nv_bfloat16* ex, const __nv_bfloat16* ey,
                                   const __nv_bfloat16* et, const __nv_bfloat16* invd,
                                   __nv_bfloat16* uo, __nv_bfloat16* vo, const int* org,
                                   int b, int h, int w, int img_h, int img_w, int sweeps,
                                   int device, void* stream) {
  if (org == nullptr) return (int)cudaErrorInvalidValue;
  return launch<ArgsBf16>(u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w,
                          sweeps, device, stream);
}

namespace {

template <class A, bool kShard>
int geometry_of(int sweeps, int device, int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid_max = 0;
  err = configure<A, kShard>(device, &grid_max);
  if (err != cudaSuccess) return (int)err;
  return (int)report(build_kernel<A, kShard>(), build_smem<A>(), sweeps, device, grid_max,
                     out);
}

}  // namespace

// K2's geometry at `sweeps` on `device` (K9's with `shard` nonzero), into
// out[0..7]: tile rows, tile columns, threads a block, shared bytes a
// block, registers a thread, local (spilled) bytes a thread, blocks
// resident on one multiprocessor, and the number of multiprocessors.
extern "C" int hs_jacobi_geometry(int sweeps, int shard, int device, int* out) {
  return shard ? geometry_of<Args, true>(sweeps, device, out)
               : geometry_of<Args, false>(sweeps, device, out);
}

// The bfloat16 builds' geometry (K9's with `shard` nonzero), as
// hs_jacobi_geometry reports the float ones.
extern "C" int hs_jacobi_geometry_bf16(int sweeps, int shard, int device, int* out) {
  return shard ? geometry_of<ArgsBf16, true>(sweeps, device, out)
               : geometry_of<ArgsBf16, false>(sweeps, device, out);
}
