// K3 hs_sor_sweeps: `sweeps` 4-color SOR sweeps of Horn-Schunck per launch,
// temporally blocked on chip, over one frame or a (B, H, W) stack.
//
// Replaces these TPU kernels of opticalflowhs_tpu/kernels/:
//   * sor.py, _sor_vmem_kernel (line 59, called at line 315): n sweeps with
//     the whole image resident;
//   * sor.py, _sor_banded_kernel (line 113, called at line 166): s sweeps
//     per row band with a 4s-row halo slab;
//   * solve_resident.py, stage 2 of _resident_body with stages=4 (lines
//     281-322, called at line 427 through hs_solve_resident_sor, line 745).
// Each sweep is ops/stencils.py sor_step: colors (row%2, col%2) = (0,0),
// (0,1), (1,0), (1,1) in that order; each color stage computes the Jacobi
// target from the CURRENT field, then blends u + omega*(u* - u) on that
// color's pixels only.
//
// Design: one persistent block of 384 threads a streaming multiprocessor
// walks 48 x 128 windows, every tile of every image of the stack.
//   * Warp j owns window rows 4j..4j+3, lane l the 4 adjacent columns
//     4l..4l+3, for all of a tile's sweeps: every warp holds two rows of
//     each row parity, so each half sweep keeps every lane busy. A thread
//     keeps u and v of its 16 pixels and the fields Ex, Ey, Et and invd in
//     registers.
//   * A sweep is two halves with a block barrier after each. Stages (0,0)
//     and (0,1) write only the even rows and read the odd rows, which they
//     do not change; stages (1,0) and (1,1) the other way round. So within
//     a half a row depends only on its own pixels and on the two rows
//     beside it as they were when the half began, and a thread's own rows
//     come from its registers. Only the row beside a thread's first (last)
//     row belongs to the warp above (below): each half reads that one row
//     of u and v from shared memory and stores the thread's own boundary
//     row that the half changed, which the neighbouring warp reads in the
//     next half.
//   * Within a row, stage (x,0) and stage (x,1) are warp-local. The column
//     sums t = (a(i-1) + 2a) + a(i+1) are formed once for the 4 columns of
//     a lane, the neighbouring lane's by a shuffle; after stage (x,0) only
//     the sums of the 2 columns it updated are formed again. 36 float32
//     operations a pixel a sweep: 10.5 per field for the sums and the
//     neighbour average, 5 for frac, 4 for the targets, 6 for the blends.
//   * While a block sweeps one tile, cp.async copies the next tile's u, v
//     and fields into shared memory (16-byte copies where w is a multiple
//     of 4 and every array 16-byte aligned, else 4-byte): a thread copies
//     exactly the pixels it will own, so the fields need no second buffer;
//     u and v take a second pair, since the sweeps exchange boundary rows
//     through the first. 196,608 bytes of shared memory.
//   * Interior windows run without clamps; a window that holds an edge of
//     the array (or, on a shard, a true image edge) takes each row's
//     clamps and each column's (kEdge).
//
// The halo: 2s rows and 4s columns. The tile is the window less 2s rows
// above and below and less 4s columns on each side (4s is a multiple of 4,
// so tile and window columns stay 16-byte aligned): 32 x 96 at s = 4, and
// at most 11 sweeps a launch (a 4 x 40 tile). The cone of a wrong value is
// 2 rows a sweep: a half reads rows of the other parity only, so a value
// on an odd row reaches the even rows beside it in the first half and the
// odd rows two away in the second, and a value on an even row reaches the
// odd rows beside it in the second half and the even rows two away in the
// next sweep's first. In columns it is 4 a sweep: each half's second stage
// reads what its first stage wrote in the columns beside it, so a half
// moves a value 2 columns. Computation outside the exact region, such as
// the shuffles at lanes 0 and 31, where the window's columns 0 and 127
// take their own lane's column sums, and the rows above and below the
// window, taken as the window's first and last, writes junk that the cone
// keeps out of the owned tile. Warps skip sweep k where none of their rows
// is still needed: the rows [2k - 1, 49 - 2k) of the window, cut at the
// array's edges (the second half of sweep k reads the row of the first
// half's parity just outside the window shrunk by 2k). Only the owned tile
// is written, from registers.
// kernels/sor.py `k3_launch_schedule_plain` walks this schedule in plain
// torch, NaN staged outside the array.
//
// Clamps fire at the array's edges and, on a shard, at the true image
// edges, from global coordinates; window edges inside the image are halo,
// not edges. Color parity is taken from the global row and column, never
// from the window's own coordinates: an odd shard origin flips it (kPr,
// kPc).
//
// Batch: image k starts k*h*w floats into every array (a 64-bit stride);
// the window, halo, clamp and color bookkeeping is per image. The entry
// points refuse batches beyond 65535, the limit the other kernels' grids
// keep.
//
// Bound: device memory, at 8 arrays read or written per launch (u, v and
// the four fields in, u and v out): 66.8 MB at 1088x1920, 19.9 us at 3.35
// TB/s. The schedule itself reads its windows' 6 arrays, the window's area
// over the tile's times the frame (2.0x at s = 4), and writes 2: 34.9 us at
// 1088x1920. Measured on an H100 at 700 W (PERF.md): 0.0527 ms a launch of
// 4 sweeps at 1088x1920 (the shared-memory design before it: 0.1718), 1.5x
// the schedule's floor; 0.302 ms at 8 x 1088x1920, 1.08x its floor. The
// operations (36 a pixel a sweep) bound it at 4.5 us, so what holds it is
// the bytes of its windows: a faster K3 needs a schedule that moves fewer.
//
// Exactness: the association order is that of ops/stencils.py
// (neighbor_avg, sor_step), the constants are the float32 values of 1/12,
// 1/3 and omega, and the library is built with --fmad=false, so the output
// equals the plain PyTorch sweeps bitwise.
//
// K9's SOR twin, hs_sor_tile_sweeps, is the same kernel on the halo-padded
// shards of the tiled solver (opticalflowhs_tpu_torch/dist/): it replaces
// sor_tile_sweeps of opticalflowhs_tpu/kernels/sor.py (line 331, through
// _sor_vmem_kernel, line 59, and _sor_banded_kernel, line 113). Image k of
// the stack is a shard whose element (0, 0) is the global pixel org[2k],
// org[2k+1] of an img_h x img_w image; the clamps fire at the true image
// edges and at the shard's own edges, and the color parity is that of the
// global row and column.
//
// bfloat16 (hs_sor_sweeps_bf16, single frame and stack; K9's SOR entry
// hs_sor_tile_sweeps_bf16 on shards): the same walk on bfloat16 arrays (k3_window.cuh's storage
// types): the pairs and fields staged in bfloat16 (16-byte copies of 8
// values where the width and the tile's first column are multiples of 8,
// as at every even s; else 8-byte copies), widened into the same
// registers, the boundary rows exchanged in a float32 pair within a sweep,
// u and v rounded to nearest even at each sweep's end: 147,456 bytes of
// shared memory, the float32 geometry and s. Bound: 8 arrays of 2 bytes,
// 10.0 us at 1088x1920 (K9 SOR: 43.4 us at config 5's 16 shards of
// 572x992); 38 operations a pixel a sweep with the two roundings.
//
// The walk itself is in k3_window.cuh, which K8 (sor_planes.cu) shares: all
// of it in an unnamed namespace, as when it lived here, so that each source
// compiles its own copy and K3's SASS stays what it was; from k2_window.cuh
// it takes the window's width (a warp's 32 lanes of 4 columns), the
// constants and the copy helpers as they are.

#include <cuda_runtime.h>

#include "k3_window.cuh"

namespace {

// kShard: the images are K9's shards, each at its own global origin (org);
// otherwise whole images (K3). One launch is one walk (k3_window.cuh).
template <bool kShard>
__global__ void __launch_bounds__(kThreads, 1) sor_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  walk_tiles<kShard, false>(smem, a, true);
}

// The bfloat16 build, K3 (kShard false) or K9 SOR.
template <bool kShard>
__global__ void __launch_bounds__(kThreads, 1) sor_kernel_bf16(const ArgsBf16 a) {
  extern __shared__ __align__(16) float smem[];
  walk_tiles<kShard, false>(reinterpret_cast<__nv_bfloat16*>(smem), a, true);
}

// The kernel and shared bytes of a build: K3 (kShard false) or K9 SOR, in
// float or bfloat16.
template <class A, bool kShard>
auto build_kernel() {
  if constexpr (kIsFloat<A>)
    return sor_kernel<kShard>;
  else
    return sor_kernel_bf16<kShard>;
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      build_smem<A>());
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
           int sweeps, float omega, int device, void* stream) {
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
  a.omega = omega;
  a.tiles_x = (w + g.tw - 1) / g.tw;
  a.tiles_y = (h + g.th - 1) / g.th;
  if constexpr (kIsFloat<A>) {
    a.vec = w % 4 == 0 && aligned(u) && aligned(v) && aligned(ex) && aligned(ey) &&
            aligned(et) && aligned(invd) && aligned(uo) && aligned(vo);
  } else {
    // 8 bytes (4 bfloat16 values) a lane's copy or store; 2: rows also
    // staged 16 bytes at a time (bf16_wide).
    auto all_aligned = [&](unsigned long long n) {
      return aligned(u, n) && aligned(v, n) && aligned(ex, n) && aligned(ey, n) &&
             aligned(et, n) && aligned(invd, n) && aligned(uo, n) && aligned(vo, n);
    };
    a.vec = w % 4 == 0 && all_aligned(8);
    if (a.vec && w % 8 == 0 && all_aligned(16)) a.vec = 2;
  }
  const long long tiles = (long long)b * a.tiles_x * a.tiles_y;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < grid_max ? tiles : grid_max);
  const auto kernel = org != nullptr ? build_kernel<A, true>() : build_kernel<A, false>();
  kernel<<<grid, kThreads, build_smem<A>(), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_sor_sweeps(const float* u, const float* v, const float* ex,
                             const float* ey, const float* et,
                             const float* invd, float* uo, float* vo, int b,
                             int h, int w, int sweeps, float omega, int device,
                             void* stream) {
  return launch<Args>(u, v, ex, ey, et, invd, uo, vo, nullptr, b, h, w, h, w, sweeps,
                      omega, device, stream);
}

// K3's bfloat16 build: the same arguments, every array bfloat16.
extern "C" int hs_sor_sweeps_bf16(const __nv_bfloat16* u, const __nv_bfloat16* v,
                                  const __nv_bfloat16* ex, const __nv_bfloat16* ey,
                                  const __nv_bfloat16* et, const __nv_bfloat16* invd,
                                  __nv_bfloat16* uo, __nv_bfloat16* vo, int b, int h, int w,
                                  int sweeps, float omega, int device, void* stream) {
  return launch<ArgsBf16>(u, v, ex, ey, et, invd, uo, vo, nullptr, b, h, w, h, w, sweeps,
                          omega, device, stream);
}

// K9's SOR twin: b halo-padded h x w shards; org holds 2b ints on the
// device, the global (row, column) of each shard's element (0, 0) in the
// img_h x img_w image.
extern "C" int hs_sor_tile_sweeps(const float* u, const float* v,
                                  const float* ex, const float* ey,
                                  const float* et, const float* invd,
                                  float* uo, float* vo, const int* org, int b,
                                  int h, int w, int img_h, int img_w,
                                  int sweeps, float omega, int device,
                                  void* stream) {
  if (org == nullptr) return (int)cudaErrorInvalidValue;
  return launch<Args>(u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w,
                      sweeps, omega, device, stream);
}

// K9 SOR's bfloat16 build: the same arguments, every array bfloat16.
extern "C" int hs_sor_tile_sweeps_bf16(const __nv_bfloat16* u, const __nv_bfloat16* v,
                                       const __nv_bfloat16* ex, const __nv_bfloat16* ey,
                                       const __nv_bfloat16* et, const __nv_bfloat16* invd,
                                       __nv_bfloat16* uo, __nv_bfloat16* vo, const int* org,
                                       int b, int h, int w, int img_h, int img_w,
                                       int sweeps, float omega, int device, void* stream) {
  if (org == nullptr) return (int)cudaErrorInvalidValue;
  return launch<ArgsBf16>(u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w,
                          sweeps, omega, device, stream);
}

// K3's geometry at `sweeps` on `device` (K9 SOR's with `shard` nonzero),
// into out[0..8]: sweeps, tile rows, tile columns, threads a block, shared
// bytes a block, registers a thread, local (spilled) bytes a thread, blocks
// resident on one multiprocessor, and the number of multiprocessors.
namespace {

template <class A, bool kShard>
int report(int sweeps, int device, int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid_max = 0, sms = 0;
  err = configure<A, kShard>(device, &grid_max);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, build_kernel<A, kShard>());
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g = geometry(sweeps);
  out[0] = sweeps;
  out[1] = g.th;
  out[2] = g.tw;
  out[3] = kThreads;
  out[4] = (int)build_smem<A>();
  out[5] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  out[7] = grid_max / sms;
  out[8] = sms;
  return cudaSuccess;
}

}  // namespace

extern "C" int hs_sor_geometry(int sweeps, int shard, int device, int* out) {
  return shard ? report<Args, true>(sweeps, device, out)
               : report<Args, false>(sweeps, device, out);
}

// The bfloat16 builds (K9 SOR's with `shard` nonzero), as hs_sor_geometry's.
extern "C" int hs_sor_geometry_bf16(int sweeps, int shard, int device, int* out) {
  return shard ? report<ArgsBf16, true>(sweeps, device, out)
               : report<ArgsBf16, false>(sweeps, device, out);
}
