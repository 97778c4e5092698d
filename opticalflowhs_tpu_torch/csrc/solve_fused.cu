// K6 hs_solve_fused_sweeps: all n Jacobi sweeps of a whole Horn-Schunck
// solve in ONE launch, over one frame or a (B, H, W) stack, after K1 has
// computed the four fields.
//
// Replaces the TPU megakernels of opticalflowhs_tpu/kernels/solve_fused.py:
// _mega_kernel (line 111, called at line 245; grid (n_blocks, n_bands)) and
// its batched twin _mega_kernel_b (line 375, called at line 490; grid
// (n_blocks, B, n_bands), zero start). On the TPU the grid's outer axis is a
// sequence of sweep blocks and its inner axis the row bands, run in order
// on one core; u/v ping-pong between two HBM buffers by block parity, the
// zero start is written in-kernel at block 0, and a remainder of n mod s
// sweeps is the final block phase of the same launch.
//
// Hopper design: K2's window loop (k2_window.cuh) inside one persistent
// cooperative grid of K2's blocks (512 threads, one an SM, 147,456 bytes of
// shared memory: three u/v pairs of the 48 x 128 window). Sweep block k is
// one K2 launch's walk: each block sweeps the stack's K2 tiles blockIdx.x,
// + gridDim.x, ..., the fields in registers, the next tile's u/v staged by
// cp.async into the spare pair while the current tile sweeps, the last
// sweep written from registers to pair A (k even) or B (k odd); a grid
// barrier then separates block k from block k + 1. Block 0 stages u0/v0, or
// zeros (zero-fill copies) for the zero start. The remainder n mod s is the
// last block, at its own K2 tile (geometry(rem)). u/v written during the
// launch are read around the SM's L1 (cp.async.cg, or __ldcg on the 4-byte
// path of unaligned views), which other SMs' writes do not invalidate.
// The first tile after a barrier is the only staging not hidden behind
// sweeps: it reads what block k just wrote.
//
// Bound: per sweep block the same 8 arrays as a K2 launch (u, v and the
// four fields in, u and v out), 265 MB or 79 us at 3.35 TB/s at 2160x3840;
// the whole solve at i100 does 2,709 float32 operations a pixel (K1 with
// its first sweep, then 99 sweeps of 27; chip_smoke.py), 335 us at 4K and
// 1341 us at 4320x7680 at 67 TFLOP/s. Against the K1 + K2 chain it saves
// the launches and their gaps, not bytes, and pays a grid barrier and one
// exposed staging a sweep block.
//
// bfloat16 (hs_solve_fused_sweeps_bf16): the same launch on K2's bfloat16
// walk (k2_window.cuh's storage types: u and v rounded at the end of every
// sweep, three bfloat16 pairs, 73,728 bytes of shared memory). Bound: half
// the float bytes a sweep block.
//
// Exactness: K2's sweeps on K2's tiles, so K6 equals the plain sweeps (and
// the K1 + K2 chain) bitwise.

#include <cuda_runtime.h>

#include "cooperative.cuh"
#include "k2_window.cuh"

namespace {

using namespace hs_k2;

constexpr size_t kSmemBytes = 3 * kPairBytes;
constexpr size_t kSmemBytesBf16 = 3 * pair_bytes<ArgsBf16>();

// One Args for each kind of sweep block, built on the host, and one instance
// of K2's walk for each, so that a sweep block reads its sources,
// destinations and tiles from the kernel's parameters as a K2 launch does.
// On an H100 that runs a sweep block as fast as a K2 launch; the same
// Args held in registers, or read from shared memory, made the sweeps
// spill or wait and run slower.
template <class A>
struct FusedArgsOf {
  A first;  // block 0: from u0/v0 (or zeros, first_live 0) into A
  A even;   // blocks 2, 4, ...: from B into A
  A odd;    // blocks 1, 3, ...: from A into B
  A rem;    // the remainder n mod s, at its own tile, after the full blocks
  unsigned long long* barrier;  // the grid barrier's count, zero at the start
  int n_full, first_live, rem_live;
};
struct FusedArgs : FusedArgsOf<Args> {};
struct FusedArgsBf16 : FusedArgsOf<ArgsBf16> {};

// The two builds' kernels are the same loop, each written out in its kernel:
// reached through a shared function, the float build's SASS changed.
__global__ void __launch_bounds__(kThreads, 1) fused_kernel(const FusedArgs f) {
  extern __shared__ __align__(16) float smem[];
  const int n_blocks = f.n_full + (f.rem.sweeps > 0 ? 1 : 0);
  for (int k = 0; k < n_blocks; ++k) {
    if (k == f.n_full)
      walk_tiles<false, true>(smem, f.rem, f.rem_live);
    else if (k == 0)
      walk_tiles<false, true>(smem, f.first, f.first_live);
    else if (k & 1)
      walk_tiles<false, true>(smem, f.odd, true);
    else
      walk_tiles<false, true>(smem, f.even, true);
    if (k + 1 < n_blocks) hs_coop::grid_barrier(f.barrier, k + 1);
  }
}

__global__ void __launch_bounds__(kThreads, 1) fused_kernel_bf16(const FusedArgsBf16 f) {
  extern __shared__ __align__(16) float smem_f[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_f);
  const int n_blocks = f.n_full + (f.rem.sweeps > 0 ? 1 : 0);
  for (int k = 0; k < n_blocks; ++k) {
    if (k == f.n_full)
      walk_tiles<false, true>(smem, f.rem, f.rem_live);
    else if (k == 0)
      walk_tiles<false, true>(smem, f.first, f.first_live);
    else if (k & 1)
      walk_tiles<false, true>(smem, f.odd, true);
    else
      walk_tiles<false, true>(smem, f.even, true);
    if (k + 1 < n_blocks) hs_coop::grid_barrier(f.barrier, k + 1);
  }
}

}  // namespace

// Most blocks of K6 that can be resident at once on `device`.
extern "C" int hs_solve_fused_blocks(int device, int* blocks) {
  return (int)hs_coop::max_blocks(fused_kernel, kSmemBytes, kThreads, device, blocks);
}

// The same for K6's bfloat16 build.
extern "C" int hs_solve_fused_blocks_bf16(int device, int* blocks) {
  return (int)hs_coop::max_blocks(fused_kernel_bf16, kSmemBytesBf16, kThreads, device,
                                  blocks);
}

// K6's build at `sweeps` on `device`, as hs_jacobi_geometry reports K2's:
// out[0..7] tile rows, tile columns, threads, shared bytes, registers a
// thread, spilled bytes a thread, resident blocks a multiprocessor,
// multiprocessors.
extern "C" int hs_solve_fused_geometry(int sweeps, int device, int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  int grid_max = 0;
  const int err = hs_solve_fused_blocks(device, &grid_max);
  if (err != 0) return err;
  return (int)report(fused_kernel, kSmemBytes, sweeps, device, grid_max, out);
}

// The same for K6's bfloat16 build.
extern "C" int hs_solve_fused_geometry_bf16(int sweeps, int device, int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  int grid_max = 0;
  const int err = hs_solve_fused_blocks_bf16(device, &grid_max);
  if (err != 0) return err;
  return (int)report(fused_kernel_bf16, kSmemBytesBf16, sweeps, device, grid_max, out);
}

namespace {

// hs_solve_fused_sweeps on arrays of A's storage type E, F its kernel's
// arguments (FusedArgs or FusedArgsBf16).
template <class F, class A, class E = typename A::Elem, class Kernel>
int fused_sweeps(Kernel kernel, size_t smem, const E* u0, const E* v0, const E* ex,
                 const E* ey, const E* et, const E* invd, E* ua, E* va, E* ub, E* vb,
                 unsigned long long* barrier, int b, int h, int w, int n, int s, int grid,
                 int device, void* stream) {
  if (b < 1 || h < 1 || w < 1 || n < 1 || s < 1 || s > kMaxSweeps || grid < 1 ||
      (u0 == nullptr) != (v0 == nullptr) || barrier == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(s);
  if ((long long)b * ((w + g.tw - 1) / g.tw) * ((h + g.th - 1) / g.th) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  A a;
  a.ex = ex; a.ey = ey; a.et = et; a.invd = invd; a.org = nullptr;
  a.b = b; a.h = h; a.w = w; a.img_h = h; a.img_w = w;
  auto all_aligned = [&](unsigned long long n) {
    return aligned(ex, n) && aligned(ey, n) && aligned(et, n) && aligned(invd, n) &&
           aligned(ua, n) && aligned(va, n) && aligned(ub, n) && aligned(vb, n) &&
           (u0 == nullptr || (aligned(u0, n) && aligned(v0, n)));
  };
  // 16 bytes (4 floats) or 8 (4 bfloat16 values) a lane's load or store; 2:
  // bfloat16 rows also staged 16 bytes at a time (bf16_wide).
  a.vec = w % 4 == 0 && all_aligned(4 * sizeof(E));
  if (sizeof(E) == 2 && a.vec && w % 8 == 0 && all_aligned(16)) a.vec = 2;
  // A sweep block of `sweeps` (0: none) from (su, sv) into (du, dv).
  auto block = [&](int sweeps, const E* su, const E* sv, E* du, E* dv) {
    A x = a;
    x.u = su != nullptr ? su : ex;  // a zero start copies nothing (live 0)
    x.v = sv != nullptr ? sv : ex;
    x.uo = du;
    x.vo = dv;
    x.sweeps = sweeps;
    const Geometry gx = geometry(sweeps > 0 ? sweeps : 1);
    x.tiles_x = (w + gx.tw - 1) / gx.tw;
    x.tiles_y = (h + gx.th - 1) / gx.th;
    return x;
  };
  F f;
  f.n_full = n / s;
  const int rem = n % s;
  f.first = block(s, u0, v0, ua, va);
  f.even = block(s, ub, vb, ua, va);
  f.odd = block(s, ua, va, ub, vb);
  f.first_live = u0 != nullptr;
  // The remainder is block n_full: from the start when it is the only one.
  f.rem = f.n_full == 0 ? block(rem, u0, v0, ua, va)
          : f.n_full % 2 ? block(rem, ua, va, ub, vb)
                         : block(rem, ub, vb, ua, va);
  f.rem_live = f.n_full > 0 || u0 != nullptr;
  f.barrier = barrier;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(barrier, 0, sizeof(*barrier), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&f};
  return (int)hs_coop::launch(kernel, grid, kThreads, smem, args, device, stream);
}

}  // namespace

// n sweeps from (u0, v0), or from zeros when u0 is null, over b images of
// h x w, s a sweep block (the last block n mod s); the result lands in
// (ua, va) when ceil(n/s) is odd, else in (ub, vb). `barrier` is 8 bytes of
// device memory for the grid barrier, cleared here on the stream. One
// cooperative launch of `grid` blocks on `stream`; a grid that cannot be
// resident is refused.
extern "C" int hs_solve_fused_sweeps(const float* u0, const float* v0,
                                     const float* ex, const float* ey,
                                     const float* et, const float* invd,
                                     float* ua, float* va, float* ub,
                                     float* vb, unsigned long long* barrier, int b,
                                     int h, int w, int n, int s, int grid,
                                     int device, void* stream) {
  return fused_sweeps<FusedArgs, Args>(fused_kernel, kSmemBytes, u0, v0, ex, ey, et, invd,
                                       ua, va, ub, vb, barrier, b, h, w, n, s, grid, device,
                                       stream);
}

// K6's bfloat16 build: the same arguments, every array bfloat16.
extern "C" int hs_solve_fused_sweeps_bf16(
    const __nv_bfloat16* u0, const __nv_bfloat16* v0, const __nv_bfloat16* ex,
    const __nv_bfloat16* ey, const __nv_bfloat16* et, const __nv_bfloat16* invd,
    __nv_bfloat16* ua, __nv_bfloat16* va, __nv_bfloat16* ub, __nv_bfloat16* vb,
    unsigned long long* barrier, int b, int h, int w, int n, int s, int grid, int device,
    void* stream) {
  return fused_sweeps<FusedArgsBf16, ArgsBf16>(fused_kernel_bf16, kSmemBytesBf16, u0, v0,
                                               ex, ey, et, invd, ua, va, ub, vb, barrier, b,
                                               h, w, n, s, grid, device, stream);
}
