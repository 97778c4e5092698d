// K8 hs_sor_planes: a whole 4-color SOR solve (n sweeps) of one frame in ONE
// persistent cooperative launch, after K1 has computed the four fields.
//
// Replaces opticalflowhs_tpu/kernels/sor_planes.py, _planes_kernel (line 78,
// called at line 189 through hs_solve_sor_planes, line 261). That kernel
// holds u, v and the four fields in VMEM as the frame's quarter-resolution
// (row%2, col%2) parity planes and runs all n sweeps in one launch, each
// color stage updating one plane in place. The planes keep the TPU's lanes
// from idling under masks; they are a layout of that machine, not part of
// the function, and the plain plane schedule (kernels/sor_planes.py
// sor_planes_plain) stays as its record.
//
// Hopper design: K6's scheme (solve_fused.cu) on K3's window walk
// (k3_window.cuh). One persistent cooperative grid of K3's blocks (384
// threads, one an SM, 196,608 bytes of shared memory: two u/v pairs and the
// four fields of the 48 x 128 window). Sweep block k is one K3 launch's
// walk: each block sweeps the frame's K3 tiles blockIdx.x, + gridDim.x, ...,
// u, v and the fields of a thread's 16 pixels in registers, two block
// barriers a sweep, the next tile staged by cp.async while the current one
// sweeps, the owned tile of the last sweep written from registers to pair A
// (k even) or B (k odd); a grid barrier (cooperative.cuh) then separates
// block k from block k + 1. Block 0 stages u0/v0, or zeros for the zero
// start; the remainder n mod s is the last block, at its own K3 tile
// (geometry(rem)). u and v written during the launch are read around the
// SM's L1 (cp.async.cg, or __ldcg on the 4-byte path of unaligned frames),
// which other SMs' writes do not invalidate. The interleaved (h, w) arrays
// are read and written as they are: no plane set lies in device memory and
// nothing is packed or unpacked. K3's half sweeps, split by row parity,
// already do no masked work. The first tile after a barrier is the only
// staging not hidden behind sweeps: it reads what block k just wrote.
//
// Bound at 1088x1920, n = 50: the same work as the K1 + K3 chain, 1,831
// float32 operations a pixel (K1's 31, then K3's 36 a sweep), 57.1 us at 67
// TFLOP/s (114.2 us at the unfused rate that --fmad=false kernels can
// reach); the bytes of the whole solve (two frames in, two flows out) are
// far below. The schedule moves a K3 launch's bytes every sweep block (the
// window's 6 arrays at 2.0x the frame at s = 4, and u and v out), so it
// does what the chain does less the launches and their gaps, and pays a
// grid barrier and one exposed staging a block.
//
// bfloat16 (hs_sor_planes_bf16): the same launch on K3's bfloat16 walk
// (k3_window.cuh's storage types: bfloat16 staging, float32 sweeps with the
// rows exchanged in float32, u and v rounded at each sweep's end), so pairs
// A and B hold bfloat16 and every value that crosses a grid barrier is
// rounded; 147,456 bytes of shared memory. It equals the bfloat16 K1 + K3
// chain and the plain sweeps of the storage rule bitwise.
//
// Exactness: K3's sweeps on K3's tiles, character for character, built
// with --fmad=false, so K8 equals the plain SOR sweeps (ops/stencils.py
// sor_step), the plain plane schedule and the K1 + K3 chain bitwise.

#include <cuda_runtime.h>

#include <type_traits>

#include "cooperative.cuh"
#include "k3_window.cuh"

namespace {

// One Args for each kind of sweep block, built on the host, and one instance
// of K3's walk for each, so that a sweep block reads its sources,
// destinations and tiles from the kernel's parameters as a K3 launch does
// (K6's lesson: Args held in registers or shared memory made the sweeps
// spill or wait).
template <class A>
struct PlanesArgsOf {
  A first;  // block 0: from u0/v0 (or zeros, first_live 0) into A
  A even;   // blocks 2, 4, ...: from B into A
  A odd;    // blocks 1, 3, ...: from A into B
  A rem;    // the remainder n mod s, at its own tile, after the full blocks
  unsigned long long* barrier;  // the grid barrier's count, zero at the start
  int n_full, first_live, rem_live;
};
struct PlanesArgs : PlanesArgsOf<Args> {};
struct PlanesArgsBf16 : PlanesArgsOf<ArgsBf16> {};

__global__ void __launch_bounds__(kThreads, 1) planes_kernel(const PlanesArgs f) {
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

// The bfloat16 build: the same sweep blocks on K3's bfloat16 walk.
__global__ void __launch_bounds__(kThreads, 1) planes_kernel_bf16(const PlanesArgsBf16 f) {
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(smem);
  const int n_blocks = f.n_full + (f.rem.sweeps > 0 ? 1 : 0);
  for (int k = 0; k < n_blocks; ++k) {
    if (k == f.n_full)
      walk_tiles<false, true>(staged, f.rem, f.rem_live);
    else if (k == 0)
      walk_tiles<false, true>(staged, f.first, f.first_live);
    else if (k & 1)
      walk_tiles<false, true>(staged, f.odd, true);
    else
      walk_tiles<false, true>(staged, f.even, true);
    if (k + 1 < n_blocks) hs_coop::grid_barrier(f.barrier, k + 1);
  }
}

// The kernel and shared bytes of a build.
template <class A>
auto build_kernel() {
  if constexpr (kIsFloat<A>)
    return planes_kernel;
  else
    return planes_kernel_bf16;
}

template <class A>
constexpr size_t build_smem() {
  return kIsFloat<A> ? kSmemBytes : kSmemBytesBf16;
}

template <class A>
int blocks_of(int device, int* blocks) {
  return (int)hs_coop::max_blocks(build_kernel<A>(), build_smem<A>(), kThreads, device,
                                  blocks);
}

template <class A>
int report(int sweeps, int device, int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  int grid_max = 0, sms = 0;
  cudaError_t err = hs_coop::max_blocks(build_kernel<A>(), build_smem<A>(), kThreads, device,
                                        &grid_max);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, build_kernel<A>());
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g = geometry(sweeps);
  out[0] = g.th;
  out[1] = g.tw;
  out[2] = kThreads;
  out[3] = (int)build_smem<A>();
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = grid_max / sms;
  out[7] = sms;
  return cudaSuccess;
}

// n >= 1 sweeps of an h x w frame from (u0, v0), or from zeros when both are
// null, s a sweep block (the last block n mod s); the result lands in (ua,
// va) when ceil(n/s) is odd, else in (ub, vb). `barrier` is 8 bytes of
// device memory for the grid barrier, cleared here on the stream. One
// cooperative launch of `grid` blocks on `stream`; a grid that cannot be
// resident is refused.
template <class A>
int solve(const typename A::Elem* u0, const typename A::Elem* v0,
          const typename A::Elem* ex, const typename A::Elem* ey,
          const typename A::Elem* et, const typename A::Elem* invd, typename A::Elem* ua,
          typename A::Elem* va, typename A::Elem* ub, typename A::Elem* vb,
          unsigned long long* barrier, int h, int w, int n, int s, float omega, int grid,
          int device, void* stream) {
  using E = typename A::Elem;
  if (h < 1 || w < 1 || n < 1 || s < 1 || s > kMaxSweeps || grid < 1 ||
      (u0 == nullptr) != (v0 == nullptr) || barrier == nullptr)
    return (int)cudaErrorInvalidValue;
  A a;
  a.ex = ex; a.ey = ey; a.et = et; a.invd = invd; a.org = nullptr;
  a.b = 1; a.h = h; a.w = w; a.img_h = h; a.img_w = w;
  a.omega = omega;
  // 16 bytes a lane's copy or store (bfloat16: 8; 2, rows also staged 16
  // bytes at a time, `bf16_wide`).
  auto all_aligned = [&](unsigned long long bytes) {
    return aligned(ex, bytes) && aligned(ey, bytes) && aligned(et, bytes) &&
           aligned(invd, bytes) && aligned(ua, bytes) && aligned(va, bytes) &&
           aligned(ub, bytes) && aligned(vb, bytes) &&
           (u0 == nullptr || (aligned(u0, bytes) && aligned(v0, bytes)));
  };
  a.vec = w % 4 == 0 && all_aligned(4 * sizeof(E));
  if (!kIsFloat<A> && a.vec && w % 8 == 0 && all_aligned(16)) a.vec = 2;
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
  std::conditional_t<kIsFloat<A>, PlanesArgs, PlanesArgsBf16> f;
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
  return (int)hs_coop::launch(build_kernel<A>(), grid, kThreads, build_smem<A>(), args, device,
                              stream);
}

}  // namespace

// Most blocks of K8 that can be resident at once on `device`.
extern "C" int hs_sor_planes_blocks(int device, int* blocks) {
  return blocks_of<Args>(device, blocks);
}

extern "C" int hs_sor_planes_blocks_bf16(int device, int* blocks) {
  return blocks_of<ArgsBf16>(device, blocks);
}

// K8's build at `sweeps` on `device`, in the order of K6's report
// (hs_solve_fused_geometry): out[0..7] K3's tile rows and columns, threads,
// shared bytes, registers a thread, spilled bytes a thread, resident blocks
// a multiprocessor, multiprocessors.
extern "C" int hs_sor_planes_geometry(int sweeps, int device, int* out) {
  return report<Args>(sweeps, device, out);
}

extern "C" int hs_sor_planes_geometry_bf16(int sweeps, int device, int* out) {
  return report<ArgsBf16>(sweeps, device, out);
}

// n >= 1 sweeps of an h x w frame from (u0, v0), or from zeros when both are
// null, s a sweep block (the last block n mod s); the result lands in (ua,
// va) when ceil(n/s) is odd, else in (ub, vb). `barrier` is 8 bytes of
// device memory for the grid barrier, cleared here on the stream. One
// cooperative launch of `grid` blocks on `stream`; a grid that cannot be
// resident is refused.
extern "C" int hs_sor_planes(const float* u0, const float* v0, const float* ex,
                             const float* ey, const float* et, const float* invd,
                             float* ua, float* va, float* ub, float* vb,
                             unsigned long long* barrier, int h, int w, int n, int s,
                             float omega, int grid, int device, void* stream) {
  return solve<Args>(u0, v0, ex, ey, et, invd, ua, va, ub, vb, barrier, h, w, n, s, omega,
                     grid, device, stream);
}

// K8's bfloat16 build: the same arguments, every array bfloat16.
extern "C" int hs_sor_planes_bf16(const __nv_bfloat16* u0, const __nv_bfloat16* v0,
                                  const __nv_bfloat16* ex, const __nv_bfloat16* ey,
                                  const __nv_bfloat16* et, const __nv_bfloat16* invd,
                                  __nv_bfloat16* ua, __nv_bfloat16* va, __nv_bfloat16* ub,
                                  __nv_bfloat16* vb, unsigned long long* barrier, int h, int w,
                                  int n, int s, float omega, int grid, int device,
                                  void* stream) {
  return solve<ArgsBf16>(u0, v0, ex, ey, et, invd, ua, va, ub, vb, barrier, h, w, n, s, omega,
                         grid, device, stream);
}
