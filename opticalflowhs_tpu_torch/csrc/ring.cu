// K10 hs_ring_halo_exchange, and K11/K12 hs_ring_fused_sweeps: the ring
// halo exchange of the tiled solver and the whole Jacobi solve of a mesh of
// shards with the halo exchange inside the launch.
//
// Replaces these TPU kernels of opticalflowhs_tpu/kernels/rdma_halo.py:
//   * K10: _halo_kernel (line 49, called by ring_halo_exchange at line 104):
//     the periodic ring exchange of `halo` rows along y, (h, w) -> (h +
//     2 halo, w);
//   * K11: _fused_kernel (line 135, called by ring_fused_sweeps at line 304
//     and by its logic twin at line 371): all n Jacobi sweeps of a
//     row-decomposed shard in one launch, a sigma-row u/v halo exchanged
//     with both ring neighbours every s sweeps, the transfer overlapped with
//     the interior sweep, comm slots double-buffered by block parity;
//   * K12: _fused_kernel_2d (line 398, called at line 554): the same on a
//     (y, x) mesh, two-phase: row strips of the owned columns along y, then
//     full-height column strips along x that carry the fresh row halos, so
//     the corners land without diagonal transfers.
// On the TPU each chip runs one launch and pltpu.make_async_remote_copy
// moves the rows chip to chip with DMA semaphores. Here a device runs one
// launch for every shard it holds (several shards share a device on a
// virtual mesh), and a row moves by a plain store into the neighbour's
// array: a global store on the same device, a peer store over NVLink on
// another (the wrapper enables peer access first). The sender's block then
// meets at a barrier, and one thread fences (__threadfence_system) and
// release-stores a flag (st.release.sys) in the receiver's memory; the
// receiver acquire-loads it (ld.acquire.sys) until it reaches the sweep
// block's epoch. Flags hold epochs (a per-call base plus the block index),
// so they never need a reset.
//
// K11/K12 design: K2's window loop (k2_window.cuh) in one persistent
// cooperative grid of K2's blocks a device (512 threads, one an SM, three
// u/v pairs of the 48 x 128 window in shared memory), as K6 runs it; every
// shard that waits on another runs in the same launch, or the launch is
// refused (cooperative.cuh). The images of a device (its shards, and the
// images of a shard's stack) are stacked, (b, th + 2 sy, tw + 2 sx), the
// fields' own shape: one Args serves u, v and the four fields, and K9's
// origin table gives each image's global origin, so the clamps fire at the
// true image edges. u/v live in two such pairs, P0 and P1; sweep block k
// reads P[k % 2] and writes the owned pixels of P[(k + 1) % 2] (block 0
// reads the start, which the wrapper copied into P0). The halo lives in the
// pairs themselves:
//   * phase R of block k: one block a side of an image stores the image's
//     sy top (bottom) owned rows of P[k % 2] straight into the bottom (top)
//     halo rows of its upper (lower) neighbour's P[k % 2], then releases
//     the neighbour's flag;
//   * phase C (K12) then sends the full-height column strips of the
//     row-extended image, once its row halos have arrived, into the halo
//     columns of its left and right neighbours' P[k % 2]; all flags of the
//     device's images are waited for and a grid barrier ends the exchange
//     before any tile is staged, the reference's serial two-phase order;
//   * the sweeps: each sweep block is one K2 launch's walk over the owned
//     K2 tiles of the stack (walk_owned: K9's shard clamps, the kL2 reads),
//     one Args a kind of block (even: P0 to P1, odd: P1 to P0, the
//     remainder n mod s at its own tile) in the kernel's parameters. The
//     walk covers only the owned rectangle and writes only owned pixels, so
//     no sweep ever writes a halo row or column of its destination pair,
//     which a neighbour on another card may be storing into for its next
//     phase R. On a 1-D mesh (K11) a tile
//     whose window reaches no halo row is staged without waiting; before
//     staging one that does, thread 0 waits for that halo's flag. The
//     interior tile rows are walked first (tile_index), so the waits fall at
//     the end of the block, the reference's overlap of the transfer with
//     the interior sweep;
//   * a grid barrier (hs_coop::grid_barrier, on a count the entry point
//     clears) ends the sweep block.
// No slot or staging buffer is needed: the windows are staged by cp.async
// (kL2: around L1, which stores by other SMs and by peers do not
// invalidate) from one array. The reference's parity argument holds with
// P[p] in place of its slot p: a neighbour's block k + 2 store into my
// P[k % 2] follows its block k + 1 flag wait, which follows my block k + 1
// phase R, which follows the barrier after my block k reads of P[k % 2]
// (rdma_halo.py:177-185).
//
// Deep sweep blocks (ring_kernel_deep). K2's 48-row window leaves a 16-row
// tile at 16 sweeps (kMaxSweeps), and the reference takes any block its
// halo allows (s <= sy, sx). A block of s > 16 runs in the same launch,
// between the same exchange and the same end-of-block barrier, as P passes
// of K2's walk, s = s_1 + ... + s_P (ring_passes: the fewest passes, every
// one but the first of q sweeps, q the multiple of 4 nearest s / P, the
// first the rest). Pass p walks the owned rectangle grown by r_p = s -
// (s_1 + ... + s_p) rows on each side (K12: and columns), a multiple of 4,
// so the columns keep the 16-byte paths' alignment; the last (r_P = 0) is
// ring_kernel's walk. A pass reaches s_p + r_p <= s <= sy beyond the owned
// rectangle, so it reads only the halo just exchanged (pass 1) or pixels
// the previous pass wrote; the clamps still fire at the true image edges,
// and rows of wrapped halo outside the image are swept but never read by a
// true pixel. A grid barrier ends each pass; K11 waits for a halo's flag
// only in pass 1 (HaloRing's wait, in PassRing).
// Where the passes write: no pass but the last may write P[(k + 1) % 2],
// whose halo a neighbour (another card, or another process through the IPC
// arena) may already be storing into for its block k + 1. The passes
// alternate between Q, a scratch pair of the device's stack that the
// wrapper allocates (never exported, not in the arena), and P[k % 2]: pass
// 1 reads P[k % 2] into Q, then Q into P[k % 2], P[k % 2] into Q, ..., the
// last into P[(k + 1) % 2]. P[k % 2] is free for that from pass 2 on. Its
// writers are my last pass of block k - 1 (before block k's start), my
// neighbours' phase R and C of block k (each landed before pass 1 ends: K12
// waits for every flag before it; on K11 each image's first and last tile
// rows of pass 1 reach both of its halos and wait for them, and the grid
// barrier after pass 1 orders those waits before any pass 2 store), and
// their phase R and C of block k + 2, which follow their block k + 1 flag
// waits, which follow my block k + 1 exchange, which follows my block k's
// last barrier. Its readers are my block k exchange (before pass 1's
// barrier) and pass 1. So between pass 1's end and block k's end no other
// agent touches P[k % 2]. Launches, epochs and exchanges stay one a device,
// one a block; grid barriers become P a block (K12: and the exchange's),
// less the launch's last (ring.ring_barriers). The deep kernels are
// instantiations of their own, so the s <= 16 kernels keep their SASS.
//
// Bound: a whole solve moves each input once (the four fields of the
// extended shards, the start) and writes u and v once, against 27 float32
// operations a pixel a sweep (K2's count), an operations bound; a schedule
// of sweep blocks cannot keep the fields on chip between blocks at 4K, so
// the byte floor of this schedule is ceil(n/s) blocks of K2's 8 arrays of
// the extended shards (chip_smoke.py prints both), plus the halo bytes over
// NVLink (450 GB/s each way) when the neighbours sit on other cards.
//
// Exactness: K2's sweeps on K2's tiles with K9's clamps, so the owned
// pixels equal the plain version (kernels/ring.py) bitwise.
//
// bfloat16 (hs_ring_halo_exchange_bf16, hs_ring_fused_sweeps_bf16): K10
// moves 2-byte values, 16 bytes (8 values) at a time where w % 8 == 0 and
// the shard's four pointers are 16-byte aligned, else one value at a time.
// K11 and K12 run K2's bfloat16 walk (k2_window.cuh's storage types: u and
// v rounded where every sweep stores them, the fields widened into the
// same registers) in kernels of their own (ring_kernel_bf16), with P0 and
// P1 in bfloat16 and 73,728 bytes of shared memory; the exchange moves the
// stored, already rounded u and v, so a tiled solve equals the untiled one
// bitwise. Its rectangles go 16 bytes at a time where w % 8 == 0, sx % 8 ==
// 0 and the arrays are 16-byte aligned, else 2 bytes at a time (a column
// halo of 4, as at config 5's 2 x 2 mesh, takes the 2-byte path in both
// phases). The float kernels are written as they were, so that their SASS
// does not change. Bound: K10 half of float32's bytes (10.0 us at config
// 5's shards, halo 5); K11 and K12 the operations bound of 29 operations a
// pixel a sweep (K2's 27 and the two roundings), and half of float32's
// schedule bytes.

// Across processes of one host (hs_ipc_*, at the end): a neighbour's pairs
// and flags belong to another CUDA context. Each process allocates its ring
// buffers of a shape (the four pair planes and the epoch flags) as one arena
// with cudaMalloc, exports it once (cudaIpcGetMemHandle: a handle names a
// whole allocation, which is why the arena does not come from PyTorch's
// caching allocator), and maps its neighbours' arenas once
// (cudaIpcOpenMemHandle with lazy peer access); kernels/ring.py writes the
// mapped addresses into the link table, and K11/K12 run unchanged: their
// flags are released and acquired at system scope, the scope that memory
// shared between processes needs. hs_ipc_ping_pong is a probe of that
// protocol, not a kernel of the solve: one thread of one block a process,
// two processes, each releasing a flag in the other's mapped arena and
// acquiring its own. On one card without MPS the two processes' contexts
// are time-sliced, so a round trip costs about two of the card's context
// switches; the ring solve pays the same for each sweep block whose halo
// crosses the process boundary.

#include <cuda_runtime.h>

#include <cstring>

#include "cooperative.cuh"
#include "k2_window.cuh"

namespace {

using namespace hs_k2;

// -- K10 ---------------------------------------------------------------------

// K10's design: a row copy that reads each source row once. One block a
// source row (blockIdx.x the row, blockIdx.y the shard), its threads striding
// along the row: it stores the row to the shard's own output and, for the
// shard's first (last) `halo` rows, also into the bottom (top) halo of its
// upper (lower) ring neighbour's output, a peer store over NVLink where that
// lies on another card. The row's base is formed once; the threads then
// stride along it with 16-byte loads and stores where w % 4 == 0 and all
// four pointers of the shard are 16-byte aligned (every row is then
// aligned), else 4 bytes at a time. A block a row, rather than a warp,
// gives each thread a few loads to put in flight at once (3.75 float4 at w
// = 3840) instead of 30 in turn, and fills the SMs: config 5's 2,160 rows
// are 16 warps an SM as a warp a row. On an H100 at config 5's 4 x
// 540x3840, halo 5, a warp a row took 29-30 us of device time, a block a
// row 23.4-23.8, as a copy_ of the same bytes (PERF.md). Nothing is read
// twice, so loads and stores carry the streaming hints (__ldcs, __stcs).
// Bound: each shard read once and each output written once, (2h + 2 halo)
// w floats a shard, at the memory's rate: 20.0 us there.

constexpr int kHaloThreads = 256;

template <class E>
struct HaloShardOf {
  const E* src;  // the shard, h x w
  E* own;        // its output, (h + 2 halo) x w
  E* up;         // the output of its upper ring neighbour
  E* dn;         // the output of its lower ring neighbour
};
struct HaloShard : HaloShardOf<float> {};
struct HaloShardBf16 : HaloShardOf<__nv_bfloat16> {};

// One row of n units (float4 or float; bfloat16: uint4 of 8 values, or one
// value) from s to d, and to e and f where
// they are not null, the block's threads striding along it.
template <class T>
__device__ __forceinline__ void copy_row(const T* __restrict__ s, T* d, T* e, T* f, int n) {
#pragma unroll 4
  for (int c = threadIdx.x; c < n; c += kHaloThreads) {
    const T x = __ldcs(s + c);
    __stcs(d + c, x);
    if (e != nullptr) __stcs(e + c, x);
    if (f != nullptr) __stcs(f + c, x);
  }
}

__global__ void __launch_bounds__(kHaloThreads) halo_kernel(
    const HaloShard* __restrict__ shards, int h, int w, int halo) {
  const int r = blockIdx.x;
  const HaloShard sh = shards[blockIdx.y];
  const long long row = (long long)r * w;
  // My top rows are the upper neighbour's bottom halo, my bottom rows the
  // lower neighbour's top halo; where halo > h/2 a row is both.
  float* up = r < halo ? sh.up + (long long)(halo + h) * w + row : nullptr;
  float* dn = r >= h - halo ? sh.dn + row - (long long)(h - halo) * w : nullptr;
  float* own = sh.own + (long long)halo * w + row;
  const unsigned long long bases = (unsigned long long)sh.src | (unsigned long long)sh.own |
                                   (unsigned long long)sh.up | (unsigned long long)sh.dn;
  if ((w & 3) == 0 && (bases & 15ull) == 0)
    copy_row(reinterpret_cast<const float4*>(sh.src + row), reinterpret_cast<float4*>(own),
             reinterpret_cast<float4*>(up), reinterpret_cast<float4*>(dn), w >> 2);
  else
    copy_row(sh.src + row, own, up, dn, w);
}

// K10's bfloat16 build: the same row copy, 8 values or one at a time.
__global__ void __launch_bounds__(kHaloThreads) halo_kernel_bf16(
    const HaloShardBf16* __restrict__ shards, int h, int w, int halo) {
  typedef unsigned short B;  // a bfloat16 value's bits
  const int r = blockIdx.x;
  const HaloShardBf16 sh = shards[blockIdx.y];
  const long long row = (long long)r * w;
  B* up = r < halo ? reinterpret_cast<B*>(sh.up) + (long long)(halo + h) * w + row : nullptr;
  B* dn = r >= h - halo ? reinterpret_cast<B*>(sh.dn) + row - (long long)(h - halo) * w
                        : nullptr;
  B* own = reinterpret_cast<B*>(sh.own) + (long long)halo * w + row;
  const B* src = reinterpret_cast<const B*>(sh.src) + row;
  const unsigned long long bases = (unsigned long long)sh.src | (unsigned long long)sh.own |
                                   (unsigned long long)sh.up | (unsigned long long)sh.dn;
  if ((w & 7) == 0 && (bases & 15ull) == 0)
    copy_row(reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(own),
             reinterpret_cast<uint4*>(up), reinterpret_cast<uint4*>(dn), w >> 3);
  else
    copy_row(src, own, up, dn, w);
}

// -- K11 / K12 ---------------------------------------------------------------

typedef unsigned long long u64;

constexpr size_t kSmemBytes = 3 * kPairBytes;
constexpr size_t kSmemBytesBf16 = 3 * pair_bytes<ArgsBf16>();

// Per image of a device's stack: where its ring neighbours' arrays and
// flags lie (on this device or a peer), for arrays stored as E.
template <class E>
struct RingLinkOf {
  E* nb[4][4];       // neighbour [up, down, left, right]: its image's element
                     // (0, 0) in [P0 u, P0 v, P1 u, P1 v]
  u64* nb_flags[4];  // the neighbours' flags
  u64* flags;        // mine: [phase: rows, columns][parity][side: top or
                     // left, bottom or right]
};

// One Args for each kind of sweep block, in the kernel's parameters, as
// K6's FusedArgs; even.u/v is P0 and odd.u/v P1 for the exchange.
template <class A>
struct RingArgsOf {
  A even;  // blocks 0, 2, ...: from P0 into P1
  A odd;   // blocks 1, 3, ...: from P1 into P0
  A rem;   // the remainder n mod s, at its own tile, after the full blocks
  const RingLinkOf<typename A::Elem>* links;  // one an image
  u64* barrier;           // the grid barrier's count, zero at the start
  u64 epoch0;
  int n_full;
  int oy, ox;             // the owned rectangle's first row and column: sy, sx
};
struct RingArgs : RingArgsOf<Args> {};
struct RingArgsBf16 : RingArgsOf<ArgsBf16> {};

__device__ __forceinline__ u64 ld_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void wait_flag(const u64* p, u64 epoch) {
  while (ld_acquire_sys(p) < epoch) __nanosleep(64);
}

__device__ __forceinline__ int flag_index(int phase, int parity, int side) {
  return (phase * 2 + parity) * 2 + side;
}

// rows x cols values of type E from src to dst, both of row stride w, by
// this block's threads, T (float or float4; bfloat16: uint4 of 8 values,
// or one value's bits) at a time. src was written during the launch, by
// other SMs, so it is read around L1. One load is in flight a thread: two
// made an instance of the kernel spill, the sweeps' registers being all
// the kernel has.
template <class T, class E>
__device__ __forceinline__ void copy_rect_of(E* dst, const E* src, int rows, int cols,
                                             int w) {
  const int per_row = cols / (int)(sizeof(T) / sizeof(E));
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const size_t o = (size_t)r * w + (size_t)(i - r * per_row) * (sizeof(T) / sizeof(E));
    *reinterpret_cast<T*>(dst + o) = __ldcg(reinterpret_cast<const T*>(src + o));
  }
}

// 16 bytes at a time with vec (cols and the offsets multiples of 4).
__device__ __forceinline__ void copy_rect(float* dst, const float* src, int rows, int cols,
                                          int w, bool vec) {
  if (vec)
    copy_rect_of<float4>(dst, src, rows, cols, w);
  else
    copy_rect_of<float>(dst, src, rows, cols, w);
}

// bfloat16: 16 bytes at a time with vec (cols and the offsets multiples of
// 8), else 2.
__device__ __forceinline__ void copy_rect(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows, int cols, int w, bool vec) {
  if (vec)
    copy_rect_of<uint4>(dst, src, rows, cols, w);
  else
    copy_rect_of<unsigned short>(dst, src, rows, cols, w);
}

// Whether the exchange's rectangles go 16 bytes at a time: float, the
// walk's rule (vec: w and sx multiples of 4, every array 16-byte aligned);
// bfloat16, w and sx multiples of 8 and every array 16-byte aligned.
template <class A>
__device__ __forceinline__ bool rect_vec(const A& a, int ox) {
  if constexpr (kIsFloat<A>)
    return a.vec;
  else
    return a.vec == 2 && (ox & 7) == 0;
}

// Phase R (kCols false) or C of sweep block k: job 2 img + side sends one
// side of one image, for u and v, and releases the receiver's flag. The
// jobs go to the last blocks, which hold the fewest tiles. Rows: side 0 my
// top owned rows into my upper neighbour's bottom halo, side 1 my bottom
// owned rows into my lower neighbour's top halo (owned columns only).
// Columns, once both row halos have arrived: side 0 my left owned columns,
// full height, into my left neighbour's right halo, side 1 my right ones
// into my right neighbour's left halo.
template <bool kCols, class R>
__device__ __forceinline__ void exchange(const R& r, int k) {
  const auto& a = r.even;
  using E = typename decltype(r.even)::Elem;
  const int p = k & 1;
  const u64 epoch = r.epoch0 + k;
  const size_t area = (size_t)a.h * a.w;
  const int oy = r.oy, ox = r.ox;
  for (int j = gridDim.x - 1 - blockIdx.x; j < 2 * a.b; j += gridDim.x) {
    const int img = j >> 1, side = j & 1;
    const auto& link = r.links[img];
    if (kCols) {
      if (threadIdx.x == 0) {
        wait_flag(link.flags + flag_index(0, p, 0), epoch);
        wait_flag(link.flags + flag_index(0, p, 1), epoch);
      }
      __syncthreads();
    }
    const int nb = kCols ? 2 + side : side;
    for (int f = 0; f < 2; ++f) {
      const E* mine =
          (f == 0 ? (p ? r.odd.u : a.u) : (p ? r.odd.v : a.v)) + img * area;
      E* theirs = link.nb[nb][2 * p + f];
      if (kCols)
        copy_rect(theirs + (side ? 0 : a.w - ox), mine + (side ? a.w - 2 * ox : ox), a.h, ox,
                  a.w, rect_vec(a, ox));
      else
        copy_rect(theirs + (size_t)(side ? 0 : a.h - oy) * a.w + ox,
                  mine + (size_t)(side ? a.h - 2 * oy : oy) * a.w + ox, oy, a.w - 2 * ox, a.w,
                  rect_vec(a, ox));
    }
    // The block's stores, ordered before thread 0's by the barrier, are
    // made visible to the whole system by its fence and release.
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      st_release_sys(link.nb_flags[nb] + flag_index(kCols, p, 1 - side), epoch);
    }
  }
}

// The Ring of walk_owned (k2_window.cuh): the owned rectangle, and with
// kWait (K11) a wait for the row halo that a tile's window reaches before
// it is staged. It reads what it needs from the kernel's parameters.
template <bool kWait, class R>
struct HaloRing {
  const R& r;
  int k;
  __device__ __forceinline__ int oy() const { return r.oy; }
  __device__ __forceinline__ int ox() const { return r.ox; }
  template <class A>
  __device__ __forceinline__ void before_stage(const A& a, int t, const Tile& x) const {
    if (!kWait) return;
    const bool top = x.r0 < r.oy;
    const bool bot = min(x.r0 + kWinH, a.h) > a.h - r.oy;
    if (!top && !bot) return;  // the same for every thread of the block
    if (threadIdx.x == 0) {
      int img, ty, tx;
      tile_index(a, t, img, ty, tx);
      const u64* f = r.links[img].flags;
      if (top) wait_flag(f + flag_index(0, k & 1, 0), r.epoch0 + k);
      if (bot) wait_flag(f + flag_index(0, k & 1, 1), r.epoch0 + k);
    }
    __syncthreads();
  }
};

// K11 (kTwoD false) and K12: all sweep blocks of the device's stack. One
// instance of K2's walk serves the three kinds of sweep block: three, as K6
// has four, made the sweeps spill (its Args read from the parameters at an
// offset picked by the kind instead). The n-th grid barrier of the launch
// is k + 1 (K11) or 2k + 1 and 2k + 2 (K12).
template <bool kTwoD>
__global__ void __launch_bounds__(kThreads, 1) ring_kernel(const RingArgs r) {
  extern __shared__ __align__(16) float smem[];
  const int n_blocks = r.n_full + (r.rem.sweeps > 0 ? 1 : 0);
  for (int k = 0; k < n_blocks; ++k) {
    exchange<false>(r, k);
    if (kTwoD) {
      exchange<true>(r, k);
      // Every halo of every image of the device has landed before any tile
      // is staged.
      for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 4 * r.even.b;
           i += gridDim.x * blockDim.x)
        wait_flag(r.links[i >> 2].flags + flag_index((i >> 1) & 1, k & 1, i & 1),
                  r.epoch0 + k);
      hs_coop::grid_barrier(r.barrier, 2 * k + 1);
    }
    const HaloRing<!kTwoD, RingArgs> ring{r, k};
    walk_owned(smem, k == r.n_full ? r.rem : (k & 1) ? r.odd : r.even, ring);
    if (k + 1 < n_blocks) hs_coop::grid_barrier(r.barrier, kTwoD ? 2 * k + 2 : k + 1);
  }
}

// The bfloat16 build of K11 and K12: the same loop, written out in its own
// kernel (reached through a shared function, a float build's SASS changed:
// solve_fused.cu).
template <bool kTwoD>
__global__ void __launch_bounds__(kThreads, 1) ring_kernel_bf16(const RingArgsBf16 r) {
  extern __shared__ __align__(16) float smem_f[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_f);
  const int n_blocks = r.n_full + (r.rem.sweeps > 0 ? 1 : 0);
  for (int k = 0; k < n_blocks; ++k) {
    exchange<false>(r, k);
    if (kTwoD) {
      exchange<true>(r, k);
      for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 4 * r.even.b;
           i += gridDim.x * blockDim.x)
        wait_flag(r.links[i >> 2].flags + flag_index((i >> 1) & 1, k & 1, i & 1),
                  r.epoch0 + k);
      hs_coop::grid_barrier(r.barrier, 2 * k + 1);
    }
    const HaloRing<!kTwoD, RingArgsBf16> ring{r, k};
    walk_owned(smem, k == r.n_full ? r.rem : (k & 1) ? r.odd : r.even, ring);
    if (k + 1 < n_blocks) hs_coop::grid_barrier(r.barrier, kTwoD ? 2 * k + 2 : k + 1);
  }
}

// -- K11/K12: sweep blocks deeper than K2's window takes ----------------------

// The passes of a sweep block of s sweeps (header: deep sweep blocks): n
// passes, the first of s1 sweeps and the others of q (s = s1 + (n - 1) q,
// each at most kMaxSweeps); n = 1, s1 = s, q = 0 for s <= kMaxSweeps.
struct Passes {
  int n, s1, q;
};

inline Passes ring_passes(int s) {
  Passes p;
  p.n = (s + kMaxSweeps - 1) / kMaxSweeps;
  if (p.n == 1) {
    p.s1 = s;
    p.q = 0;
    return p;
  }
  // q: the multiple of kLaneCols nearest s / n, raised to what keeps s1 at
  // most kMaxSweeps.
  const int near = (s + 2 * p.n) / (4 * p.n) * kLaneCols;
  const int least = ((s - kMaxSweeps + p.n - 2) / (p.n - 1) + kLaneCols - 1) / kLaneCols *
                    kLaneCols;
  p.q = near > least ? near : least;
  if (p.q > kMaxSweeps) p.q = kMaxSweeps;
  p.s1 = s - (p.n - 1) * p.q;
  return p;
}

// The deep build's parameters: one Args a pass role, each from its source
// into its destination (P0, P1 the pairs, Q the scratch pair, par a block's
// parity, n its passes); the Ring gives each pass its rectangle and tiles.
// even and odd double as the exchange's P0 and P1, as RingArgs' do.
template <class A>
struct RingDeepArgsOf {
  A even;         // pass 1 of an even block: P0 into Q
  A odd;          // pass 1 of an odd block: P1 into Q
  A mid[2][2];    // [par][p & 1], 1 < p < n: p even Q into P[par], p odd P[par] into Q
  A last[2];      // [par], pass n: Q (n even) or P[par] (n odd) into P[1 - par]
  A rem_first, rem_mid[2], rem_last;  // the remainder block's, at its parity
  const RingLinkOf<typename A::Elem>* links;
  u64* barrier;
  u64 epoch0;
  int n_full;
  int oy, ox;
  int passes, q;          // the full blocks' n and q (ring_passes)
  int rem_passes, rem_q;  // the remainder block's (rem_passes 0: none)
};
struct RingDeepArgs : RingDeepArgsOf<Args> {};
struct RingDeepArgsBf16 : RingDeepArgsOf<ArgsBf16> {};

// One pass's rectangle (the owned one grown by the sweeps still to come),
// its tiles, its block and whether K11 waits for the halo (the block's
// first pass), written by thread 0 before the pass's walk into shared
// memory, volatile: the walk reads each where it uses it instead of
// holding it in a register through the sweeps (held in registers, they
// made K12's float build spill).
struct PassDesc {
  int oy, ox, tiles_x, tiles_y, k, wait;
};

// The Ring of walk_rect for one pass: the PassDesc's rectangle, and with
// kWait (K11) HaloRing's wait for the row halos (rows above r.oy, below
// a.h - r.oy) that a tile's window reaches, in the block's first pass.
template <bool kWait, class R>
struct PassRing {
  const R& r;
  const volatile PassDesc& d;
  __device__ __forceinline__ int oy() const { return d.oy; }
  __device__ __forceinline__ int ox() const { return d.ox; }
  __device__ __forceinline__ int tiles_x() const { return d.tiles_x; }
  __device__ __forceinline__ int tiles_y() const { return d.tiles_y; }
  template <class A>
  __device__ __forceinline__ void before_stage(const A& a, int t, const Tile& x) const {
    if (!kWait || !d.wait) return;
    const bool top = x.r0 < r.oy;
    const bool bot = min(x.r0 + kWinH, a.h) > a.h - r.oy;
    if (!top && !bot) return;  // the same for every thread of the block
    if (threadIdx.x == 0) {
      int img, ty, tx;
      tile_index_in(a, d.tiles_x, d.tiles_y, t, img, ty, tx);
      const u64* f = r.links[img].flags;
      const int k = d.k;
      if (top) wait_flag(f + flag_index(0, k & 1, 0), r.epoch0 + k);
      if (bot) wait_flag(f + flag_index(0, k & 1, 1), r.epoch0 + k);
    }
    __syncthreads();
  }
};

// K11 (kTwoD false) and K12 with sweep blocks deeper than kMaxSweeps, float
// (R = RingDeepArgs) or bfloat16 (RingDeepArgsBf16). One loop over the
// launch's passes, i, from which the block k and its pass p follow (only i
// lives through the walk): a block's first pass starts with its exchange
// as ring_kernel's, and a grid barrier ends every pass but the launch's
// last. The n-th barrier is i + 1 (K11) or, after block k's exchange, i +
// k + 1 and, after pass i, i + k + 2 (K12).
template <bool kTwoD, class R>
__global__ void __launch_bounds__(kThreads, 1) ring_kernel_deep(const R r) {
  using E = typename decltype(r.even)::Elem;
  extern __shared__ __align__(16) float smem_f[];
  __shared__ volatile PassDesc desc;
  E* smem = reinterpret_cast<E*>(smem_f);
  const int full = r.n_full * r.passes;
  const int steps = full + r.rem_passes;
  for (int i = 0; i < steps; ++i) {
    const bool rem = i >= full;
    const int k = rem ? r.n_full : i / r.passes;
    const int p = rem ? i - full + 1 : i - k * r.passes + 1;
    const int passes = rem ? r.rem_passes : r.passes;
    if (p == 1) {
      exchange<false>(r, k);
      if (kTwoD) {
        exchange<true>(r, k);
        for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < 4 * r.even.b;
             j += gridDim.x * blockDim.x)
          wait_flag(r.links[j >> 2].flags + flag_index((j >> 1) & 1, k & 1, j & 1),
                    r.epoch0 + k);
        hs_coop::grid_barrier(r.barrier, i + k + 1);
      }
    }
    const int par = k & 1;
    const auto& a = p == passes ? (rem ? r.rem_last : r.last[par])
                    : p == 1    ? (rem ? r.rem_first : par ? r.odd : r.even)
                                : (rem ? r.rem_mid[p & 1] : r.mid[par][p & 1]);
    if (threadIdx.x == 0) {
      const int grow = (passes - p) * (rem ? r.rem_q : r.q);
      const int oy = r.oy - grow, ox = kTwoD ? r.ox - grow : 0;
      const Geometry g = geometry(a.sweeps);
      desc.oy = oy;
      desc.ox = ox;
      desc.tiles_x = (a.w - 2 * ox + g.tw - 1) / g.tw;
      desc.tiles_y = (a.h - 2 * oy + g.th - 1) / g.th;
      desc.k = k;
      desc.wait = p == 1;
    }
    __syncthreads();
    walk_rect(smem, a, PassRing<!kTwoD, R>{r, desc});
    if (i + 1 < steps) hs_coop::grid_barrier(r.barrier, kTwoD ? i + k + 2 : i + 1);
  }
}

// The kernel of a build: K11 (kTwoD false) or K12, in float or bfloat16.
template <class A, bool kTwoD>
auto ring_kernel_of() {
  if constexpr (kIsFloat<A>)
    return ring_kernel<kTwoD>;
  else
    return ring_kernel_bf16<kTwoD>;
}

// The deep kernel of a build.
template <class A, bool kTwoD>
auto ring_kernel_deep_of() {
  if constexpr (kIsFloat<A>)
    return ring_kernel_deep<kTwoD, RingDeepArgs>;
  else
    return ring_kernel_deep<kTwoD, RingDeepArgsBf16>;
}

template <class A>
constexpr size_t ring_smem() {
  return kIsFloat<A> ? kSmemBytes : kSmemBytesBf16;
}

}  // namespace

// K10: one launch over the n local shards of `table` (n HaloShard records on
// the device); every pointer may lie on another device that this one can
// reach (hs_enable_peer).
extern "C" int hs_ring_halo_exchange(const void* table, int n, int h, int w,
                                     int halo, int device, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || halo < 1 || halo > h)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  halo_kernel<<<dim3(h, n), kHaloThreads, 0, (cudaStream_t)stream>>>(
      (const HaloShard*)table, h, w, halo);
  return (int)cudaGetLastError();
}

// K10's bfloat16 build: the same arguments, the table's records pointing
// at bfloat16 shards.
extern "C" int hs_ring_halo_exchange_bf16(const void* table, int n, int h, int w,
                                          int halo, int device, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || halo < 1 || halo > h)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  halo_kernel_bf16<<<dim3(h, n), kHaloThreads, 0, (cudaStream_t)stream>>>(
      (const HaloShardBf16*)table, h, w, halo);
  return (int)cudaGetLastError();
}

// Let `device` store into `peer`'s memory: 0 when it can (already enabled
// included), cudaErrorPeerAccessUnsupported when the pair cannot.
extern "C" int hs_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it
    return 0;
  }
  return (int)err;
}

namespace {

template <class A, class Kernel>
int report_of(Kernel kernel, int sweeps, int device, int* out) {
  int grid_max = 0;
  const cudaError_t err = hs_coop::max_blocks(kernel, ring_smem<A>(), kThreads, device,
                                              &grid_max);
  return (int)(err != cudaSuccess
                   ? err
                   : report(kernel, ring_smem<A>(), sweeps, device, grid_max, out));
}

// A block of `sweeps` <= kMaxSweeps: ring_kernel's build; deeper, the deep
// kernel's, with the tile of its passes of q sweeps.
template <class A>
int geometry_of(int sweeps, int two_d, int device, int* out) {
  if (sweeps < 1) return (int)cudaErrorInvalidValue;
  if (sweeps > kMaxSweeps) {
    const int q = ring_passes(sweeps).q;
    return two_d ? report_of<A>(ring_kernel_deep_of<A, true>(), q, device, out)
                 : report_of<A>(ring_kernel_deep_of<A, false>(), q, device, out);
  }
  return two_d ? report_of<A>(ring_kernel_of<A, true>(), sweeps, device, out)
               : report_of<A>(ring_kernel_of<A, false>(), sweeps, device, out);
}

}  // namespace

// Most K11/K12 blocks resident at once on `device`.
extern "C" int hs_ring_blocks(int device, int* blocks) {
  return (int)hs_coop::max_blocks(ring_kernel<false>, kSmemBytes, kThreads, device, blocks);
}

// The same for the bfloat16 build.
extern "C" int hs_ring_blocks_bf16(int device, int* blocks) {
  return (int)hs_coop::max_blocks(ring_kernel_bf16<false>, kSmemBytesBf16, kThreads, device,
                                  blocks);
}

// K11's (two_d 0) or K12's build at `sweeps` on `device`, as
// hs_jacobi_geometry reports K2's:
// out[0..7] tile rows, tile columns, threads, shared bytes, registers a
// thread, spilled bytes a thread, resident blocks a multiprocessor,
// multiprocessors.
extern "C" int hs_ring_geometry(int sweeps, int two_d, int device, int* out) {
  return geometry_of<Args>(sweeps, two_d, device, out);
}

// The same for the bfloat16 build.
extern "C" int hs_ring_geometry_bf16(int sweeps, int two_d, int device, int* out) {
  return geometry_of<ArgsBf16>(sweeps, two_d, device, out);
}

namespace {

// hs_ring_fused_sweeps on arrays of A's storage type E.
template <class A, class E = typename A::Elem>
int ring_sweeps(const void* links, const int* org, E* pu0, E* pv0, E* pu1, E* pv1, E* qu,
                E* qv, const E* ex, const E* ey, const E* et, const E* invd, u64* barrier,
                int b, int h, int w, int sy, int sx, int img_h, int img_w, int n, int s,
                u64 epoch0, int grid, int device, void* stream) {
  const int th = h - 2 * sy, tw = w - 2 * sx;
  const bool deep = s > kMaxSweeps;
  if (links == nullptr || org == nullptr || barrier == nullptr || b < 1 || sy < 1 ||
      sx < 0 || th < sy || tw < 1 || tw < sx || n < 1 || s < 1 || s > sy ||
      (sx > 0 && s > sx) || grid < 1 || epoch0 < 1 ||
      (deep && (qu == nullptr || qv == nullptr)))
    return (int)cudaErrorInvalidValue;
  A a;
  a.ex = ex; a.ey = ey; a.et = et; a.invd = invd; a.org = org;
  a.b = b; a.h = h; a.w = w; a.img_h = img_h; a.img_w = img_w;
  auto all_aligned = [&](unsigned long long n) {
    return aligned(ex, n) && aligned(ey, n) && aligned(et, n) && aligned(invd, n) &&
           aligned(pu0, n) && aligned(pv0, n) && aligned(pu1, n) && aligned(pv1, n) &&
           (!deep || (aligned(qu, n) && aligned(qv, n)));
  };
  // 16 bytes (4 floats) or 8 (4 bfloat16 values) a lane's load or store; 2:
  // bfloat16 rows also staged 16 bytes at a time (bf16_wide). A deep block's
  // passes keep it: their insets differ from sx by multiples of 4.
  a.vec = w % 4 == 0 && sx % 4 == 0 && all_aligned(4 * sizeof(E));
  if (!kIsFloat<A> && a.vec && w % 8 == 0 && all_aligned(16)) a.vec = 2;
  // A sweep block of `sweeps` (0: none) from (su, sv) into (du, dv).
  auto block = [&](int sweeps, E* su, E* sv, E* du, E* dv) {
    A x = a;
    x.u = su;
    x.v = sv;
    x.uo = du;
    x.vo = dv;
    x.sweeps = sweeps;
    const Geometry gx = geometry(sweeps > 0 ? sweeps : 1);
    x.tiles_x = (tw + gx.tw - 1) / gx.tw;
    x.tiles_y = (th + gx.th - 1) / gx.th;
    return x;
  };
  // A deep block's passes walk the rectangle grown up to the whole array.
  const Geometry g = geometry(1);
  const int rows = deep ? h : th, cols = deep ? w : tw;
  if ((long long)b * ((cols + g.tw - 1) / g.tw) * ((rows + g.th - 1) / g.th) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(barrier, 0, sizeof(*barrier), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (deep) {
    typename std::conditional<kIsFloat<A>, RingDeepArgs, RingDeepArgsBf16>::type r;
    E* pair[2][2] = {{pu0, pv0}, {pu1, pv1}};
    E* const q[2] = {qu, qv};
    auto pass = [&](int sweeps, E* const* src, E* const* dst) {
      return block(sweeps, src[0], src[1], dst[0], dst[1]);
    };
    const Passes full = ring_passes(s);
    for (int par = 0; par < 2; ++par) {
      (par ? r.odd : r.even) = pass(full.s1, pair[par], q);
      r.mid[par][0] = pass(full.q, q, pair[par]);
      r.mid[par][1] = pass(full.q, pair[par], q);
      r.last[par] = pass(full.q, full.n % 2 ? pair[par] : q, pair[1 - par]);
    }
    r.n_full = n / s;
    const int rem = n % s, pr = r.n_full % 2;
    const Passes part = ring_passes(rem > 0 ? rem : 1);
    r.rem_first = pass(part.s1, pair[pr], q);
    r.rem_mid[0] = pass(part.q, q, pair[pr]);
    r.rem_mid[1] = pass(part.q, pair[pr], q);
    r.rem_last = pass(part.n > 1 ? part.q : rem, part.n % 2 ? pair[pr] : q, pair[1 - pr]);
    r.passes = full.n;
    r.q = full.q;
    r.rem_passes = rem > 0 ? part.n : 0;
    r.rem_q = part.q;
    r.links = (const RingLinkOf<E>*)links;
    r.barrier = barrier;
    r.epoch0 = epoch0;
    r.oy = sy;
    r.ox = sx;
    void* args[] = {&r};
    const auto kernel =
        sx > 0 ? ring_kernel_deep_of<A, true>() : ring_kernel_deep_of<A, false>();
    return (int)hs_coop::launch(kernel, grid, kThreads, ring_smem<A>(), args, device, stream);
  }
  typename std::conditional<kIsFloat<A>, RingArgs, RingArgsBf16>::type r;
  r.n_full = n / s;
  r.even = block(s, pu0, pv0, pu1, pv1);
  r.odd = block(s, pu1, pv1, pu0, pv0);
  r.rem = r.n_full % 2 ? block(n % s, pu1, pv1, pu0, pv0) : block(n % s, pu0, pv0, pu1, pv1);
  r.links = (const RingLinkOf<E>*)links;
  r.barrier = barrier;
  r.epoch0 = epoch0;
  r.oy = sy;
  r.ox = sx;
  void* args[] = {&r};
  const auto kernel = sx > 0 ? ring_kernel_of<A, true>() : ring_kernel_of<A, false>();
  return (int)hs_coop::launch(kernel, grid, kThreads, ring_smem<A>(), args, device, stream);
}

}  // namespace

// K11 (sx = 0) and K12 (sx > 0): n sweeps of the b images of a device, s a
// sweep block (the last block n mod s), in one cooperative launch of `grid`
// blocks. Each image is h x w, its owned th x tw pixels at (sy, sx), th = h
// - 2 sy, tw = w - 2 sx; (pu0, pv0) and (pu1, pv1) are the pairs P0 and P1,
// (b, h, w) each, with the start in P0's owned pixels; the result lands in
// the owned pixels of P1 when ceil(n/s) is odd, else of P0. (qu, qv) is the
// scratch pair Q of a block deeper than kMaxSweeps (b, h, w each; null for
// s <= kMaxSweeps), local to the device. `links` holds b RingLink records
// and `org` 2b ints, the global origin of each image's element (0, 0) in
// the img_h x img_w image, both on the device; `barrier` is 8 bytes of
// device memory, cleared here on the stream; epochs epoch0 .. epoch0 +
// ceil(n/s) - 1 must exceed every epoch already in the flags. s must not
// exceed the halo (sy, and sx > 0). A grid that cannot be resident is
// refused.
extern "C" int hs_ring_fused_sweeps(const void* links, const int* org, float* pu0, float* pv0,
                                    float* pu1, float* pv1, float* qu, float* qv,
                                    const float* ex, const float* ey, const float* et,
                                    const float* invd, u64* barrier, int b, int h, int w,
                                    int sy, int sx, int img_h, int img_w, int n, int s,
                                    u64 epoch0, int grid, int device, void* stream) {
  return ring_sweeps<Args>(links, org, pu0, pv0, pu1, pv1, qu, qv, ex, ey, et, invd, barrier,
                           b, h, w, sy, sx, img_h, img_w, n, s, epoch0, grid, device, stream);
}

// The bfloat16 build: the same arguments, every array bfloat16.
extern "C" int hs_ring_fused_sweeps_bf16(
    const void* links, const int* org, __nv_bfloat16* pu0, __nv_bfloat16* pv0,
    __nv_bfloat16* pu1, __nv_bfloat16* pv1, __nv_bfloat16* qu, __nv_bfloat16* qv,
    const __nv_bfloat16* ex, const __nv_bfloat16* ey, const __nv_bfloat16* et,
    const __nv_bfloat16* invd, u64* barrier, int b, int h, int w, int sy, int sx, int img_h,
    int img_w, int n, int s, u64 epoch0, int grid, int device, void* stream) {
  return ring_sweeps<ArgsBf16>(links, org, pu0, pv0, pu1, pv1, qu, qv, ex, ey, et, invd,
                               barrier, b, h, w, sy, sx, img_h, img_w, n, s, epoch0, grid,
                               device, stream);
}

// -- across processes: the arenas' CUDA IPC and the flag probe ----------------

namespace {

// Round i (0-based) of `rounds`: the first process releases base + 2i + 1
// into the other's flag and waits for base + 2i + 2 in its own; the second
// waits for base + 2i + 1 and answers with base + 2i + 2.
__global__ void ping_pong_kernel(const u64* mine, u64* theirs, int rounds, int first,
                                 u64 base) {
  for (int i = 0; i < rounds; ++i) {
    const u64 go = base + 2 * (u64)i + 1, back = go + 1;
    if (first) {
      st_release_sys(theirs, go);
      wait_flag(mine, back);
    } else {
      wait_flag(mine, go);
      st_release_sys(theirs, back);
    }
  }
}

}  // namespace

// The bytes of an IPC handle (cudaIpcMemHandle_t), written to *bytes.
extern "C" int hs_ipc_handle_bytes(int* bytes) {
  if (bytes == nullptr) return (int)cudaErrorInvalidValue;
  *bytes = (int)sizeof(cudaIpcMemHandle_t);
  return 0;
}

// A zeroed arena of `bytes` on `device`, and its IPC handle written to
// `handle` (hs_ipc_handle_bytes bytes). The arena lives until hs_ipc_free.
extern "C" int hs_ipc_alloc(int device, unsigned long long bytes, void** ptr, void* handle) {
  if (ptr == nullptr || handle == nullptr || bytes == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return (int)err;
  }
  std::memcpy(handle, &h, sizeof h);
  return 0;
}

// Another process's arena, mapped into this one on `device` (a handle of this
// process's own is refused by CUDA).
extern "C" int hs_ipc_open(int device, const void* handle, void** ptr) {
  if (ptr == nullptr || handle == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// Unmap an arena that hs_ipc_open mapped.
extern "C" int hs_ipc_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaIpcCloseMemHandle(ptr);
}

// Free an arena of this process (hs_ipc_alloc).
extern "C" int hs_ipc_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFree(ptr);
}

// The probe: `rounds` round trips of one flag each way between this process
// (`first` 1 starts) and another, `mine` an 8-byte flag of this process's
// arena and `theirs` one of the other's, mapped; one thread, on `stream`.
// `base` must exceed every value either flag already holds.
extern "C" int hs_ipc_ping_pong(const void* mine, void* theirs, int rounds, int first,
                                unsigned long long base, int device, void* stream) {
  if (mine == nullptr || theirs == nullptr || rounds < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ping_pong_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const u64*)mine, (u64*)theirs, rounds,
                                                       first, base);
  return (int)cudaGetLastError();
}
