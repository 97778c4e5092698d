// K7 hs_solve_skewed_sweeps: all n Jacobi sweeps of a whole Horn-Schunck
// solve in ONE launch, with u and v updated IN PLACE (no second u/v pair),
// over one frame or, one after another, the frames of a (B, H, W) stack.
//
// Replaces the TPU kernels of opticalflowhs_tpu/kernels/solve_skewed.py:
// _skewed_body (lines 125-216) through _skewed_kernel (line 219, called at
// line 279; grid (n_blocks, n_bands)) and _skewed_kernel_b (line 229, called
// at line 383; grid (B, n_blocks, n_bands), zero start). On the TPU u and v
// live in VMEM for the whole solve and are updated in place; the order is
// made correct by time skewing over row bands: before band i overwrites its
// rows, the OLD values of its last sigma rows are saved to a pencil, and
// band i+1 reads its window's top rows from that pencil.
//
// Hopper design: the same schedule on K2's window loop (k2_window.cuh) in a
// persistent cooperative grid of K2's blocks (512 threads, one an SM). The
// working memory is the two output arrays (u, v, written in place) and two
// pencils of s x w for each of u and v. Sweep block k (s sweeps, the last
// one the remainder at its own K2 tile, sigma = the block's sweeps) walks
// bands of `band_ty` rows of K2 tiles top to bottom; each block owns up to
// m (1-3) tiles of a band: blockIdx.x + j * gridDim.x. A band step:
//   1. every window of the band has landed in shared memory: rows above the
//      band from pencil i % 2 (saved by band i-1), the rest from u/v, all
//      still old (from zeros or u0/v0 at block 0); the tiles that hold the
//      band's last sigma rows save them, old, from their windows into
//      pencil (i + 1) % 2;
//   2. grid barrier: every window of the band is read before any write;
//   3. each block sweeps its tiles (fields in registers, K2's sweeps) and
//      writes their owned rows in place from registers; meanwhile cp.async
//      stages the next band step's windows into u/v pairs that are free.
// Shared memory holds four u/v pairs of the 48 x 128 window (196,608
// bytes) in a fixed schedule by m (`win_pair`): the band's m windows, a
// second buffer for the tile that sweeps, and the next step's windows in
// pairs as they free up (m = 1, 2: all of them behind the sweeps; m = 3:
// the last one exposed). The step's state lives in shared memory, so that
// the sweeps keep K2's registers.
// The next band reads only rows below this band and the pencil saved
// before this band's barrier, so it is staged while this band writes. Band
// 0 of the next sweep block reads rows of this block's bands 0 and 1: it is
// staged behind the last band's sweeps only where its windows end above
// the last band (3 or more bands, complete at the last band's barrier);
// otherwise one more barrier ends the sweep block first. Rows outside the
// image are never staged (zero-fill), so the band-0 pencil and the TPU's
// pad rows have no counterpart here. u, v and the pencils, written during
// the launch, are read around the SM's L1 (cp.async.cg, or __ldcg on the
// 4-byte path of unaligned views).
//
// The grid is as many blocks as can be resident; m and band_ty come from a
// cost rule (kernels/solve_skewed.py `geometry`): the sum over the bands of
// the most tiles a block has in the band and a barrier's share, a band's
// tiles at most m x grid.
//
// Bound: as K6 per sweep block (8 arrays, 79 us at 2160x3840 at 3.35 TB/s)
// and for the whole solve (2,709 float32 operations a pixel at i100, 335 us
// at 4K at 67 TFLOP/s). What it saves is memory: one u/v pair, 2*h*w*4
// bytes (66 MB at 4K), against K6 and the K1 + K2 chain. What it costs: a
// grid barrier a band step (7 a sweep block at 4K, m = 3), the bands'
// last tiles filling only part of the card, and one exposed window a step
// at m = 3.
//
// bfloat16 (hs_solve_skewed_sweeps_bf16): the same launch on K2's bfloat16
// walk (k2_window.cuh's storage types: u and v rounded at the end of every
// sweep, four bfloat16 pairs, 98,304 bytes of shared memory); the pencils
// hold bfloat16 and the band copies move a lane's 4 values as 8 bytes.
//
// Exactness: K2's sweeps on K2's tiles, so K7 equals the plain sweeps (and
// the K1 + K2 chain) bitwise.

#include <cuda_runtime.h>

#include "cooperative.cuh"
#include "k2_window.cuh"

namespace {

using namespace hs_k2;

constexpr int kPairs = 4;
constexpr size_t kSmemBytes = kPairs * kPairBytes;
constexpr size_t kSmemBytesBf16 = kPairs * pair_bytes<ArgsBf16>();
constexpr int kMaxTiles = 3;  // m: tiles a block a band

// The sweeps read their Args from the kernel's parameters (`full`, or
// `rem` for the remainder block), as a K2 launch does; read from shared
// memory or held in registers they ran slower.
template <class A>
struct SkewArgsOf {
  using E = typename A::Elem;
  A a;                    // the frame or stack and its fields; a.uo/a.vo = u/v
  A full, rem;            // a's sweeps and tiles at s and at n mod s (0: none)
  const E *u0, *v0;       // the start, or null for zeros
  E *pu, *pv;             // two pencils of s x w each
  unsigned long long* barrier;  // the grid barrier's count, zero at the start
  int n, s, m, band_ty;   // band_ty: tile rows a band
};
struct SkewArgs : SkewArgsOf<Args> {};
struct SkewArgsBf16 : SkewArgsOf<ArgsBf16> {};

// One band step: image, sweep block, band, and what follows from them.
struct Step {
  int img, k, i;
  int ns;            // sweeps of the block (its halo and pencil rows)
  int tiles_x, ty0;  // tiles a row, the band's first tile row
  int tiles;         // tiles of the band
  int r0, r_end;     // the band's rows
  int n_bands;
};

template <class A>
__device__ __forceinline__ Step step_at(const SkewArgsOf<A>& f, int img, int k, int i) {
  Step st;
  st.img = img;
  st.k = k;
  st.i = i;
  const int n_full = f.n / f.s;
  st.ns = k < n_full ? f.s : f.n - n_full * f.s;
  const Geometry g = geometry(st.ns);
  st.tiles_x = (f.a.w + g.tw - 1) / g.tw;
  const int tiles_y = (f.a.h + g.th - 1) / g.th;
  st.n_bands = (tiles_y + f.band_ty - 1) / f.band_ty;
  st.ty0 = i * f.band_ty;
  const int nty = min(f.band_ty, tiles_y - st.ty0);
  st.tiles = nty * st.tiles_x;
  st.r0 = st.ty0 * g.th;
  st.r_end = min(f.a.h, (st.ty0 + nty) * g.th);
  return st;
}

// The step after `st` into *nx; false after the last.
template <class A>
__device__ __forceinline__ bool next_step(const SkewArgsOf<A>& f, const Step& st, Step* nx) {
  int img = st.img, k = st.k, i = st.i + 1;
  if (i == st.n_bands) {
    i = 0;
    if (++k == (f.n + f.s - 1) / f.s) {
      k = 0;
      if (++img == f.a.b) return false;
    }
  }
  *nx = step_at(f, img, k, i);
  return true;
}

// The arguments of a step's staging and pencil (its sweeps take f.full or
// f.rem).
template <class A>
__device__ __forceinline__ A step_args(const SkewArgsOf<A>& f, const Step& st) {
  A a = f.a;
  a.sweeps = st.ns;
  a.tiles_x = st.tiles_x;
  if (st.k == 0 && f.u0 != nullptr) {
    a.u = f.u0;
    a.v = f.v0;
  }  // else u/v in place, or (k = 0, no u0) zeros: live false
  return a;
}

template <class A>
__device__ __forceinline__ Tile step_tile(const A& a, const Step& st, int t) {
  const int ty = t / st.tiles_x;
  return tile_rc(a, geometry(st.ns), st.img, st.ty0 + ty, t - ty * st.tiles_x);
}

// The pair of this block's j-th window of step q, and the pair its sweeps
// use as a second buffer: a fixed schedule by m in which the next step's
// windows go into pairs that are free when they are staged (`skewed_kernel`).
//   m = 1: windows in pair 0 or 2 by the step's parity, sweeps in 1 or 3;
//   m = 2: windows in two of pairs 0-2, rotating by one a step (the next
//          step's first window in the third, its second in this step's
//          first once that is swept), sweeps in pair 3;
//   m = 3: window j in pair j, sweeps in pair 3.
__device__ __forceinline__ int win_pair(int m, int q, int j) {
  if (m == 1) return 2 * (q & 1);
  if (m == 2) return ((3 - q % 3) % 3 + j) % 3;
  return j;
}

__device__ __forceinline__ int scratch_pair(int m, int q) {
  return m == 1 ? 2 * (q & 1) + 1 : 3;
}

// Starts the staging of this block's j-th tile of step st into `pair`:
// window rows above the band from the pencil the band above saved, the rest
// from u/v (zeros at a zero start); outside the array zeros.
template <class A>
__device__ __forceinline__ void stage_step_tile(typename A::Elem* smem, int pair,
                                                const SkewArgsOf<A>& f, const Step& st,
                                                int j, int row0, int col0) {
  const A a = step_args(f, st);
  const Tile t = step_tile(a, st, blockIdx.x + j * gridDim.x);
  const bool live = st.k > 0 || f.u0 != nullptr;
  const long long pen = (long long)(st.i % 2) * f.s * a.w;
  const int top = st.r0 - st.ns;  // the pencil's first row
  const int ac = t.c0 + col0;
  typename A::Elem* pu = smem + 2 * pair * kArea;
  if constexpr (!kIsFloat<A>) {
    if (bf16_wide(a.vec, t.c0)) {  // the even lanes' 16-byte copies
      if ((col0 & kLaneCols) == 0) {
        const bool col_in = ac >= 0 && ac < a.w;
#pragma unroll
        for (int jj = 0; jj < kRows; ++jj) {
          const int wr = row0 + jj;
          const int ar = t.r0 + wr;
          typename A::Elem* du = pu + wr * kWinW + col0;
          if (ar >= 0 && ar < st.r0) {  // above the band, inside the image
            const long long g = pen + (long long)(ar - top) * a.w + ac;
            copy16(du, col_in ? f.pu + g : f.pu, col_in);
            copy16(du + kArea, col_in ? f.pv + g : f.pv, col_in);
          } else {
            const long long g = t.base + (long long)ar * a.w + ac;
            const bool in = live && col_in && ar >= 0 && ar < a.h;
            copy16(du, in ? a.u + g : a.u, in);
            copy16(du + kArea, in ? a.v + g : a.v, in);
          }
        }
      }
      copy_commit();
      return;
    }
  }
  // One row at a time: on the 4-byte path the loads go through registers.
#pragma unroll 1
  for (int jj = 0; jj < kRows; ++jj) {
    const int wr = row0 + jj;
    const int ar = t.r0 + wr;
    typename A::Elem* du = pu + wr * kWinW + col0;
    if (ar >= 0 && ar < st.r0) {  // above the band, inside the image
      const long long g = pen + (long long)(ar - top) * a.w + ac;
      copy_quad<true>(du, f.pu, g, a.vec, true, ac, a.w, true);
      copy_quad<true>(du + kArea, f.pv, g, a.vec, true, ac, a.w, true);
    } else {
      const long long g = t.base + (long long)ar * a.w + ac;
      const bool row_in = ar >= 0 && ar < a.h;
      copy_quad<true>(du, a.u, g, a.vec, row_in, ac, a.w, live);
      copy_quad<true>(du + kArea, a.v, g, a.vec, row_in, ac, a.w, live);
    }
  }
  copy_commit();
}

// Whether this block has a j-th tile in step st.
__device__ __forceinline__ bool has_tile(const Step& st, int j) {
  return (int)(blockIdx.x + j * gridDim.x) < st.tiles;
}

// Saves the band's last ns rows, still old, from this block's landed
// windows into pencil (i + 1) % 2: each thread its own staged pixels of
// the owned tiles.
template <class A>
__device__ __forceinline__ void save_pencil(const typename A::Elem* smem,
                                            const SkewArgsOf<A>& f, const Step& st, int q,
                                            int row0, int col0) {
  if (st.r_end >= f.a.h) return;
  const A a = step_args(f, st);
  const Geometry g = geometry(st.ns);
  const long long pen = (long long)((st.i + 1) % 2) * f.s * a.w;
  const int top = st.r_end - st.ns;
  for (int j = 0; j < f.m && has_tile(st, j); ++j) {
    const Tile t = step_tile(a, st, blockIdx.x + j * gridDim.x);
    const typename A::Elem* su = smem + 2 * win_pair(f.m, q, j) * kArea;
    const int ac = t.c0 + col0;
#pragma unroll
    for (int jj = 0; jj < kRows; ++jj) {
      const int wr = row0 + jj;
      const int ar = t.r0 + wr;
      if (ar < top || ar >= st.r_end) continue;
      const long long p = pen + (long long)(ar - top) * a.w + ac;
      if constexpr (!kIsFloat<A>) {
        // bfloat16: the staged values as they are, 8 bytes a lane.
        const unsigned short* us =
            reinterpret_cast<const unsigned short*>(su) + wr * kWinW + col0;
        const unsigned short* vs = us + kArea;
        unsigned short* pu = reinterpret_cast<unsigned short*>(f.pu) + p;
        unsigned short* pv = reinterpret_cast<unsigned short*>(f.pv) + p;
        if (a.vec && col0 >= g.lh && col0 + kLaneCols <= g.lh + g.tw && ac < a.w) {
          *reinterpret_cast<uint2*>(pu) = *reinterpret_cast<const uint2*>(us);
          *reinterpret_cast<uint2*>(pv) = *reinterpret_cast<const uint2*>(vs);
        } else {
#pragma unroll
          for (int c = 0; c < kLaneCols; ++c) {
            if (col0 + c >= g.lh && col0 + c < g.lh + g.tw && ac + c < a.w) {
              pu[c] = us[c];
              pv[c] = vs[c];
            }
          }
        }
      } else {
        const float4 u4 = ld4(su, wr, col0), v4 = ld4(su + kArea, wr, col0);
        const float us[kLaneCols] = {u4.x, u4.y, u4.z, u4.w};
        const float vs[kLaneCols] = {v4.x, v4.y, v4.z, v4.w};
        if (a.vec && col0 >= g.lh && col0 + kLaneCols <= g.lh + g.tw && ac < a.w) {
          *reinterpret_cast<float4*>(f.pu + p) = u4;
          *reinterpret_cast<float4*>(f.pv + p) = v4;
        } else {
#pragma unroll
          for (int c = 0; c < kLaneCols; ++c) {
            if (col0 + c >= g.lh && col0 + c < g.lh + g.tw && ac + c < a.w) {
              f.pu[p + c] = us[c];
              f.pv[p + c] = vs[c];
            }
          }
        }
      }
    }
  }
}

// The sweeps of this block's j-th tile of step st (its window in
// win_pair(m, q, j)), written in place; `a` is f.full or f.rem.
template <class A>
__device__ __forceinline__ void sweep_step_tile(typename A::Elem* smem, const A& a,
                                                const Step& st, int m, int q, int j,
                                                int row0, int col0) {
  const Tile tile = step_tile(a, st, blockIdx.x + j * gridDim.x);
  Fields fl;
  load_fields(fl, a, tile, row0, col0);
  Lane ln;
  ln.row0 = row0;
  ln.col0 = col0;
  int cur = win_pair(m, q, j), dst = scratch_pair(m, q);
  sweep_tile<false>(smem, cur, dst, a, geometry(a.sweeps), tile, ln, fl);
}

// The kernel's band steps, on arrays of A's storage type.
template <class A>
__device__ __forceinline__ void skewed_steps(typename A::Elem* smem, const SkewArgsOf<A>& f) {
  // The step (sh[q & 1]) and the next (sh[(q + 1) & 1]) live in shared
  // memory and are read where they are used, so that they hold no registers
  // across the sweeps (K2's sweeps leave none of the 128 a thread).
  __shared__ Step sh[2];
  __shared__ int sh_next;  // 0: the last step; 1: the next one staged behind
                           // the sweeps; 2: staged after one more barrier
  __shared__ unsigned long long sh_barriers;  // grid barriers so far (thread 0's)
  const int row0 = (threadIdx.x >> 5) * kRows, col0 = (threadIdx.x & 31) * kLaneCols;
  const int m = f.m;
  if (threadIdx.x == 0) {
    sh[0] = step_at(f, 0, 0, 0);
    sh_barriers = 0;
  }
  __syncthreads();
  for (int j = 0; j < m && has_tile(sh[0], j); ++j)
    stage_step_tile(smem, win_pair(m, 0, j), f, sh[0], j, row0, col0);
  for (int q = 0;; ++q) {
    copy_wait<0>();
    save_pencil(smem, f, sh[q & 1], q, row0, col0);
    // Every window of the band is staged before any write (only thread 0
    // counts the barriers and waits).
    hs_coop::grid_barrier(f.barrier, threadIdx.x == 0 ? ++sh_barriers : 0ull);
    if (threadIdx.x == 0) {
      const Step& st = sh[q & 1];
      Step& nx = sh[(q + 1) & 1];
      // Band 0 of the next sweep block reads rows the bands above wrote;
      // those of bands before this one are complete at this band's barrier.
      sh_next = !next_step(f, st, &nx) ? 0
                : nx.i > 0 || nx.img != st.img || min(f.a.h, nx.r_end + nx.ns) <= st.r0
                    ? 1
                    : 2;
    }
    __syncthreads();
    // The next step's windows go into pairs free at that point: window j
    // before slot j for m <= 2, after it (before slot j + 1, or after the
    // last slot) for m = 3.
    const int lag = m == 3 ? 1 : 0;
    for (int j = 0; j <= m; ++j) {
      const int jn = j - lag;
      if (sh_next == 1 && jn >= 0 && jn < m && has_tile(sh[(q + 1) & 1], jn))
        stage_step_tile(smem, win_pair(m, q + 1, jn), f, sh[(q + 1) & 1], jn, row0, col0);
      if (j < m && has_tile(sh[q & 1], j)) {
        if (sh[q & 1].ns == f.s)
          sweep_step_tile(smem, f.full, sh[q & 1], m, q, j, row0, col0);
        else
          sweep_step_tile(smem, f.rem, sh[q & 1], m, q, j, row0, col0);
        __syncthreads();  // the tile's pairs are free again
      }
    }
    if (sh_next == 0) break;
    if (sh_next == 2) {
      // This sweep block's writes land before the next block reads them.
      hs_coop::grid_barrier(f.barrier, threadIdx.x == 0 ? ++sh_barriers : 0ull);
      for (int j = 0; j < m && has_tile(sh[(q + 1) & 1], j); ++j)
        stage_step_tile(smem, win_pair(m, q + 1, j), f, sh[(q + 1) & 1], j, row0, col0);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) skewed_kernel(const SkewArgs f) {
  extern __shared__ __align__(16) float smem[];
  skewed_steps<Args>(smem, f);
}

__global__ void __launch_bounds__(kThreads, 1) skewed_kernel_bf16(const SkewArgsBf16 f) {
  extern __shared__ __align__(16) float smem[];
  skewed_steps<ArgsBf16>(reinterpret_cast<__nv_bfloat16*>(smem), f);
}

// hs_solve_skewed_sweeps on arrays of A's storage type E, F its kernel's
// arguments (SkewArgs or SkewArgsBf16).
template <class F, class A, class E = typename A::Elem, class Kernel>
int skewed_sweeps(Kernel kernel, size_t smem, const E* u0, const E* v0, const E* ex,
                  const E* ey, const E* et, const E* invd, E* u, E* v, E* pu, E* pv,
                  unsigned long long* barrier, int b, int h, int w, int n, int s, int m,
                  int band_ty, int grid, int device, void* stream) {
  if (b < 1 || h < 1 || w < 1 || n < 1 || s < 1 || s > kMaxSweeps || m < 1 ||
      m > kMaxTiles || band_ty < 1 || grid < 1 || (u0 == nullptr) != (v0 == nullptr) ||
      barrier == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(s);
  const long long tiles_x = (w + g.tw - 1) / g.tw, tiles_y = (h + g.th - 1) / g.th;
  if ((band_ty < tiles_y ? band_ty : tiles_y) * tiles_x > (long long)m * grid)
    return (int)cudaErrorInvalidValue;
  F f;
  A& a = f.a;
  a.u = u; a.v = v; a.ex = ex; a.ey = ey; a.et = et; a.invd = invd;
  a.uo = u; a.vo = v; a.org = nullptr;
  a.b = b; a.h = h; a.w = w; a.img_h = h; a.img_w = w;
  a.sweeps = s; a.tiles_x = (int)tiles_x; a.tiles_y = (int)tiles_y;
  auto all_aligned = [&](unsigned long long n) {
    return aligned(ex, n) && aligned(ey, n) && aligned(et, n) && aligned(invd, n) &&
           aligned(u, n) && aligned(v, n) && aligned(pu, n) && aligned(pv, n) &&
           (u0 == nullptr || (aligned(u0, n) && aligned(v0, n)));
  };
  // 16 bytes (4 floats) or 8 (4 bfloat16 values) a lane's load or store; 2:
  // bfloat16 rows also staged 16 bytes at a time (bf16_wide).
  a.vec = w % 4 == 0 && all_aligned(4 * sizeof(E));
  if (sizeof(E) == 2 && a.vec && w % 8 == 0 && all_aligned(16)) a.vec = 2;
  f.full = f.rem = a;
  const Geometry gr = geometry(n % s > 0 ? n % s : s);
  f.rem.sweeps = n % s;
  f.rem.tiles_x = (w + gr.tw - 1) / gr.tw;
  f.rem.tiles_y = (h + gr.th - 1) / gr.th;
  f.u0 = u0; f.v0 = v0; f.pu = pu; f.pv = pv;
  f.n = n; f.s = s; f.m = m; f.band_ty = band_ty;
  f.barrier = barrier;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(barrier, 0, sizeof(*barrier), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&f};
  return (int)hs_coop::launch(kernel, grid, kThreads, smem, args, device, stream);
}

}  // namespace

// Most blocks of K7 that can be resident at once on `device`.
extern "C" int hs_solve_skewed_blocks(int device, int* blocks) {
  return (int)hs_coop::max_blocks(skewed_kernel, kSmemBytes, kThreads, device, blocks);
}

// The same for K7's bfloat16 build.
extern "C" int hs_solve_skewed_blocks_bf16(int device, int* blocks) {
  return (int)hs_coop::max_blocks(skewed_kernel_bf16, kSmemBytesBf16, kThreads, device,
                                  blocks);
}

// K7's build at `sweeps` on `device`, as hs_jacobi_geometry reports K2's:
// out[0..7] tile rows, tile columns, threads, shared bytes, registers a
// thread, spilled bytes a thread, resident blocks a multiprocessor,
// multiprocessors.
extern "C" int hs_solve_skewed_geometry(int sweeps, int device, int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  int grid_max = 0;
  const int err = hs_solve_skewed_blocks(device, &grid_max);
  if (err != 0) return err;
  return (int)report(skewed_kernel, kSmemBytes, sweeps, device, grid_max, out);
}

// The same for K7's bfloat16 build.
extern "C" int hs_solve_skewed_geometry_bf16(int sweeps, int device, int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  int grid_max = 0;
  const int err = hs_solve_skewed_blocks_bf16(device, &grid_max);
  if (err != 0) return err;
  return (int)report(skewed_kernel_bf16, kSmemBytesBf16, sweeps, device, grid_max, out);
}

// n sweeps in place in (u, v), from (u0, v0) or from zeros when u0 is
// null, over b images of h x w, one after another, s a sweep block (the
// last block n mod s); pu/pv hold 2*s*w floats each. Bands of band_ty rows
// of K2 tiles; each block takes m <= 3 tiles a band, so a band's tiles
// must not outnumber m * grid. `barrier` is 8 bytes of device memory for
// the grid barrier, cleared here on the stream. One cooperative launch of
// `grid` blocks on `stream`; a grid that cannot be resident is refused.
extern "C" int hs_solve_skewed_sweeps(const float* u0, const float* v0,
                                      const float* ex, const float* ey,
                                      const float* et, const float* invd,
                                      float* u, float* v, float* pu,
                                      float* pv, unsigned long long* barrier, int b,
                                      int h, int w, int n, int s, int m, int band_ty,
                                      int grid, int device, void* stream) {
  return skewed_sweeps<SkewArgs, Args>(skewed_kernel, kSmemBytes, u0, v0, ex, ey, et, invd,
                                       u, v, pu, pv, barrier, b, h, w, n, s, m, band_ty,
                                       grid, device, stream);
}

// K7's bfloat16 build: the same arguments, every array (the pencils too)
// bfloat16.
extern "C" int hs_solve_skewed_sweeps_bf16(
    const __nv_bfloat16* u0, const __nv_bfloat16* v0, const __nv_bfloat16* ex,
    const __nv_bfloat16* ey, const __nv_bfloat16* et, const __nv_bfloat16* invd,
    __nv_bfloat16* u, __nv_bfloat16* v, __nv_bfloat16* pu, __nv_bfloat16* pv,
    unsigned long long* barrier, int b, int h, int w, int n, int s, int m, int band_ty,
    int grid, int device, void* stream) {
  return skewed_sweeps<SkewArgsBf16, ArgsBf16>(skewed_kernel_bf16, kSmemBytesBf16, u0, v0,
                                               ex, ey, et, invd, u, v, pu, pv, barrier, b,
                                               h, w, n, s, m, band_ty, grid, device,
                                               stream);
}
