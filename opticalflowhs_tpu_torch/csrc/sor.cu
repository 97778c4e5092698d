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
// Only this source includes the K3 code below, all of it in an unnamed
// namespace; from k2_window.cuh it takes the window's width (a warp's 32
// lanes of 4 columns), the constants and the copy helpers as they are.

#include <cuda_runtime.h>

#include "k2_window.cuh"

namespace {

using hs_k2::aligned;
using hs_k2::copy_commit;
using hs_k2::copy_quad;
using hs_k2::copy_wait;
using hs_k2::kLaneCols;  // 4 adjacent columns a lane owns
using hs_k2::kThird;
using hs_k2::kTwelfth;
using hs_k2::kWinW;  // 128: one warp spans the window
using hs_k2::st4;

constexpr int kRows = 4;                   // rows a thread owns
constexpr int kWarps = 12;
constexpr int kThreads = 32 * kWarps;      // 384
constexpr int kWinH = kWarps * kRows;      // 48
constexpr int kArea = kWinH * kWinW;
// Shared arrays: two u/v pairs (one swept, one staged) and the four fields.
constexpr int kPairs = 2;
constexpr size_t kSmemBytes = (size_t)(2 * kPairs + 4) * kArea * sizeof(float);
constexpr int kMaxSweeps = (kWinH - kRows) / 4;  // 11: a tile of 4 rows
constexpr int kMaxBatch = 65535;
constexpr unsigned kFull = 0xffffffffu;

// The tile of s sweeps: the window less 2s rows above and below and 4s
// columns on each side.
struct Geometry {
  int th, tw;
};

__host__ __device__ inline Geometry geometry(int s) {
  Geometry g;
  g.th = kWinH - 4 * s;
  g.tw = kWinW - 8 * s;
  return g;
}

struct Args {
  const float *u, *v, *ex, *ey, *et, *invd;
  float *uo, *vo;
  const int* org;  // K9: per-image global origins; null otherwise
  int b, h, w, img_h, img_w, sweeps, tiles_x, tiles_y;
  int vec;  // 16-byte copies and stores
  float omega;
};

// One tile: its image, the window's origin in the image's array, its
// global origin, and the window rows inside the array.
struct Tile {
  long long base;
  int r0, c0, org_r, org_c, wr_lo, wr_hi;
};

template <bool kShard>
__device__ __forceinline__ Tile tile_at(const Args& a, const Geometry& g, int t) {
  const int per_img = a.tiles_x * a.tiles_y;
  const int img = t / per_img;
  const int rem = t - img * per_img;
  const int ty = rem / a.tiles_x;
  const int tx = rem - ty * a.tiles_x;
  Tile x;
  x.base = (long long)img * a.h * a.w;
  x.r0 = ty * g.th - 2 * a.sweeps;
  x.c0 = tx * g.tw - 4 * a.sweeps;
  x.org_r = kShard ? a.org[2 * img] : 0;
  x.org_c = kShard ? a.org[2 * img + 1] : 0;
  x.wr_lo = max(0, -x.r0);
  x.wr_hi = min(kWinH, a.h - x.r0);
  return x;
}

// A thread's place in the window and what it needs for a tile: bit jj of
// tcl (bcl) clamps row jj's i-1 (i+1) to the row itself, bit q of lcl
// (rcl) column q's j-1 (j+1); own marks the columns of the owned tile.
struct Lane {
  int row0, col0;
  unsigned tcl, bcl, lcl, rcl, own;
};

// u and v of a thread's 4 x 4 pixels, and the fields there.
struct Own {
  float u[kRows][kLaneCols], v[kRows][kLaneCols];
  float x[kRows][kLaneCols], y[kRows][kLaneCols], t[kRows][kLaneCols],
      i[kRows][kLaneCols];
};

__device__ __forceinline__ void ld4(float (&d)[kLaneCols], const float* s, int r, int c) {
  const float4 x = *reinterpret_cast<const float4*>(s + r * kWinW + c);
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}

// Starts the copies of a thread's pixels of a tile's window, u and v into
// the pair `pair` and the four fields into theirs; zero outside the array.
__device__ __forceinline__ void stage_tile(float* smem, int pair, const Args& a,
                                           const Tile& t, const Lane& ln) {
  float* pu = smem + 2 * pair * kArea;
  float* pf = smem + 2 * kPairs * kArea;
  const int ac = t.c0 + ln.col0;
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int wr = ln.row0 + jj;
    const int ar = t.r0 + wr;
    const bool row_in = ar >= 0 && ar < a.h;
    const long long g = t.base + (long long)ar * a.w + ac;
    const int o = wr * kWinW + ln.col0;
    copy_quad<false>(pu + o, a.u, g, a.vec, row_in, ac, a.w, true);
    copy_quad<false>(pu + kArea + o, a.v, g, a.vec, row_in, ac, a.w, true);
    copy_quad<false>(pf + o, a.ex, g, a.vec, row_in, ac, a.w, true);
    copy_quad<false>(pf + kArea + o, a.ey, g, a.vec, row_in, ac, a.w, true);
    copy_quad<false>(pf + 2 * kArea + o, a.et, g, a.vec, row_in, ac, a.w, true);
    copy_quad<false>(pf + 3 * kArea + o, a.invd, g, a.vec, row_in, ac, a.w, true);
  }
  copy_commit();
}

// A thread's staged pixels, from shared memory into registers.
__device__ __forceinline__ void load_own(Own& o, const float* smem, int pair, const Lane& ln) {
  const float* pu = smem + 2 * pair * kArea;
  const float* pf = smem + 2 * kPairs * kArea;
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int r = ln.row0 + jj;
    ld4(o.u[jj], pu, r, ln.col0);
    ld4(o.v[jj], pu + kArea, r, ln.col0);
    ld4(o.x[jj], pf, r, ln.col0);
    ld4(o.y[jj], pf + kArea, r, ln.col0);
    ld4(o.t[jj], pf + 2 * kArea, r, ln.col0);
    ld4(o.i[jj], pf + 3 * kArea, r, ln.col0);
  }
}

// One color stage on columns kA and kA + 2 of a lane's 4 at one row: the
// neighbour average from the column sums tu, tv (the neighbouring lane's
// by a shuffle: left of column 0 for kA = 0, right of column 3 for kA = 1),
// the HS target, and the blend, in place in mu, mv. neighbor_avg: s =
// (t(j-1) + 2t) + t(j+1), then s/12 - a/3.
template <int kA, bool kClamp>
__device__ __forceinline__ void stage_cols(float (&mu)[kLaneCols], float (&mv)[kLaneCols],
                                           const float (&tu)[kLaneCols],
                                           const float (&tv)[kLaneCols],
                                           const float (&fx)[kLaneCols],
                                           const float (&fy)[kLaneCols],
                                           const float (&ft)[kLaneCols],
                                           const float (&fi)[kLaneCols], const Lane& ln,
                                           float omega) {
  const float nu = kA == 0 ? __shfl_up_sync(kFull, tu[3], 1) : __shfl_down_sync(kFull, tu[0], 1);
  const float nv = kA == 0 ? __shfl_up_sync(kFull, tv[3], 1) : __shfl_down_sync(kFull, tv[0], 1);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = kA + 2 * e;
    float lu = q == 0 ? nu : tu[q > 0 ? q - 1 : 0];
    float lv = q == 0 ? nv : tv[q > 0 ? q - 1 : 0];
    float ru = q == 3 ? nu : tu[q < 3 ? q + 1 : 3];
    float rv = q == 3 ? nv : tv[q < 3 ? q + 1 : 3];
    if (kClamp) {
      if (ln.lcl >> q & 1u) {
        lu = tu[q];
        lv = tv[q];
      }
      if (ln.rcl >> q & 1u) {
        ru = tu[q];
        rv = tv[q];
      }
    }
    const float ubar = ((lu + 2.0f * tu[q]) + ru) * kTwelfth - mu[q] * kThird;
    const float vbar = ((lv + 2.0f * tv[q]) + rv) * kTwelfth - mv[q] * kThird;
    const float frac = ((fx[q] * ubar + fy[q] * vbar) + ft[q]) * fi[q];
    const float un = ubar - fx[q] * frac;
    const float vn = vbar - fy[q] * frac;
    mu[q] = mu[q] + omega * (un - mu[q]);
    mv[q] = mv[q] + omega * (vn - mv[q]);
  }
}

// The column sums (a(i-1) + 2a) + a(i+1) of columns q in `cols` (a bit
// set) of one row; with kClamp, tc (bc) takes the row itself as i-1 (i+1).
template <bool kClamp>
__device__ __forceinline__ void col_sums(float (&t)[kLaneCols], const float (&top)[kLaneCols],
                                         const float (&mid)[kLaneCols],
                                         const float (&bot)[kLaneCols], bool tc, bool bc,
                                         unsigned cols) {
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) {
    if (!(cols >> q & 1u)) continue;
    const float a = kClamp && tc ? mid[q] : top[q];
    const float b = kClamp && bc ? mid[q] : bot[q];
    t[q] = (a + 2.0f * mid[q]) + b;
  }
}

// Both color stages of one row: (x, kPc) then (x, 1 - kPc) in the
// columns' global parity, the sums of the first stage's columns formed
// again between them.
template <int kPc, bool kClamp>
__device__ __forceinline__ void update_row(const float (&ut)[kLaneCols], float (&um)[kLaneCols],
                                           const float (&ub)[kLaneCols],
                                           const float (&vt)[kLaneCols], float (&vm)[kLaneCols],
                                           const float (&vb)[kLaneCols], Own& o, int jj,
                                           bool tc, bool bc, const Lane& ln, float omega) {
  float tu[kLaneCols], tv[kLaneCols];
  col_sums<kClamp>(tu, ut, um, ub, tc, bc, 0xfu);
  col_sums<kClamp>(tv, vt, vm, vb, tc, bc, 0xfu);
  stage_cols<kPc, kClamp>(um, vm, tu, tv, o.x[jj], o.y[jj], o.t[jj], o.i[jj], ln, omega);
  const unsigned first = kPc == 0 ? 0x5u : 0xau;
  col_sums<kClamp>(tu, ut, um, ub, tc, bc, first);
  col_sums<kClamp>(tv, vt, vm, vb, tc, bc, first);
  stage_cols<1 - kPc, kClamp>(um, vm, tu, tv, o.x[jj], o.y[jj], o.t[jj], o.i[jj], ln, omega);
}

// One half sweep on a thread's rows kA and kA + 2 (the rows of one global
// parity): the row beside them that another warp owns (above for kA = 0,
// below for kA = 1; the window's own first or last row at its edges) from
// shared memory, the rest from registers; then the boundary row the half
// changed (the thread's first or last) to shared memory for the
// neighbouring warp.
template <int kA, int kPc, bool kEdge>
__device__ __forceinline__ void half_sweep(float* su, float* sv, Own& o, const Lane& ln,
                                           float omega) {
  const int hr = kA == 0 ? max(ln.row0 - 1, 0) : min(ln.row0 + kRows, kWinH - 1);
  float hu[kLaneCols], hv[kLaneCols];
  ld4(hu, su, hr, ln.col0);
  ld4(hv, sv, hr, ln.col0);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int jj = kA + 2 * e;
    const bool tc = kEdge && (ln.tcl >> jj & 1u);
    const bool bc = kEdge && (ln.bcl >> jj & 1u);
    if (jj == 0)
      update_row<kPc, kEdge>(hu, o.u[0], o.u[1], hv, o.v[0], o.v[1], o, 0, tc, bc, ln, omega);
    else if (jj == 3)
      update_row<kPc, kEdge>(o.u[2], o.u[3], hu, o.v[2], o.v[3], hv, o, 3, tc, bc, ln, omega);
    else
      update_row<kPc, kEdge>(o.u[jj - 1], o.u[jj], o.u[jj + 1], o.v[jj - 1], o.v[jj],
                             o.v[jj + 1], o, jj, tc, bc, ln, omega);
  }
  const int pj = kA == 0 ? 0 : kRows - 1;
  st4(su, ln.row0 + pj, ln.col0, o.u[pj]);
  st4(sv, ln.row0 + pj, ln.col0, o.v[pj]);
}

// The tile's sweeps on the pair at su: sweep k on the warps whose rows
// meet the rows [2k - 1, kWinH + 1 - 2k), cut at the array's edges, the
// global-even rows (window rows of parity kPr) first; a block barrier
// after each half but the last (the next tile's first barrier covers it).
template <bool kEdge, int kPr, int kPc>
__device__ __forceinline__ void run_sweeps(float* su, const Args& a, const Tile& tile,
                                           const Lane& ln, Own& o) {
  float* sv = su + kArea;
  for (int k = 1; k <= a.sweeps; ++k) {
    const int rlo = max(2 * k - 1, tile.wr_lo), rhi = min(kWinH + 1 - 2 * k, tile.wr_hi);
    const bool live = ln.row0 < rhi && ln.row0 + kRows > rlo;  // uniform across the warp
    if (live) half_sweep<kPr, kPc, kEdge>(su, sv, o, ln, a.omega);
    __syncthreads();
    if (live) half_sweep<1 - kPr, kPc, kEdge>(su, sv, o, ln, a.omega);
    if (k < a.sweeps) __syncthreads();
  }
}

// One staged tile: the thread's clamps and owned columns, the sweeps in
// the instance of the tile's edges and parities, and the owned pixels
// from registers to device memory.
template <bool kShard>
__device__ __forceinline__ void sweep_tile(float* su, const Args& a, const Geometry& geo,
                                           const Tile& tile, Lane& ln, Own& o) {
  const int hs = 2 * a.sweeps, hc = 4 * a.sweeps;
  ln.lcl = ln.rcl = ln.own = ln.tcl = ln.bcl = 0;
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) {
    const int ac = tile.c0 + ln.col0 + q, gc = tile.org_c + ac;
    if (ac < 0 || ac >= a.w) continue;
    if (ac == 0 || (kShard && gc == 0)) ln.lcl |= 1u << q;
    if (ac == a.w - 1 || (kShard && gc == a.img_w - 1)) ln.rcl |= 1u << q;
    if (ln.col0 + q >= hc && ln.col0 + q < hc + geo.tw) ln.own |= 1u << q;
  }
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int ar = tile.r0 + ln.row0 + jj, gr = tile.org_r + ar;
    if (ar < 0 || ar >= a.h) continue;
    if (ar == 0 || (kShard && gr == 0)) ln.tcl |= 1u << jj;
    if (ar == a.h - 1 || (kShard && gr == a.img_h - 1)) ln.bcl |= 1u << jj;
  }
  // An edge in the window: the array's, or on a shard a true image edge.
  const int gr0 = tile.org_r + tile.r0, gc0 = tile.org_c + tile.c0;
  const bool edge =
      tile.wr_lo > 0 || tile.wr_hi < kWinH || tile.c0 < 0 || tile.c0 + kWinW > a.w ||
      (kShard && ((gr0 <= 0 && gr0 + kWinH > 0) || (gr0 < a.img_h && gr0 + kWinH >= a.img_h) ||
                  (gc0 <= 0 && gc0 + kWinW > 0) || (gc0 < a.img_w && gc0 + kWinW >= a.img_w)));
  // The global parity of window row and column 0: always even on whole
  // images (tiles and halos are even), the origin's on a shard.
  const bool pr = kShard && (gr0 & 1), pc = kShard && (gc0 & 1);
  if (edge) {
    if (pr)
      pc ? run_sweeps<true, 1, 1>(su, a, tile, ln, o) : run_sweeps<true, 1, 0>(su, a, tile, ln, o);
    else
      pc ? run_sweeps<true, 0, 1>(su, a, tile, ln, o) : run_sweeps<true, 0, 0>(su, a, tile, ln, o);
  } else {
    if (pr)
      pc ? run_sweeps<false, 1, 1>(su, a, tile, ln, o)
         : run_sweeps<false, 1, 0>(su, a, tile, ln, o);
    else
      pc ? run_sweeps<false, 0, 1>(su, a, tile, ln, o)
         : run_sweeps<false, 0, 0>(su, a, tile, ln, o);
  }
  // The owned tile, cut at the array.
  const int out_lo = max(hs, tile.wr_lo), out_hi = min(hs + geo.th, tile.wr_hi);
  if (!ln.own) return;
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int r = ln.row0 + jj;
    if (r < out_lo || r >= out_hi) continue;
    const long long g = tile.base + (long long)(tile.r0 + r) * a.w + tile.c0 + ln.col0;
    if (a.vec && ln.own == 0xfu) {
      __stcg(reinterpret_cast<float4*>(a.uo + g),
             make_float4(o.u[jj][0], o.u[jj][1], o.u[jj][2], o.u[jj][3]));
      __stcg(reinterpret_cast<float4*>(a.vo + g),
             make_float4(o.v[jj][0], o.v[jj][1], o.v[jj][2], o.v[jj][3]));
    } else {
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q) {
        if (ln.own >> q & 1u) {
          a.uo[g + q] = o.u[jj][q];
          a.vo[g + q] = o.v[jj][q];
        }
      }
    }
  }
}

// kShard: the images are K9's shards, each at its own global origin (org);
// otherwise whole images (K3). The block walks tiles blockIdx.x, +
// gridDim.x, ... of the stack: each tile's copies landed (a barrier, for
// the rows other warps staged), its pixels into registers, the next tile's
// copies started into the other u/v pair and into the fields' arrays
// (each thread overwrites only the pixels it has just read), the sweeps.
template <bool kShard>
__global__ void __launch_bounds__(kThreads, 1) sor_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Geometry geo = geometry(a.sweeps);
  const int ntiles = a.b * a.tiles_x * a.tiles_y;
  if ((int)blockIdx.x >= ntiles) return;
  Lane ln;
  ln.row0 = (threadIdx.x >> 5) * kRows;
  ln.col0 = (threadIdx.x & 31) * kLaneCols;
  int cur = 0;
  stage_tile(smem, cur, a, tile_at<kShard>(a, geo, blockIdx.x), ln);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tile = tile_at<kShard>(a, geo, t);
    copy_wait<0>();
    __syncthreads();
    Own o;
    load_own(o, smem, cur, ln);
    const int tn = t + gridDim.x;
    if (tn < ntiles) stage_tile(smem, cur ^ 1, a, tile_at<kShard>(a, geo, tn), ln);
    sweep_tile<kShard>(smem + 2 * cur * kArea, a, geo, tile, ln, o);
    cur ^= 1;
  }
}

template <bool kShard>
cudaError_t configure(int device, int* grid_max) {
  // Per device: opt into the shared memory above 48 KB, and the number of
  // blocks that can be resident at once (the persistent grid).
  static int cached[64];
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *grid_max = cached[device];
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      sor_kernel<kShard>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sor_kernel<kShard>, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid_max = per_sm * sms;
  if (device >= 0 && device < 64) cached[device] = *grid_max;
  return cudaSuccess;
}

int launch(const float* u, const float* v, const float* ex, const float* ey,
           const float* et, const float* invd, float* uo, float* vo,
           const int* org, int b, int h, int w, int img_h, int img_w,
           int sweeps, float omega, int device, void* stream) {
  if (b < 1 || b > kMaxBatch || h < 1 || w < 1 || sweeps < 1 || sweeps > kMaxSweeps)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid_max = 0;
  err = org != nullptr ? configure<true>(device, &grid_max)
                       : configure<false>(device, &grid_max);
  if (err != cudaSuccess) return (int)err;
  const Geometry g = geometry(sweeps);
  Args a;
  a.u = u; a.v = v; a.ex = ex; a.ey = ey; a.et = et; a.invd = invd;
  a.uo = uo; a.vo = vo; a.org = org;
  a.b = b; a.h = h; a.w = w; a.img_h = img_h; a.img_w = img_w; a.sweeps = sweeps;
  a.omega = omega;
  a.tiles_x = (w + g.tw - 1) / g.tw;
  a.tiles_y = (h + g.th - 1) / g.th;
  a.vec = w % 4 == 0 && aligned(u) && aligned(v) && aligned(ex) && aligned(ey) &&
          aligned(et) && aligned(invd) && aligned(uo) && aligned(vo);
  const long long tiles = (long long)b * a.tiles_x * a.tiles_y;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < grid_max ? tiles : grid_max);
  if (org != nullptr)
    sor_kernel<true><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a);
  else
    sor_kernel<false><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_sor_sweeps(const float* u, const float* v, const float* ex,
                             const float* ey, const float* et,
                             const float* invd, float* uo, float* vo, int b,
                             int h, int w, int sweeps, float omega, int device,
                             void* stream) {
  return launch(u, v, ex, ey, et, invd, uo, vo, nullptr, b, h, w, h, w, sweeps,
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
  return launch(u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w,
                sweeps, omega, device, stream);
}

// K3's geometry at `sweeps` on `device` (K9 SOR's with `shard` nonzero),
// into out[0..8]: sweeps, tile rows, tile columns, threads a block, shared
// bytes a block, registers a thread, local (spilled) bytes a thread, blocks
// resident on one multiprocessor, and the number of multiprocessors.
extern "C" int hs_sor_geometry(int sweeps, int shard, int device, int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid_max = 0, sms = 0;
  err = shard ? configure<true>(device, &grid_max) : configure<false>(device, &grid_max);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = shard ? cudaFuncGetAttributes(&attr, sor_kernel<true>)
              : cudaFuncGetAttributes(&attr, sor_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g = geometry(sweeps);
  out[0] = sweeps;
  out[1] = g.th;
  out[2] = g.tw;
  out[3] = kThreads;
  out[4] = (int)kSmemBytes;
  out[5] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  out[7] = grid_max / sms;
  out[8] = sms;
  return cudaSuccess;
}
