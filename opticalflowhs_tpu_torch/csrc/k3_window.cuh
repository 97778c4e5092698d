// K3's window walk: the temporally blocked 4-color SOR sweeps of one
// persistent block of 384 threads walking 48 x 128 windows, shared by K3
// and K9's SOR entry (sor.cu) and K8 (sor_planes.cu). csrc/sor.cu's note
// sets out the design: warps of 4 rows, lanes of 4 columns, u, v and the
// fields of a thread's 16 pixels in registers, two block barriers a sweep,
// the next tile staged by cp.async, a halo of 2s rows and 4s columns.
//
// Everything here lies in an unnamed namespace, as it did inside sor.cu, so
// that every source that includes it compiles its own copy with internal
// linkage: K3's code, and its SASS, stay what they were when it lived in
// sor.cu (external linkage in k2_window.cuh once changed K2's SASS). A
// source compiles only the functions it calls.
//
// Storage types: the walk's arguments (`Args`, `ArgsBf16`) name the type
// the arrays are stored in, float or bfloat16 (K3, K9's SOR entry and K8
// have bfloat16 builds). In bfloat16 the two u/v pairs and
// the four fields are staged in shared memory as bfloat16 (16-byte
// cp.async of 8 values by the even lanes where the width and the tile's
// first column allow, `bf16_wide`; else 8-byte copies of a lane's 4, or
// 2-byte loads), widened into the same registers, and swept in float32.
// The rows the warps exchange inside a sweep go through a float32 pair of
// their own (the swept pair itself in float), so that the odd rows' half
// reads the even rows' float32 values of this sweep, as the plain sweep's
// later color stages do; the first half of a tile's first sweep reads the
// staged bfloat16 rows. At each sweep's end a thread rounds u and v of its
// 16 pixels to nearest even (one cvt.rn.bf16x2.f32 a pair), before it
// stores its last row for the next sweep, so every value that crosses a
// sweep, or the launch, is rounded once. The float code paths are as they
// were (`if constexpr` on the storage type), so the float builds do not
// change.
//
// Exactness: the association order is that of ops/stencils.py
// (neighbor_avg, sor_step), the constants are the float32 values of 1/12,
// 1/3 and omega, and the library is built with --fmad=false, so every
// kernel built on this equals the plain PyTorch sweeps bitwise (in
// bfloat16, the plain sweeps of the storage rule, `stencils.store`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "k2_window.cuh"

namespace {

using hs_k2::aligned;
using hs_k2::bf16_round2;
using hs_k2::bf16_round4;
using hs_k2::bf16_wide;
using hs_k2::bf16_widen;
using hs_k2::bf16_widen4;
using hs_k2::copy16;
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
// Shared arrays: two u/v pairs (one swept, one staged) and the four fields;
// in bfloat16 also a float32 u/v pair for the rows exchanged in a sweep.
constexpr int kPairs = 2;
constexpr size_t kSmemBytes = (size_t)(2 * kPairs + 4) * kArea * sizeof(float);
constexpr size_t kSmemBytesBf16 =
    (size_t)(2 * kPairs + 4) * kArea * sizeof(__nv_bfloat16) + 2 * kArea * sizeof(float);
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

// The arguments of one walk, over arrays stored as E.
template <class E>
struct ArgsOf {
  using Elem = E;
  const E *u, *v, *ex, *ey, *et, *invd;
  E *uo, *vo;
  const int* org;  // K9: per-image global origins; null otherwise
  int b, h, w, img_h, img_w, sweeps, tiles_x, tiles_y;
  int vec;  // 16-byte copies and stores (bfloat16: 1, 8-byte; 2, also
            // 16-byte staging, `bf16_wide`)
  float omega;
};
struct Args : ArgsOf<float> {};
struct ArgsBf16 : ArgsOf<__nv_bfloat16> {};

template <class A>
inline constexpr bool kIsFloat = std::is_same<typename A::Elem, float>::value;

// One tile: its image, the window's origin in the image's array, its
// global origin, and the window rows inside the array.
struct Tile {
  long long base;
  int r0, c0, org_r, org_c, wr_lo, wr_hi;
};

template <bool kShard, class A>
__device__ __forceinline__ Tile tile_at(const A& a, const Geometry& g, int t) {
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

// ld4 of 4 bfloat16 values, widened.
__device__ __forceinline__ void ld4(float (&d)[kLaneCols], const __nv_bfloat16* s, int r,
                                    int c) {
  const float4 x = bf16_widen4(*reinterpret_cast<const uint2*>(s + r * kWinW + c));
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}

// Starts the copies of a thread's pixels of a tile's window, u and v into
// the pair `pair` (zeros where `live` is false: a zero start) and the four
// fields into theirs; zero outside the array. kL2 (K8): u and v may have
// been written during the launch by other multiprocessors, so they are read
// around the SM's L1, which those writes do not invalidate. The 16-byte
// copies (cp.async.cg) already are; on the 4-byte path u and v become
// __ldcg loads and shared stores, a row at a time, so that the loads in
// flight do not add to the registers that hold the thread's pixels. The
// fields are never written during a launch and keep their copies.
//
// bfloat16: one row at a time; where `bf16_wide` allows, the even lanes copy
// 16 bytes, their own 4 values of each array and the next lane's, and the
// odd lanes none (the 8 columns are all in the array or all out); else
// copy_quad's 8-byte copies (with kL2 8-byte __ldcg loads for u and v) or
// 2-byte loads.
template <bool kL2, class A>
__device__ __forceinline__ void stage_tile(typename A::Elem* smem, int pair, const A& a,
                                           const Tile& t, const Lane& ln, bool live) {
  using E = typename A::Elem;
  E* pu = smem + 2 * pair * kArea;
  E* pf = smem + 2 * kPairs * kArea;
  const int ac = t.c0 + ln.col0;
  if constexpr (!kIsFloat<A>) {
    const bool wide = bf16_wide(a.vec, t.c0);
#pragma unroll 1
    for (int jj = 0; jj < kRows; ++jj) {
      const int wr = ln.row0 + jj;
      const int ar = t.r0 + wr;
      const bool row_in = ar >= 0 && ar < a.h;
      const long long g = t.base + (long long)ar * a.w + ac;
      const int o = wr * kWinW + ln.col0;
      if (wide) {
        if (ln.col0 & kLaneCols) continue;
        const bool in = row_in && ac >= 0 && ac < a.w;
        const long long gi = in ? g : 0;
        copy16(pu + o, a.u + gi, in && live);
        copy16(pu + kArea + o, a.v + gi, in && live);
        copy16(pf + o, a.ex + gi, in);
        copy16(pf + kArea + o, a.ey + gi, in);
        copy16(pf + 2 * kArea + o, a.et + gi, in);
        copy16(pf + 3 * kArea + o, a.invd + gi, in);
      } else {
        copy_quad<kL2>(pu + o, a.u, g, a.vec, row_in, ac, a.w, live);
        copy_quad<kL2>(pu + kArea + o, a.v, g, a.vec, row_in, ac, a.w, live);
        copy_quad<false>(pf + o, a.ex, g, a.vec, row_in, ac, a.w, true);
        copy_quad<false>(pf + kArea + o, a.ey, g, a.vec, row_in, ac, a.w, true);
        copy_quad<false>(pf + 2 * kArea + o, a.et, g, a.vec, row_in, ac, a.w, true);
        copy_quad<false>(pf + 3 * kArea + o, a.invd, g, a.vec, row_in, ac, a.w, true);
      }
    }
    copy_commit();
    return;
  }
  const bool uv_l2 = kL2 && !a.vec;
  if (uv_l2) {
#pragma unroll 1
    for (int jj = 0; jj < kRows; ++jj) {
      const int wr = ln.row0 + jj;
      const int ar = t.r0 + wr;
      const bool row_in = ar >= 0 && ar < a.h;
      const long long g = t.base + (long long)ar * a.w + ac;
      const int o = wr * kWinW + ln.col0;
      copy_quad<true>(pu + o, a.u, g, 0, row_in, ac, a.w, live);
      copy_quad<true>(pu + kArea + o, a.v, g, 0, row_in, ac, a.w, live);
    }
  }
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int wr = ln.row0 + jj;
    const int ar = t.r0 + wr;
    const bool row_in = ar >= 0 && ar < a.h;
    const long long g = t.base + (long long)ar * a.w + ac;
    const int o = wr * kWinW + ln.col0;
    if (!uv_l2) {
      copy_quad<false>(pu + o, a.u, g, a.vec, row_in, ac, a.w, live);
      copy_quad<false>(pu + kArea + o, a.v, g, a.vec, row_in, ac, a.w, live);
    }
    copy_quad<false>(pf + o, a.ex, g, a.vec, row_in, ac, a.w, true);
    copy_quad<false>(pf + kArea + o, a.ey, g, a.vec, row_in, ac, a.w, true);
    copy_quad<false>(pf + 2 * kArea + o, a.et, g, a.vec, row_in, ac, a.w, true);
    copy_quad<false>(pf + 3 * kArea + o, a.invd, g, a.vec, row_in, ac, a.w, true);
  }
  copy_commit();
}

// A thread's staged pixels, from shared memory into registers (bfloat16
// widened).
template <class E>
__device__ __forceinline__ void load_own(Own& o, const E* smem, int pair, const Lane& ln) {
  const E* pu = smem + 2 * pair * kArea;
  const E* pf = smem + 2 * kPairs * kArea;
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

// u and v of a thread's 16 pixels rounded to bfloat16 (to nearest even)
// and widened back, two values a conversion.
__device__ __forceinline__ void round_own(Own& o) {
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
#pragma unroll
    for (int q = 0; q < kLaneCols; q += 2) {
      const unsigned pu = bf16_round2(o.u[jj][q], o.u[jj][q + 1]);
      const unsigned pv = bf16_round2(o.v[jj][q], o.v[jj][q + 1]);
      o.u[jj][q] = bf16_widen((unsigned short)(pu & 0xffffu));
      o.u[jj][q + 1] = bf16_widen((unsigned short)(pu >> 16));
      o.v[jj][q] = bf16_widen((unsigned short)(pv & 0xffffu));
      o.v[jj][q + 1] = bf16_widen((unsigned short)(pv >> 16));
    }
  }
}

// One half sweep on a thread's rows kA and kA + 2 (the rows of one global
// parity): the row beside them that another warp owns (above for kA = 0,
// below for kA = 1; the window's own first or last row at its edges) from
// shared memory (hu, hv: the float32 exchange pair, or in bfloat16 at a
// tile's first half the staged pair), the rest from registers; with kRound
// (bfloat16, the half that ends a sweep) u and v rounded; then the
// boundary row the half changed (the thread's first or last) to the
// exchange pair (su, sv) for the neighbouring warp.
template <int kA, int kPc, bool kEdge, bool kRound = false, class S>
__device__ __forceinline__ void half_sweep(const S* hsu, const S* hsv, float* su, float* sv,
                                           Own& o, const Lane& ln, float omega) {
  const int hr = kA == 0 ? max(ln.row0 - 1, 0) : min(ln.row0 + kRows, kWinH - 1);
  float hu[kLaneCols], hv[kLaneCols];
  ld4(hu, hsu, hr, ln.col0);
  ld4(hv, hsv, hr, ln.col0);
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
  if (kRound) round_own(o);
  const int pj = kA == 0 ? 0 : kRows - 1;
  st4(su, ln.row0 + pj, ln.col0, o.u[pj]);
  st4(sv, ln.row0 + pj, ln.col0, o.v[pj]);
}

// The tile's sweeps: sweep k on the warps whose rows meet the rows
// [2k - 1, kWinH + 1 - 2k), cut at the array's edges, the global-even rows
// (window rows of parity kPr) first, exchanging rows through the float32
// pair at su (in float the swept pair itself; in bfloat16 the first half
// reads the staged pair at pu); a block barrier after each half but the
// last (the next tile's first barrier covers it).
template <bool kEdge, int kPr, int kPc, class A>
__device__ __forceinline__ void run_sweeps(const typename A::Elem* pu, float* su, const A& a,
                                           const Tile& tile, const Lane& ln, Own& o) {
  float* sv = su + kArea;
  for (int k = 1; k <= a.sweeps; ++k) {
    const int rlo = max(2 * k - 1, tile.wr_lo), rhi = min(kWinH + 1 - 2 * k, tile.wr_hi);
    const bool live = ln.row0 < rhi && ln.row0 + kRows > rlo;  // uniform across the warp
    if constexpr (kIsFloat<A>) {
      if (live) half_sweep<kPr, kPc, kEdge>(su, sv, su, sv, o, ln, a.omega);
      __syncthreads();
      if (live) half_sweep<1 - kPr, kPc, kEdge>(su, sv, su, sv, o, ln, a.omega);
    } else {
      if (live) {
        if (k == 1)
          half_sweep<kPr, kPc, kEdge>(pu, pu + kArea, su, sv, o, ln, a.omega);
        else
          half_sweep<kPr, kPc, kEdge>(su, sv, su, sv, o, ln, a.omega);
      }
      __syncthreads();
      if (live) half_sweep<1 - kPr, kPc, kEdge, true>(su, sv, su, sv, o, ln, a.omega);
    }
    if (k < a.sweeps) __syncthreads();
  }
}

// One staged tile: the thread's clamps and owned columns, the sweeps in
// the instance of the tile's edges and parities, and the owned pixels
// from registers to device memory.
template <bool kShard, class A>
__device__ __forceinline__ void sweep_tile(const typename A::Elem* pu, float* su, const A& a,
                                           const Geometry& geo, const Tile& tile, Lane& ln,
                                           Own& o) {
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
      pc ? run_sweeps<true, 1, 1>(pu, su, a, tile, ln, o) : run_sweeps<true, 1, 0>(pu, su, a, tile, ln, o);
    else
      pc ? run_sweeps<true, 0, 1>(pu, su, a, tile, ln, o) : run_sweeps<true, 0, 0>(pu, su, a, tile, ln, o);
  } else {
    if (pr)
      pc ? run_sweeps<false, 1, 1>(pu, su, a, tile, ln, o)
         : run_sweeps<false, 1, 0>(pu, su, a, tile, ln, o);
    else
      pc ? run_sweeps<false, 0, 1>(pu, su, a, tile, ln, o)
         : run_sweeps<false, 0, 0>(pu, su, a, tile, ln, o);
  }
  // The owned tile, cut at the array.
  const int out_lo = max(hs, tile.wr_lo), out_hi = min(hs + geo.th, tile.wr_hi);
  if (!ln.own) return;
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int r = ln.row0 + jj;
    if (r < out_lo || r >= out_hi) continue;
    const long long g = tile.base + (long long)(tile.r0 + r) * a.w + tile.c0 + ln.col0;
    if constexpr (!kIsFloat<A>) {  // the values are rounded: stored exactly
      if (a.vec && ln.own == 0xfu) {
        __stcg(reinterpret_cast<uint2*>(a.uo + g),
               bf16_round4(o.u[jj][0], o.u[jj][1], o.u[jj][2], o.u[jj][3]));
        __stcg(reinterpret_cast<uint2*>(a.vo + g),
               bf16_round4(o.v[jj][0], o.v[jj][1], o.v[jj][2], o.v[jj][3]));
      } else {
        unsigned short* qu = reinterpret_cast<unsigned short*>(a.uo);
        unsigned short* qv = reinterpret_cast<unsigned short*>(a.vo);
#pragma unroll
        for (int q = 0; q < kLaneCols; ++q) {
          if (ln.own >> q & 1u) {
            qu[g + q] = hs_k2::bf16_round(o.u[jj][q]);
            qv[g + q] = hs_k2::bf16_round(o.v[jj][q]);
          }
        }
      }
    } else if (a.vec && ln.own == 0xfu) {
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

// One K3 launch's walk for this block: a.sweeps sweeps from (a.u, a.v), or
// from zeros where `live` is false, into (a.uo, a.vo), on the block's tiles
// blockIdx.x, + gridDim.x, ... of the stack (kShard: the images are K9's
// shards, each at its own global origin; otherwise whole images). Each
// tile's copies landed (a barrier, for the rows other warps staged), its
// pixels into registers, the next tile's copies started into the other u/v
// pair and into the fields' arrays (each thread overwrites only the pixels
// it has just read), the sweeps. It ends with no copy in flight; the last
// half sweep is not followed by a barrier, so a caller that walks again
// (K8) puts one first.
//
// bfloat16: a warp barrier after a thread's pixels are read, before the next
// tile's copies start, since with 16-byte copies an even lane stages the
// next lane's pixels of the fields' one buffer.
template <bool kShard, bool kL2, class A>
__device__ __forceinline__ void walk_tiles(typename A::Elem* smem, const A& a, bool live) {
  const Geometry geo = geometry(a.sweeps);
  const int ntiles = a.b * a.tiles_x * a.tiles_y;
  if ((int)blockIdx.x >= ntiles) return;
  Lane ln;
  ln.row0 = (threadIdx.x >> 5) * kRows;
  ln.col0 = (threadIdx.x & 31) * kLaneCols;
  int cur = 0;
  stage_tile<kL2>(smem, cur, a, tile_at<kShard>(a, geo, blockIdx.x), ln, live);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tile = tile_at<kShard>(a, geo, t);
    copy_wait<0>();
    __syncthreads();
    Own o;
    load_own(o, smem, cur, ln);
    if constexpr (!kIsFloat<A>) __syncwarp();
    const int tn = t + gridDim.x;
    if (tn < ntiles) stage_tile<kL2>(smem, cur ^ 1, a, tile_at<kShard>(a, geo, tn), ln, live);
    // The rows exchanged in a sweep: through the swept pair in float; in
    // bfloat16 through a float32 pair of their own after the staged arrays.
    if constexpr (kIsFloat<A>)
      sweep_tile<kShard>(smem + 2 * cur * kArea, smem + 2 * cur * kArea, a, geo, tile, ln, o);
    else
      sweep_tile<kShard>(smem + 2 * cur * kArea,
                         reinterpret_cast<float*>(smem + (2 * kPairs + 4) * kArea), a, geo,
                         tile, ln, o);
    cur ^= 1;
  }
}

}  // namespace
