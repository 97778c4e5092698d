// K2's window loop: the temporally blocked Jacobi sweeps of one persistent
// block of 512 threads walking 48 x 128 windows, shared by K2 and K9
// (jacobi.cu), K6 (solve_fused.cu), K7 (solve_skewed.cu), K11 and K12
// (ring.cu).
//
//   * Each tile is the centre of a 48 x 128 window: the tile grown by s rows
//     above and below, and by s columns rounded up to 4 on the left and at
//     least s on the right (`geometry`): 32 x 112 at s = 8.
//   * The mapping of threads to pixels is fixed for all of a tile's sweeps:
//     warp j owns window rows 3j..3j+2, lane l the 4 adjacent columns
//     4l..4l+3, so one warp spans the window's width. The fields Ex, Ey, Et
//     and invd of a thread's 12 pixels are loaded once, from device memory,
//     into registers; shared memory holds only u and v.
//   * A lane forms the column sums t = (a(i-1) + 2a) + a(i+1) of its own 4
//     columns and takes t(j-1) of its first and t(j+1) of its last column
//     from its neighbours with __shfl_up_sync/__shfl_down_sync: each column
//     sum is computed once, 27 float32 operations a pixel a sweep, and a
//     pixel costs 2 shared loads and 2 stores (16-byte, one per 4 pixels).
//     Lanes 0 and 31 hold window columns 0 and 127, which are halo: what
//     they receive from the shuffle is never read by an exact pixel.
//   * Sweep k runs on every row of the warps that meet the window's rows
//     shrunk by k (a warp outside skips it) and on all 128 columns; what
//     that computes outside the exact region is never read by an exact
//     pixel. The last sweep writes the owned tile straight from registers
//     to device memory (a.uo, a.vo).
//   * Interior windows run without clamps, their rows rolled in registers. A
//     window that holds an edge of the array (or, on a shard, a true image
//     edge) takes each row's rows i-1 and i+1 with their clamps and replaces
//     t(j-1) or t(j+1) by the lane's own t where the plain version's shifts
//     clamp.
//   * `walk_tiles` is one K2 launch's walk: while a block sweeps one tile,
//     cp.async copies the next tile's u and v into a third shared u/v pair.
//     kL2 (K6, K7): u and v may have been written during the launch by other
//     multiprocessors, so they are read around the SM's L1, which those
//     writes do not invalidate: the 16-byte copies (cp.async.cg) already
//     are; the 4-byte ones become __ldcg loads and shared stores
//     (cp.async.ca may allocate in L1).
//   * `walk_owned` is the walk of K11 and K12: it covers only the owned
//     rectangle of each image, rows [oy, h - oy) and columns [ox, w - ox),
//     and writes only its pixels, so that the halo around it, which the
//     ring's neighbours store into during the launch, is never written by
//     a sweep; it walks the interior tile rows first, and its Ring is
//     called before each tile is staged. It has functions of its own
//     (tile_owned, sweep_owned) beside walk_tiles and sweep_tile, which
//     stay as they were, so that K2, K9, K6 and K7 build to the same code;
//     they are static, so a source that does not walk a ring compiles none
//     of them (with external linkage they changed K2's SASS). `walk_rect`
//     is the walk of one pass of a deep sweep block (ring.cu): walk_owned
//     over a rectangle whose inset and tile counts its Ring gives, read at
//     each use. It is a function of its own, as are its `tile_index_in` and
//     `tile_owned_in`: walk_owned reading them from a Ring changed K11's and
//     K12's SASS.
//
// Storage types: the loop's arguments (`Args`, `ArgsBf16`) name the type
// the arrays are stored in, float or bfloat16 (every kernel on this loop
// has a bfloat16 build). A bfloat16 value is widened to float where it is loaded (fields
// into the same registers, u and v from shared memory, which holds them
// in bfloat16), the sweep runs the float32 arithmetic below unchanged, and
// u and v are rounded to nearest even (__float2bfloat16_rn) where each
// sweep stores them: into shared memory, or from the last sweep to device
// memory. So every sweep rounds, also inside a launch, and the result does
// not depend on the sweeps a launch runs. A lane's 4 bfloat16 values are 8
// bytes: staged by an 8-byte cp.async where w is a multiple of 4 and the
// arrays are 8-byte aligned (with kL2 by 8-byte __ldcg loads a row at a
// time), else by 2-byte loads. The float code paths are as they were
// (`if constexpr` on the storage type), so the float builds do not change.
//
// Exactness: the association order is that of ops/stencils.py
// (neighbor_avg, jacobi_step), the constants are the float32 values of
// 1/12 and 1/3, and the library is built with --fmad=false, so every kernel
// built on this equals the plain PyTorch sweeps bitwise (in bfloat16, the
// plain sweeps of the storage rule, `stencils.store`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace hs_k2 {

constexpr int kLaneCols = 4;                  // adjacent columns a lane owns
constexpr int kWinW = 32 * kLaneCols;         // 128: one warp spans the window
constexpr int kRows = 3;                      // rows a thread owns
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;         // 512
constexpr int kWinH = kWarps * kRows;         // 48
constexpr int kArea = kWinH * kWinW;
// Shared bytes of one u/v pair of a window (float; in bfloat16 half).
constexpr size_t kPairBytes = (size_t)2 * kArea * sizeof(float);
constexpr int kMaxSweeps = 16;
constexpr float kTwelfth = (float)(1.0 / 12.0);
constexpr float kThird = (float)(1.0 / 3.0);

// The tile of s sweeps inside the 48 x 128 window: th x tw at window row s
// and column lh (s rounded up to 4, so that tile and window columns stay
// 16-byte aligned in the image).
struct Geometry {
  int th, tw, lh;
};

__host__ __device__ inline Geometry geometry(int s) {
  Geometry g;
  g.lh = (s + kLaneCols - 1) / kLaneCols * kLaneCols;
  g.th = kWinH - 2 * s;
  g.tw = (kWinW - g.lh - s) / kLaneCols * kLaneCols;
  return g;
}

// The arguments of one walk, over arrays stored as E (Elem).
template <class E>
struct ArgsOf {
  using Elem = E;
  const E *u, *v, *ex, *ey, *et, *invd;
  E *uo, *vo;
  const int* org;  // K9: per-image global origins; null otherwise
  int b, h, w, img_h, img_w, sweeps, tiles_x, tiles_y;
  int vec;         // 16-byte loads and stores (bfloat16: 1, 8-byte; 2, also
                   // 16-byte staging, `bf16_wide`)
};
struct Args : ArgsOf<float> {};
struct ArgsBf16 : ArgsOf<__nv_bfloat16> {};

template <class A>
inline constexpr bool kIsFloat = std::is_same<typename A::Elem, float>::value;

// Shared bytes of one u/v pair of a window of A's storage type.
template <class A>
constexpr size_t pair_bytes() {
  return (size_t)2 * kArea * sizeof(typename A::Elem);
}

// bfloat16 to and from float, only by the intrinsics, and packed by 2 and 4
// (the lower address in the lower bits).
__device__ __forceinline__ float bf16_widen(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

__device__ __forceinline__ unsigned short bf16_round(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 bf16_widen4(const uint2& x) {
  return make_float4(bf16_widen((unsigned short)(x.x & 0xffffu)),
                     bf16_widen((unsigned short)(x.x >> 16)),
                     bf16_widen((unsigned short)(x.y & 0xffffu)),
                     bf16_widen((unsigned short)(x.y >> 16)));
}

// Two values rounded by one conversion (cvt.rn.bf16x2.f32), each as
// __float2bfloat16_rn rounds it.
__device__ __forceinline__ unsigned bf16_round2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ uint2 bf16_round4(float a, float b, float c, float d) {
  return make_uint2(bf16_round2(a, b), bf16_round2(c, d));
}

// One tile: its image, the window's origin in the image's array and the
// window rows inside the array.
struct Tile {
  long long base;  // first element of the image
  int r0, c0, org_r, org_c, wr_lo, wr_hi;
};

// The tile at tile row ty and column tx of image img.
template <class A>
__device__ __forceinline__ Tile tile_rc(const A& a, const Geometry& g, int img, int ty,
                                        int tx) {
  Tile x;
  x.base = (long long)img * a.h * a.w;
  x.r0 = ty * g.th - a.sweeps;
  x.c0 = tx * g.tw - g.lh;
  x.org_r = 0;
  x.org_c = 0;
  x.wr_lo = max(0, -x.r0);
  x.wr_hi = min(kWinH, a.h - x.r0);
  return x;
}

template <bool kShard, class A>
__device__ __forceinline__ Tile tile_at(const A& a, const Geometry& g, int t) {
  const int per_img = a.tiles_x * a.tiles_y;
  const int img = t / per_img;
  const int rem = t - img * per_img;
  const int ty = rem / a.tiles_x;
  const int tx = rem - ty * a.tiles_x;
  Tile x = tile_rc(a, g, img, ty, tx);
  x.org_r = kShard ? a.org[2 * img] : 0;
  x.org_c = kShard ? a.org[2 * img + 1] : 0;
  return x;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 (4) bytes; src_size 0 fills zeros and reads nothing.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// cp.async.cg of 16 bytes (8 bfloat16 values: a lane's and the next lane's).
__device__ __forceinline__ void copy16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                       bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// bfloat16 rows go by copy16 where the arrays allow (vec == 2: w a multiple
// of 8, 16-byte aligned) and the tile's first column c0 is a multiple of 8:
// each even lane copies its 4 values and the next lane's, the odd lanes
// none. Then 8 columns are all inside the array or all outside.
__device__ __forceinline__ bool bf16_wide(int vec, int c0) {
  return vec == 2 && (c0 & 7) == 0;
}

// cp.async of 8 bytes (4 bfloat16 values); src_size 0 fills zeros.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst, const __nv_bfloat16* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* s, int r, int c) {
  return *reinterpret_cast<const float4*>(s + r * kWinW + c);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* s, int r, int c) {
  return bf16_widen4(*reinterpret_cast<const uint2*>(s + r * kWinW + c));
}

// Copies 4 adjacent floats of row `g` (g + q for column q, `in_q` saying
// which are inside the array) to d[0..3]: with vec, all four are in or all
// out and one 16-byte copy moves them; else 4-byte copies, or with kL2
// __ldcg loads and shared stores. Outside the array (or with `live` false:
// a zero start) they are zero.
template <bool kL2>
__device__ __forceinline__ void copy_quad(float* d, const float* __restrict__ src,
                                          long long g, int vec, bool row_in, int ac,
                                          int w, bool live) {
  if (vec) {
    // ac and w are multiples of 4: the 4 columns are all in or all out.
    const bool in = live && row_in && ac >= 0 && ac < w;
    copy16(d, in ? src + g : src, in);
  } else {
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const bool in = live && row_in && ac + q >= 0 && ac + q < w;
      if (kL2)
        d[q] = in ? __ldcg(src + g + q) : 0.0f;
      else
        copy4(d + q, in ? src + g + q : src, in);
    }
  }
}

// copy_quad of 4 bfloat16 values: with vec one 8-byte cp.async, or with kL2
// an 8-byte __ldcg load and shared store; else 2-byte loads (__ldg, with kL2
// __ldcg) and shared stores.
template <bool kL2>
__device__ __forceinline__ void copy_quad(__nv_bfloat16* d,
                                          const __nv_bfloat16* __restrict__ src,
                                          long long g, int vec, bool row_in, int ac, int w,
                                          bool live) {
  if (vec) {
    const bool in = live && row_in && ac >= 0 && ac < w;
    if (kL2)
      *reinterpret_cast<uint2*>(d) =
          in ? __ldcg(reinterpret_cast<const uint2*>(src + g)) : make_uint2(0u, 0u);
    else
      copy8(d, in ? src + g : src, in);
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const bool in = live && row_in && ac + q >= 0 && ac + q < w;
      reinterpret_cast<unsigned short*>(d)[q] =
          !in ? (unsigned short)0 : kL2 ? __ldcg(p + g + q) : __ldg(p + g + q);
    }
  }
}

// Starts the copies of this thread's pixels of one array of a tile's
// window into shared memory; outside the array they are zero.
template <bool kL2, class A>
__device__ __forceinline__ void stage(typename A::Elem* dst,
                                      const typename A::Elem* __restrict__ src,
                                      const A& a, const Tile& t, int row0, int col0,
                                      bool live) {
  const int ac = t.c0 + col0;
  if constexpr (!kIsFloat<A>) {
    const bool wide = bf16_wide(a.vec, t.c0);
    if (wide || kL2 || !a.vec) {
      // bfloat16 rows one at a time: 16-byte copies (wide), or loads through
      // registers. One loop for both keeps K6 within its registers.
#pragma unroll 1
      for (int jj = 0; jj < kRows; ++jj) {
        const int wr = row0 + jj;
        const int ar = t.r0 + wr;
        const long long g = t.base + (long long)ar * a.w + ac;
        if (!wide) {
          copy_quad<kL2>(dst + wr * kWinW + col0, src, g, a.vec, ar >= 0 && ar < a.h, ac,
                         a.w, live);
        } else if ((col0 & kLaneCols) == 0) {
          const bool in = live && ar >= 0 && ar < a.h && ac >= 0 && ac < a.w;
          copy16(dst + wr * kWinW + col0, in ? src + g : src, in);
        }
      }
      return;
    }
  }
  if (kL2 && !a.vec) {
    // The 4-byte loads go through registers: one row at a time, so that
    // they do not add to what the fields and the sweeps hold.
#pragma unroll 1
    for (int jj = 0; jj < kRows; ++jj) {
      const int wr = row0 + jj;
      const int ar = t.r0 + wr;
      const long long g = t.base + (long long)ar * a.w + ac;
      copy_quad<true>(dst + wr * kWinW + col0, src, g, 0, ar >= 0 && ar < a.h, ac, a.w,
                      live);
    }
    return;
  }
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int wr = row0 + jj;
    const int ar = t.r0 + wr;
    const bool row_in = ar >= 0 && ar < a.h;
    const long long g = t.base + (long long)ar * a.w + ac;
    copy_quad<kL2>(dst + wr * kWinW + col0, src, g, a.vec, row_in, ac, a.w, live);
  }
}

// Starts the staging of a tile's u and v (a.u, a.v; zeros where `live` is
// false) into the pair at `pair`.
template <bool kL2, class A>
__device__ __forceinline__ void stage_tile(typename A::Elem* smem, int pair, const A& a,
                                           const Tile& t, int row0, int col0, bool live) {
  typename A::Elem* pu = smem + 2 * pair * kArea;
  stage<kL2>(pu, a.u, a, t, row0, col0, live);
  stage<kL2>(pu + kArea, a.v, a, t, row0, col0, live);
  copy_commit();
}

// A thread's kRows x 4 pixels of one field, from device memory into registers
// (zero outside the array).
template <class A>
__device__ __forceinline__ void load_field(float (&f)[kRows][kLaneCols],
                                           const float* __restrict__ p,
                                           const A& a, const Tile& t,
                                           int row0, int col0) {
  const int ac = t.c0 + col0;
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int ar = t.r0 + row0 + jj;
    const bool row_in = ar >= 0 && ar < a.h;
    const long long g = t.base + (long long)ar * a.w + ac;
    if (a.vec) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row_in && ac >= 0 && ac < a.w) x = __ldg(reinterpret_cast<const float4*>(p + g));
      f[jj][0] = x.x;
      f[jj][1] = x.y;
      f[jj][2] = x.z;
      f[jj][3] = x.w;
    } else {
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q) {
        const bool in = row_in && ac + q >= 0 && ac + q < a.w;
        f[jj][q] = in ? __ldg(p + g + q) : 0.0f;
      }
    }
  }
}

// load_field of a bfloat16 field, widened into the same registers: 8-byte
// loads with vec, else 2-byte ones.
template <class A>
__device__ __forceinline__ void load_field(float (&f)[kRows][kLaneCols],
                                           const __nv_bfloat16* __restrict__ p,
                                           const A& a, const Tile& t,
                                           int row0, int col0) {
  const int ac = t.c0 + col0;
  const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int ar = t.r0 + row0 + jj;
    const bool row_in = ar >= 0 && ar < a.h;
    const long long g = t.base + (long long)ar * a.w + ac;
    if (a.vec) {
      uint2 x = make_uint2(0u, 0u);
      if (row_in && ac >= 0 && ac < a.w) x = __ldg(reinterpret_cast<const uint2*>(p + g));
      const float4 y = bf16_widen4(x);
      f[jj][0] = y.x;
      f[jj][1] = y.y;
      f[jj][2] = y.z;
      f[jj][3] = y.w;
    } else {
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q) {
        const bool in = row_in && ac + q >= 0 && ac + q < a.w;
        f[jj][q] = in ? bf16_widen(__ldg(ps + g + q)) : 0.0f;
      }
    }
  }
}

// The four fields of a thread's pixels of a tile.
struct Fields {
  float x[kRows][kLaneCols], y[kRows][kLaneCols], t[kRows][kLaneCols],
      i[kRows][kLaneCols];
};

template <class A>
__device__ __forceinline__ void load_fields(Fields& f, const A& a, const Tile& t,
                                            int row0, int col0) {
  load_field(f.x, a.ex, a, t, row0, col0);
  load_field(f.y, a.ey, a, t, row0, col0);
  load_field(f.t, a.et, a, t, row0, col0);
  load_field(f.i, a.invd, a, t, row0, col0);
}

__device__ __forceinline__ void st4(float* s, int r, int c, const float (&x)[kLaneCols]) {
  *reinterpret_cast<float4*>(s + r * kWinW + c) = make_float4(x[0], x[1], x[2], x[3]);
}

// st4 into bfloat16: each value rounded to nearest even.
__device__ __forceinline__ void st4(__nv_bfloat16* s, int r, int c,
                                    const float (&x)[kLaneCols]) {
  *reinterpret_cast<uint2*>(s + r * kWinW + c) = bf16_round4(x[0], x[1], x[2], x[3]);
}

// neighbor_avg of a lane's 4 columns at one row: t per column from rows
// i-1, i, i+1, then s = (t(j-1) + 2t) + t(j+1), then s/12 - a/3. With
// kClamp, bit q of lcl (rcl) clamps column q's left (right) neighbour to
// itself.
template <bool kClamp>
__device__ __forceinline__ void neighbor_avg4(const float4& top, const float4& mid,
                                              const float4& bot, unsigned lcl,
                                              unsigned rcl, float (&bar)[kLaneCols]) {
  const float t[kLaneCols] = {(top.x + 2.0f * mid.x) + bot.x, (top.y + 2.0f * mid.y) + bot.y,
                              (top.z + 2.0f * mid.z) + bot.z, (top.w + 2.0f * mid.w) + bot.w};
  const float left = __shfl_up_sync(0xffffffffu, t[3], 1);
  const float right = __shfl_down_sync(0xffffffffu, t[0], 1);
  float tl[kLaneCols] = {left, t[0], t[1], t[2]};
  float tr[kLaneCols] = {t[1], t[2], t[3], right};
  if (kClamp) {
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      if (lcl >> q & 1u) tl[q] = t[q];
      if (rcl >> q & 1u) tr[q] = t[q];
    }
  }
  const float m[kLaneCols] = {mid.x, mid.y, mid.z, mid.w};
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q)
    bar[q] = ((tl[q] + 2.0f * t[q]) + tr[q]) * kTwelfth - m[q] * kThird;
}

// What a lane needs at one sweep besides the rows: its column clamps, the
// owned columns it writes, the rows [out_lo, out_hi) of the owned tile, and
// whether this is the tile's last sweep.
struct Lane {
  int row0, col0;
  unsigned lcl, rcl, own;
  int out_lo, out_hi;
};

// The HS update of one row of a lane's 4 pixels, and its store: into the
// next shared buffer, or on the last sweep, for rows of the owned tile,
// straight to device memory.
template <bool kClamp, bool kLast, class A>
__device__ __forceinline__ void update_row(
    const float4& ut, const float4& um, const float4& ub, const float4& vt,
    const float4& vm, const float4& vb, const float (&fx)[kLaneCols],
    const float (&fy)[kLaneCols], const float (&ft)[kLaneCols],
    const float (&fi)[kLaneCols], typename A::Elem* __restrict__ du,
    typename A::Elem* __restrict__ dv, const A& a, const Tile& tile, const Lane& ln,
    int r) {
  float ubar[kLaneCols], vbar[kLaneCols], uo[kLaneCols], vo[kLaneCols];
  neighbor_avg4<kClamp>(ut, um, ub, ln.lcl, ln.rcl, ubar);
  neighbor_avg4<kClamp>(vt, vm, vb, ln.lcl, ln.rcl, vbar);
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) {
    const float frac = ((fx[q] * ubar[q] + fy[q] * vbar[q]) + ft[q]) * fi[q];
    uo[q] = ubar[q] - fx[q] * frac;
    vo[q] = vbar[q] - fy[q] * frac;
  }
  if (!kLast) {
    st4(du, r, ln.col0, uo);
    st4(dv, r, ln.col0, vo);
  } else if (ln.own && r >= ln.out_lo && r < ln.out_hi) {
    const long long g = tile.base + (long long)(tile.r0 + r) * a.w + tile.c0 + ln.col0;
    if constexpr (kIsFloat<A>) {
      if (a.vec && ln.own == 0xfu) {
        __stcg(reinterpret_cast<float4*>(a.uo + g), make_float4(uo[0], uo[1], uo[2], uo[3]));
        __stcg(reinterpret_cast<float4*>(a.vo + g), make_float4(vo[0], vo[1], vo[2], vo[3]));
      } else {
#pragma unroll
        for (int q = 0; q < kLaneCols; ++q) {
          if (ln.own >> q & 1u) {
            a.uo[g + q] = uo[q];
            a.vo[g + q] = vo[q];
          }
        }
      }
    } else {  // bfloat16: each value rounded to nearest even
      if (a.vec && ln.own == 0xfu) {
        __stcg(reinterpret_cast<uint2*>(a.uo + g), bf16_round4(uo[0], uo[1], uo[2], uo[3]));
        __stcg(reinterpret_cast<uint2*>(a.vo + g), bf16_round4(vo[0], vo[1], vo[2], vo[3]));
      } else {
        unsigned short* pu = reinterpret_cast<unsigned short*>(a.uo);
        unsigned short* pv = reinterpret_cast<unsigned short*>(a.vo);
#pragma unroll
        for (int q = 0; q < kLaneCols; ++q) {
          if (ln.own >> q & 1u) {
            pu[g + q] = bf16_round(uo[q]);
            pv[g + q] = bf16_round(vo[q]);
          }
        }
      }
    }
  }
}

// One sweep of a warp's kRows rows, all of them (rows outside the sweep's
// exact region are garbage that no exact pixel reads), from (su, sv) into
// (du, dv). kEdge false: no clamp anywhere in the window, the rows roll
// down in registers (the first row's i-1 and the last row's i+1 are kept
// inside the window). kEdge true: the window holds an edge of the array
// or, on a shard, a true image edge; each row takes rows i-1 and i+1 with
// their clamps, and each column its clamps. The pointers are restrict so
// that the loads of a row may be issued before the stores of the last.
template <bool kEdge, bool kShard, bool kLast, class A>
__device__ __forceinline__ void sweep_rows(
    const typename A::Elem* __restrict__ su, const typename A::Elem* __restrict__ sv,
    typename A::Elem* __restrict__ du, typename A::Elem* __restrict__ dv, const A& a,
    const Tile& tile, const Lane& ln, const Fields& f) {
  const int row0 = ln.row0, col0 = ln.col0;
  if (!kEdge) {
    float4 ut = ld4(su, max(row0 - 1, 0), col0), vt = ld4(sv, max(row0 - 1, 0), col0);
    float4 um = ld4(su, row0, col0), vm = ld4(sv, row0, col0);
#pragma unroll
    for (int jj = 0; jj < kRows; ++jj) {
      const int r = row0 + jj;
      const int rd = jj == kRows - 1 ? min(r + 1, kWinH - 1) : r + 1;
      const float4 ub = ld4(su, rd, col0), vb = ld4(sv, rd, col0);
      update_row<false, kLast>(ut, um, ub, vt, vm, vb, f.x[jj], f.y[jj], f.t[jj], f.i[jj],
                               du, dv, a, tile, ln, r);
      ut = um;
      vt = vm;
      um = ub;
      vm = vb;
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < kRows; ++jj) {
      const int r = row0 + jj;
      const int ar = tile.r0 + r, gr = tile.org_r + ar;
      const int ru = r > 0 && ar > 0 && (!kShard || gr != 0) ? r - 1 : r;  // i-1
      const int rd =
          r < kWinH - 1 && ar < a.h - 1 && (!kShard || gr != a.img_h - 1) ? r + 1 : r;  // i+1
      update_row<true, kLast>(ld4(su, ru, col0), ld4(su, r, col0), ld4(su, rd, col0),
                              ld4(sv, ru, col0), ld4(sv, r, col0), ld4(sv, rd, col0),
                              f.x[jj], f.y[jj], f.t[jj], f.i[jj], du, dv, a, tile, ln, r);
    }
  }
}

// The tile's sweeps: sweep k on the warps whose rows meet the window's rows
// shrunk by k (cut at the array's edges), a block barrier between sweeps;
// the last sweep writes the owned tile. On return `cur` and `dst` name the
// two pairs the sweeps used.
template <bool kEdge, bool kShard, class A>
__device__ __forceinline__ void run_tile(typename A::Elem* smem, int& cur, int& dst,
                                         const A& a, const Tile& tile, const Lane& ln,
                                         const Fields& f) {
  for (int k = 1; k <= a.sweeps; ++k) {
    const int rlo = max(k, tile.wr_lo), rhi = min(kWinH - k, tile.wr_hi);
    const typename A::Elem* su = smem + 2 * cur * kArea;
    typename A::Elem* du = smem + 2 * dst * kArea;
    if (ln.row0 < rhi && ln.row0 + kRows > rlo) {  // uniform across the warp
      // Each sweep's rows are straight-line code: the last sweep, which
      // writes to device memory, is its own instance.
      if (k < a.sweeps)
        sweep_rows<kEdge, kShard, false>(su, su + kArea, du, du + kArea, a, tile, ln, f);
      else
        sweep_rows<kEdge, kShard, true>(su, su + kArea, du, du + kArea, a, tile, ln, f);
    }
    if (k < a.sweeps) {
      __syncthreads();
      const int x = cur;
      cur = dst;
      dst = x;
    }
  }
}

// One staged tile's sweeps, from the pair `cur` with `dst` as the second
// buffer: the lane's column clamps (at the array's edges and, on a shard,
// at the true image edges) and owned columns, then run_tile, clamped where
// the window holds an edge.
template <bool kShard, class A>
__device__ __forceinline__ void sweep_tile(typename A::Elem* smem, int& cur, int& dst,
                                           const A& a, const Geometry& geo, const Tile& tile,
                                           Lane& ln, const Fields& f) {
  ln.lcl = ln.rcl = ln.own = 0;
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) {
    const int ac = tile.c0 + ln.col0 + q, gc = tile.org_c + ac;
    if (ac < 0 || ac >= a.w) continue;
    if (ac == 0 || (kShard && gc == 0)) ln.lcl |= 1u << q;
    if (ac == a.w - 1 || (kShard && gc == a.img_w - 1)) ln.rcl |= 1u << q;
    if (ln.col0 + q >= geo.lh && ln.col0 + q < geo.lh + geo.tw) ln.own |= 1u << q;
  }
  ln.out_lo = max(a.sweeps, tile.wr_lo);
  ln.out_hi = min(a.sweeps + geo.th, tile.wr_hi);
  // An edge in the window: the array's, or on a shard a true image edge.
  const int gr0 = tile.org_r + tile.r0, gc0 = tile.org_c + tile.c0;
  const bool edge =
      tile.wr_lo > 0 || tile.wr_hi < kWinH || tile.c0 < 0 || tile.c0 + kWinW > a.w ||
      (kShard && ((gr0 <= 0 && gr0 + kWinH > 0) || (gr0 < a.img_h && gr0 + kWinH >= a.img_h) ||
                  (gc0 <= 0 && gc0 + kWinW > 0) || (gc0 < a.img_w && gc0 + kWinW >= a.img_w)));
  if (edge)
    run_tile<true, kShard>(smem, cur, dst, a, tile, ln, f);
  else
    run_tile<false, kShard>(smem, cur, dst, a, tile, ln, f);
}

// One K2 launch's work for this block: a.sweeps sweeps from (a.u, a.v), or
// from zeros where `live` is false, into (a.uo, a.vo), on the block's tiles
// blockIdx.x, + gridDim.x, ... of the stack, in three shared u/v pairs: two
// swept, one staged for the next tile by cp.async while the current one
// sweeps. Ends with every copy landed and a block barrier.
template <bool kShard, bool kL2, class A>
__device__ __forceinline__ void walk_tiles(typename A::Elem* smem, const A& a, bool live) {
  const Geometry geo = geometry(a.sweeps);
  const int ntiles = a.b * a.tiles_x * a.tiles_y;
  if ((int)blockIdx.x >= ntiles) return;
  Lane ln;
  ln.row0 = (threadIdx.x >> 5) * kRows;
  ln.col0 = (threadIdx.x & 31) * kLaneCols;
  // u/v pair p: u at smem + 2p*kArea, v kArea further.
  int cur = 0, dst = 1, spare = 2;
  stage_tile<kL2>(smem, cur, a, tile_at<kShard>(a, geo, blockIdx.x), ln.row0, ln.col0, live);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tile = tile_at<kShard>(a, geo, t);
    Fields f;
    if constexpr (kIsFloat<A>) {
      load_fields(f, a, tile, ln.row0, ln.col0);
      const int tn = t + gridDim.x;
      if (tn < ntiles) {
        stage_tile<kL2>(smem, spare, a, tile_at<kShard>(a, geo, tn), ln.row0, ln.col0, live);
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
    } else {
      // bfloat16: the next tile is staged before the fields are loaded, so
      // that the staging's address arithmetic and loads through registers
      // never meet the fields (K6 spilled with them the other way round).
      const int tn = t + gridDim.x;
      if (tn < ntiles)
        stage_tile<kL2>(smem, spare, a, tile_at<kShard>(a, geo, tn), ln.row0, ln.col0, live);
      load_fields(f, a, tile, ln.row0, ln.col0);
      if (tn < ntiles)
        copy_wait<1>();
      else
        copy_wait<0>();
    }
    __syncthreads();
    sweep_tile<kShard>(smem, cur, dst, a, geo, tile, ln, f);
    // Every thread is done with this tile's pairs before the next staging
    // reuses one of them.
    __syncthreads();
    const int x = spare;
    spare = cur;
    cur = x;
  }
}

// -- K11, K12: the walk over the owned rectangles of a ring's images ----------

// Image, tile row and tile column of tile t of the owned rectangles: the
// interior tile rows of every image first and each image's first and last
// tile rows after them all (K11: the tiles whose windows reach a halo row,
// which may have to wait for it, last).
template <class A>
static __device__ __forceinline__ void tile_index(const A& a, int t, int& img, int& ty,
                                                  int& tx) {
  const int mid = max(a.tiles_y - 2, 0);
  const int n_mid = a.b * mid * a.tiles_x;
  const bool edge = t >= n_mid;
  const int rows = edge ? a.tiles_y - mid : mid;
  if (edge) t -= n_mid;
  img = t / (rows * a.tiles_x);
  const int rem = t - img * rows * a.tiles_x;
  const int r = rem / a.tiles_x;
  tx = rem - r * a.tiles_x;
  ty = edge ? (r == 0 ? 0 : a.tiles_y - 1) : 1 + r;
}

// Tile t of the owned rectangles, which start at row oy and column ox.
template <class A>
static __device__ __forceinline__ Tile tile_owned(const A& a, const Geometry& g, int t, int oy,
                                           int ox) {
  int img, ty, tx;
  tile_index(a, t, img, ty, tx);
  Tile x = tile_rc(a, g, img, ty, tx);
  x.r0 += oy;
  x.c0 += ox;
  x.wr_lo = max(0, -x.r0);
  x.wr_hi = min(kWinH, a.h - x.r0);
  x.org_r = a.org[2 * img];
  x.org_c = a.org[2 * img + 1];
  return x;
}

// sweep_tile on a shard (kShard) with the owned pixels ending before row
// own_h and column own_w of the array.
template <class A>
static __device__ __forceinline__ void sweep_owned(typename A::Elem* smem, int& cur, int& dst,
                                            const A& a, const Geometry& geo,
                                            const Tile& tile, Lane& ln, const Fields& f,
                                            int own_h, int own_w) {
  ln.lcl = ln.rcl = ln.own = 0;
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) {
    const int ac = tile.c0 + ln.col0 + q, gc = tile.org_c + ac;
    if (ac < 0 || ac >= a.w) continue;
    if (ac == 0 || gc == 0) ln.lcl |= 1u << q;
    if (ac == a.w - 1 || gc == a.img_w - 1) ln.rcl |= 1u << q;
    if (ln.col0 + q >= geo.lh && ln.col0 + q < geo.lh + geo.tw && ac < own_w)
      ln.own |= 1u << q;
  }
  ln.out_lo = max(a.sweeps, tile.wr_lo);
  ln.out_hi = min(min(a.sweeps + geo.th, tile.wr_hi), own_h - tile.r0);
  const int gr0 = tile.org_r + tile.r0, gc0 = tile.org_c + tile.c0;
  const bool edge =
      tile.wr_lo > 0 || tile.wr_hi < kWinH || tile.c0 < 0 || tile.c0 + kWinW > a.w ||
      (gr0 <= 0 && gr0 + kWinH > 0) || (gr0 < a.img_h && gr0 + kWinH >= a.img_h) ||
      (gc0 <= 0 && gc0 + kWinW > 0) || (gc0 < a.img_w && gc0 + kWinW >= a.img_w);
  if (edge)
    run_tile<true, true>(smem, cur, dst, a, tile, ln, f);
  else
    run_tile<false, true>(smem, cur, dst, a, tile, ln, f);
}

// walk_tiles (kShard, kL2) over the owned rectangles, which start at row
// ring.oy() and column ring.ox(), in tile_index's order; every thread
// calls ring.before_stage(a, t, tile) before tile t is staged. The next
// tile is staged before this tile's fields are loaded, so that the 4-byte
// staging's loads through registers never meet the fields there.
template <class Ring, class A>
__device__ __forceinline__ void walk_owned(typename A::Elem* smem, const A& a,
                                           const Ring& ring) {
  const Geometry geo = geometry(a.sweeps);
  const int ntiles = a.b * a.tiles_x * a.tiles_y;
  if ((int)blockIdx.x >= ntiles) return;
  Lane ln;
  ln.row0 = (threadIdx.x >> 5) * kRows;
  ln.col0 = (threadIdx.x & 31) * kLaneCols;
  int cur = 0, dst = 1, spare = 2;
  const Tile first = tile_owned(a, geo, blockIdx.x, ring.oy(), ring.ox());
  ring.before_stage(a, blockIdx.x, first);
  stage_tile<true>(smem, cur, a, first, ln.row0, ln.col0, true);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tile = tile_owned(a, geo, t, ring.oy(), ring.ox());
    const int tn = t + gridDim.x;
    if (tn < ntiles) {
      const Tile next = tile_owned(a, geo, tn, ring.oy(), ring.ox());
      ring.before_stage(a, tn, next);
      stage_tile<true>(smem, spare, a, next, ln.row0, ln.col0, true);
    }
    Fields f;
    load_fields(f, a, tile, ln.row0, ln.col0);
    if (tn < ntiles)
      copy_wait<1>();
    else
      copy_wait<0>();
    __syncthreads();
    sweep_owned(smem, cur, dst, a, geo, tile, ln, f, a.h - ring.oy(), a.w - ring.ox());
    __syncthreads();
    const int x = spare;
    spare = cur;
    cur = x;
  }
}

// tile_index over owned rectangles of tiles_y x tiles_x tiles.
template <class A>
static __device__ __forceinline__ void tile_index_in(const A& a, int tiles_x, int tiles_y,
                                                     int t, int& img, int& ty, int& tx) {
  const int mid = max(tiles_y - 2, 0);
  const int n_mid = a.b * mid * tiles_x;
  const bool edge = t >= n_mid;
  const int rows = edge ? tiles_y - mid : mid;
  if (edge) t -= n_mid;
  img = t / (rows * tiles_x);
  const int rem = t - img * rows * tiles_x;
  const int r = rem / tiles_x;
  tx = rem - r * tiles_x;
  ty = edge ? (r == 0 ? 0 : tiles_y - 1) : 1 + r;
}

// tile_owned over the Ring's rectangle.
template <class Ring, class A>
static __device__ __forceinline__ Tile tile_owned_in(const A& a, const Geometry& g, int t,
                                                     const Ring& ring) {
  int img, ty, tx;
  tile_index_in(a, ring.tiles_x(), ring.tiles_y(), t, img, ty, tx);
  Tile x = tile_rc(a, g, img, ty, tx);
  x.r0 += ring.oy();
  x.c0 += ring.ox();
  x.wr_lo = max(0, -x.r0);
  x.wr_hi = min(kWinH, a.h - x.r0);
  x.org_r = a.org[2 * img];
  x.org_c = a.org[2 * img + 1];
  return x;
}

// walk_owned over the Ring's rectangle: rows [ring.oy(), h - ring.oy()),
// columns [ring.ox(), w - ring.ox()), ring.tiles_y() x ring.tiles_x()
// tiles of a.sweeps; ring.before_stage(a, t, tile) before tile t is staged.
template <class Ring, class A>
__device__ __forceinline__ void walk_rect(typename A::Elem* smem, const A& a,
                                          const Ring& ring) {
  const Geometry geo = geometry(a.sweeps);
  if ((int)blockIdx.x >= a.b * ring.tiles_x() * ring.tiles_y()) return;
  Lane ln;
  ln.row0 = (threadIdx.x >> 5) * kRows;
  ln.col0 = (threadIdx.x & 31) * kLaneCols;
  int cur = 0, dst = 1, spare = 2;
  const Tile first = tile_owned_in(a, geo, blockIdx.x, ring);
  ring.before_stage(a, blockIdx.x, first);
  stage_tile<true>(smem, cur, a, first, ln.row0, ln.col0, true);
  for (int t = blockIdx.x; t < a.b * ring.tiles_x() * ring.tiles_y(); t += gridDim.x) {
    const Tile tile = tile_owned_in(a, geo, t, ring);
    const int tn = t + gridDim.x;
    const bool more = tn < a.b * ring.tiles_x() * ring.tiles_y();
    if (more) {
      const Tile next = tile_owned_in(a, geo, tn, ring);
      ring.before_stage(a, tn, next);
      stage_tile<true>(smem, spare, a, next, ln.row0, ln.col0, true);
    }
    Fields f;
    load_fields(f, a, tile, ln.row0, ln.col0);
    if (more)
      copy_wait<1>();
    else
      copy_wait<0>();
    __syncthreads();
    sweep_owned(smem, cur, dst, a, geo, tile, ln, f, a.h - ring.oy(), a.w - ring.ox());
    __syncthreads();
    const int x = spare;
    spare = cur;
    cur = x;
  }
}

// A kernel's build: tile rows and columns at `sweeps`, threads a block,
// shared bytes a block, registers a thread, local (spilled) bytes a
// thread, blocks resident on one multiprocessor, and the number of
// multiprocessors, into out[0..7].
template <class Kernel>
cudaError_t report(Kernel kernel, size_t smem, int sweeps, int device, int grid_max,
                   int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const Geometry g = geometry(sweeps);
  out[0] = g.th;
  out[1] = g.tw;
  out[2] = kThreads;
  out[3] = (int)smem;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = grid_max / sms;
  out[7] = sms;
  return cudaSuccess;
}

inline bool aligned(const void* p, unsigned long long bytes = 16) {
  return ((unsigned long long)p & (bytes - 1)) == 0;
}

}  // namespace hs_k2
