// K5: the TV-L1 inner loop, `iters` alternations of one warp iteration
// (tvl1.py, tvl1_warp_iteration's loop body), over one frame or a (B, H, W)
// stack, behind one C entry point, hs_tvl1_inner, that enqueues every launch.
//
// Replaces opticalflowhs_tpu/kernels/tvl1_inner.py, _tvl1_kernel (line 99,
// called at line 220). That kernel keeps the 6 state fields (u1, u2, p1x,
// p1y, p2x, p2y) and the 5 constant fields (rho0, gx, gy, 1/g2, th)
// resident in VMEM and runs each alternation as two banded passes in place:
// pass 1 writes u and reads p, pass 2 writes p and reads the new u. At
// 1088x1920 the 11 fields take 92 MB, more than the card's shared memory
// and registers together, so that one-launch schedule does not carry over.
// What does is temporal blocking, as in K2 (csrc/jacobi.cu): one
// alternation has a dependency halo of one pixel (the u-step reads p at
// (r, c-1) and (r-1, c), the p-step the new u at (r, c+1) and (r+1, c)), so
// after s alternations the exact region of a window has shrunk by s on
// every side. Each launch runs s alternations on shared-memory windows:
//   * u-step: rho = (rho0 + u1*gx) + u2*gy, the three-case step, v = u +
//     step*g, then u = v + theta*div p from p at (r, c-1) and (r-1, c), zero
//     at the true column 0 and row 0. It writes u at its own pixel and reads
//     p, which nobody writes in that pass.
//   * p-step: dx, dy of the new u1 and u2, zero at the true last column and
//     row, n = 1 + sigma*sqrt(dx^2 + dy^2), then (p + sigma*d)/n, with px
//     zeroed at c = w-1 and py at r = h-1 (tvl1.py _mask_dual). It writes p
//     at its own pixel and reads u, which nobody writes in that pass.
// So the reference's in-place two-pass discipline holds inside a window with
// one block barrier between the passes.
//
// Design (one persistent block of 1024 threads a streaming multiprocessor):
//   * A block walks 32 x 128 windows of the stack (image, tile row, tile
//     column; tile column fastest, so that neighbouring blocks share halos
//     in L2). Each tile is the window less s rows above and below, s
//     columns rounded up to 4 on the left and at least s on the right
//     (`geometry`, K2's rule): 24 x 120 at s = 4. Windows never span two
//     images; edges are per image.
//   * Warp j owns window row j, lane l the 4 columns 4l..4l+3. Shared
//     memory holds all 11 arrays of the window (cp.async, zero outside the
//     image), updated in place, and a second slot for rho0, gx and gy,
//     into which those of the block's next tile are staged while this one
//     runs: 229,376 bytes. Keeping the constant fields in registers instead
//     (48 x 128 windows, 3 rows and 60 field registers a thread) left too
//     few registers for the arithmetic and ran slower.
//   * A lane takes the column neighbour of its first (last) column from
//     the lane beside it by a warp shuffle, the row neighbours from shared
//     memory. Edge lanes receive their own value: window columns 0 and 127
//     are halo, and what they compute is never read by an exact pixel.
//   * Alternation k runs its u-step on window rows [k, 32-k+1) and its
//     p-step on [k, 32-k), cut at the image's edges; what the rest of a row
//     computes is never read by an exact pixel. After the last alternation
//     the owned tile goes from shared to device memory.
//   * A call of n alternations is ceil(n/s) launches, ping-ponging between
//     two slots of every state array: a launch reads slot A and writes its
//     owned tile into slot B. The first launch starts from zero duals in the
//     kernel (it reads 7 arrays, not 11); the last one skips its final
//     p-step and writes only u1 and u2. A remainder of n mod s runs as a
//     shorter last launch. s is block_iters, or the s in [2, 8] that
//     minimises launches x rounds of tiles x (s + the staging's cost)
//     (`plan`), so that a coarse pyramid level, whose tiles do not fill the
//     card, takes fewer, longer launches.
//
// Batch: image k starts k*h*w floats into every array (a 64-bit stride).
// The entry point refuses batches beyond 65535, the limit the other kernels'
// grids keep.
//
// Bounds: the function reads u1, u2 and the 5 constant fields once and
// writes u1, u2 once (9 arrays, 75 MB at 1088x1920, 22 us at 3.35 TB/s),
// and does 51 float32 operations a pixel an alternation, 4 of them IEEE
// divisions and 2 square roots, which take several instructions each
// without fast math (chip_smoke.py K5_OPS_PER_PX_ITER counts 93): the
// operations bound it (0.29 ms at 1088x1920). The schedule itself moves,
// per launch, the 11 arrays of the windows in (1.42x the tile at s = 4) and
// the 6 state arrays of the tiles out: 1.33 ms at 1088x1920, against 5.74
// for the two launches an alternation it replaces. Measured on an H100 at
// 700 W (PERF.md): 3.39-3.46 ms a call of 100 alternations at 1088x1920
// (7.74 before), held back by the alternations' arithmetic (2.26 ms with
// no staging at all, tools/torch_k5_limits.py) and by the staging of the
// 8 arrays that are not prefetched, which no other work hides.
//
// Exactness: the association order is that of tvl1.py (lines 189-205);
// theta, sigma and lambda*theta come in as the float32 values torch rounds
// them to; the divisions are IEEE divisions and the norm is sqrtf, which
// equals _safe_norm in value (sqrt(+0) = +0). With --fmad=false the output
// equals the plain PyTorch loop on the card bitwise.
//
// bfloat16 (tvl1_kernel_bf16, hs_tvl1_inner_bf16): every array in device
// memory is bfloat16, the window in shared memory stays float32, with the
// float32 build's geometry, plan and launches. Arrays are widened where they
// are staged: the 6 state arrays, inv_g2 and th by 8-byte loads (a lane's 4
// values) at the tile's start; rho0, gx and gy of the next tile by one 8-byte
// cp.async a row into a bfloat16 buffer in the second slot's bytes (cp.async
// copies bytes and cannot widen), widened into the float32 slot when that
// tile starts; at widths that are not a multiple of 4 by 2-byte loads. The
// u-step rounds u1 and u2 to nearest even where it stores them, the p-step
// the four duals, in shared memory and in the halo as well (time-blocking
// recomputes the halo, and its values must equal the neighbour tile's);
// rho, the step, v, the differences and the norms stay float32. So the
// bfloat16 build equals the plain bfloat16 twin (kernels/tvl1_inner.py,
// ops/stencils.py `store`) bitwise at every s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxBatch = 65535;
constexpr int kLaneCols = 4;           // adjacent columns a lane owns
constexpr int kWinW = 32 * kLaneCols;  // 128: one warp spans the window
constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;  // 1024
constexpr int kWinH = kWarps;          // warp j owns window row j
constexpr int kArea = kWinH * kWinW;
constexpr int kStates = 6;             // u1, u2, p1x, p1y, p2x, p2y
constexpr int kFields = 5;             // rho0, gx, gy, inv_g2, th
constexpr int kArrays = kStates + kFields;
// Shared memory: the 6 state arrays, inv_g2 and th, and two slots of three
// arrays for rho0, gx and gy, one for the current tile and one being staged
// for the next: 14 window arrays, 229,376 bytes.
constexpr int kPrefetched = 3;
constexpr int kSlots = kArrays + kPrefetched;
constexpr size_t kSmemBytes = (size_t)kSlots * kArea * sizeof(float);
// The most alternations a launch: the range of the auto rule (`plan`).
constexpr int kMaxIters = 8;
// The auto rule's cost of staging a window, in alternations of it
// (`plan`): measured on an H100, staging all 11 arrays takes about half as
// long as 4 alternations on them.
constexpr int kStageCost = 2;

struct Geometry {
  int th, tw, lh;
};

// The tile of s alternations inside the window: th x tw at window row s and
// column lh (s rounded up to 4, so that tile and window columns stay
// 16-byte aligned in the image); at least s columns on the right.
__host__ __device__ inline Geometry geometry(int s) {
  Geometry g;
  g.lh = (s + kLaneCols - 1) / kLaneCols * kLaneCols;
  g.th = kWinH - 2 * s;
  g.tw = (kWinW - g.lh - s) / kLaneCols * kLaneCols;
  return g;
}

// A launch's arguments, for arrays of storage type E (float or bfloat16).
template <class E>
struct ArgsOf {
  using Elem = E;
  const E* in[kStates];   // slot read; in[2..5] null: zero duals
  const E* f[kFields];
  E* out[kStates];        // slot written; out[2..5] null: u only
  int b, h, w, iters, tiles_x, tiles_y;
  float theta, sigma, lam_theta;
  int vec;                // 16-byte loads and stores (bfloat16: 8-byte)
};
struct Args : ArgsOf<float> {};
struct ArgsBf16 : ArgsOf<__nv_bfloat16> {};

// One tile: the window's origin in its image, and where the image starts.
struct Tile {
  long long base;
  int r0, c0;
};

template <class A>
__device__ __forceinline__ Tile tile_at(const A& a, const Geometry& g, int t) {
  const int per_img = a.tiles_x * a.tiles_y;
  const int img = t / per_img;
  const int rem = t - img * per_img;
  const int ty = rem / a.tiles_x;
  const int tx = rem - ty * a.tiles_x;
  Tile x;
  x.base = (long long)img * a.h * a.w;
  x.r0 = ty * g.th - a.iters;
  x.c0 = tx * g.tw - g.lh;
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

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every copy but those of the last group committed.
__device__ __forceinline__ void copy_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cp.async of 8 bytes (4 bfloat16 values); src_size 0 fills zeros.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst, const __nv_bfloat16* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

// bfloat16 to and from float, only by the intrinsics; 4 values packed in 8
// bytes, the lower address in the lower bits.
__device__ __forceinline__ float bf16_widen(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

__device__ __forceinline__ float4 bf16_widen4(const uint2& x) {
  return make_float4(bf16_widen((unsigned short)(x.x & 0xffffu)),
                     bf16_widen((unsigned short)(x.x >> 16)),
                     bf16_widen((unsigned short)(x.y & 0xffffu)),
                     bf16_widen((unsigned short)(x.y >> 16)));
}

__device__ __forceinline__ unsigned bf16_round2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// x rounded to bfloat16 (nearest even) where kRound, widened back; x itself
// otherwise.
template <bool kRound>
__device__ __forceinline__ float stored(float x) {
  if constexpr (kRound) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ void unpack(const float4& v, float (&x)[kLaneCols]) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// A thread's 4 pixels of one window array at window row r.
__device__ __forceinline__ void ld4(const float* s, int r, int c, float (&x)[kLaneCols]) {
  unpack(*reinterpret_cast<const float4*>(s + r * kWinW + c), x);
}

__device__ __forceinline__ void st4(float* s, int r, int c, const float (&x)[kLaneCols]) {
  *reinterpret_cast<float4*>(s + r * kWinW + c) = make_float4(x[0], x[1], x[2], x[3]);
}

// A thread's place: window row r (its warp) and columns c..c+3 (its lane),
// the row's image row, and which of its columns are the image's column 0 and
// w-1 (bit q).
struct Lane {
  int r, c, ar;
  unsigned cfirst, clast;
};

// Starts the copy of this thread's 4 pixels of one array into the window
// (zero outside the image), or with src null writes zeros.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, const Args& a,
                                      const Tile& t, const Lane& ln) {
  float* d = dst + ln.r * kWinW + ln.c;
  if (src == nullptr) {
    *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const int ac = t.c0 + ln.c;
  const bool row_in = ln.ar >= 0 && ln.ar < a.h;
  const long long g = t.base + (long long)ln.ar * a.w + ac;
  if (a.vec) {
    // ac and w are multiples of 4: the 4 columns are all in or all out.
    const bool in = row_in && ac >= 0 && ac < a.w;
    copy16(d, in ? src + g : src, in);
  } else {
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const bool in = row_in && ac + q >= 0 && ac + q < a.w;
      copy4(d + q, in ? src + g + q : src, in);
    }
  }
}

// The bfloat16 build's staging. A thread's 4 pixels of one array, widened
// into the float32 window (zero outside the image), or with src null zeros:
// one 8-byte load with vec, else 2-byte loads.
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* __restrict__ src,
                                      const ArgsBf16& a, const Tile& t, const Lane& ln) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (src != nullptr) {
    const int ac = t.c0 + ln.c;
    const bool row_in = ln.ar >= 0 && ln.ar < a.h;
    const long long g = t.base + (long long)ln.ar * a.w + ac;
    if (a.vec) {
      if (row_in && ac >= 0 && ac < a.w) x = bf16_widen4(*reinterpret_cast<const uint2*>(src + g));
    } else {
      float y[kLaneCols];
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q) {
        const bool in = row_in && ac + q >= 0 && ac + q < a.w;
        y[q] = in ? __bfloat162float(src[g + q]) : 0.0f;
      }
      x = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
  *reinterpret_cast<float4*>(dst + ln.r * kWinW + ln.c) = x;
}

// Starts the copy of this thread's 4 bfloat16 pixels of one array into the
// bfloat16 buffer `dst` (zero outside the image): one 8-byte cp.async with
// vec, else 2-byte loads and stores, done when the call returns.
__device__ __forceinline__ void prefetch(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                         const ArgsBf16& a, const Tile& t, const Lane& ln) {
  __nv_bfloat16* d = dst + ln.r * kWinW + ln.c;
  const int ac = t.c0 + ln.c;
  const bool row_in = ln.ar >= 0 && ln.ar < a.h;
  const long long g = t.base + (long long)ln.ar * a.w + ac;
  if (a.vec) {
    const bool in = row_in && ac >= 0 && ac < a.w;
    copy8(d, in ? src + g : src, in);
  } else {
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const bool in = row_in && ac + q >= 0 && ac + q < a.w;
      d[q] = in ? src[g + q] : __float2bfloat16_rn(0.0f);
    }
  }
}

// u = v + theta*div p for one field: p at the pixel, left of it (from the
// lane beside for the first column) and above it, zero at the image's column
// 0 and row 0. kRound (bfloat16): u rounded where it is stored.
template <bool kRound>
__device__ __forceinline__ void u_field(float* __restrict__ su, const float* __restrict__ spx,
                                        const float* __restrict__ spy, const Lane& ln,
                                        float theta, const float (&a)[kLaneCols],
                                        const float (&step)[kLaneCols],
                                        const float (&g)[kLaneCols]) {
  float x[kLaneCols], y[kLaneCols], t[kLaneCols], o[kLaneCols];
  ld4(spx, ln.r, ln.c, x);
  ld4(spy, ln.r, ln.c, y);
  ld4(spy, max(ln.r - 1, 0), ln.c, t);
  const float l = __shfl_up_sync(0xffffffffu, x[kLaneCols - 1], 1);
  const bool rfirst = ln.ar == 0;
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) {
    const float v = a[q] + step[q] * g[q];
    const float qx = (ln.cfirst >> q & 1u) ? 0.0f : (q == 0 ? l : x[q > 0 ? q - 1 : 0]);
    const float qy = rfirst ? 0.0f : t[q];
    const float div = (x[q] - qx) + (y[q] - qy);
    o[q] = stored<kRound>(v + theta * div);
  }
  st4(su, ln.r, ln.c, o);
}

// The u-step of a thread's 4 pixels, in place; `tri` holds rho0, gx, gy.
template <bool kRound, class A>
__device__ __forceinline__ void u_step(float* __restrict__ sm, const float* __restrict__ tri,
                                       const A& a, const Lane& ln) {
  const float* sf = sm + kStates * kArea;  // inv_g2, th
  float a1[kLaneCols], a2[kLaneCols], gx[kLaneCols], gy[kLaneCols], step[kLaneCols];
  {
    float rho0[kLaneCols], ig2[kLaneCols], th[kLaneCols];
    ld4(sm, ln.r, ln.c, a1);
    ld4(sm + kArea, ln.r, ln.c, a2);
    ld4(tri, ln.r, ln.c, rho0);
    ld4(tri + kArea, ln.r, ln.c, gx);
    ld4(tri + 2 * kArea, ln.r, ln.c, gy);
    ld4(sf, ln.r, ln.c, ig2);
    ld4(sf + kArea, ln.r, ln.c, th);
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      // v-step: the closed-form prox of the L1 data term.
      const float rho = (rho0[q] + a1[q] * gx[q]) + a2[q] * gy[q];
      step[q] = rho < -th[q]  ? a.lam_theta
                : rho > th[q] ? -a.lam_theta
                              : -rho * ig2[q];
    }
  }
  u_field<kRound>(sm, sm + 2 * kArea, sm + 3 * kArea, ln, a.theta, a1, step, gx);
  u_field<kRound>(sm + kArea, sm + 4 * kArea, sm + 5 * kArea, ln, a.theta, a2, step, gy);
}

// The p-step of one field of a thread's 4 pixels, in place: p from the new u
// at the pixel, right of it (from the lane beside for the last column) and
// below it, and p at the pixel; the differences are zero at the image's last
// column and row, where the clamped shift of the plain version gives a - a,
// and px (py) is written as zero there (tvl1.py _mask_dual). kRound
// (bfloat16): p rounded where it is stored.
template <bool kRound>
__device__ __forceinline__ void p_field(const float* __restrict__ su, float* __restrict__ spx,
                                        float* __restrict__ spy, const Lane& ln, bool rlast,
                                        float sigma) {
  float c[kLaneCols], n[kLaneCols], x[kLaneCols], y[kLaneCols];
  ld4(su, ln.r, ln.c, c);
  ld4(su, min(ln.r + 1, kWinH - 1), ln.c, n);
  ld4(spx, ln.r, ln.c, x);
  ld4(spy, ln.r, ln.c, y);
  const float g = __shfl_down_sync(0xffffffffu, c[0], 1);
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) {
    const bool clast = ln.clast >> q & 1u;
    const float dx =
        clast ? 0.0f : (q == kLaneCols - 1 ? g : c[q < kLaneCols - 1 ? q + 1 : q]) - c[q];
    const float dy = rlast ? 0.0f : n[q] - c[q];
    const float nrm = 1.0f + sigma * sqrtf(dx * dx + dy * dy);
    const float qx = (x[q] + sigma * dx) / nrm;
    const float qy = (y[q] + sigma * dy) / nrm;
    x[q] = clast ? 0.0f : stored<kRound>(qx);
    y[q] = rlast ? 0.0f : stored<kRound>(qy);
  }
  st4(spx, ln.r, ln.c, x);
  st4(spy, ln.r, ln.c, y);
}

// Writes this thread's owned pixels of one window array to device memory.
__device__ __forceinline__ void store(float* __restrict__ dst, const float* src, const Args& a,
                                      const Tile& t, const Lane& ln, unsigned own) {
  float x[kLaneCols];
  ld4(src, ln.r, ln.c, x);
  const long long g = t.base + (long long)ln.ar * a.w + t.c0 + ln.c;
  if (a.vec && own == 0xfu) {
    __stcg(reinterpret_cast<float4*>(dst + g), make_float4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q)
      if (own >> q & 1u) dst[g + q] = x[q];
  }
}

// The bfloat16 build's store: the owned pixels rounded to bfloat16 (the
// window holds values the u- and p-steps already rounded, so the conversion
// is exact), 8 bytes at once with vec.
__device__ __forceinline__ void store(__nv_bfloat16* __restrict__ dst, const float* src,
                                      const ArgsBf16& a, const Tile& t, const Lane& ln,
                                      unsigned own) {
  float x[kLaneCols];
  ld4(src, ln.r, ln.c, x);
  const long long g = t.base + (long long)ln.ar * a.w + t.c0 + ln.c;
  if (a.vec && own == 0xfu) {
    __stcg(reinterpret_cast<uint2*>(dst + g),
           make_uint2(bf16_round2(x[0], x[1]), bf16_round2(x[2], x[3])));
  } else {
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q)
      if (own >> q & 1u) dst[g + q] = __float2bfloat16_rn(x[q]);
  }
}

// A thread's place in tile t.
template <class A>
__device__ __forceinline__ Lane lane_at(const A& a, const Tile& t, int r, int c) {
  Lane ln;
  ln.r = r;
  ln.c = c;
  ln.ar = t.r0 + r;
  ln.cfirst = ln.clast = 0;
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) {
    const int ac = t.c0 + c + q;
    if (ac == 0) ln.cfirst |= 1u << q;
    if (ac == a.w - 1) ln.clast |= 1u << q;
  }
  return ln;
}

// Starts the copies of rho0, gx and gy of tile t into the slot `tri`.
__device__ __forceinline__ void stage_tri(float* tri, const Args& a, const Tile& t,
                                          const Lane& ln) {
#pragma unroll
  for (int k = 0; k < kPrefetched; ++k) stage(tri + k * kArea, a.f[k], a, t, ln);
}

// One persistent block an SM walks the tiles (image, tile row, tile column;
// tile column fastest, so that neighbouring blocks share halos in L2).
// While it runs one tile, cp.async stages rho0, gx and gy of its next tile
// into the other slot; the rest is staged when the tile starts.
__global__ void __launch_bounds__(kThreads, 1) tvl1_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Geometry geo = geometry(a.iters);
  const int ntiles = a.b * a.tiles_x * a.tiles_y;
  const bool last_launch = a.out[2] == nullptr;
  const int r = threadIdx.x >> 5, c = (threadIdx.x & 31) * kLaneCols;
  int slot = 0;  // the slot of rho0, gx, gy: at array kStates + 2 or kArrays
  if ((int)blockIdx.x < ntiles) {
    const Tile t0 = tile_at(a, geo, blockIdx.x);
    stage_tri(smem + (kStates + 2) * kArea, a, t0, lane_at(a, t0, r, c));
  }
  for (int ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const Tile tile = tile_at(a, geo, ti);
    const Lane ln = lane_at(a, tile, r, c);
    float* tri = smem + (slot ? kArrays : kStates + 2) * kArea;
    unsigned own = 0;  // columns of the owned tile, inside the image
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const int ac = tile.c0 + c + q;
      if (ac >= 0 && ac < a.w && c + q >= geo.lh && c + q < geo.lh + geo.tw) own |= 1u << q;
    }
    if (r < a.iters || r >= a.iters + geo.th || ln.ar >= a.h) own = 0;
#pragma unroll
    for (int k = 0; k < kStates; ++k) stage(smem + k * kArea, a.in[k], a, tile, ln);
    stage(smem + kStates * kArea, a.f[3], a, tile, ln);
    stage(smem + (kStates + 1) * kArea, a.f[4], a, tile, ln);
    copy_commit();
    const int tn = ti + gridDim.x;
    if (tn < ntiles) {
      const Tile next = tile_at(a, geo, tn);
      stage_tri(smem + (slot ? kStates + 2 : kArrays) * kArea, a, next, lane_at(a, next, r, c));
    }
    copy_commit();
    copy_wait_but_last();
    __syncthreads();

    // Alternation k: the u-step on window rows [k, H-k+1), the p-step on
    // [k, H-k), both cut at the image's edges (a row outside them computes
    // nothing any exact pixel reads). The call's last p-step is not needed.
    const bool in_img = ln.ar >= 0 && ln.ar < a.h;
    const bool rlast = ln.ar == a.h - 1;
    for (int k = 1; k <= a.iters; ++k) {
      const bool final_p = k == a.iters && last_launch;
      if (in_img && ln.r >= k && ln.r < kWinH - k + 1) u_step<false>(smem, tri, a, ln);
      __syncthreads();
      if (final_p) break;
      if (in_img && ln.r >= k && ln.r < kWinH - k) {
        p_field<false>(smem, smem + 2 * kArea, smem + 3 * kArea, ln, rlast, a.sigma);
        p_field<false>(smem + kArea, smem + 4 * kArea, smem + 5 * kArea, ln, rlast, a.sigma);
      }
      __syncthreads();
    }
    // The owned tile to device memory: u1 and u2, and in all but the call's
    // last launch the duals.
    if (own) {
      const int n_out = last_launch ? 2 : kStates;
      for (int k = 0; k < n_out; ++k) store(a.out[k], smem + k * kArea, a, tile, ln, own);
    }
    // Every thread is done with the window before the next staging.
    __syncthreads();
    slot ^= 1;
  }
}

// The bfloat16 build: tvl1_kernel's walk and alternations on the same
// float32 window, the state rounded where the u- and p-steps store it.
// rho0, gx and gy of the block's next tile land in a bfloat16 buffer in the
// second slot's bytes (cp.async copies bytes and cannot widen) and are
// widened into the one float32 slot when that tile starts, before the buffer
// takes the tile after it; the other 8 arrays are widened as they are loaded.
// Each thread widens and prefetches only its own pixels, so no barrier
// stands between the two.
__global__ void __launch_bounds__(kThreads, 1) tvl1_kernel_bf16(const ArgsBf16 a) {
  extern __shared__ __align__(16) float smem[];
  const Geometry geo = geometry(a.iters);
  const int ntiles = a.b * a.tiles_x * a.tiles_y;
  const bool last_launch = a.out[2] == nullptr;
  const int r = threadIdx.x >> 5, c = (threadIdx.x & 31) * kLaneCols;
  float* tri = smem + (kStates + 2) * kArea;
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem + kArrays * kArea);
  if ((int)blockIdx.x < ntiles) {
    const Tile t0 = tile_at(a, geo, blockIdx.x);
    const Lane l0 = lane_at(a, t0, r, c);
#pragma unroll
    for (int k = 0; k < kPrefetched; ++k) prefetch(buf + k * kArea, a.f[k], a, t0, l0);
    copy_commit();
  }
  for (int ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const Tile tile = tile_at(a, geo, ti);
    const Lane ln = lane_at(a, tile, r, c);
    unsigned own = 0;  // columns of the owned tile, inside the image
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const int ac = tile.c0 + c + q;
      if (ac >= 0 && ac < a.w && c + q >= geo.lh && c + q < geo.lh + geo.tw) own |= 1u << q;
    }
    if (r < a.iters || r >= a.iters + geo.th || ln.ar >= a.h) own = 0;
    copy_wait_all();
#pragma unroll
    for (int k = 0; k < kPrefetched; ++k) {
      const uint2 x = *reinterpret_cast<const uint2*>(buf + k * kArea + r * kWinW + c);
      *reinterpret_cast<float4*>(tri + k * kArea + r * kWinW + c) = bf16_widen4(x);
    }
    const int tn = ti + gridDim.x;
    if (tn < ntiles) {
      const Tile next = tile_at(a, geo, tn);
      const Lane lnext = lane_at(a, next, r, c);
#pragma unroll
      for (int k = 0; k < kPrefetched; ++k) prefetch(buf + k * kArea, a.f[k], a, next, lnext);
      copy_commit();
    }
#pragma unroll
    for (int k = 0; k < kStates; ++k) stage(smem + k * kArea, a.in[k], a, tile, ln);
    stage(smem + kStates * kArea, a.f[3], a, tile, ln);
    stage(smem + (kStates + 1) * kArea, a.f[4], a, tile, ln);
    __syncthreads();

    const bool in_img = ln.ar >= 0 && ln.ar < a.h;
    const bool rlast = ln.ar == a.h - 1;
    for (int k = 1; k <= a.iters; ++k) {
      const bool final_p = k == a.iters && last_launch;
      if (in_img && ln.r >= k && ln.r < kWinH - k + 1) u_step<true>(smem, tri, a, ln);
      __syncthreads();
      if (final_p) break;
      if (in_img && ln.r >= k && ln.r < kWinH - k) {
        p_field<true>(smem, smem + 2 * kArea, smem + 3 * kArea, ln, rlast, a.sigma);
        p_field<true>(smem + kArea, smem + 4 * kArea, smem + 5 * kArea, ln, rlast, a.sigma);
      }
      __syncthreads();
    }
    if (own) {
      const int n_out = last_launch ? 2 : kStates;
      for (int k = 0; k < n_out; ++k) store(a.out[k], smem + k * kArea, a, tile, ln, own);
    }
    __syncthreads();
  }
}

// The kernel of a build: float32 (Args) or bfloat16 (ArgsBf16).
template <class A>
auto kernel_of() {
  if constexpr (std::is_same<A, Args>::value) {
    return tvl1_kernel;
  } else {
    return tvl1_kernel_bf16;
  }
}

template <class A>
cudaError_t configure(int device, int* grid_max) {
  // Per device and build: opt into the shared memory above 48 KB, and the
  // number of blocks that can be resident at once (the persistent grid).
  static int cached[64];
  if (device >= 0 && device < 64 && cached[device] > 0) {
    *grid_max = cached[device];
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel_of<A>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of<A>(), kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid_max = per_sm * sms;
  if (device >= 0 && device < 64) cached[device] = *grid_max;
  return cudaSuccess;
}

// The vector path's alignment: 16 bytes for float (float4), 8 for bfloat16
// (a lane's 4 values).
bool aligned(const void* p, unsigned long long bytes) {
  return ((unsigned long long)p & (bytes - 1)) == 0;
}

long long tiles_of(int b, int h, int w, int s) {
  const Geometry g = geometry(s);
  return (long long)b * ((h + g.th - 1) / g.th) * ((w + g.tw - 1) / g.tw);
}

// Alternations a launch: block_iters, or for 0 the s in [2, 8] that
// minimises the launches times the rounds of tiles a resident block walks
// times the cost of one round (s alternations and the staging), the first
// such s on a tie. Measured on an H100, it picks s = 4 at 1088x1920 and 8 x
// 1088x1920, 6 at 544x960 and 8 at 272x480 for 100 alternations.
int plan(int b, int h, int w, int iters, int block_iters, int grid_max) {
  if (block_iters > 0) return block_iters;
  int best = 2;
  long long best_cost = -1;
  for (int s = 2; s <= kMaxIters; ++s) {
    const long long rounds = (tiles_of(b, h, w, s) + grid_max - 1) / grid_max;
    const long long cost = (long long)((iters + s - 1) / s) * rounds * (s + kStageCost);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// `iters` alternations as ceil(iters/s) launches of A's build (s from
// `plan`): hs_tvl1_inner's body for either storage type.
template <class A>
int inner(typename A::Elem* u1, typename A::Elem* u2, const typename A::Elem* rho0,
          const typename A::Elem* gx, const typename A::Elem* gy,
          const typename A::Elem* inv_g2, const typename A::Elem* th, typename A::Elem* p1x,
          typename A::Elem* p1y, typename A::Elem* p2x, typename A::Elem* p2y, int b, int h,
          int w, int iters, float theta, float sigma, float lam_theta, int block_iters,
          int device, void* stream, int* launches) {
  using E = typename A::Elem;
  *launches = 0;
  if (b < 1 || b > kMaxBatch || h < 1 || w < 1 || iters < 1 || block_iters < 0 ||
      block_iters > kMaxIters)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid_max = 0;
  err = configure<A>(device, &grid_max);
  if (err != cudaSuccess) return (int)err;
  const int s = plan(b, h, w, iters, block_iters, grid_max);
  const long long n = (long long)b * h * w;
  E* state[kStates] = {u1, u2, p1x, p1y, p2x, p2y};
  A a;
  a.f[0] = rho0;
  a.f[1] = gx;
  a.f[2] = gy;
  a.f[3] = inv_g2;
  a.f[4] = th;
  a.b = b;
  a.h = h;
  a.w = w;
  a.theta = theta;
  a.sigma = sigma;
  a.lam_theta = lam_theta;
  const unsigned long long bytes = kLaneCols * sizeof(E);
  bool al = w % 4 == 0;
  for (int k = 0; k < kStates; ++k) al = al && aligned(state[k], bytes);
  for (int k = 0; k < kFields; ++k) al = al && aligned(a.f[k], bytes);
  a.vec = al;
  cudaStream_t st = (cudaStream_t)stream;
  int slot = 0;
  for (int done = 0; done < iters; slot ^= 1) {
    const int k = iters - done < s ? iters - done : s;
    const bool first = done == 0, last = done + k == iters;
    for (int j = 0; j < kStates; ++j) {
      a.in[j] = (j >= 2 && first) ? nullptr : state[j] + slot * n;
      a.out[j] = (j >= 2 && last) ? nullptr : state[j] + (slot ^ 1) * n;
    }
    a.iters = k;
    const Geometry g = geometry(k);
    a.tiles_x = (w + g.tw - 1) / g.tw;
    a.tiles_y = (h + g.th - 1) / g.th;
    const long long tiles = (long long)b * a.tiles_x * a.tiles_y;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = (int)(tiles < grid_max ? tiles : grid_max);
    const auto kernel = kernel_of<A>();
    kernel<<<grid, kThreads, kSmemBytes, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
    done += k;
  }
  return (int)cudaSuccess;
}

// K5's plan and geometry of A's build, as hs_tvl1_geometry reports them.
template <class A>
int geometry_of(int b, int h, int w, int iters, int block_iters, int device, int* out) {
  if (b < 1 || h < 1 || w < 1 || iters < 1 || block_iters < 0 || block_iters > kMaxIters)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid_max = 0, sms = 0;
  err = configure<A>(device, &grid_max);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel_of<A>());
  if (err != cudaSuccess) return (int)err;
  const int s = plan(b, h, w, iters, block_iters, grid_max);
  const Geometry g = geometry(s);
  out[0] = s;
  out[1] = (iters + s - 1) / s;
  out[2] = kWinH;
  out[3] = g.th;
  out[4] = g.tw;
  out[5] = kThreads;
  out[6] = (int)kSmemBytes;
  out[7] = attr.numRegs;
  out[8] = (int)attr.localSizeBytes;
  out[9] = grid_max / sms;
  out[10] = (int)tiles_of(b, h, w, s);
  return (int)cudaSuccess;
}

}  // namespace

// `iters` alternations as ceil(iters/s) launches (s from `plan`). Each of
// u1, u2, p1x, p1y, p2x, p2y holds two slots of b*h*w floats: u1 and u2
// start in slot 0, the duals start at zero (their slot 0 is never read),
// and the result is in slot (launches mod 2) of u1 and u2. *launches gets
// the number of launches enqueued, also when one of them fails.
extern "C" int hs_tvl1_inner(float* u1, float* u2, const float* rho0, const float* gx,
                             const float* gy, const float* inv_g2, const float* th,
                             float* p1x, float* p1y, float* p2x, float* p2y, int b, int h,
                             int w, int iters, float theta, float sigma, float lam_theta,
                             int block_iters, int device, void* stream, int* launches) {
  return inner<Args>(u1, u2, rho0, gx, gy, inv_g2, th, p1x, p1y, p2x, p2y, b, h, w, iters,
                     theta, sigma, lam_theta, block_iters, device, stream, launches);
}

// The bfloat16 build: hs_tvl1_inner on bfloat16 arrays (two slots of
// b*h*w bfloat16 values each), the same plan and launches.
extern "C" int hs_tvl1_inner_bf16(__nv_bfloat16* u1, __nv_bfloat16* u2,
                                  const __nv_bfloat16* rho0, const __nv_bfloat16* gx,
                                  const __nv_bfloat16* gy, const __nv_bfloat16* inv_g2,
                                  const __nv_bfloat16* th, __nv_bfloat16* p1x,
                                  __nv_bfloat16* p1y, __nv_bfloat16* p2x, __nv_bfloat16* p2y,
                                  int b, int h, int w, int iters, float theta, float sigma,
                                  float lam_theta, int block_iters, int device, void* stream,
                                  int* launches) {
  return inner<ArgsBf16>(u1, u2, rho0, gx, gy, inv_g2, th, p1x, p1y, p2x, p2y, b, h, w, iters,
                         theta, sigma, lam_theta, block_iters, device, stream, launches);
}

// K5's plan and geometry for a call of `iters` alternations at (b, h, w)
// with block_iters on `device`, into out[0..10]: alternations a launch,
// launches, window rows, tile rows, tile columns, threads a block, shared
// bytes a block, registers a thread, local (spilled) bytes a thread, blocks
// resident on one multiprocessor, and the tiles of one launch of s.
extern "C" int hs_tvl1_geometry(int b, int h, int w, int iters, int block_iters, int device,
                                int* out) {
  return geometry_of<Args>(b, h, w, iters, block_iters, device, out);
}

// The same of the bfloat16 build.
extern "C" int hs_tvl1_geometry_bf16(int b, int h, int w, int iters, int block_iters,
                                     int device, int* out) {
  return geometry_of<ArgsBf16>(b, h, w, iters, block_iters, device, out);
}
