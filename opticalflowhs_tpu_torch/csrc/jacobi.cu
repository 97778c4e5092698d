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
// Design (one persistent block of 512 threads a streaming multiprocessor):
//   * A block walks tiles of the stack (image, tile row, tile column; tile
//     column fastest, so that neighbouring blocks share halos in L2). Each
//     tile is the centre of a 48 x 128 window: the tile grown by s rows
//     above and below, and by s columns rounded up to 4 on the left and at
//     least s on the right (`geometry`): 32 x 112 at s = 8.
//   * The mapping of threads to pixels is fixed for all of a tile's sweeps:
//     warp j owns window rows 3j..3j+2, lane l the 4 adjacent columns
//     4l..4l+3, so one warp spans the window's width. The fields Ex, Ey, Et
//     and invd of a thread's 12 pixels are loaded once, from device memory,
//     into registers (at most the launch bound's 128 a thread, no spills;
//     4 rows a thread at a 64-row window spilled and ran slower); shared
//     memory holds only u and v.
//   * A lane forms the column sums t = (a(i-1) + 2a) + a(i+1) of its own 4
//     columns and takes t(j-1) of its first and t(j+1) of its last column
//     from its neighbours with __shfl_up_sync/__shfl_down_sync: each column
//     sum is computed once, 27 float32 operations a pixel a sweep, and a
//     pixel costs 2 shared loads and 2 stores (16-byte, one per 4 pixels).
//     Lanes 0 and 31 hold window columns 0 and 127, which are halo: what
//     they receive from the shuffle is never read by an exact pixel.
//   * Sweep k runs on every row of the warps that meet the window's rows
//     shrunk by k (a warp outside skips it; the rows of a warp are
//     straight-line code) and on all 128 columns; what that computes
//     outside the exact region is never read by an exact pixel. The last
//     sweep writes the owned tile straight from registers to device memory.
//   * Interior windows, the most, run without clamps, their rows rolled in
//     registers. A window that holds an edge of the array (or, on a shard,
//     a true image edge) takes each row's rows i-1 and i+1 with their clamps
//     and replaces t(j-1) or t(j+1) by the lane's own t where the plain
//     version's shifts clamp.
//   * Staging overlaps the sweeps: while a block sweeps one tile, cp.async
//     copies the next tile's u and v into a third shared u/v pair (16-byte
//     copies where w is a multiple of 4 and the arrays are 16-byte aligned,
//     else 4-byte, no division per element). The three u/v pairs take
//     147,456 bytes of shared memory. The fields are loaded at each tile's
//     start (prefetching them into L2 a tile ahead did not pay).
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
// Exactness: the association order is that of ops/stencils.py
// (neighbor_avg, jacobi_step), the constants are the float32 values of
// 1/12 and 1/3, and the library is built with --fmad=false, so the output
// equals the plain PyTorch sweeps bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBatch = 65535;
constexpr int kLaneCols = 4;                  // adjacent columns a lane owns
constexpr int kWinW = 32 * kLaneCols;         // 128: one warp spans the window
constexpr int kRows = 3;                      // rows a thread owns
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;         // 512
constexpr int kWinH = kWarps * kRows;         // 48
constexpr int kArea = kWinH * kWinW;
// Shared arrays of one window: three u/v pairs, two swept and one staged
// for the next tile.
constexpr int kPairs = 3;
constexpr size_t kSmemBytes = (size_t)2 * kPairs * kArea * sizeof(float);
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

struct Args {
  const float *u, *v, *ex, *ey, *et, *invd;
  float *uo, *vo;
  const int* org;  // K9: per-image global origins; null for K2
  int b, h, w, img_h, img_w, sweeps, tiles_x, tiles_y;
  int vec;         // 16-byte loads and stores
};

// One tile: its image, the window's origin in the image's array and the
// window rows inside the array.
struct Tile {
  long long base;  // first element of the image
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
  x.r0 = ty * g.th - a.sweeps;
  x.c0 = tx * g.tw - g.lh;
  x.org_r = kShard ? a.org[2 * img] : 0;
  x.org_c = kShard ? a.org[2 * img + 1] : 0;
  x.wr_lo = max(0, -x.r0);
  x.wr_hi = min(kWinH, a.h - x.r0);
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

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* s, int r, int c) {
  return *reinterpret_cast<const float4*>(s + r * kWinW + c);
}

// Starts the copies of this thread's pixels of one array of a tile's
// window into shared memory; outside the array they are zero.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      const Args& a, const Tile& t, int row0, int col0) {
  const int ac = t.c0 + col0;
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const int wr = row0 + jj;
    const int ar = t.r0 + wr;
    const bool row_in = ar >= 0 && ar < a.h;
    const long long g = t.base + (long long)ar * a.w + ac;
    float* d = dst + wr * kWinW + col0;
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
}

// Starts the staging of a tile's u and v into the pair at `pair`.
__device__ __forceinline__ void stage_tile(float* smem, int pair, const Args& a,
                                           const Tile& t, int row0, int col0) {
  float* pu = smem + 2 * pair * kArea;
  stage(pu, a.u, a, t, row0, col0);
  stage(pu + kArea, a.v, a, t, row0, col0);
  copy_commit();
}

// A thread's kRows x 4 pixels of one field, from device memory into registers
// (zero outside the array).
__device__ __forceinline__ void load_field(float (&f)[kRows][kLaneCols],
                                           const float* __restrict__ p,
                                           const Args& a, const Tile& t,
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

// The four fields of a thread's pixels of a tile.
__device__ __forceinline__ void load_fields(float (&fx)[kRows][kLaneCols],
                                            float (&fy)[kRows][kLaneCols],
                                            float (&ft)[kRows][kLaneCols],
                                            float (&fi)[kRows][kLaneCols], const Args& a,
                                            const Tile& t, int row0, int col0) {
  load_field(fx, a.ex, a, t, row0, col0);
  load_field(fy, a.ey, a, t, row0, col0);
  load_field(ft, a.et, a, t, row0, col0);
  load_field(fi, a.invd, a, t, row0, col0);
}

__device__ __forceinline__ void st4(float* s, int r, int c, const float (&x)[kLaneCols]) {
  *reinterpret_cast<float4*>(s + r * kWinW + c) = make_float4(x[0], x[1], x[2], x[3]);
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
template <bool kClamp, bool kLast>
__device__ __forceinline__ void update_row(
    const float4& ut, const float4& um, const float4& ub, const float4& vt,
    const float4& vm, const float4& vb, const float (&fx)[kLaneCols],
    const float (&fy)[kLaneCols], const float (&ft)[kLaneCols],
    const float (&fi)[kLaneCols], float* __restrict__ du, float* __restrict__ dv,
    const Args& a, const Tile& tile, const Lane& ln, int r) {
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
template <bool kEdge, bool kShard, bool kLast>
__device__ __forceinline__ void sweep_rows(
    const float* __restrict__ su, const float* __restrict__ sv,
    float* __restrict__ du, float* __restrict__ dv, const Args& a,
    const Tile& tile, const Lane& ln,
    const float (&fx)[kRows][kLaneCols], const float (&fy)[kRows][kLaneCols],
    const float (&ft)[kRows][kLaneCols], const float (&fi)[kRows][kLaneCols]) {
  const int row0 = ln.row0, col0 = ln.col0;
  if (!kEdge) {
    float4 ut = ld4(su, max(row0 - 1, 0), col0), vt = ld4(sv, max(row0 - 1, 0), col0);
    float4 um = ld4(su, row0, col0), vm = ld4(sv, row0, col0);
#pragma unroll
    for (int jj = 0; jj < kRows; ++jj) {
      const int r = row0 + jj;
      const int rd = jj == kRows - 1 ? min(r + 1, kWinH - 1) : r + 1;
      const float4 ub = ld4(su, rd, col0), vb = ld4(sv, rd, col0);
      update_row<false, kLast>(ut, um, ub, vt, vm, vb, fx[jj], fy[jj], ft[jj], fi[jj], du,
                               dv, a, tile, ln, r);
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
                              ld4(sv, ru, col0), ld4(sv, r, col0), ld4(sv, rd, col0), fx[jj],
                              fy[jj], ft[jj], fi[jj], du, dv, a, tile, ln, r);
    }
  }
}

// The tile's sweeps: sweep k on the warps whose rows meet the window's rows
// shrunk by k (cut at the array's edges), a block barrier between sweeps;
// the last sweep writes the owned tile. On return `cur` and `dst` name the
// two pairs the sweeps used.
template <bool kEdge, bool kShard>
__device__ __forceinline__ void run_tile(float* smem, int& cur, int& dst, const Args& a,
                                         const Tile& tile, const Lane& ln,
                                         const float (&fx)[kRows][kLaneCols],
                                         const float (&fy)[kRows][kLaneCols],
                                         const float (&ft)[kRows][kLaneCols],
                                         const float (&fi)[kRows][kLaneCols]) {
  for (int k = 1; k <= a.sweeps; ++k) {
    const int rlo = max(k, tile.wr_lo), rhi = min(kWinH - k, tile.wr_hi);
    const float* su = smem + 2 * cur * kArea;
    float* du = smem + 2 * dst * kArea;
    if (ln.row0 < rhi && ln.row0 + kRows > rlo) {  // uniform across the warp
      // Each sweep's rows are straight-line code: the last sweep, which
      // writes to device memory, is its own instance.
      if (k < a.sweeps)
        sweep_rows<kEdge, kShard, false>(su, su + kArea, du, du + kArea, a, tile, ln, fx, fy,
                                         ft, fi);
      else
        sweep_rows<kEdge, kShard, true>(su, su + kArea, du, du + kArea, a, tile, ln, fx, fy,
                                        ft, fi);
    }
    if (k < a.sweeps) {
      __syncthreads();
      const int x = cur;
      cur = dst;
      dst = x;
    }
  }
}

// kShard: the images are K9's shards, each at its own global origin (org);
// otherwise whole images (K2).
template <bool kShard>
__global__ void __launch_bounds__(kThreads, 1) jacobi_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const Geometry geo = geometry(a.sweeps);
  const int ntiles = a.b * a.tiles_x * a.tiles_y;
  if ((int)blockIdx.x >= ntiles) return;
  Lane ln;
  ln.row0 = (threadIdx.x >> 5) * kRows;
  ln.col0 = lane * kLaneCols;
  // u/v pair p: u at smem + 2p*kArea, v kArea further.
  int cur = 0, dst = 1, spare = 2;
  stage_tile(smem, cur, a, tile_at<kShard>(a, geo, blockIdx.x), ln.row0, ln.col0);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tile = tile_at<kShard>(a, geo, t);
    float fx[kRows][kLaneCols], fy[kRows][kLaneCols], ft[kRows][kLaneCols],
        fi[kRows][kLaneCols];
    load_fields(fx, fy, ft, fi, a, tile, ln.row0, ln.col0);
    const int tn = t + gridDim.x;
    if (tn < ntiles) {
      stage_tile(smem, spare, a, tile_at<kShard>(a, geo, tn), ln.row0, ln.col0);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();

    // Clamps of this lane's columns (at the array's edges and, on a shard,
    // at the true image edges), and the columns of the owned tile it writes.
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
      run_tile<true, kShard>(smem, cur, dst, a, tile, ln, fx, fy, ft, fi);
    else
      run_tile<false, kShard>(smem, cur, dst, a, tile, ln, fx, fy, ft, fi);
    // Every thread is done with this tile's pairs before the next staging
    // reuses one of them.
    __syncthreads();
    const int x = spare;
    spare = cur;
    cur = x;
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
      jacobi_kernel<kShard>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jacobi_kernel<kShard>,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid_max = per_sm * sms;
  if (device >= 0 && device < 64) cached[device] = *grid_max;
  return cudaSuccess;
}

bool aligned(const void* p) { return ((unsigned long long)p & 15ull) == 0; }

int launch(const float* u, const float* v, const float* ex, const float* ey,
           const float* et, const float* invd, float* uo, float* vo,
           const int* org, int b, int h, int w, int img_h, int img_w,
           int sweeps, int device, void* stream) {
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
  a.tiles_x = (w + g.tw - 1) / g.tw;
  a.tiles_y = (h + g.th - 1) / g.th;
  a.vec = w % 4 == 0 && aligned(u) && aligned(v) && aligned(ex) && aligned(ey) &&
          aligned(et) && aligned(invd) && aligned(uo) && aligned(vo);
  const long long tiles = (long long)b * a.tiles_x * a.tiles_y;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < grid_max ? tiles : grid_max);
  if (org != nullptr)
    jacobi_kernel<true><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a);
  else
    jacobi_kernel<false><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_jacobi_sweeps(const float* u, const float* v,
                                const float* ex, const float* ey,
                                const float* et, const float* invd, float* uo,
                                float* vo, int b, int h, int w, int sweeps,
                                int device, void* stream) {
  return launch(u, v, ex, ey, et, invd, uo, vo, nullptr, b, h, w, h, w, sweeps,
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
  return launch(u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w,
                sweeps, device, stream);
}

// K2's geometry at `sweeps` on `device` (K9's with `shard` nonzero), into
// out[0..7]: tile rows, tile columns, threads a block, shared bytes a
// block, registers a thread, local (spilled) bytes a thread, blocks
// resident on one multiprocessor, and the number of multiprocessors.
extern "C" int hs_jacobi_geometry(int sweeps, int shard, int device, int* out) {
  if (sweeps < 1 || sweeps > kMaxSweeps) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid_max = 0;
  err = shard ? configure<true>(device, &grid_max) : configure<false>(device, &grid_max);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = shard ? cudaFuncGetAttributes(&attr, jacobi_kernel<true>)
              : cudaFuncGetAttributes(&attr, jacobi_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const Geometry g = geometry(sweeps);
  out[0] = g.th;
  out[1] = g.tw;
  out[2] = kThreads;
  out[3] = (int)kSmemBytes;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = grid_max / sms;
  out[7] = sms;
  return (int)cudaSuccess;
}
