// The temporally blocked Jacobi sweeps of one shared-memory window, run only
// by the fused ring solves K11 and K12 (ring.cu) on the shards of the tiled
// solver. K2 and K9 (jacobi.cu), K6 (solve_fused.cu) and K7
// (solve_skewed.cu) run K2's window loop (k2_window.cuh: fields in
// registers, column sums shared by warp shuffles, the next window staged
// behind the sweeps), which runs 1.8-2.5x faster than this loop on an H100
// (PERF.md); K11 and K12 move onto it in a later change.
//
// A block owns a th x tw output tile at (tr0, tc0) and stages the window
// grown by `halo` rows and columns on each side, cut at the true image
// edges, for u, v, Ex, Ey, Et and invd. It runs up to `halo` sweeps between
// two shared u/v buffers; each sweep's valid region shrinks by one ring (the
// decaying-halo argument of kernels/jacobi.py:15-21 of the JAX package), so
// after them exactly the owned tile is exact. The clamp fires at the true
// image edges, from global coordinates; window edges inside the image are
// halo, not edges.
//
// Inside a sweep each thread walks a column strip, keeping the 3x3
// neighbourhood of u and v in registers, so a pixel costs 3 + 3 shared
// loads of u and v, 4 of the fields and 2 stores.
//
// Exactness: the association order is that of ops/stencils.py
// (neighbor_avg, jacobi_step), the constants are the float32 values of
// 1/12 and 1/3, and the library is built with --fmad=false, so every kernel
// built on this equals the plain PyTorch sweeps bitwise.

#pragma once

#include <cuda_runtime.h>

namespace hs_tile {

constexpr int kFields = 8;  // u, v (two buffers each), ex, ey, et, invd
constexpr float kTwelfth = (float)(1.0 / 12.0);
constexpr float kThird = (float)(1.0 / 3.0);

// Shared memory of one window of `halo` rings around a th x tw tile.
__host__ __device__ inline size_t smem_bytes(int th, int tw, int halo) {
  return (size_t)kFields * (th + 2 * halo) * (tw + 2 * halo) * sizeof(float);
}

struct Window {
  int r0, c0;                      // array origin (negative at the top/left)
  int win_h, win_w;                // extent, halo included
  int wr_lo, wr_hi, wc_lo, wc_hi;  // the part inside the array
  int halo;
  int org_r, org_c;                // global coordinates of array element (0, 0)
  int img_h, img_w;                // the true image the clamps fire at
};

__device__ __forceinline__ Window make_window(int tr0, int tc0, int th, int tw,
                                              int halo, int h, int w) {
  Window win;
  win.halo = halo;
  win.r0 = tr0 - halo;
  win.c0 = tc0 - halo;
  win.win_h = th + 2 * halo;
  win.win_w = tw + 2 * halo;
  win.wr_lo = max(0, -win.r0);
  win.wr_hi = min(win.win_h, h - win.r0);
  win.wc_lo = max(0, -win.c0);
  win.wc_hi = min(win.win_w, w - win.c0);
  win.org_r = 0;
  win.org_c = 0;
  win.img_h = h;
  win.img_w = w;
  return win;
}

// The window of make_window in an array whose element (0, 0) is the global
// pixel (org_r, org_c) of an img_h x img_w image.
__device__ __forceinline__ Window make_window_at(int tr0, int tc0, int th,
                                                 int tw, int halo, int h, int w,
                                                 int org_r, int org_c,
                                                 int img_h, int img_w) {
  Window win = make_window(tr0, tc0, th, tw, halo, h, w);
  win.org_r = org_r;
  win.org_c = org_c;
  win.img_h = img_h;
  win.img_w = img_w;
  return win;
}

// The eight shared arrays of a window, carved from one dynamic buffer.
struct Buffers {
  float *su, *sv, *du, *dv, *sex, *sey, *set, *sinvd;
};

__device__ __forceinline__ Buffers carve(float* smem, const Window& win) {
  const int area = win.win_h * win.win_w;
  Buffers b;
  b.su = smem;
  b.sv = b.su + area;
  b.du = b.sv + area;
  b.dv = b.du + area;
  b.sex = b.dv + area;
  b.sey = b.sex + area;
  b.set = b.sey + area;
  b.sinvd = b.set + area;
  return b;
}

// Stages window rows [wr_from, wr_to) (inside the image) of the window: the
// four fields from device memory (read-only for the whole launch), u and v
// from `load(global_row, global_col, offset)`, which writes them through its
// last two arguments; the caller decides where u and v come from. Keep
// `load` free of branches on the element: a uniform choice of source made
// outside the loop lets the compiler keep many loads in flight.
template <class Load>
__device__ __forceinline__ void stage_rows(const Buffers& b, const Window& win,
                                           int wr_from, int wr_to,
                                           const float* __restrict__ ex,
                                           const float* __restrict__ ey,
                                           const float* __restrict__ et,
                                           const float* __restrict__ invd,
                                           int w, Load load) {
  const int lw = win.wc_hi - win.wc_lo;
  const int n = (wr_to - wr_from) * lw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int wr = wr_from + i / lw;
    const int wc = win.wc_lo + i % lw;
    const int gr = win.r0 + wr, gc = win.c0 + wc;
    const long long g = (long long)gr * w + gc;
    const int s = wr * win.win_w + wc;
    load(gr, gc, g, b.su[s], b.sv[s]);
    b.sex[s] = ex[g];
    b.sey[s] = ey[g];
    b.set[s] = et[g];
    b.sinvd[s] = invd[g];
  }
}

// Stages the whole in-image part of the window (stage_rows).
template <class Load>
__device__ __forceinline__ void stage(const Buffers& b, const Window& win,
                                      const float* __restrict__ ex,
                                      const float* __restrict__ ey,
                                      const float* __restrict__ et,
                                      const float* __restrict__ invd, int w,
                                      Load load) {
  stage_rows(b, win, win.wr_lo, win.wr_hi, ex, ey, et, invd, w, load);
}

// `sweeps` (<= win.halo) Jacobi sweeps between (su, sv) and (du, dv); on
// return su/sv point at the last sweep. (h, w) is the array's size, a
// shard of a larger image (K11, K12) whose true edges, from win.org_* and
// win.img_*, may also lie inside a strip; the clamps fire at both. Ends
// with a __syncthreads.
__device__ __forceinline__ void run_sweeps(Buffers& b, const Window& win,
                                           int h, int w, int sweeps) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int win_h = win.win_h, win_w = win.win_w;
  const int r0 = win.r0, c0 = win.c0;
  for (int k = 1; k <= sweeps; ++k) {
    // Sweep k is exact on the window shrunk by k rings, except where the
    // window is cut by the image edge.
    const int rlo = max(k, win.wr_lo), rhi = min(win_h - k, win.wr_hi);
    const int clo = max(k, win.wc_lo), chi = min(win_w - k, win.wc_hi);
    const int ncols = chi - clo, nrows = rhi - rlo;
    const float* su = b.su;
    const float* sv = b.sv;
    float* du = b.du;
    float* dv = b.dv;
    if (ncols > 0 && nrows > 0) {
      const int groups = max(1, nthreads / ncols);
      const int chunk = (nrows + groups - 1) / groups;
      for (int strip = tid; strip < ncols * groups; strip += nthreads) {
        const int c = clo + strip % ncols;
        const int ra = rlo + (strip / ncols) * chunk;
        const int rb = min(ra + chunk, rhi);
        if (ra >= rb) continue;
        // Clamps at the array's edges and, on a shard, at the true image
        // edges.
        const int ac = c0 + c, gc = win.org_c + ac;
        const int ar = r0 + ra;
        const int cl = ac > 0 && gc != 0 ? c - 1 : c;                     // j-1
        const int cr = ac < w - 1 && gc != win.img_w - 1 ? c + 1 : c;     // j+1
        const int ru = ar > 0 && win.org_r + ar != 0 ? ra - 1 : ra;       // i-1
        // Rows i-1 (top) and i (mid) of the 3x3 neighbourhood.
        float ut_l = su[ru * win_w + cl], ut_c = su[ru * win_w + c],
              ut_r = su[ru * win_w + cr];
        float vt_l = sv[ru * win_w + cl], vt_c = sv[ru * win_w + c],
              vt_r = sv[ru * win_w + cr];
        float um_l = su[ra * win_w + cl], um_c = su[ra * win_w + c],
              um_r = su[ra * win_w + cr];
        float vm_l = sv[ra * win_w + cl], vm_c = sv[ra * win_w + c],
              vm_r = sv[ra * win_w + cr];
        for (int r = ra; r < rb; ++r) {
          const int rd =
              r0 + r < h - 1 && win.org_r + r0 + r != win.img_h - 1 ? r + 1 : r;  // i+1
          const float ub_l = su[rd * win_w + cl], ub_c = su[rd * win_w + c],
                      ub_r = su[rd * win_w + cr];
          const float vb_l = sv[rd * win_w + cl], vb_c = sv[rd * win_w + c],
                      vb_r = sv[rd * win_w + cr];
          // neighbor_avg: t = (a(i-1) + 2a) + a(i+1) per column, then
          // s = (t(j-1) + 2t) + t(j+1), then s/12 - a/3.
          const float tu_l = (ut_l + 2.0f * um_l) + ub_l;
          const float tu_c = (ut_c + 2.0f * um_c) + ub_c;
          const float tu_r = (ut_r + 2.0f * um_r) + ub_r;
          const float ubar =
              ((tu_l + 2.0f * tu_c) + tu_r) * kTwelfth - um_c * kThird;
          const float tv_l = (vt_l + 2.0f * vm_l) + vb_l;
          const float tv_c = (vt_c + 2.0f * vm_c) + vb_c;
          const float tv_r = (vt_r + 2.0f * vm_r) + vb_r;
          const float vbar =
              ((tv_l + 2.0f * tv_c) + tv_r) * kTwelfth - vm_c * kThird;
          const int o = r * win_w + c;
          const float e_x = b.sex[o];
          const float e_y = b.sey[o];
          const float frac =
              ((e_x * ubar + e_y * vbar) + b.set[o]) * b.sinvd[o];
          du[o] = ubar - e_x * frac;
          dv[o] = vbar - e_y * frac;
          // Roll the neighbourhood down a row. A true image edge inside
          // the strip breaks the roll: below the bottom edge,
          // row i+1 was row i itself, so row r+1 is loaded afresh; at the
          // top edge, row r+1's i-1 clamps to itself.
          ut_l = um_l; ut_c = um_c; ut_r = um_r;
          vt_l = vm_l; vt_c = vm_c; vt_r = vm_r;
          if (rd == r + 1) {
            um_l = ub_l; um_c = ub_c; um_r = ub_r;
            vm_l = vb_l; vm_c = vb_c; vm_r = vb_r;
          } else if (r + 1 < rb) {
            const int n = (r + 1) * win_w;
            um_l = su[n + cl]; um_c = su[n + c]; um_r = su[n + cr];
            vm_l = sv[n + cl]; vm_c = sv[n + c]; vm_r = sv[n + cr];
          }
          if (win.org_r + r0 + r + 1 == 0) {
            ut_l = um_l; ut_c = um_c; ut_r = um_r;
            vt_l = vm_l; vt_c = vm_c; vt_r = vm_r;
          }
        }
      }
    }
    __syncthreads();
    float* t = b.su; b.su = b.du; b.du = t;
    t = b.sv; b.sv = b.dv; b.dv = t;
  }
}

}  // namespace hs_tile
