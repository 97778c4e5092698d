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
// Hopper design: the same schedule on a persistent cooperative grid. The
// working memory is the two output arrays (u, v, written in place) and two
// pencil buffers of sigma x w for each of u and v. Sweep block k (s sweeps,
// the last one the remainder, sigma = the block's sweeps) walks the row
// bands top to bottom; band i is cut into tiles of up to tile_h x tile_w,
// one a block (the band's tiles must not outnumber the grid). For band i:
//   1. each block stages its tile's window: rows above the band from pencil
//      i % 2 (saved by band i-1), the rest from u/v, all still old (from
//      zeros or u0/v0 at block 0); the tiles of the band's last sigma rows
//      save them, old, into pencil (i + 1) % 2 for band i+1;
//   2. grid barrier: every window of the band is read before any write;
//   3. each block runs the block's sweeps on chip (the shared body,
//      jacobi_tile.cuh) and writes its central rows back in place.
// Band i+1 reads only rows below band i and the pencil, so it needs no
// barrier after band i's writes; one more barrier ends each sweep block.
// Rows outside the image are never staged (the windows are cut at the true
// edges, which the global-coordinate clamps handle), so the band-0 pencil
// and the TPU's pad rows have no counterpart here. u, v and the pencils,
// written during the launch, are read with __ldcg (L2, not the SM's L1).
//
// Bound: as K6 per sweep block (8 arrays, 79 us at 2160x3840 at 3.35 TB/s)
// and for the whole solve (3,897 float32 operations a pixel at i100, 482 us
// at 4K at 67 TFLOP/s). What it saves is memory: one u/v pair, 2*h*w*4
// bytes (66 MB at 4K), against K6 and the K1 + K2 chain. What it costs: one
// barrier a band, and a band's tiles fill only part of the card (the
// wrapper sizes bands to the grid).
//
// Exactness: the shared sweep body, so K7 equals the plain sweeps bitwise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cooperative.cuh"
#include "jacobi_tile.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(512, 1) skewed_kernel(const float* u0, const float* v0,
                              const float* __restrict__ ex,
                              const float* __restrict__ ey,
                              const float* __restrict__ et,
                              const float* __restrict__ invd, float* u,
                              float* v, float* pu, float* pv, int b, int h,
                              int w, int n, int s, int band, int tile_h,
                              int tile_w) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const int n_bands = (h + band - 1) / band;
  const long long img_px = (long long)h * w;
  const long long pencil = (long long)s * w;  // one pencil buffer
  const int n_full = n / s, rem = n % s;
  const int n_blocks = n_full + (rem > 0 ? 1 : 0);
  for (int img = 0; img < b; ++img) {
    const long long off = img * img_px;
    float* ui = u + off;
    float* vi = v + off;
    for (int k = 0; k < n_blocks; ++k) {
      const int ns = k < n_full ? s : rem;  // sweeps and halo of this block
      for (int i = 0; i < n_bands; ++i) {
        const int r0 = i * band;
        const int r_end = min(r0 + band, h);
        const int n_tiles = ((r_end - r0 + tile_h - 1) / tile_h) * tiles_x;
        const float* pu_cur = pu + (i % 2) * pencil;  // rows [r0-ns, r0)
        const float* pv_cur = pv + (i % 2) * pencil;
        float* pu_next = pu + ((i + 1) % 2) * pencil;  // [r_end-ns, r_end)
        float* pv_next = pv + ((i + 1) % 2) * pencil;
        const bool mine = blockIdx.x < n_tiles;
        hs_tile::Window win;
        hs_tile::Buffers bf;
        int th = 0, tw = 0;
        if (mine) {
          const int tr0 = r0 + (blockIdx.x / tiles_x) * tile_h;
          const int tc0 = (blockIdx.x % tiles_x) * tile_w;
          th = min(tile_h, r_end - tr0);
          tw = min(tile_w, w - tc0);
          win = hs_tile::make_window(tr0, tc0, th, tw, ns, h, w);
          bf = hs_tile::carve(smem, win);
          const float* fx = ex + off;
          const float* fy = ey + off;
          const float* ft = et + off;
          const float* fi = invd + off;
          // Window rows above the band (only the band's first row of tiles
          // has any) come from the pencil, old; the rest from u/v, still
          // old, or from the start at block 0. One source a loop.
          const int split =
              min(max(r0 - win.r0, win.wr_lo), win.wr_hi);  // window row of r0
          const int top = r0 - ns;
          hs_tile::stage_rows(bf, win, win.wr_lo, split, fx, fy, ft, fi, w,
                              [=](int gr, int gc, long long, float& uu,
                                  float& vv) {
                                const long long p = (long long)(gr - top) * w + gc;
                                uu = __ldcg(pu_cur + p);
                                vv = __ldcg(pv_cur + p);
                              });
          if (k > 0) {
            hs_tile::stage_rows(bf, win, split, win.wr_hi, fx, fy, ft, fi, w,
                                [=](int, int, long long g, float& uu,
                                    float& vv) {
                                  uu = __ldcg(ui + g);
                                  vv = __ldcg(vi + g);
                                });
          } else if (u0 != nullptr) {
            const float* su = u0 + off;
            const float* sv = v0 + off;
            hs_tile::stage_rows(bf, win, split, win.wr_hi, fx, fy, ft, fi, w,
                                [=](int, int, long long g, float& uu,
                                    float& vv) {
                                  uu = su[g];
                                  vv = sv[g];
                                });
          } else {  // the zero start
            hs_tile::stage_rows(bf, win, split, win.wr_hi, fx, fy, ft, fi, w,
                                [](int, int, long long, float& uu, float& vv) {
                                  uu = 0.0f;
                                  vv = 0.0f;
                                });
          }
          __syncthreads();
          if (r_end < h) {
            // The next band's pencil: rows [r_end-ns, r_end) of this
            // tile's central columns, still old in the window.
            const int lo = max(r_end - ns, tr0), hi = tr0 + th;
            const int lw = tw;
            const int cnt = max(0, hi - lo) * lw;
            for (int q = threadIdx.x; q < cnt; q += blockDim.x) {
              const int gr = lo + q / lw, gc = tc0 + q % lw;
              const int sidx = (gr - win.r0) * win.win_w + (gc - win.c0);
              const long long p = (long long)(gr - (r_end - ns)) * w + gc;
              pu_next[p] = bf.su[sidx];
              pv_next[p] = bf.sv[sidx];
            }
          }
        }
        grid.sync();  // every window of band i is staged before any write
        if (mine) {
          hs_tile::run_sweeps(bf, win, h, w, ns);
          hs_tile::write_tile(ui, vi, bf, win, th, tw, w);
          __syncthreads();  // the next band reuses the shared memory
        }
      }
      grid.sync();  // the sweep block's writes land before the next reads
    }
  }
}

}  // namespace

// Most blocks of K7 that can be resident at once at s sweeps a block.
extern "C" int hs_solve_skewed_blocks(int s, int tile_h, int tile_w,
                                      int threads, int device, int* blocks) {
  return (int)hs_coop::max_blocks(skewed_kernel,
                                  hs_tile::smem_bytes(tile_h, tile_w, s),
                                  threads, device, blocks);
}

// n sweeps in place in (u, v), from (u0, v0) or from zeros when u0 is
// null, over b images of h x w, one after another; pu/pv hold 2*s*w floats
// each. Bands of `band` rows (>= s); a band's tiles must not outnumber
// `grid`. One cooperative launch of `grid` blocks on `stream`.
extern "C" int hs_solve_skewed_sweeps(const float* u0, const float* v0,
                                      const float* ex, const float* ey,
                                      const float* et, const float* invd,
                                      float* u, float* v, float* pu,
                                      float* pv, int b, int h, int w, int n,
                                      int s, int band, int tile_h,
                                      int tile_w, int threads, int grid,
                                      int device, void* stream) {
  const int band_rows = band < h ? band : h;
  const int band_tiles =
      ((band_rows + tile_h - 1) / tile_h) * ((w + tile_w - 1) / tile_w);
  if (b < 1 || h < 1 || w < 1 || n < 1 || s < 1 || band < s || tile_h < s ||
      grid < band_tiles || (u0 == nullptr) != (v0 == nullptr))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&u0, &v0, &ex, &ey, &et,   &invd,   &u,     &v,
                  &pu, &pv, &b,  &h,  &w,    &n,      &s,     &band,
                  &tile_h, &tile_w};
  return (int)hs_coop::launch(skewed_kernel, grid, threads,
                              hs_tile::smem_bytes(tile_h, tile_w, s), args,
                              device, stream);
}
