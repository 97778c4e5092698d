// K6 hs_solve_fused_sweeps: all n Jacobi sweeps of a whole Horn-Schunck
// solve in ONE launch, over one frame or a (B, H, W) stack, after K1 has
// computed the four fields.
//
// Replaces the TPU megakernels of opticalflowhs_tpu/kernels/solve_fused.py:
// _mega_kernel (line 111, called at line 245; grid (n_blocks, n_bands)) and
// its batched twin _mega_kernel_b (line 375, called at line 490; grid
// (n_blocks, B, n_bands), zero start). On the TPU the grid's outer axis is a
// sequence of sweep blocks and its inner axis the row bands, run in order
// on one core; u/v ping-pong between two HBM buffers by block parity, the
// zero start is written in-kernel at block 0, and a remainder of n mod s
// sweeps is the final block phase of the same launch.
//
// Hopper design: a persistent cooperative grid (as many blocks as can be
// resident, ~1 an SM at the ~200 KB window of s = 8). Sweep block k: each
// block loops over its 64 x 64 tiles (of every image of the stack), stages
// the tile's window from pair A or B (from zeros or from u0/v0 at block 0),
// runs the block's sweeps on chip with the shared body (jacobi_tile.cuh) and
// writes its tile to the other pair; a grid-wide barrier then separates the
// block from the next. The last block runs the remainder. u/v written
// during the launch are read with __ldcg (L2, not the SM's own L1, which
// other SMs' writes do not invalidate).
//
// Bound: per sweep block the same 8 arrays as a K2 launch (u, v and the
// four fields in, u and v out), 265 MB or 79 us at 3.35 TB/s at 2160x3840;
// the whole solve at i100 does 3,897 float32 operations a pixel (K1 with
// its first sweep, then 99 sweeps; chip_smoke.py), 482 us at 4K and 1930 us
// at 4320x7680 at 67 TFLOP/s. Against the K1 + K2 chain it saves the
// launches and their gaps, not bytes: its tiles and sweeps are those that
// K2 ran before K2 took a loop of its own (csrc/jacobi.cu).
//
// Exactness: the shared sweep body, so K6 equals the plain sweeps (and the K1 + K2
// chain) bitwise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cooperative.cuh"
#include "jacobi_tile.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(512, 1) fused_kernel(const float* u0, const float* v0,
                             const float* __restrict__ ex,
                             const float* __restrict__ ey,
                             const float* __restrict__ et,
                             const float* __restrict__ invd, float* ua,
                             float* va, float* ub, float* vb, int b, int h,
                             int w, int n, int s, int tile_h, int tile_w) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const int tiles_y = (h + tile_h - 1) / tile_h;
  const long long per_img = (long long)tiles_x * tiles_y;
  const long long total = per_img * b;
  const long long img_px = (long long)h * w;
  const int n_full = n / s, rem = n % s;
  const int n_blocks = n_full + (rem > 0 ? 1 : 0);
  for (int k = 0; k < n_blocks; ++k) {
    const int ns = k < n_full ? s : rem;
    // Block k reads what block k-1 wrote: A after an even block, B after
    // an odd one; it writes the other pair.
    const float* su_g = k % 2 == 1 ? ua : ub;
    const float* sv_g = k % 2 == 1 ? va : vb;
    float* du_g = k % 2 == 0 ? ua : ub;
    float* dv_g = k % 2 == 0 ? va : vb;
    for (long long t = blockIdx.x; t < total; t += gridDim.x) {
      const long long off = (t / per_img) * img_px;
      const int tt = (int)(t % per_img);
      const hs_tile::Window win = hs_tile::make_window(
          (tt / tiles_x) * tile_h, (tt % tiles_x) * tile_w, tile_h, tile_w,
          ns, h, w);
      hs_tile::Buffers bf = hs_tile::carve(smem, win);
      const float* fx = ex + off;
      const float* fy = ey + off;
      const float* ft = et + off;
      const float* fi = invd + off;
      // One source for the whole window, chosen outside the staging loop.
      if (k > 0) {
        const float* su = su_g + off;
        const float* sv = sv_g + off;
        hs_tile::stage(bf, win, fx, fy, ft, fi, w,
                       [=](int, int, long long g, float& uu, float& vv) {
                         uu = __ldcg(su + g);
                         vv = __ldcg(sv + g);
                       });
      } else if (u0 != nullptr) {
        const float* su = u0 + off;
        const float* sv = v0 + off;
        hs_tile::stage(bf, win, fx, fy, ft, fi, w,
                       [=](int, int, long long g, float& uu, float& vv) {
                         uu = su[g];
                         vv = sv[g];
                       });
      } else {  // the zero start, written in-kernel
        hs_tile::stage(bf, win, fx, fy, ft, fi, w,
                       [](int, int, long long, float& uu, float& vv) {
                         uu = 0.0f;
                         vv = 0.0f;
                       });
      }
      __syncthreads();
      hs_tile::run_sweeps(bf, win, h, w, ns);
      hs_tile::write_tile(du_g + off, dv_g + off, bf, win, tile_h, tile_w, w);
      __syncthreads();  // the next tile reuses the shared memory
    }
    if (k + 1 < n_blocks) grid.sync();
  }
}

}  // namespace

// Most blocks of K6 that can be resident at once at s sweeps a block.
extern "C" int hs_solve_fused_blocks(int s, int tile_h, int tile_w,
                                     int threads, int device, int* blocks) {
  return (int)hs_coop::max_blocks(fused_kernel,
                                  hs_tile::smem_bytes(tile_h, tile_w, s),
                                  threads, device, blocks);
}

// n sweeps from (u0, v0), or from zeros when u0 is null, over b images of
// h x w; the result lands in (ua, va) when ceil(n/s) is odd, else in
// (ub, vb). One cooperative launch of `grid` blocks on `stream`.
extern "C" int hs_solve_fused_sweeps(const float* u0, const float* v0,
                                     const float* ex, const float* ey,
                                     const float* et, const float* invd,
                                     float* ua, float* va, float* ub,
                                     float* vb, int b, int h, int w, int n,
                                     int s, int tile_h, int tile_w,
                                     int threads, int grid, int device,
                                     void* stream) {
  if (b < 1 || h < 1 || w < 1 || n < 1 || s < 1 || grid < 1 ||
      (u0 == nullptr) != (v0 == nullptr))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&u0, &v0, &ex, &ey, &et, &invd, &ua, &va, &ub, &vb,
                  &b,  &h,  &w,  &n,  &s,  &tile_h, &tile_w};
  return (int)hs_coop::launch(fused_kernel, grid, threads,
                              hs_tile::smem_bytes(tile_h, tile_w, s), args,
                              device, stream);
}
