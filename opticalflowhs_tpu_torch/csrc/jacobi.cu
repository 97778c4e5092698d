// K2 hs_jacobi_sweeps: `sweeps` Jacobi sweeps of Horn-Schunck per launch,
// temporally blocked in shared memory, over one frame or a (B, H, W) stack.
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
// arrays (~67 MB a frame at 1088x1920) exceed the card's shared memory, so
// the solve streams through L2 and device memory once per launch, and each
// launch runs `sweeps` sweeps on chip.
//
// Batch: grid (ceil(w/tile_w), ceil(h/tile_h), B); blockIdx.z is the image,
// and image k starts k*h*w floats into every array (a 64-bit stride). The
// window, halo and clamp bookkeeping below is per image, in the image's own
// coordinates, so no window reads across an image seam. gridDim.z is at
// most 65535, so the entry point refuses larger batches.
//
// Bound: device memory, at 8 arrays read or written per launch (u, v and
// the four fields in, u and v out): 8 x B x h x w x 4 bytes, 66.8 MB x B
// at 1088x1920 float32, or 19.9 us x B at 3.35 TB/s, so the number of
// sweeps per launch sets the bytes per sweep. (One launch at 1088x1920
// measured ~5.7x that bound on an H100, PERF.md: the in-block work, not
// memory, limits it so far.) Each block owns a tile_h x tile_w output tile and stages the (tile + 2*sweeps) window of u,
// v, Ex, Ey, Et and invd in shared memory. It runs the sweeps between two
// shared u/v buffers; each sweep's valid region shrinks by one ring (the
// decaying-halo argument of kernels/jacobi.py:15-21 of the JAX package), so
// after `sweeps` sweeps exactly the owned tile is exact, and only it is
// written back. The clamp fires at the true image edges, from global
// coordinates; window edges inside the image are halo, not edges.
//
// Inside a sweep each thread walks a column strip, keeping the 3x3
// neighbourhood of u and v in registers, so a pixel costs 3 + 3 shared
// loads of u and v, 4 of the fields and 2 stores.
//
// Exactness: the association order is that of ops/stencils.py
// (neighbor_avg, jacobi_step), the constants are the float32 values of
// 1/12 and 1/3, and the library is built with --fmad=false, so the output
// equals the plain PyTorch sweeps bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 8;  // u, v (two buffers each), ex, ey, et, invd
constexpr int kMaxBatch = 65535;  // gridDim.z limit
constexpr float kTwelfth = (float)(1.0 / 12.0);
constexpr float kThird = (float)(1.0 / 3.0);

__global__ void jacobi_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ ex, const float* __restrict__ ey,
    const float* __restrict__ et, const float* __restrict__ invd,
    float* __restrict__ uo, float* __restrict__ vo,
    int h, int w, int sweeps, int tile_h, int tile_w) {
  extern __shared__ float smem[];
  // Move every array to image blockIdx.z; below, all indices are per image.
  const long long img = (long long)blockIdx.z * h * w;
  u += img;
  v += img;
  ex += img;
  ey += img;
  et += img;
  invd += img;
  uo += img;
  vo += img;
  const int win_h = tile_h + 2 * sweeps;
  const int win_w = tile_w + 2 * sweeps;
  const int area = win_h * win_w;
  float* su = smem;            // source buffers of the current sweep
  float* sv = su + area;
  float* du = sv + area;       // destination buffers
  float* dv = du + area;
  float* sex = dv + area;
  float* sey = sex + area;
  float* set = sey + area;
  float* sinvd = set + area;

  // Global origin of the window, and the part of it inside the image.
  const int r0 = blockIdx.y * tile_h - sweeps;
  const int c0 = blockIdx.x * tile_w - sweeps;
  const int wr_lo = max(0, -r0), wr_hi = min(win_h, h - r0);
  const int wc_lo = max(0, -c0), wc_hi = min(win_w, w - c0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  {
    const int lw = wc_hi - wc_lo;
    const int n = (wr_hi - wr_lo) * lw;
    for (int i = tid; i < n; i += nthreads) {
      const int wr = wr_lo + i / lw;
      const int wc = wc_lo + i % lw;
      const long long g = (long long)(r0 + wr) * w + (c0 + wc);
      const int s = wr * win_w + wc;
      su[s] = u[g];
      sv[s] = v[g];
      sex[s] = ex[g];
      sey[s] = ey[g];
      set[s] = et[g];
      sinvd[s] = invd[g];
    }
  }
  __syncthreads();

  for (int k = 1; k <= sweeps; ++k) {
    // Sweep k is exact on the window shrunk by k rings, except where the
    // window is cut by the image edge.
    const int rlo = max(k, wr_lo), rhi = min(win_h - k, wr_hi);
    const int clo = max(k, wc_lo), chi = min(win_w - k, wc_hi);
    const int ncols = chi - clo, nrows = rhi - rlo;
    if (ncols > 0 && nrows > 0) {
      const int groups = max(1, nthreads / ncols);
      const int chunk = (nrows + groups - 1) / groups;
      for (int strip = tid; strip < ncols * groups; strip += nthreads) {
        const int c = clo + strip % ncols;
        const int ra = rlo + (strip / ncols) * chunk;
        const int rb = min(ra + chunk, rhi);
        if (ra >= rb) continue;
        const int gc = c0 + c;
        const int cl = gc > 0 ? c - 1 : c;       // j-1, clamped at column 0
        const int cr = gc < w - 1 ? c + 1 : c;   // j+1, clamped at column w-1
        const int ru = r0 + ra > 0 ? ra - 1 : ra;  // i-1, clamped at row 0
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
          const int rd = r0 + r < h - 1 ? r + 1 : r;  // i+1, clamped at h-1
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
          const float e_x = sex[o];
          const float e_y = sey[o];
          const float frac = ((e_x * ubar + e_y * vbar) + set[o]) * sinvd[o];
          du[o] = ubar - e_x * frac;
          dv[o] = vbar - e_y * frac;
          ut_l = um_l; ut_c = um_c; ut_r = um_r;
          vt_l = vm_l; vt_c = vm_c; vt_r = vm_r;
          um_l = ub_l; um_c = ub_c; um_r = ub_r;
          vm_l = vb_l; vm_c = vb_c; vm_r = vb_r;
        }
      }
    }
    __syncthreads();
    float* t = su; su = du; du = t;
    t = sv; sv = dv; dv = t;
  }

  // su/sv now hold the last sweep; write back the owned tile only.
  {
    const int tr_hi = min(sweeps + tile_h, wr_hi);
    const int tc_hi = min(sweeps + tile_w, wc_hi);
    const int lw = tc_hi - sweeps;
    const int n = (tr_hi - sweeps) * lw;
    for (int i = tid; i < n; i += nthreads) {
      const int wr = sweeps + i / lw;
      const int wc = sweeps + i % lw;
      const long long g = (long long)(r0 + wr) * w + (c0 + wc);
      const int s = wr * win_w + wc;
      uo[g] = su[s];
      vo[g] = sv[s];
    }
  }
}

}  // namespace

extern "C" int hs_jacobi_sweeps(const float* u, const float* v,
                                const float* ex, const float* ey,
                                const float* et, const float* invd, float* uo,
                                float* vo, int b, int h, int w,
                                int sweeps, int tile_h, int tile_w,
                                int threads, int device, void* stream) {
  if (b < 1 || b > kMaxBatch) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kFields * (tile_h + 2 * sweeps) *
                      (tile_w + 2 * sweeps) * sizeof(float);
  if (smem > 48 * 1024) {
    // Above 48 KB, dynamic shared memory must be opted into per kernel.
    err = cudaFuncSetAttribute(jacobi_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, b);
  jacobi_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      u, v, ex, ey, et, invd, uo, vo, h, w, sweeps, tile_h, tile_w);
  return (int)cudaGetLastError();
}
