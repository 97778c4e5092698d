// K3 hs_sor_sweeps: `sweeps` 4-color SOR sweeps of Horn-Schunck per launch,
// temporally blocked in shared memory, over one frame or a (B, H, W) stack.
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
// Batch: grid (ceil(w/tile_w), ceil(h/tile_h), B); blockIdx.z is the image,
// and image k starts k*h*w floats into every array (a 64-bit stride). The
// window, halo, clamp and color bookkeeping is per image, in the image's own
// coordinates. gridDim.z is at most 65535, so the entry point refuses more.
//
// Bound: device memory, at 8 arrays read or written per launch (u, v and
// the four fields in, u and v out): 66.8 MB at 1088x1920, 19.9 us at
// 3.35 TB/s, so the sweeps per launch set the bytes per sweep. Each block
// owns a tile_h x tile_w output tile and stages the window of u, v, Ex, Ey,
// Et and invd, tile + 2*4*sweeps on each side, in shared memory. A color
// stage reads pixels that earlier stages of the same sweep updated, so the
// exact region shrinks by one ring per STAGE, four per sweep (the argument
// of kernels/sor.py:92-99 of the JAX package): after 4*sweeps stages
// exactly the owned tile is exact, and only it is written back. Clamps fire
// at the true image edges, from global coordinates; window edges inside the
// image are halo, not edges. Color parity is taken from the global row and
// column, never from the window's own coordinates.
//
// u and v are updated in place in shared memory: no two same-color pixels
// are HS neighbours (nor is a clamped neighbour ever another pixel of the
// same color), so a stage that writes only its own color reads no value
// written in that stage. A __syncthreads separates the stages. Pixels of
// the other colors keep their values exactly, as the plain version's
// torch.where keeps them.
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
// global row and column (an odd origin flips the local parity).

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 6;  // u, v (updated in place), ex, ey, et, invd
constexpr int kStagesPerSweep = 4;
constexpr int kMaxBatch = 65535;  // gridDim.z limit
constexpr float kTwelfth = (float)(1.0 / 12.0);
constexpr float kThird = (float)(1.0 / 3.0);

// kShard: the images are K9's shards, each at its own global origin (org),
// with clamps at the true image edges too; otherwise whole images.
template <bool kShard>
__global__ void sor_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ ex, const float* __restrict__ ey,
    const float* __restrict__ et, const float* __restrict__ invd,
    float* __restrict__ uo, float* __restrict__ vo, const int* __restrict__ org,
    int h, int w, int img_h, int img_w, int sweeps, float omega, int tile_h,
    int tile_w) {
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
  const int halo = kStagesPerSweep * sweeps;
  const int win_h = tile_h + 2 * halo;
  const int win_w = tile_w + 2 * halo;
  const int area = win_h * win_w;
  float* su = smem;
  float* sv = su + area;
  float* sex = sv + area;
  float* sey = sex + area;
  float* set = sey + area;
  float* sinvd = set + area;

  // Array origin of the window, and the part of it inside the array; the
  // array's element (0, 0) is the global pixel (org_r, org_c), zero for
  // whole images.
  const int r0 = blockIdx.y * tile_h - halo;
  const int c0 = blockIdx.x * tile_w - halo;
  const int org_r = kShard ? org[2 * blockIdx.z] : 0;
  const int org_c = kShard ? org[2 * blockIdx.z + 1] : 0;
  const int gr0 = org_r + r0, gc0 = org_c + c0;  // global origin of the window
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

  for (int k = 1; k <= halo; ++k) {
    const int color = (k - 1) % kStagesPerSweep;
    const int pi = color >> 1, pj = color & 1;
    // Stage k is exact on the window shrunk by k rings, except where the
    // window is cut by the image edge. Its pixels are those of the region
    // whose GLOBAL row and column have parities (pi, pj) (x & 1 is the
    // parity of negative x too).
    const int rlo = max(k, wr_lo), rhi = min(win_h - k, wr_hi);
    const int clo = max(k, wc_lo), chi = min(win_w - k, wc_hi);
    const int ra = rlo + ((pi - (gr0 + rlo)) & 1);
    const int ca = clo + ((pj - (gc0 + clo)) & 1);
    const int nr = rhi > ra ? (rhi - ra + 1) / 2 : 0;
    const int nc = chi > ca ? (chi - ca + 1) / 2 : 0;
    const int n = nr * nc;
    for (int i = tid; i < n; i += nthreads) {
      const int r = ra + 2 * (i / nc);
      const int c = ca + 2 * (i % nc);
      // Clamps at the array's edges and, on a shard, at the true image edges.
      const int ar = r0 + r, ac = c0 + c;
      const int gr = gr0 + r, gc = gc0 + c;
      const int ru = ar > 0 && (!kShard || gr != 0) ? r - 1 : r;              // i-1
      const int rd = ar < h - 1 && (!kShard || gr != img_h - 1) ? r + 1 : r;  // i+1
      const int cl = ac > 0 && (!kShard || gc != 0) ? c - 1 : c;              // j-1
      const int cr = ac < w - 1 && (!kShard || gc != img_w - 1) ? c + 1 : c;  // j+1
      const int top = ru * win_w, mid = r * win_w, bot = rd * win_w;
      const int o = mid + c;
      // neighbor_avg: t = (a(i-1) + 2a) + a(i+1) per column, then
      // s = (t(j-1) + 2t) + t(j+1), then s/12 - a/3.
      const float uc = su[o];
      const float tu_l = (su[top + cl] + 2.0f * su[mid + cl]) + su[bot + cl];
      const float tu_c = (su[top + c] + 2.0f * uc) + su[bot + c];
      const float tu_r = (su[top + cr] + 2.0f * su[mid + cr]) + su[bot + cr];
      const float ubar = ((tu_l + 2.0f * tu_c) + tu_r) * kTwelfth - uc * kThird;
      const float vc = sv[o];
      const float tv_l = (sv[top + cl] + 2.0f * sv[mid + cl]) + sv[bot + cl];
      const float tv_c = (sv[top + c] + 2.0f * vc) + sv[bot + c];
      const float tv_r = (sv[top + cr] + 2.0f * sv[mid + cr]) + sv[bot + cr];
      const float vbar = ((tv_l + 2.0f * tv_c) + tv_r) * kTwelfth - vc * kThird;
      const float e_x = sex[o];
      const float e_y = sey[o];
      const float frac = ((e_x * ubar + e_y * vbar) + set[o]) * sinvd[o];
      const float un = ubar - e_x * frac;
      const float vn = vbar - e_y * frac;
      su[o] = uc + omega * (un - uc);
      sv[o] = vc + omega * (vn - vc);
    }
    __syncthreads();
  }

  // Write back the owned tile only.
  {
    const int tr_hi = min(halo + tile_h, wr_hi);
    const int tc_hi = min(halo + tile_w, wc_hi);
    const int lw = tc_hi - halo;
    const int n = (tr_hi - halo) * lw;
    for (int i = tid; i < n; i += nthreads) {
      const int wr = halo + i / lw;
      const int wc = halo + i % lw;
      const long long g = (long long)(r0 + wr) * w + (c0 + wc);
      const int s = wr * win_w + wc;
      uo[g] = su[s];
      vo[g] = sv[s];
    }
  }
}

int launch(const float* u, const float* v, const float* ex, const float* ey,
           const float* et, const float* invd, float* uo, float* vo,
           const int* org, int b, int h, int w, int img_h, int img_w,
           int sweeps, float omega, int tile_h, int tile_w, int threads,
           int device, void* stream) {
  if (b < 1 || b > kMaxBatch || sweeps < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int halo = kStagesPerSweep * sweeps;
  const size_t smem = (size_t)kFields * (tile_h + 2 * halo) *
                      (tile_w + 2 * halo) * sizeof(float);
  const auto kernel = org != nullptr ? sor_kernel<true> : sor_kernel<false>;
  if (smem > 48 * 1024) {
    // Above 48 KB, dynamic shared memory must be opted into per kernel.
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, b);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      u, v, ex, ey, et, invd, uo, vo, org, h, w, img_h, img_w, sweeps, omega,
      tile_h, tile_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_sor_sweeps(const float* u, const float* v, const float* ex,
                             const float* ey, const float* et,
                             const float* invd, float* uo, float* vo, int b,
                             int h, int w, int sweeps, float omega,
                             int tile_h, int tile_w, int threads, int device,
                             void* stream) {
  return launch(u, v, ex, ey, et, invd, uo, vo, nullptr, b, h, w, h, w, sweeps,
                omega, tile_h, tile_w, threads, device, stream);
}

// K9's SOR twin: b halo-padded h x w shards; org holds 2b ints on the
// device, the global (row, column) of each shard's element (0, 0) in the
// img_h x img_w image.
extern "C" int hs_sor_tile_sweeps(const float* u, const float* v,
                                  const float* ex, const float* ey,
                                  const float* et, const float* invd,
                                  float* uo, float* vo, const int* org, int b,
                                  int h, int w, int img_h, int img_w,
                                  int sweeps, float omega, int tile_h,
                                  int tile_w, int threads, int device,
                                  void* stream) {
  if (org == nullptr) return (int)cudaErrorInvalidValue;
  return launch(u, v, ex, ey, et, invd, uo, vo, org, b, h, w, img_h, img_w,
                sweeps, omega, tile_h, tile_w, threads, device, stream);
}
