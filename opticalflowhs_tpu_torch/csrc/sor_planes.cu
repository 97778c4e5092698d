// K8 hs_sor_planes: a whole 4-color SOR solve (n sweeps) of one frame on
// (row%2, col%2) parity planes, behind one C entry point that enqueues every
// launch: a pack launch, 4*n color-stage launches and an unpack launch.
//
// Replaces opticalflowhs_tpu/kernels/sor_planes.py, _planes_kernel (line 78,
// called at line 189 through hs_solve_sor_planes, line 261). That kernel
// holds u, v and the four fields as quarter-resolution parity planes in
// VMEM; a color stage then updates exactly one plane in place, with no
// masks, and the launch is one whole solve. Here the planes live in device
// memory (6 arrays, 50 MB at 1088x1920, about the H100's 50 MB L2):
//   * pack: one thread a plane cell de-interleaves u0, v0 (zeros for a zero
//     start), Ex, Ey, Et and 1/den into a (6, 4, ceil(h/2), ceil(w/2))
//     set. Pad cells, where h or w is odd, get 0.0 and are never read for a
//     real pixel;
//   * color stage (pi, pj): one thread a pixel of that color's plane. It
//     reads its 3x3 neighbourhood of u and v from the four planes and its
//     fields from its own plane, and writes its u and v in place. The launch
//     boundary is the barrier between stages;
//   * unpack: one thread a pixel interleaves u and v back to (h, w).
// Clamps are taken in global coordinates, (r-1, r+1, c-1, c+1) clamped to
// the image, and then mapped to a plane cell: the true bottom row and right
// column fall in the plane of the parity of h-1 and w-1, which is what the
// TPU kernel's m_bot/m_rt fixes select by the parity of h and w.
//
// In place within a stage is race-free: no two same-color pixels are HS
// neighbours, and a clamped neighbour of a pixel is either a pixel of
// another color or the pixel itself, which reads its own centre before it
// writes it (as in K3, csrc/sor.cu).
//
// Exactness: the arithmetic and its association are K3's, character for
// character (csrc/sor.cu, the stage body): t = (a(i-1) + 2a) + a(i+1), then
// ((t_l + 2t_c) + t_r)*(1/12) - a*(1/3), then frac = ((ex*ubar + ey*vbar) +
// et)*invd, then u + omega*(u* - u). Built with --fmad=false, K8 equals the
// plain SOR sweeps (ops/stencils.py sor_step) bitwise.
//
// Bounds at 1088x1920. The whole solve does the same work as the K1 + K3
// chain, 2281 float32 operations a pixel at n = 50 (K1's 31, then 45 a
// sweep), so its least time is set by the operations: 71.1 us (142.2 us at
// the unfused rate that --fmad=false kernels can reach). A color stage of
// this schedule moves about 3.5 full-frame arrays: u and v of all four
// planes read (2), the four fields of one plane read (1), u and v of one
// plane written (0.5): 29.2 MB, 8.7 us at 3.35 TB/s, so 1.75 ms for 200
// stages if every stage goes to device memory, less where the 50 MB working
// set stays in L2. A persistent cooperative grid (K6's cooperative.cuh),
// plane tiles in shared memory and temporal blocking over stages are left
// to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kArrays = 6;  // u, v, ex, ey, et, invd
constexpr float kTwelfth = (float)(1.0 / 12.0);
constexpr float kThird = (float)(1.0 / 3.0);

// Offset of global pixel (r, c) in a 4-plane set: plane (r%2, c%2), cell
// (r/2, c/2).
__device__ __forceinline__ long long cell(int r, int c, int w2,
                                          long long plane) {
  return ((r & 1) * 2 + (c & 1)) * plane + (long long)(r >> 1) * w2 + (c >> 1);
}

// blockIdx.z = array * 4 + plane; a null u0/v0 packs zeros.
__global__ void pack_kernel(const float* __restrict__ u0,
                            const float* __restrict__ v0,
                            const float* __restrict__ ex,
                            const float* __restrict__ ey,
                            const float* __restrict__ et,
                            const float* __restrict__ invd,
                            float* __restrict__ planes, int h, int w, int h2,
                            int w2) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= h2 || j >= w2) return;
  const int a = blockIdx.z >> 2, p = blockIdx.z & 3;
  const int r = 2 * i + (p >> 1), c = 2 * j + (p & 1);
  const float* src = a == 0   ? u0
                     : a == 1 ? v0
                     : a == 2 ? ex
                     : a == 3 ? ey
                     : a == 4 ? et
                              : invd;
  const long long plane = (long long)h2 * w2;
  float val = 0.0f;
  if (src != nullptr && r < h && c < w) val = src[(long long)r * w + c];
  planes[blockIdx.z * plane + (long long)i * w2 + j] = val;
}

// One color stage: the pixels (r, c) = (2i + pi, 2j + pj).
__global__ void stage_kernel(float* __restrict__ pu, float* __restrict__ pv,
                             const float* __restrict__ pex,
                             const float* __restrict__ pey,
                             const float* __restrict__ pet,
                             const float* __restrict__ pinvd, int h, int w,
                             int w2, long long plane, int pi, int pj,
                             float omega) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int r = 2 * i + pi, c = 2 * j + pj;
  if (r >= h || c >= w) return;
  const int ru = r > 0 ? r - 1 : r;      // i-1, clamped at row 0
  const int rd = r < h - 1 ? r + 1 : r;  // i+1, clamped at row h-1
  const int cl = c > 0 ? c - 1 : c;      // j-1, clamped at column 0
  const int cr = c < w - 1 ? c + 1 : c;  // j+1, clamped at column w-1
  const long long o = cell(r, c, w2, plane);
  const long long ul = cell(ru, cl, w2, plane), uc_ = cell(ru, c, w2, plane),
                  ur = cell(ru, cr, w2, plane);
  const long long ml = cell(r, cl, w2, plane), mr = cell(r, cr, w2, plane);
  const long long dl = cell(rd, cl, w2, plane), dc = cell(rd, c, w2, plane),
                  dr = cell(rd, cr, w2, plane);
  // neighbor_avg: t = (a(i-1) + 2a) + a(i+1) per column, then
  // s = (t(j-1) + 2t) + t(j+1), then s/12 - a/3.
  const float uc = pu[o];
  const float tu_l = (pu[ul] + 2.0f * pu[ml]) + pu[dl];
  const float tu_c = (pu[uc_] + 2.0f * uc) + pu[dc];
  const float tu_r = (pu[ur] + 2.0f * pu[mr]) + pu[dr];
  const float ubar = ((tu_l + 2.0f * tu_c) + tu_r) * kTwelfth - uc * kThird;
  const float vc = pv[o];
  const float tv_l = (pv[ul] + 2.0f * pv[ml]) + pv[dl];
  const float tv_c = (pv[uc_] + 2.0f * vc) + pv[dc];
  const float tv_r = (pv[ur] + 2.0f * pv[mr]) + pv[dr];
  const float vbar = ((tv_l + 2.0f * tv_c) + tv_r) * kTwelfth - vc * kThird;
  const float e_x = pex[o];
  const float e_y = pey[o];
  const float frac = ((e_x * ubar + e_y * vbar) + pet[o]) * pinvd[o];
  const float un = ubar - e_x * frac;
  const float vn = vbar - e_y * frac;
  pu[o] = uc + omega * (un - uc);
  pv[o] = vc + omega * (vn - vc);
}

__global__ void unpack_kernel(const float* __restrict__ pu,
                              const float* __restrict__ pv,
                              float* __restrict__ uo, float* __restrict__ vo,
                              int h, int w, int w2, long long plane) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= h || c >= w) return;
  const long long g = (long long)r * w + c;
  const long long o = cell(r, c, w2, plane);
  uo[g] = pu[o];
  vo[g] = pv[o];
}

}  // namespace

// planes: 6 * 4 * ceil(h/2) * ceil(w/2) floats of scratch. u0 and v0 are
// both null (zero start) or both given. n = 0 packs and unpacks only.
extern "C" int hs_sor_planes(const float* u0, const float* v0,
                             const float* ex, const float* ey,
                             const float* et, const float* invd,
                             float* planes, float* uo, float* vo, int h,
                             int w, int n, float omega, int device,
                             void* stream) {
  if (h < 1 || w < 1 || n < 0 || (u0 == nullptr) != (v0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  const long long plane = (long long)h2 * w2;
  const dim3 block(kBlockX, kBlockY);
  const dim3 plane_grid((w2 + kBlockX - 1) / kBlockX,
                        (h2 + kBlockY - 1) / kBlockY);
  cudaStream_t s = (cudaStream_t)stream;
  pack_kernel<<<dim3(plane_grid.x, plane_grid.y, kArrays * 4), block, 0, s>>>(
      u0, v0, ex, ey, et, invd, planes, h, w, h2, w2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* pu = planes;
  float* pv = planes + 4 * plane;
  const float* pex = planes + 8 * plane;
  const float* pey = planes + 12 * plane;
  const float* pet = planes + 16 * plane;
  const float* pinvd = planes + 20 * plane;
  // One C loop enqueues every stage: a stage at 1080p runs for about ten
  // microseconds, not much more than a call from Python would cost.
  for (int k = 0; k < n; ++k) {
    for (int color = 0; color < 4; ++color) {
      stage_kernel<<<plane_grid, block, 0, s>>>(pu, pv, pex, pey, pet, pinvd,
                                                h, w, w2, plane, color >> 1,
                                                color & 1, omega);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  unpack_kernel<<<grid, block, 0, s>>>(pu, pv, uo, vo, h, w, w2, plane);
  return (int)cudaGetLastError();
}
