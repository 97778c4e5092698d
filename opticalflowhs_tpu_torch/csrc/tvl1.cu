// K5: the TV-L1 inner loop, `iters` alternations of one warp iteration
// (tvl1.py, tvl1_warp_iteration's loop body), over one frame or a (B, H, W)
// stack, behind one C entry point, hs_tvl1_inner, that enqueues every launch.
//
// Replaces opticalflowhs_tpu/kernels/tvl1_inner.py, _tvl1_kernel (line 99,
// called at line 220). That kernel keeps the 6 state fields (u1, u2, p1x,
// p1y, p2x, p2y) and the 5 constant fields (rho0, gx, gy, 1/g2, th)
// resident in VMEM and runs each alternation as two banded passes in place:
// pass 1 writes u and reads p, pass 2 writes p and reads the new u. Here the
// 11 fields live in device memory (92 MB at 1088x1920, more than the 50 MB
// L2; at the coarser pyramid levels they fit in it), and each pass is one
// launch, one thread per pixel:
//   * u-step: rho = (rho0 + u1*gx) + u2*gy, the three-case step, v = u +
//     step*g, then u = v + theta*div p from p at (r, c-1) and (r-1, c), zero
//     at column 0 and row 0. It writes u1 and u2 in place, and reads u only
//     at its own pixel.
//   * p-step: dx, dy of the new u1 and u2, zero at the true last column and
//     row (never read past the edge), n = 1 + sigma*sqrt(dx^2 + dy^2), then
//     (p + sigma*d)/n in place, with px zeroed at c = w-1 and py at r = h-1
//     (tvl1.py _mask_dual). It writes p, and reads p only at its own pixel.
// So in-place updates are race-free, and the launch boundary is the barrier
// between the passes that the TPU kernel's band order provides. The TPU's
// one-launch in-place schedule does not carry over: concurrent blocks would
// read half-updated neighbours.
//
// Batch: blockIdx.z is the image; image k starts k*h*w floats into every
// array (a 64-bit stride). gridDim.z is at most 65535.
//
// Bounds: device memory. A u-step launch reads 11 arrays and writes 2, a
// p-step launch reads 6 and writes 4: 23 arrays an alternation (192 MB at
// 1088x1920, 57 us at 3.35 TB/s). The function as a whole reads 7 arrays
// and writes 2, and does 51 float32 operations a pixel an alternation, so
// at 100 alternations its least time is set by the operations (0.16 ms at
// 1088x1920); this two-launch schedule moves every field through memory
// twice an alternation and sits near its per-launch byte bound instead.
// Closing that gap needs alternations blocked in shared memory (as K2 does
// for Jacobi) or a persistent grid.
//
// Exactness: the association order is that of tvl1.py (lines 189-205);
// theta, sigma and lambda*theta come in as the float32 values torch rounds
// them to; the divisions are IEEE divisions and the norm is sqrtf, which
// equals _safe_norm in value (sqrt(+0) = +0). With --fmad=false the output
// equals the plain PyTorch loop on the card bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxBatch = 65535;  // gridDim.z limit

__global__ void u_step_kernel(
    float* __restrict__ u1, float* __restrict__ u2,
    const float* __restrict__ rho0, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ inv_g2,
    const float* __restrict__ th, const float* __restrict__ p1x,
    const float* __restrict__ p1y, const float* __restrict__ p2x,
    const float* __restrict__ p2y, int h, int w, float theta,
    float lam_theta) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= h || c >= w) return;
  const long long o = (long long)blockIdx.z * h * w + (long long)r * w + c;
  const float a1 = u1[o], a2 = u2[o];
  const float g_x = gx[o], g_y = gy[o], t = th[o];
  // v-step: the closed-form prox of the L1 data term.
  const float rho = (rho0[o] + a1 * g_x) + a2 * g_y;
  const float step = rho < -t ? lam_theta
                     : rho > t ? -lam_theta
                               : -rho * inv_g2[o];
  const float v1 = a1 + step * g_x;
  const float v2 = a2 + step * g_y;
  // u-step: divergence of the duals, p[-1] = 0 at column 0 and row 0.
  const float q1x = c > 0 ? p1x[o - 1] : 0.0f;
  const float q2x = c > 0 ? p2x[o - 1] : 0.0f;
  const float q1y = r > 0 ? p1y[o - w] : 0.0f;
  const float q2y = r > 0 ? p2y[o - w] : 0.0f;
  const float div1 = (p1x[o] - q1x) + (p1y[o] - q1y);
  const float div2 = (p2x[o] - q2x) + (p2y[o] - q2y);
  u1[o] = v1 + theta * div1;
  u2[o] = v2 + theta * div2;
}

__device__ __forceinline__ void project(float* __restrict__ px,
                                        float* __restrict__ py, long long o,
                                        float dx, float dy, bool last_col,
                                        bool last_row, float sigma) {
  const float n = 1.0f + sigma * sqrtf(dx * dx + dy * dy);
  const float qx = (px[o] + sigma * dx) / n;
  const float qy = (py[o] + sigma * dy) / n;
  px[o] = last_col ? 0.0f : qx;
  py[o] = last_row ? 0.0f : qy;
}

__global__ void p_step_kernel(
    const float* __restrict__ u1, const float* __restrict__ u2,
    float* __restrict__ p1x, float* __restrict__ p1y,
    float* __restrict__ p2x, float* __restrict__ p2y, int h, int w,
    float sigma) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= h || c >= w) return;
  const long long o = (long long)blockIdx.z * h * w + (long long)r * w + c;
  const bool last_col = c == w - 1;
  const bool last_row = r == h - 1;
  // Forward differences; the structural zero sits at the true last column
  // and row, where the clamped shift of the plain version gives a - a.
  const float a1 = u1[o], a2 = u2[o];
  const float d1x = last_col ? 0.0f : u1[o + 1] - a1;
  const float d1y = last_row ? 0.0f : u1[o + w] - a1;
  const float d2x = last_col ? 0.0f : u2[o + 1] - a2;
  const float d2y = last_row ? 0.0f : u2[o + w] - a2;
  project(p1x, p1y, o, d1x, d1y, last_col, last_row, sigma);
  project(p2x, p2y, o, d2x, d2y, last_col, last_row, sigma);
}

}  // namespace

extern "C" int hs_tvl1_inner(float* u1, float* u2, const float* rho0,
                             const float* gx, const float* gy,
                             const float* inv_g2, const float* th, float* p1x,
                             float* p1y, float* p2x, float* p2y, int b, int h,
                             int w, int iters, float theta, float sigma,
                             float lam_theta, int device, void* stream) {
  if (b < 1 || b > kMaxBatch || iters < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, b);
  cudaStream_t s = (cudaStream_t)stream;
  // One C loop enqueues every launch: at the coarse pyramid levels a launch
  // runs for a few microseconds, less than a call from Python would cost.
  for (int k = 0; k < iters; ++k) {
    u_step_kernel<<<grid, block, 0, s>>>(u1, u2, rho0, gx, gy, inv_g2, th,
                                         p1x, p1y, p2x, p2y, h, w, theta,
                                         lam_theta);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    p_step_kernel<<<grid, block, 0, s>>>(u1, u2, p1x, p1y, p2x, p2y, h, w,
                                         sigma);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
