// K1 hs_derivatives: Horn-Schunck derivatives and the hoisted 1/den, one pass.
//
// Replaces the TPU kernels opticalflowhs_tpu/kernels/derivatives.py
// (_deriv_kernel, line 40) and stage 1 of
// opticalflowhs_tpu/kernels/solve_resident.py (_resident_body, lines
// 198-246): read i1 and i2 once, write Ex, Ey, Et and
// invd = 1 / (alpha^2 + Ex^2 + Ey^2), and optionally the first Jacobi
// sweep from a zero start, u1 = 0 - Ex*(Et*invd), v1 = 0 - Ey*(Et*invd)
// (neighbor_avg(0) == 0, so this is that sweep exactly, and a zero-start
// solve needs neither a zero fill nor a first sweep launch).
//
// Bound: device memory. Each pixel reads 2 floats and writes 4 (6 with the
// zero-start sweep); the arithmetic is ~30 flops. One thread per pixel; the
// +1 row and column neighbours come through L1/L2, so each frame is read
// from device memory about once. Neighbours clamp at the true image edges
// by index clamping, with no padding.
//
// Exactness: the association order is that of ops/stencils.py (both
// packages), the constants are the float32 values torch and JAX see, and
// the library is built with --fmad=false and IEEE division, so the output
// equals the plain PyTorch version bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void derivatives_kernel(
    const float* __restrict__ i1, const float* __restrict__ i2,
    float* __restrict__ ex_out, float* __restrict__ ey_out,
    float* __restrict__ et_out, float* __restrict__ invd_out,
    float* __restrict__ u1_out, float* __restrict__ v1_out,
    int h, int w, float alpha2, int variant) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= h || c >= w) return;
  const long long row = (long long)r * w;
  const long long row_dn = (long long)(r + 1 < h ? r + 1 : r) * w;  // i+1
  const long long row_up = (long long)(r > 0 ? r - 1 : r) * w;      // i-1
  const int c_rt = c + 1 < w ? c + 1 : c;                           // j+1
  const int c_lf = c > 0 ? c - 1 : c;                               // j-1

  float ex, ey, et;
  if (variant == 0) {  // hs_cube
    ex = 0.0f;
    ey = 0.0f;
    const float* frames[2] = {i1, i2};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* p = frames[k];
      const float f = p[row + c];
      const float fr = p[row_dn + c];
      const float fc = p[row + c_rt];
      const float frc = p[row_dn + c_rt];
      ex = (ex + (fc - f)) + (frc - fr);
      ey = (ey + (fr - f)) + (frc - fc);
    }
    ex = ex * 0.25f;
    ey = ey * 0.25f;
    const float d = i2[row + c] - i1[row + c];
    const float dr = i2[row_dn + c] - i1[row_dn + c];
    const float dc = i2[row + c_rt] - i1[row + c_rt];
    const float drc = i2[row_dn + c_rt] - i1[row_dn + c_rt];
    et = 0.25f * (((d + dr) + dc) + drc);
  } else {  // central
    ex = 0.5f * (i1[row + c_rt] - i1[row + c_lf]);
    ey = 0.5f * (i1[row_dn + c] - i1[row_up + c]);
    et = i2[row + c] - i1[row + c];
  }
  const float invd = 1.0f / ((alpha2 + ex * ex) + ey * ey);
  const long long o = row + c;
  ex_out[o] = ex;
  ey_out[o] = ey;
  et_out[o] = et;
  invd_out[o] = invd;
  if (u1_out != nullptr) {
    const float frac = et * invd;
    u1_out[o] = 0.0f - ex * frac;  // not -(ex*frac): keeps the sign of zero
    v1_out[o] = 0.0f - ey * frac;
  }
}

}  // namespace

extern "C" int hs_derivatives(const float* i1, const float* i2, float* ex,
                              float* ey, float* et, float* invd, float* u1,
                              float* v1, int h, int w, float alpha2,
                              int variant, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  derivatives_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      i1, i2, ex, ey, et, invd, u1, v1, h, w, alpha2, variant);
  return (int)cudaGetLastError();
}

extern "C" const char* hs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
