// K1 hs_derivatives: Horn-Schunck derivatives and the hoisted 1/den, one pass,
// over one frame pair or a (B, H, W) stack of pairs.
//
// Replaces these TPU kernels of opticalflowhs_tpu/kernels/:
//   * derivatives.py, _deriv_kernel (line 40), on its (B, bands) grid
//     (line 196): one frame or a stack;
//   * solve_resident.py, stage 1 of _resident_body (lines 198-246), both in
//     the single-frame _resident_kernel and, per grid step, in the batched
//     _resident_kernel_b (line 394, called at line 519).
// It reads i1 and i2 once and writes Ex, Ey, Et and
// invd = 1 / (alpha^2 + Ex^2 + Ey^2), and optionally the first Jacobi
// sweep from a zero start, u1 = 0 - Ex*(Et*invd), v1 = 0 - Ey*(Et*invd)
// (neighbor_avg(0) == 0, so this is that sweep exactly, and a zero-start
// solve needs neither a zero fill nor a first sweep launch).
//
// Batch: blockIdx.z is the image; image k starts k*h*w floats into every
// array (a 64-bit stride). Clamps are per image: a neighbour index never
// leaves its own image, so no read crosses an image seam. gridDim.z is at
// most 65535, so the entry point refuses larger batches.
//
// Bound: device memory. Each pixel reads 2 floats and writes 4 (6 with the
// zero-start sweep): with the sweep, 8 arrays x B x h x w x 4 bytes, 66.8 MB
// x B at 1088x1920, or 19.9 us x B at 3.35 TB/s. The arithmetic is ~30
// flops a pixel. One thread per pixel; the +1 row and column neighbours
// come through L1/L2, so each frame is read from device memory about once.
// Neighbours clamp at the true image edges by index clamping, with no
// padding.
//
// bfloat16 (hs_derivatives_bf16): the same pass on bfloat16 arrays, the
// frames widened to float, the arithmetic in float32 registers, each of Ex,
// Ey and Et rounded once to nearest even, invd formed from the rounded Ex
// and Ey (the reference's data flow: its Ex is already a bfloat16 array
// when 1/den is formed) and rounded, and the first sweep formed from the
// rounded fields. Bound: 8 arrays of 2 bytes a pixel, 10.0 us at 1088x1920.
//
// Exactness: the association order is that of ops/stencils.py
// (both packages), the constants are the float32 values torch and JAX see,
// and the library is built with --fmad=false and IEEE division, so the
// output equals the plain PyTorch version bitwise (in bfloat16, the plain
// version of the storage rule, derivatives_plain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxBatch = 65535;  // gridDim.z limit

// A storage type's loads (widened to float), the value a float has once
// stored, and stores (rounded to nearest even in bfloat16).
template <class T>
struct Store;

template <>
struct Store<float> {
  static __device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void put(float* p, long long i, float x) { p[i] = x; }
};

template <>
struct Store<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, long long i, float x) {
    p[i] = __float2bfloat16_rn(x);
  }
};

// This thread's pixel of the pass, over arrays stored as T.
template <class T>
__device__ __forceinline__ void derivatives_pixel(
    const T* __restrict__ i1, const T* __restrict__ i2,
    T* __restrict__ ex_out, T* __restrict__ ey_out,
    T* __restrict__ et_out, T* __restrict__ invd_out,
    T* __restrict__ u1_out, T* __restrict__ v1_out,
    int h, int w, float alpha2, int variant) {
  using S = Store<T>;
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= h || c >= w) return;
  // Move every array to image blockIdx.z; below, all indices are per image.
  const long long img = (long long)blockIdx.z * h * w;
  i1 += img;
  i2 += img;
  ex_out += img;
  ey_out += img;
  et_out += img;
  invd_out += img;
  if (u1_out != nullptr) {
    u1_out += img;
    v1_out += img;
  }
  const long long row = (long long)r * w;
  const long long row_dn = (long long)(r + 1 < h ? r + 1 : r) * w;  // i+1
  const long long row_up = (long long)(r > 0 ? r - 1 : r) * w;      // i-1
  const int c_rt = c + 1 < w ? c + 1 : c;                           // j+1
  const int c_lf = c > 0 ? c - 1 : c;                               // j-1

  float ex, ey, et;
  if (variant == 0) {  // hs_cube
    ex = 0.0f;
    ey = 0.0f;
    const T* frames[2] = {i1, i2};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const T* p = frames[k];
      const float f = S::load(p, row + c);
      const float fr = S::load(p, row_dn + c);
      const float fc = S::load(p, row + c_rt);
      const float frc = S::load(p, row_dn + c_rt);
      ex = (ex + (fc - f)) + (frc - fr);
      ey = (ey + (fr - f)) + (frc - fc);
    }
    ex = ex * 0.25f;
    ey = ey * 0.25f;
    const float d = S::load(i2, row + c) - S::load(i1, row + c);
    const float dr = S::load(i2, row_dn + c) - S::load(i1, row_dn + c);
    const float dc = S::load(i2, row + c_rt) - S::load(i1, row + c_rt);
    const float drc = S::load(i2, row_dn + c_rt) - S::load(i1, row_dn + c_rt);
    et = 0.25f * (((d + dr) + dc) + drc);
  } else {  // central
    ex = 0.5f * (S::load(i1, row + c_rt) - S::load(i1, row + c_lf));
    ey = 0.5f * (S::load(i1, row_dn + c) - S::load(i1, row_up + c));
    et = S::load(i2, row + c) - S::load(i1, row + c);
  }
  // The fields as stored: invd and the first sweep are formed from them.
  ex = S::round(ex);
  ey = S::round(ey);
  et = S::round(et);
  const float invd = 1.0f / ((alpha2 + ex * ex) + ey * ey);
  const long long o = row + c;
  S::put(ex_out, o, ex);
  S::put(ey_out, o, ey);
  S::put(et_out, o, et);
  S::put(invd_out, o, invd);
  if (u1_out != nullptr) {
    const float frac = et * S::round(invd);
    S::put(u1_out, o, 0.0f - ex * frac);  // not -(ex*frac): keeps the sign of zero
    S::put(v1_out, o, 0.0f - ey * frac);
  }
}

__global__ void derivatives_kernel(
    const float* __restrict__ i1, const float* __restrict__ i2,
    float* __restrict__ ex_out, float* __restrict__ ey_out,
    float* __restrict__ et_out, float* __restrict__ invd_out,
    float* __restrict__ u1_out, float* __restrict__ v1_out,
    int h, int w, float alpha2, int variant) {
  derivatives_pixel<float>(i1, i2, ex_out, ey_out, et_out, invd_out, u1_out, v1_out, h, w,
                           alpha2, variant);
}

__global__ void derivatives_kernel_bf16(
    const __nv_bfloat16* __restrict__ i1, const __nv_bfloat16* __restrict__ i2,
    __nv_bfloat16* __restrict__ ex_out, __nv_bfloat16* __restrict__ ey_out,
    __nv_bfloat16* __restrict__ et_out, __nv_bfloat16* __restrict__ invd_out,
    __nv_bfloat16* __restrict__ u1_out, __nv_bfloat16* __restrict__ v1_out,
    int h, int w, float alpha2, int variant) {
  derivatives_pixel<__nv_bfloat16>(i1, i2, ex_out, ey_out, et_out, invd_out, u1_out,
                                   v1_out, h, w, alpha2, variant);
}

template <class T, class Kernel>
int launch(Kernel kernel, const T* i1, const T* i2, T* ex, T* ey, T* et, T* invd, T* u1,
           T* v1, int b, int h, int w, float alpha2, int variant, int device,
           void* stream) {
  if (b < 1 || b > kMaxBatch) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, b);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(i1, i2, ex, ey, et, invd, u1, v1, h, w,
                                                    alpha2, variant);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_derivatives(const float* i1, const float* i2, float* ex,
                              float* ey, float* et, float* invd, float* u1,
                              float* v1, int b, int h, int w, float alpha2,
                              int variant, int device, void* stream) {
  return launch(derivatives_kernel, i1, i2, ex, ey, et, invd, u1, v1, b, h, w, alpha2,
                variant, device, stream);
}

// K1's bfloat16 build: the same arguments, every array bfloat16.
extern "C" int hs_derivatives_bf16(const __nv_bfloat16* i1, const __nv_bfloat16* i2,
                                   __nv_bfloat16* ex, __nv_bfloat16* ey,
                                   __nv_bfloat16* et, __nv_bfloat16* invd,
                                   __nv_bfloat16* u1, __nv_bfloat16* v1, int b, int h,
                                   int w, float alpha2, int variant, int device,
                                   void* stream) {
  return launch(derivatives_kernel_bf16, i1, i2, ex, ey, et, invd, u1, v1, b, h, w, alpha2,
                variant, device, stream);
}

extern "C" const char* hs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
