// Bilinear warp (grid_sample, align_corners=True) with its two derivative
// maps, for Hopper (sm_90a).
//
//   out[b,i,j,c] = bilinear sample of image[b,:,:,c] at the pixel
//                  coordinates of grid[b,i,j] = (gx, gy) in [-1, 1]:
//                  x = (gx + 1) * 0.5 * (W - 1), y = (gy + 1) * 0.5 * (H - 1)
//   A[b,i,j,c]   = d out / d x,   B[b,i,j,c] = d out / d y
//
// image [B,H,W,C] (C <= 3, fp32 or bf16), grid [B,Ho,Wo,2] fp32 (Ho need not
// be H: the loss stacks four grids along the rows), out [B,Ho,Wo,C] in the
// image type, A and B [B,Ho,Wo,C] fp32. Padding 'zeros' (a tap outside the
// image reads 0) or 'border' (the coordinates are clamped into the image
// first, and the tap right of or below the last pixel reads the edge).
//
// Replaces packnet_sfm_tpu/ops/pallas/warp.py `_warp_kernel` (pallas_call at
// :298), which on the TPU gathers the taps as a one-hot MXU contraction in a
// VMEM row band, with a band-violation flag and an XLA fall back around it.
// Hopper gathers natively, so this owes only the semantics of the XLA path
// (ops/image.py `_gs_patches`, `_gs_combine`, `_gs_derivs`): it is exact for
// any grid and has no fall back. The formulas keep that path's order:
//   top = p00 + (p01 - p00) * wx,  bot = p10 + (p11 - p10) * wx,
//   out = top + (bot - top) * wy,
//   A = (p01 - p00) * (1 - wy) + (p11 - p10) * wy,
//   B = (p10 - p00) * (1 - wx) + (p11 - p01) * wx,
// with the tap differences rounded to the image type (a bf16 - bf16
// difference is bf16 there) and every product and sum in fp32. Built with
// -fmad=false, so no product is fused into a sum and the result equals the
// plain PyTorch version (ops/kernels/warp.py) bit for bit.
//
// Coordinates far outside the image (|x| ~ 1e7 when the depth is clipped at
// 1e-5) are clamped in float to [-2, W] before the conversion to int, as the
// XLA path's clip(...).astype(int32): a C cast of an out-of-range float is
// undefined.
//
// What bounds it on this card: bytes. Per output pixel it reads the grid
// (8 B) and four taps (L1/L2 serve their reuse), and writes out (C x 2 or 4 B)
// and A, B (C x 8 B); the operations are a few dozen FLOPs per pixel. At the
// slice's shape (B8, 768x640 output, C3, bf16 image) that is about 150 MB per
// launch, ~45 us at 3.35 TB/s.
//
// Design (first, simple version): one thread per output pixel, 256 a block;
// consecutive threads take consecutive pixels, so the grid reads and the
// out/A/B writes are coalesced. The taps are read straight from global
// memory.
//
// C entry point (ctypes): returns cudaGetLastError() right after the launch,
// or cudaErrorInvalidValue for arguments it does not take. It launches on
// the given stream, allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a difference of two taps, rounded to the image type
template <typename T> __device__ __forceinline__ float diff(float a, float b);
template <> __device__ __forceinline__ float diff<float>(float a, float b) { return a - b; }
template <> __device__ __forceinline__ float diff<__nv_bfloat16>(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(a - b));
}

template <typename T, bool BORDER>
__global__ void __launch_bounds__(NT)
warp_kernel(const T* __restrict__ image, const float2* __restrict__ grid,
            T* __restrict__ out, float* __restrict__ dA,
            float* __restrict__ dB, int H, int W, int C, int64_t n_out,
            int64_t out_per_image) {
  const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (i >= n_out) return;
  const int64_t b = i / out_per_image;
  const float2 g = grid[i];
  float x = (g.x + 1.f) * 0.5f * (float)(W - 1);
  float y = (g.y + 1.f) * 0.5f * (float)(H - 1);
  if (BORDER) {
    x = fminf(fmaxf(x, 0.f), (float)(W - 1));
    y = fminf(fmaxf(y, 0.f), (float)(H - 1));
  }
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = x - x0;
  const float wy = y - y0;
  // clamp in float before the conversion: both taps of a far-out pair stay
  // outside the image
  const int xa = (int)fminf(fmaxf(x0, -2.f), (float)W);
  const int ya = (int)fminf(fmaxf(y0, -2.f), (float)H);
  int xb = xa + 1, yb = ya + 1;
  bool vxa = true, vxb = true, vya = true, vyb = true;
  if (BORDER) {          // xa in [0, W-1]: the right tap reads the edge
    xb = min(xb, W - 1);
    yb = min(yb, H - 1);
  } else {
    vxa = xa >= 0 && xa < W;
    vxb = xb >= 0 && xb < W;
    vya = ya >= 0 && ya < H;
    vyb = yb >= 0 && yb < H;
  }
  const T* img = image + b * (int64_t)H * W * C;
  const int64_t r_a = (int64_t)ya * W, r_b = (int64_t)yb * W;
  for (int c = 0; c < C; ++c) {
    const float p00 = (vya && vxa) ? to_f(img[(r_a + xa) * C + c]) : 0.f;
    const float p01 = (vya && vxb) ? to_f(img[(r_a + xb) * C + c]) : 0.f;
    const float p10 = (vyb && vxa) ? to_f(img[(r_b + xa) * C + c]) : 0.f;
    const float p11 = (vyb && vxb) ? to_f(img[(r_b + xb) * C + c]) : 0.f;
    const float d01 = diff<T>(p01, p00);
    const float d23 = diff<T>(p11, p10);
    const float top = p00 + d01 * wx;
    const float bot = p10 + d23 * wx;
    out[i * C + c] = from_f<T>(top + (bot - top) * wy);
    dA[i * C + c] = d01 * (1.f - wy) + d23 * wy;
    dB[i * C + c] = diff<T>(p10, p00) * (1.f - wx) + diff<T>(p11, p01) * wx;
  }
}

template <typename T, bool BORDER>
int launch(const void* image, const void* grid, void* out, void* dA, void* dB,
           int B, int H, int W, int C, int Ho, int Wo, cudaStream_t stream) {
  const int64_t per_image = (int64_t)Ho * Wo;
  const int64_t n_out = per_image * B;
  const int64_t blocks = (n_out + NT - 1) / NT;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  warp_kernel<T, BORDER><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const T*>(image), static_cast<const float2*>(grid),
      static_cast<T*>(out), static_cast<float*>(dA), static_cast<float*>(dB),
      H, W, C, n_out, per_image);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; padding: 0 = zeros, 1 = border.
// Returns 0 on a successful launch.
extern "C" int warp_bilinear(const void* image, const void* grid, void* out,
                             void* dA, void* dB, int B, int H, int W, int C,
                             int Ho, int Wo, int dtype, int padding,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > 3 || Ho <= 0 || Wo <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && padding == 0) return launch<float, false>(image, grid, out, dA, dB, B, H, W, C, Ho, Wo, s);
  if (dtype == 0 && padding == 1) return launch<float, true>(image, grid, out, dA, dB, B, H, W, C, Ho, Wo, s);
  if (dtype == 1 && padding == 0) return launch<__nv_bfloat16, false>(image, grid, out, dA, dB, B, H, W, C, Ho, Wo, s);
  if (dtype == 1 && padding == 1) return launch<__nv_bfloat16, true>(image, grid, out, dA, dB, B, H, W, C, Ho, Wo, s);
  return (int)cudaErrorInvalidValue;
}
