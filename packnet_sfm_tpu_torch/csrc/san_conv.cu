// Block-sparse masked convolution for the SAN LiDAR branch, for Hopper (sm_90a).
//
//   out[b,y,x,:] = (conv_same(x, K)[b,y,x,:] + bias) * mask[b,y,x]
//
// x [B,H,W,Cin] (NHWC, fp32 or bf16), mask [B,H,W,1] fp32, K [k,k,Cin,Cout]
// (HWIO, same type as x), bias [Cout], out [B,H,W,Cout] (type of x).
// 'SAME' padding is k//2 zeros on every side; k is 3 or 5.
//
// Replaces packnet_sfm_tpu/ops/pallas/san_conv.py `_conv_kernel` /
// `masked_conv2d_pallas` (the TPU kernel: one grid step per 8-row band,
// k*k MXU contractions over a VMEM band, scalar-prefetched activity flags).
//
// What bounds it on this card: the work is 2*k*k*Cin*Cout FLOPs per active
// output site against (Cin + Cout) elements per site moved. At the slice's
// shapes (384x640 input, SAN levels 192x320 .. 12x20, Cin 1..1024, Cout
// 64..1024) that is far above the fp32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so this kernel, which does its math on CUDA
// cores, is bound by operations. Against the bf16 tensor-core ridge (295
// FLOP/byte) the Cin=1 convs and the narrow 12x20 and 24x40 levels are
// bound by bytes instead; chip_smoke.py prints which bound holds for each
// launch. What the data lets it skip is the point: projected LiDAR is
// empty above the horizon at every pyramid level, so tiles whose own
// output sites are all inactive do no math at all.
//
// Design (first, simple version; wgmma/TMA are later work):
// - One block per (image, 8x16 output-pixel tile, 64-channel Cout tile),
//   256 threads.
// - The block first ORs the mask over its own output sites
//   (__syncthreads_or). If none is active it writes exact zeros and returns.
//   The halo only decides which input rows are read, never whether an
//   output exists, as in the TPU kernel's tile_activity.
// - Otherwise it walks Cin in chunks of 8: stages the (8+k-1)x(16+k-1)x8
//   input band (zero-filled outside the image) and the k*k*8*64 weight
//   slice in shared memory as fp32, then every thread accumulates 8 pixels
//   x 4 output channels in fp32 registers. The weight tile for Cout 1024,
//   k=5 is never whole in shared memory: only one 8-channel chunk is.
// - Epilogue: (acc + bias) * mask, rounded to the input type.
//
// C entry point (ctypes): san_masked_conv2d(...) returns cudaGetLastError()
// right after the launch, or cudaErrorInvalidValue for arguments it does
// not take. It launches on the given stream, allocates nothing and does
// not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;            // output rows per block
constexpr int TW = 16;           // output cols per block
constexpr int TC = 64;           // output channels per block
constexpr int CC = 8;            // input channels per shared-memory chunk
constexpr int IN_STRIDE = CC + 1;  // padded pixel stride in the input band
constexpr int NT = 256;          // threads per block
constexpr int PX = 8;            // pixels per thread (one row, 8 columns)
constexpr int CO = 4;            // output channels per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int K>
constexpr int smem_floats() {
  return (TH + K - 1) * (TW + K - 1) * IN_STRIDE + K * K * CC * TC;
}
// the weight slice follows the input band and is read as float4
static_assert((TH + 2) * (TW + 2) * IN_STRIDE % 4 == 0, "w_s alignment, k=3");
static_assert((TH + 4) * (TW + 4) * IN_STRIDE % 4 == 0, "w_s alignment, k=5");

template <typename T, int K>
__global__ void __launch_bounds__(NT)
masked_conv_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                   const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ out, int H, int W, int Cin, int Cout,
                   int n_col_tiles) {
  constexpr int BH = TH + K - 1;
  constexpr int BW = TW + K - 1;
  constexpr int P = K / 2;
  extern __shared__ float smem[];
  float* in_s = smem;                        // [BH][BW][IN_STRIDE]
  float* w_s = smem + BH * BW * IN_STRIDE;   // [K*K][CC][TC]

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * TC;
  const int r0 = (blockIdx.x / n_col_tiles) * TH;
  const int c0 = (blockIdx.x % n_col_tiles) * TW;
  const int tid = threadIdx.x;
  const size_t img = (size_t)b * H;

  // activity: OR of the mask over this block's own output sites
  int pred = 0;
  if (tid < TH * TW) {
    const int r = r0 + tid / TW, c = c0 + tid % TW;
    pred = (r < H && c < W && mask[(img + r) * W + c] != 0.f);
  }
  if (!__syncthreads_or(pred)) {
    const T zero = from_f<T>(0.f);
    for (int i = tid; i < TH * TW * TC; i += NT) {
      const int co = co0 + i % TC, pix = i / TC;
      const int r = r0 + pix / TW, c = c0 + pix % TW;
      if (r < H && c < W && co < Cout) out[((img + r) * W + c) * Cout + co] = zero;
    }
    return;
  }

  const int tc = tid & 15;          // output channels co0 + tc*4 .. +3
  const int tp = tid >> 4;          // pixel group: row tp/2, cols (tp%2)*8 .. +7
  const int pr = tp >> 1;
  const int pc0 = (tp & 1) * PX;

  float acc[PX][CO];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int q = 0; q < CO; ++q) acc[j][q] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CC) {
    const int cn = min(CC, Cin - ci0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < BH * BW * CC; i += NT) {
      const int c = i % CC, pix = i / CC;
      const int gr = r0 - P + pix / BW, gc = c0 - P + pix % BW;
      float v = 0.f;
      if (c < cn && gr >= 0 && gr < H && gc >= 0 && gc < W)
        v = to_f(x[((img + gr) * W + gc) * Cin + ci0 + c]);
      in_s[pix * IN_STRIDE + c] = v;
    }
    for (int i = tid; i < K * K * CC * TC; i += NT) {
      const int co = i % TC, rest = i / TC;
      const int c = rest % CC, tap = rest / CC;
      float v = 0.f;
      if (c < cn && co0 + co < Cout)
        v = to_f(w[((size_t)tap * Cin + ci0 + c) * Cout + co0 + co]);
      w_s[i] = v;
    }
    __syncthreads();

    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const float* wp = w_s + (ky * K + kx) * CC * TC + tc * CO;
        const float* ip = in_s + ((pr + ky) * BW + pc0 + kx) * IN_STRIDE;
        if (cn == CC) {
#pragma unroll
          for (int c = 0; c < CC; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(wp + c * TC);
#pragma unroll
            for (int j = 0; j < PX; ++j) {
              const float xv = ip[j * IN_STRIDE + c];
              acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
              acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
              acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
              acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
            }
          }
        } else {  // a narrow last chunk (Cin = 1 at the first SAN stage)
          for (int c = 0; c < cn; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(wp + c * TC);
#pragma unroll
            for (int j = 0; j < PX; ++j) {
              const float xv = ip[j * IN_STRIDE + c];
              acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
              acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
              acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
              acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
            }
          }
        }
      }
    }
  }

  const int r = r0 + pr;
  if (r >= H) return;
  float bv[CO];
#pragma unroll
  for (int q = 0; q < CO; ++q) {
    const int co = co0 + tc * CO + q;
    bv[q] = co < Cout ? to_f(bias[co]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int c = c0 + pc0 + j;
    if (c >= W) continue;
    const float m = mask[(img + r) * W + c];
    T* op = out + ((img + r) * W + c) * Cout;
#pragma unroll
    for (int q = 0; q < CO; ++q) {
      const int co = co0 + tc * CO + q;
      if (co < Cout) op[co] = from_f<T>((acc[j][q] + bv[q]) * m);
    }
  }
}

template <typename T, int K>
int launch(const void* x, const void* mask, const void* w, const void* bias,
           void* out, int B, int H, int W, int Cin, int Cout,
           cudaStream_t stream) {
  const size_t smem = smem_floats<K>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        masked_conv_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_row_tiles = (H + TH - 1) / TH;
  const int n_col_tiles = (W + TW - 1) / TW;
  const dim3 grid(n_row_tiles * n_col_tiles, (Cout + TC - 1) / TC, B);
  masked_conv_kernel<T, K><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), H, W, Cin, Cout, n_col_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on a successful launch.
extern "C" int san_masked_conv2d(const void* x, const void* mask, const void* w,
                                 const void* bias, void* out, int B, int H,
                                 int W, int Cin, int Cout, int k, int dtype,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || B > 65535 ||
      (Cout + TC - 1) / TC > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && k == 3) return launch<float, 3>(x, mask, w, bias, out, B, H, W, Cin, Cout, s);
  if (dtype == 0 && k == 5) return launch<float, 5>(x, mask, w, bias, out, B, H, W, Cin, Cout, s);
  if (dtype == 1 && k == 3) return launch<__nv_bfloat16, 3>(x, mask, w, bias, out, B, H, W, Cin, Cout, s);
  if (dtype == 1 && k == 5) return launch<__nv_bfloat16, 5>(x, mask, w, bias, out, B, H, W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
