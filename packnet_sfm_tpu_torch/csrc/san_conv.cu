// Block-sparse masked convolution for the SAN LiDAR branch, for Hopper (sm_90a),
// and its input gradient.
//
// Forward, san_masked_conv2d:
//   out[b,y,x,:] = (conv_same(x, K)[b,y,x,:] + bias) * mask[b,y,x]
// x [B,H,W,Cin] (NHWC, fp32 or bf16), mask [B,H,W,1] fp32, K [k,k,Cin,Cout]
// (HWIO, same type as x), bias [Cout], out [B,H,W,Cout] (type of x).
// 'SAME' padding is k//2 zeros on every side; k is 3 or 5.
//
// Input gradient, san_masked_conv2d_dgrad:
//   dx[b,y,x,:] = conv_same(gm, KT)[b,y,x,:]
// gm [B,H,W,Cout] is the output cotangent times the forward's mask (so it is
// zero at inactive sites), KT [k,k,Cout,Cin] is K flipped in both spatial
// axes with its I/O axes swapped (the wrapper makes this copy once per
// call), dx [B,H,W,Cin]. No bias and no output mask: dx is nonzero in the
// halo around active sites.
//
// Replaces packnet_sfm_tpu/ops/pallas/san_conv.py `_conv_kernel` /
// `masked_conv2d_pallas` (the TPU kernel: one grid step per 8-row band,
// k*k MXU contractions over a VMEM band, scalar-prefetched activity flags,
// pallas_call at :149) and `_mc_bwd` (:184), which reuses that pallas_call
// for dx with flags dilated by one whole 8-row band each way.
//
// What bounds it on this card: the work is 2*k*k*Cin*Cout FLOPs per active
// output site (per active gm site for dx) against (Cin + Cout) elements per
// site moved. At the slice's shapes (384x640 input, SAN levels 192x320 ..
// 12x20, Cin 1..1024, Cout 64..1024) that is far above the fp32 CUDA-core
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so this kernel, which
// does its math on CUDA cores, is bound by operations. Against the bf16
// tensor-core ridge (295 FLOP/byte) the Cin=1 convs and the narrow 12x20
// and 24x40 levels are bound by bytes instead; chip_smoke.py prints which
// bound holds for each launch. What the data lets it skip is the point:
// projected LiDAR is empty above the horizon at every pyramid level, so
// tiles with nothing active do no math at all.
//
// Design (first, simple version; wgmma/TMA are later work):
// - One block per (image, 8x16 output-pixel tile, 64-channel output tile),
//   256 threads.
// - Activity (__syncthreads_or over the mask): the forward ORs the mask
//   over the block's own output sites (the halo only decides which input
//   rows are read, as in the TPU kernel's tile_activity); dx ORs it over
//   the tile grown by the halo k//2, the band it stages anyway, since gm is
//   zero over the whole receptive field when no site there is active. An
//   inactive block writes exact zeros and returns. This replaces the TPU
//   backward's dilation of flags by a whole band.
// - Otherwise it walks the input channels in chunks of 8: stages the
//   (8+k-1)x(16+k-1)x8 input band (zero-filled outside the image) and the
//   k*k*8*64 weight slice in shared memory as fp32, then every thread
//   accumulates 8 pixels x 4 output channels in fp32 registers. The weight
//   tile for 1024 channels, k=5 is never whole in shared memory: only one
//   8-channel chunk is.
// - Epilogue: forward (acc + bias) * mask, dx acc alone, rounded once to
//   the input type.
//
// C entry points (ctypes): each returns cudaGetLastError() right after the
// launch, or cudaErrorInvalidValue for arguments it does not take. They
// launch on the given stream, allocate nothing and do not synchronise.

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

// DGRAD: activity over the halo-grown band, no bias, no output mask.
template <typename T, int K, bool DGRAD>
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

  // activity: OR of the mask over this block's own output sites (forward)
  // or over the staged band, its sites grown by the halo (dx)
  static_assert(BH * BW <= NT, "one thread per band site");
  int pred = 0;
  if (DGRAD) {
    if (tid < BH * BW) {
      const int r = r0 - P + tid / BW, c = c0 - P + tid % BW;
      pred = (r >= 0 && r < H && c >= 0 && c < W &&
              mask[(img + r) * W + c] != 0.f);
    }
  } else if (tid < TH * TW) {
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
    bv[q] = (!DGRAD && co < Cout) ? to_f(bias[co]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int c = c0 + pc0 + j;
    if (c >= W) continue;
    const float m = DGRAD ? 1.f : mask[(img + r) * W + c];
    T* op = out + ((img + r) * W + c) * Cout;
#pragma unroll
    for (int q = 0; q < CO; ++q) {
      const int co = co0 + tc * CO + q;
      if (co < Cout) op[co] = from_f<T>((acc[j][q] + bv[q]) * m);
    }
  }
}

template <typename T, int K, bool DGRAD>
int launch(const void* x, const void* mask, const void* w, const void* bias,
           void* out, int B, int H, int W, int Cin, int Cout,
           cudaStream_t stream) {
  const size_t smem = smem_floats<K>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        masked_conv_kernel<T, K, DGRAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_row_tiles = (H + TH - 1) / TH;
  const int n_col_tiles = (W + TW - 1) / TW;
  const dim3 grid(n_row_tiles * n_col_tiles, (Cout + TC - 1) / TC, B);
  masked_conv_kernel<T, K, DGRAD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), H, W, Cin, Cout, n_col_tiles);
  return (int)cudaGetLastError();
}

// The launch for one (dtype, k, direction); Cin/Cout are the channels the
// kernel reads and writes (for dx: gm's channels in, x's channels out).
template <bool DGRAD>
int dispatch(const void* x, const void* mask, const void* w, const void* bias,
             void* out, int B, int H, int W, int Cin, int Cout, int k,
             int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || B > 65535 ||
      (Cout + TC - 1) / TC > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && k == 3) return launch<float, 3, DGRAD>(x, mask, w, bias, out, B, H, W, Cin, Cout, s);
  if (dtype == 0 && k == 5) return launch<float, 5, DGRAD>(x, mask, w, bias, out, B, H, W, Cin, Cout, s);
  if (dtype == 1 && k == 3) return launch<__nv_bfloat16, 3, DGRAD>(x, mask, w, bias, out, B, H, W, Cin, Cout, s);
  if (dtype == 1 && k == 5) return launch<__nv_bfloat16, 5, DGRAD>(x, mask, w, bias, out, B, H, W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on a successful launch.
extern "C" int san_masked_conv2d(const void* x, const void* mask, const void* w,
                                 const void* bias, void* out, int B, int H,
                                 int W, int Cin, int Cout, int k, int dtype,
                                 void* stream) {
  return dispatch<false>(x, mask, w, bias, out, B, H, W, Cin, Cout, k, dtype,
                         stream);
}

// dx [B,H,W,Cin] from gm [B,H,W,Cout], the forward's mask and KT
// [k,k,Cout,Cin] (K flipped, I/O swapped). Returns 0 on a successful launch.
extern "C" int san_masked_conv2d_dgrad(const void* gm, const void* mask,
                                       const void* wt, void* dx, int B, int H,
                                       int W, int Cout, int Cin, int k,
                                       int dtype, void* stream) {
  return dispatch<true>(gm, mask, wt, nullptr, dx, B, H, W, Cout, Cin, k,
                        dtype, stream);
}
