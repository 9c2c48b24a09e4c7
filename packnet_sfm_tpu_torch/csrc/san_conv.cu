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
//   dx[b,y,x,ci] = sum_{ky,kx,co} gm[b, y+ky-k//2, x+kx-k//2, co]
//                                 * K[k-1-ky, k-1-kx, ci, co]
// gm [B,H,W,Cout] is the output cotangent times the forward's mask (so it is
// zero at inactive sites), K the forward's own weights, read at the flipped
// tap (no flipped copy is made), dx [B,H,W,Cin]. No bias and no output
// mask: dx is nonzero in the halo around active sites.
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
// 12x20, Cin 1..1024, Cout 64..1024) all but the Cin = 1 convs are above
// the bf16 tensor-core ridge (989 TFLOP/s over 3.35 TB/s = 295 FLOP/byte)
// and bound by operations; the Cin = 1 convs and some B1 launches of the
// levels from 48x80 down are bound by bytes. chip_smoke.py prints which bound holds for each
// launch. What the data lets a kernel skip is the point: projected LiDAR
// is empty above the horizon at every pyramid level, so tiles with nothing
// active do no math at all, where a dense convolution computes them.
//
// Two paths, chosen per call by the wrapper (ops/kernels/san_conv.py
// `plan`) from dtype and shape:
//
// 1. Tensor cores (bf16, both channel counts multiples of 8; every conv of
//    the slices but the three Cin = 1 ones, and the edge shapes with Cin
//    16 / 24, Cout 16 / 96): an implicit GEMM per block. M = the output
//    pixels of the block's tile, the same tile_h x tile_w pixels of
//    tile_n images (8x16x1 and 4x16x1; for k = 3 also 8x8x2, 8x8x1, 4x8x4
//    and 4x8x1, so that the 24x40 and 12x20 levels compute few pixels
//    outside the image and a block still has 64-128 pixels); N = a tile
//    of 64 or 128 output channels (Cout forward, Cin dgrad); K = (input
//    chunk of 32 channels, tap). 4 warps as 2 (M) x 2 (N); each warp holds
//    M/32 x N/16 m16n8 fp32 accumulators and runs
//    mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//    - Why mma.sync and not wgmma: each tap's A operand is the staged band
//      shifted by (ky, kx). ldmatrix takes one row address per lane, so the
//      im2col shift costs nothing; wgmma reads A from shared memory only
//      in its canonical swizzled layout, which would need a copy per tap.
//    - Staging with cp.async (16-byte copies; a source size of 0 zero-fills
//      outside the image and past the last channel): the (tile_h+k-1) x
//      (tile_w+k-1) x 32 input band of each image of the tile,
//      double-buffered by chunk and fetched a whole chunk ahead, is reused
//      by all k*k taps; the 32 x N weight tile of each (chunk, tap) goes
//      through a 4-stage ring, one cp.async group an iteration.
//    - The band's pixel stride is padded to 40 bf16 (80 bytes): the 8 rows
//      of an 8x8 ldmatrix are 8 pixels of one row, 16-byte bank groups
//      0, 5, 2, 7, 4, 1, 6, 3, no conflict. Weight rows are padded the same
//      way (72 / 136 bf16 forward, 40 dgrad).
//    - B: forward W[tap][ci][co] is N-contiguous, staged [ci][co] and
//      loaded with ldmatrix.trans. Dgrad reads the original W at the
//      flipped tap: B[K = co][N = ci] is K-contiguous, the .col layout,
//      staged [ci][co] and loaded with plain ldmatrix; no flipped copy.
//    - Each iteration loads all its A and B fragments, then runs its MMAs.
//    - Fill: the wrapper splits K over ranges of input chunks where the
//      grid is short of blocks (the small levels, B1). Each split writes
//      fp32 partials to a workspace the wrapper allocates; a second launch
//      (san_splitk_reduce) sums them in split order, then applies bias,
//      mask and the bf16 rounding, so the result does not depend on block
//      order.
//    - Epilogue: forward (acc + bias) * mask, dgrad acc, rounded once to
//      bf16.
// 2. CUDA cores (fp32, used by the fp32 parity checks, where TF32 would
//    break their 1e-4 rule; and bf16 with a channel count that is not a
//    multiple of 8: the three Cin = 1 forward convs at 192x320, which are
//    bound by bytes, and the edge shapes with Cin or Cout 1). One block per
//    8x16 tile x 64 output channels, 256 threads, each accumulating 8
//    pixels x 4 channels in fp32 with fmaf over chunks of 8 input channels
//    staged as fp32 in shared memory; dx reads the weights at the flipped
//    tap as above.
//
// Both paths keep the TPU kernel's activity skip: the forward ORs the mask
// over the block's own output sites (the halo only decides which input
// rows are read); dx ORs it over the tile grown by the halo k//2, since gm
// is zero over the whole receptive field when no site there is active. An
// inactive block writes exact zeros (fp32 zeros to its workspace slice
// under split-K) and returns.
//
// C entry points (ctypes): each returns cudaGetLastError() right after the
// launch, or cudaErrorInvalidValue for arguments it does not take. They
// launch on the given stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ CUDA cores

constexpr int TH = 8;            // output rows per block
constexpr int TW = 16;           // output cols per block
constexpr int TC = 64;           // output channels per block
constexpr int CC = 8;            // input channels per shared-memory chunk
constexpr int IN_STRIDE = CC + 1;  // padded pixel stride in the input band
constexpr int NT = 256;          // threads per block
constexpr int PX = 8;            // pixels per thread (one row, 8 columns)
constexpr int CO = 4;            // output channels per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

template <int K>
constexpr int smem_floats() {
  return (TH + K - 1) * (TW + K - 1) * IN_STRIDE + K * K * CC * TC;
}
// the weight slice follows the input band and is read as float4
static_assert((TH + 2) * (TW + 2) * IN_STRIDE % 4 == 0, "w_s alignment, k=3");
static_assert((TH + 4) * (TW + 4) * IN_STRIDE % 4 == 0, "w_s alignment, k=5");

// Cin/Cout are the channels read and written (for dx: gm's, then x's).
// DGRAD: activity over the halo-grown band, weights at the flipped tap,
// no bias, no output mask.
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
      if (c < cn && co0 + co < Cout) {
        // forward K[tap][ci][co]; dx K[flipped tap][dx channel][gm channel]
        const size_t idx =
            DGRAD ? ((size_t)(K * K - 1 - tap) * Cout + co0 + co) * Cin + ci0 + c
                  : ((size_t)tap * Cin + ci0 + c) * Cout + co0 + co;
        v = to_f(w[idx]);
      }
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
int launch_cc(const void* x, const void* mask, const void* w, const void* bias,
              void* out, int B, int H, int W, int Cin, int Cout,
              cudaStream_t stream) {
  const size_t smem = smem_floats<K>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        masked_conv_kernel<T, K, DGRAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if ((Cout + TC - 1) / TC > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int n_row_tiles = (H + TH - 1) / TH;
  const int n_col_tiles = (W + TW - 1) / TW;
  const dim3 grid(n_row_tiles * n_col_tiles, (Cout + TC - 1) / TC, B);
  masked_conv_kernel<T, K, DGRAD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), H, W, Cin, Cout, n_col_tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- tensor cores

namespace tc {

constexpr int CK = 32;           // input channels per chunk
constexpr int PS = CK + 8;       // band pixel stride (bf16): 80 bytes
constexpr int WD = CK + 8;       // dgrad weight row stride [ci][co]: 80 B
constexpr int STAGES = 4;        // weight-tile ring
constexpr int NT = 128;          // 4 warps: 2 (M) x 2 (N)

// BNT output channels a block (64 or 128): forward weight rows [ci][co]
// of BNT + 8 (144 or 272 bytes, 16 apart mod 128), and one ring stage
template <int BNT>
__host__ __device__ constexpr int wf() { return BNT + 8; }
template <int BNT>
__host__ __device__ constexpr int w_tile() {
  return CK * wf<BNT>() > BNT * WD ? CK * wf<BNT>() : BNT * WD;
}

// a block's tile: the same THT x TWT output pixels (TWT 16 or 8) of NBT
// images; its input band and shared memory
template <int K, int THT, int TWT, int NBT>
__host__ __device__ constexpr int band_elems() {
  return NBT * (THT + K - 1) * (TWT + K - 1) * PS;
}
template <int K, int THT, int TWT, int NBT, int BNT>
__host__ __device__ constexpr int smem_bytes() {
  return (2 * band_elems<K, THT, TWT, NBT>() + STAGES * w_tile<BNT>()) *
         (int)sizeof(bf16);
}
// PS and the weight rows are multiples of 8 bf16: every band pixel, weight
// row and buffer is 16-byte aligned
static_assert(PS % 8 == 0 && WD % 8 == 0 && wf<64>() % 8 == 0 &&
              wf<128>() % 8 == 0, "16-byte aligned buffers");
static_assert(smem_bytes<5, 8, 16, 1, 128>() <= 232448,
              "shared memory of one block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; a source size of 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Kc/Nc: the channels read (forward Cin, dx Cout) and written (forward
// Cout, dx Cin). The block's NBT x THT x TWT pixels (image, row, column;
// row-major) form its M / 16 m16 tiles, an m16 tile being one 16-wide or
// two 8-wide rows of one image; half of them go to each warp row.
// blockIdx.z = image group * splits + split; split s covers input chunks
// [s * per_split, (s + 1) * per_split). SPLIT writes fp32 partials to ws
// [splits][B*H*W][Nc] instead of the bf16 output.
template <int K, int THT, int TWT, int NBT, int BNT, bool DGRAD, bool SPLIT>
__global__ void __launch_bounds__(NT)
masked_conv_tc(const bf16* __restrict__ x, const float* __restrict__ mask,
               const bf16* __restrict__ w, const bf16* __restrict__ bias,
               bf16* __restrict__ out, float* __restrict__ ws, int B, int H,
               int W, int Kc, int Nc, int n_col_tiles, int splits,
               int per_split) {
  constexpr int BH = THT + K - 1;
  constexpr int BW = TWT + K - 1;
  constexpr int P = K / 2;
  constexpr int KK = K * K;
  constexpr int PIX = THT * TWT;                // output pixels an image
  constexpr int BAND = band_elems<K, THT, TWT, NBT>();
  constexpr int MT = NBT * PIX / 32;            // m16 tiles per warp
  constexpr int NT8 = BNT / 16;                 // n8 tiles per warp
  constexpr int WF = wf<BNT>();
  constexpr int W_TILE = w_tile<BNT>();
  static_assert(MT >= 1 && MT <= 4 && (TWT == 8 || TWT == 16) &&
                (BNT == 64 || BNT == 128), "tile shape");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* band_s = reinterpret_cast<bf16*>(tc_smem);  // [2][NBT][BH][BW][PS]
  bf16* w_s = band_s + 2 * BAND;                    // [STAGES][W_TILE]

  const int b0 = (blockIdx.z / splits) * NBT, split = blockIdx.z % splits;
  const int n0 = blockIdx.y * BNT;
  const int r0 = (blockIdx.x / n_col_tiles) * THT;
  const int c0 = (blockIdx.x % n_col_tiles) * TWT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const size_t n_pix = (size_t)B * H * W;

  // activity, as on the CUDA-core path, over the tile of every image
  int pred = 0;
  if (DGRAD) {
    for (int i = tid; i < NBT * BH * BW; i += NT) {
      const int b = b0 + i / (BH * BW), j = i % (BH * BW);
      const int r = r0 - P + j / BW, c = c0 - P + j % BW;
      pred |= (b < B && r >= 0 && r < H && c >= 0 && c < W &&
               mask[((size_t)b * H + r) * W + c] != 0.f);
    }
  } else if (tid < NBT * PIX) {
    const int b = b0 + tid / PIX, j = tid % PIX;
    const int r = r0 + j / TWT, c = c0 + j % TWT;
    pred = (b < B && r < H && c < W && mask[((size_t)b * H + r) * W + c] != 0.f);
  }
  if (!__syncthreads_or(pred)) {
    for (int i = tid; i < NBT * PIX * (BNT / 2); i += NT) {
      const int co = n0 + (i % (BNT / 2)) * 2, pix = i / (BNT / 2);
      const int b = b0 + pix / PIX, j = pix % PIX;
      const int r = r0 + j / TWT, c = c0 + j % TWT;
      if (b >= B || r >= H || c >= W || co >= Nc) continue;
      const size_t p = ((size_t)b * H + r) * W + c;
      if (SPLIT)
        *reinterpret_cast<float2*>(ws + ((size_t)split * n_pix + p) * Nc + co) =
            make_float2(0.f, 0.f);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + p * Nc + co) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }

  const int n_chunks = (Kc + CK - 1) / CK;
  const int cb = split * per_split;
  const int ce = min(n_chunks, cb + per_split);
  const int n_it = ce > cb ? (ce - cb) * KK : 0;

  // the input band of chunk `chunk` into buffer `buf`
  auto load_band = [&](int chunk, int buf) {
    const int ci0 = chunk * CK;
    bf16* dst = band_s + buf * BAND;
    for (int i = tid; i < NBT * BH * BW * (CK / 8); i += NT) {
      const int q = i % (CK / 8), pix = i / (CK / 8);
      const int b = b0 + pix / (BH * BW), j = pix % (BH * BW);
      const int gr = r0 - P + j / BW, gc = c0 - P + j % BW;
      const int ci = ci0 + q * 8;
      const bool ok =
          b < B && gr >= 0 && gr < H && gc >= 0 && gc < W && ci < Kc;
      const bf16* src = ok ? x + (((size_t)b * H + gr) * W + gc) * Kc + ci : x;
      cp_async16(smem_u32(dst + pix * PS + q * 8), src, ok);
    }
  };
  // the weight tile of iteration `it` (chunk it / KK, tap it % KK)
  auto load_w = [&](int it, int stage) {
    const int ci0 = (it / KK) * CK, tap = it % KK;
    bf16* dst = w_s + stage * W_TILE;
    if (!DGRAD) {  // [CK][BNT], K[tap][ci][co], co contiguous
      for (int i = tid; i < CK * (BNT / 8); i += NT) {
        const int q = i % (BNT / 8), kr = i / (BNT / 8);
        const int ci = ci0 + kr, co = n0 + q * 8;
        const bool ok = ci < Kc && co < Nc;
        const bf16* src = ok ? w + ((size_t)tap * Kc + ci) * Nc + co : w;
        cp_async16(smem_u32(dst + kr * WF + q * 8), src, ok);
      }
    } else {  // [BNT][CK], K[flipped tap][dx channel][gm channel]
      const int ftap = KK - 1 - tap;
      for (int i = tid; i < BNT * (CK / 8); i += NT) {
        const int q = i % (CK / 8), nr = i / (CK / 8);
        const int n = n0 + nr, kc = ci0 + q * 8;
        const bool ok = n < Nc && kc < Kc;
        const bf16* src = ok ? w + ((size_t)ftap * Nc + n) * Kc + kc : w;
        cp_async16(smem_u32(dst + nr * WD + q * 8), src, ok);
      }
    }
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  // one cp.async group per iteration: the prologue fills STAGES - 1
  if (n_it > 0) load_band(cb, 0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load_w(cb * KK + s, s);
    cp_async_commit();
  }

  // per-lane parts of the ldmatrix addresses: A, the band pixel of this
  // lane's row of each m16 tile (at tap 0) and its k offset 0 / 8; B, the
  // lane's 8x8 matrix and row in it
  int a_pix[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = (warp_m * MT + mt) * 16 + (lane & 15);
    const int j = p % PIX;
    a_pix[mt] = (p / PIX) * BH * BW + (j / TWT) * BW + j % TWT;
  }
  const int a_k = (lane >> 4) * 8;
  const int l_i = lane >> 3, l_r = lane & 7;

  for (int j = 0; j < n_it; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // iteration j's data landed; iteration j-1 consumed
    const int lc = j / KK, tap = j % KK;
    // the next chunk's band a whole chunk ahead, into the buffer chunk
    // lc - 1 used
    if (tap == 0 && cb + lc + 1 < ce) load_band(cb + lc + 1, (lc + 1) & 1);
    if (j + STAGES - 1 < n_it)
      load_w(cb * KK + j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();

    const bf16* bs = band_s + (lc & 1) * BAND;
    const bf16* wt = w_s + (j % STAGES) * W_TILE;
    const int ky = tap / K, kx = tap % K;
    // every fragment of the iteration first, then the MMAs: the loads'
    // latency is paid once an iteration, not once a k step
    uint32_t a[CK / 16][MT][4], bfr[CK / 16][NT8][2];
#pragma unroll
    for (int ks = 0; ks < CK / 16; ++ks) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[ks][mt], smem_u32(bs + (a_pix[mt] + ky * BW + kx) * PS +
                                    ks * 16 + a_k));
#pragma unroll
      for (int h = 0; h < NT8 / 2; ++h) {
        uint32_t r[4];
        if (!DGRAD) {
          const int kr = ks * 16 + (l_i & 1) * 8 + l_r;
          const int nn = warp_n * (BNT / 2) + h * 16 + (l_i >> 1) * 8;
          ldsm_x4_t(r, smem_u32(wt + kr * WF + nn));
        } else {
          const int nn = warp_n * (BNT / 2) + h * 16 + (l_i >> 1) * 8 + l_r;
          const int kk = ks * 16 + (l_i & 1) * 8;
          ldsm_x4(r, smem_u32(wt + nn * WD + kk));
        }
        bfr[ks][2 * h][0] = r[0];
        bfr[ks][2 * h][1] = r[1];
        bfr[ks][2 * h + 1][0] = r[2];
        bfr[ks][2 * h + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int ks = 0; ks < CK / 16; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
          mma_bf16(acc[mt][nt], a[ks][mt], bfr[ks][nt][0], bfr[ks][nt][1]);
  }
  cp_async_wait<0>();

  // epilogue: fragment rows lane/4 and lane/4 + 8 are pixels of the m16
  // tile, fragment columns 2*(lane%4) + {0,1} output channels
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pt = (warp_m * MT + mt) * 16 + (lane >> 2) + half * 8;
      const int b = b0 + pt / PIX, jt = pt % PIX;
      const int r = r0 + jt / TWT, c = c0 + jt % TWT;
      if (b >= B || r >= H || c >= W) continue;
      const size_t p = ((size_t)b * H + r) * W + c;
      const float m = (DGRAD || SPLIT) ? 1.f : mask[p];
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        const int co = n0 + warp_n * (BNT / 2) + nt * 8 + (lane & 3) * 2;
        if (co >= Nc) continue;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (SPLIT) {
          *reinterpret_cast<float2*>(ws + ((size_t)split * n_pix + p) * Nc + co) =
              make_float2(v0, v1);
        } else {
          if (!DGRAD) {
            v0 = (v0 + __bfloat162float(bias[co])) * m;
            v1 = (v1 + __bfloat162float(bias[co + 1])) * m;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + p * Nc + co) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// out[p][c] = bf16((sum_s ws[s][p][c] + bias[c]) * mask[p]) (forward) or
// bf16(sum_s ws[s][p][c]) (bias null: dx), summed in split order.
__global__ void splitk_reduce(const float* __restrict__ ws,
                              const float* __restrict__ mask,
                              const bf16* __restrict__ bias,
                              bf16* __restrict__ out, size_t n_pix, int Nc,
                              int splits) {
  const size_t n_pairs = n_pix * (size_t)Nc / 2;
  const size_t slice = n_pix * (size_t)Nc;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = 2 * i;
    float2 s = *reinterpret_cast<const float2*>(ws + e);
    for (int k = 1; k < splits; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(ws + k * slice + e);
      s.x += v.x;
      s.y += v.y;
    }
    if (bias != nullptr) {
      const int co = (int)(e % Nc);
      const float m = mask[e / Nc];
      s.x = (s.x + __bfloat162float(bias[co])) * m;
      s.y = (s.y + __bfloat162float(bias[co + 1])) * m;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(s.x, s.y);
  }
}

template <int K, int THT, int TWT, int NBT, int BNT, bool DGRAD, bool SPLIT>
int launch(const void* x, const void* mask, const void* w, const void* bias,
           void* out, void* ws, int B, int H, int W, int Kc, int Nc,
           int splits, cudaStream_t stream) {
  constexpr int smem = smem_bytes<K, THT, TWT, NBT, BNT>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        masked_conv_tc<K, THT, TWT, NBT, BNT, DGRAD, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_chunks = (Kc + CK - 1) / CK;
  const int per_split = (n_chunks + splits - 1) / splits;
  const int n_row_tiles = (H + THT - 1) / THT;
  const int n_col_tiles = (W + TWT - 1) / TWT;
  const dim3 grid(n_row_tiles * n_col_tiles, (Nc + BNT - 1) / BNT,
                  (B + NBT - 1) / NBT * splits);
  masked_conv_tc<K, THT, TWT, NBT, BNT, DGRAD, SPLIT><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(mask),
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(ws), B, H, W, Kc, Nc,
      n_col_tiles, splits, per_split);
  return (int)cudaGetLastError();
}

template <int K, int THT, int TWT, int NBT, bool DGRAD>
int launch_split(const void* x, const void* mask, const void* w,
                 const void* bias, void* out, void* ws, int B, int H, int W,
                 int Kc, int Nc, int block_n, int splits, cudaStream_t s) {
  if (block_n == 128) {
    if (splits > 1)
      return launch<K, THT, TWT, NBT, 128, DGRAD, true>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, splits, s);
    return launch<K, THT, TWT, NBT, 128, DGRAD, false>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, 1, s);
  }
  if (block_n != 64) return (int)cudaErrorInvalidValue;
  if (splits > 1)
    return launch<K, THT, TWT, NBT, 64, DGRAD, true>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, splits, s);
  return launch<K, THT, TWT, NBT, 64, DGRAD, false>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, 1, s);
}

// tiles (tile_h x tile_w x tile_n images): 8x16x1 and 4x16x1 for k 3 and 5;
// for k 3 also 8x8x2, 8x8x1, 4x8x4 and 4x8x1, for the small levels (24x40,
// 12x20) whose widths 16 does not divide
template <int K, bool DGRAD>
int dispatch_tile(const void* x, const void* mask, const void* w,
                  const void* bias, void* out, void* ws, int B, int H, int W,
                  int Kc, int Nc, int tile_h, int tile_w, int tile_n,
                  int block_n, int splits, cudaStream_t s) {
  auto is = [&](int h, int w_, int n) {
    return tile_h == h && tile_w == w_ && tile_n == n;
  };
  if (is(8, 16, 1))
    return launch_split<K, 8, 16, 1, DGRAD>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, block_n, splits, s);
  if (is(4, 16, 1))
    return launch_split<K, 4, 16, 1, DGRAD>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, block_n, splits, s);
  if (K != 3) return (int)cudaErrorInvalidValue;
  if (is(8, 8, 2))
    return launch_split<3, 8, 8, 2, DGRAD>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, block_n, splits, s);
  if (is(8, 8, 1))
    return launch_split<3, 8, 8, 1, DGRAD>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, block_n, splits, s);
  if (is(4, 8, 4))
    return launch_split<3, 4, 8, 4, DGRAD>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, block_n, splits, s);
  if (is(4, 8, 1))
    return launch_split<3, 4, 8, 1, DGRAD>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, block_n, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// The launch for one call; Kc/Nc are the channels the kernel reads and
// writes (for dx: gm's channels in, x's channels out). tile_h 0 takes the
// CUDA-core path; else the tensor-core path (bf16, Kc and Nc multiples of
// 8) on tile_h x tile_w x tile_n tiles with `splits` K ranges (> 1: fp32
// partials to ws, reduced by san_splitk_reduce).
template <bool DGRAD>
int dispatch(const void* x, const void* mask, const void* w, const void* bias,
             void* out, void* ws, int B, int H, int W, int Kc, int Nc, int k,
             int dtype, int tile_h, int tile_w, int tile_n, int block_n,
             int splits, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Kc <= 0 || Nc <= 0 || (k != 3 && k != 5) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_h == 0) {
    if (dtype == 0 && k == 3) return launch_cc<float, 3, DGRAD>(x, mask, w, bias, out, B, H, W, Kc, Nc, s);
    if (dtype == 0 && k == 5) return launch_cc<float, 5, DGRAD>(x, mask, w, bias, out, B, H, W, Kc, Nc, s);
    if (k == 3) return launch_cc<bf16, 3, DGRAD>(x, mask, w, bias, out, B, H, W, Kc, Nc, s);
    return launch_cc<bf16, 5, DGRAD>(x, mask, w, bias, out, B, H, W, Kc, Nc, s);
  }
  const int n_chunks = (Kc + tc::CK - 1) / tc::CK;
  if (dtype != 1 || Kc % 8 != 0 || Nc % 8 != 0 || splits < 1 ||
      splits > n_chunks ||
      (splits > 1 && ws == nullptr) || tile_n < 1 ||
      (long long)(B + tile_n - 1) / tile_n * splits > 65535 ||
      (block_n != 64 && block_n != 128) || (Nc + block_n - 1) / block_n > 65535)
    return (int)cudaErrorInvalidValue;
  if (k == 3) return tc::dispatch_tile<3, DGRAD>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, tile_h, tile_w, tile_n, block_n, splits, s);
  return tc::dispatch_tile<5, DGRAD>(x, mask, w, bias, out, ws, B, H, W, Kc, Nc, tile_h, tile_w, tile_n, block_n, splits, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ws: the split-K workspace
// [splits][B*H*W][Cout] fp32 (null unless splits > 1). Returns 0 on a
// successful launch.
extern "C" int san_masked_conv2d(const void* x, const void* mask, const void* w,
                                 const void* bias, void* out, void* ws, int B,
                                 int H, int W, int Cin, int Cout, int k,
                                 int dtype, int tile_h, int tile_w,
                                 int tile_n, int block_n, int splits,
                                 void* stream) {
  return dispatch<false>(x, mask, w, bias, out, ws, B, H, W, Cin, Cout, k,
                         dtype, tile_h, tile_w, tile_n, block_n, splits,
                         stream);
}

// dx [B,H,W,Cin] from gm [B,H,W,Cout], the forward's mask and the forward's
// own K [k,k,Cin,Cout]; ws [splits][B*H*W][Cin] as above. Returns 0 on a
// successful launch.
extern "C" int san_masked_conv2d_dgrad(const void* gm, const void* mask,
                                       const void* w, void* dx, void* ws,
                                       int B, int H, int W, int Cout, int Cin,
                                       int k, int dtype, int tile_h,
                                       int tile_w, int tile_n, int block_n,
                                       int splits, void* stream) {
  return dispatch<true>(gm, mask, w, nullptr, dx, ws, B, H, W, Cout, Cin, k,
                        dtype, tile_h, tile_w, tile_n, block_n, splits,
                        stream);
}

// out [n_pix][Nc] bf16 from ws [splits][n_pix][Nc] fp32: summed in split
// order, then (+ bias) * mask where bias is not null (the forward), else as
// it is (dx). Returns 0 on a successful launch.
extern "C" int san_splitk_reduce(const void* ws, const void* mask,
                                 const void* bias, void* out, long long n_pix,
                                 int Nc, int splits, void* stream) {
  if (n_pix <= 0 || Nc <= 0 || Nc % 2 != 0 || splits < 1 ||
      (bias != nullptr && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t n_pairs = (size_t)n_pix * Nc / 2;
  const int threads = 256;
  const int blocks = (int)((n_pairs + threads - 1) / threads < 132 * 16
                               ? (n_pairs + threads - 1) / threads
                               : 132 * 16);
  tc::splitk_reduce<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<const float*>(mask),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), (size_t)n_pix,
      Nc, splits);
  return (int)cudaGetLastError();
}
