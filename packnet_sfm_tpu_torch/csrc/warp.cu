// Bilinear warp (grid_sample, align_corners=True) and its grid gradient,
// for Hopper (sm_90a). Two kernels:
//
//   warp_bilinear_out:   out[b,i,j,c] = bilinear sample of image[b,:,:,c] at
//                        the pixel coordinates of grid[b,i,j] = (gx, gy) in
//                        [-1, 1]: x = (gx + 1) * 0.5 * (W - 1),
//                        y = (gy + 1) * 0.5 * (H - 1)
//   warp_bilinear_dgrid: dgrid[b,i,j] = (sum_c g*A * (W-1)/2,
//                                        sum_c g*B * (H-1)/2)
//                        from g[b,i,j,c] = d loss / d out, with
//                        A = d out / d x and B = d out / d y
//
// image [B,H,W,C] (C <= 3, fp32 or bf16), grid [B,Ho,Wo,2] fp32 (Ho need not
// be H: the loss stacks four grids along the rows), out and g [B,Ho,Wo,C] in
// the image type, dgrid [B,Ho,Wo,2] fp32. Padding 'zeros' (a tap outside
// the image reads 0) or 'border' (the coordinates are clamped into the
// image first, and the tap right of or below the last pixel reads the edge;
// dgrid is zero where the unclamped coordinate lies outside [0, W-1] or
// [0, H-1]).
//
// Replaces packnet_sfm_tpu/ops/pallas/warp.py `_warp_kernel` (pallas_call at
// :298), which on the TPU gathers the taps as a one-hot MXU contraction in a
// VMEM row band, and the grid cotangent of the JAX grid_sample custom VJP
// (ops/image.py `_gs_fwd`, `_gs_bwd`), which saves A and B as two residual
// maps because gathers are the TPU's slowest primitive. Hopper gathers
// natively and the taps sit in L2 (the B8 192x640 bf16 source is 5.9 MB),
// so here the backward gathers the four taps again and forms A and B in
// registers: storing and re-reading two fp32 [B,Ho,Wo,C] maps moved more
// bytes than the taps cost. Both kernels owe the semantics of the XLA path
// (ops/image.py `_gs_patches`, `_gs_combine`, `_gs_derivs`, `_gs_bwd`), are
// exact for any grid and have no fall back. The formulas keep its order:
//   top = p00 + (p01 - p00) * wx,  bot = p10 + (p11 - p10) * wx,
//   out = top + (bot - top) * wy,
//   A = (p01 - p00) * (1 - wy) + (p11 - p10) * wy,
//   B = (p10 - p00) * (1 - wx) + (p11 - p01) * wx,
//   dgx = ((g0 A0 + g1 A1) + g2 A2) * ((W - 1) / 2), dgy likewise,
// with the tap differences rounded to the image type (a bf16 - bf16
// difference is bf16 there) and every product and sum in fp32. Built with
// -fmad=false, so no product is fused into a sum: out equals the plain
// PyTorch version (ops/kernels/warp.py) bit for bit, and dgrid up to the
// order in which that version's sum over the channels runs.
//
// Coordinates far outside the image (|x| ~ 1e7 when the depth is clipped at
// 1e-5) are clamped in float to [-2, W] before the conversion to int, as the
// XLA path's clip(...).astype(int32): a C cast of an out-of-range float is
// undefined.
//
// What bounds them on this card: bytes, in principle. A pixel of the
// selfsup step (C3, bf16) reads the grid (8 B) and writes out (6 B)
// forward; reads the grid and g (6 B) and writes dgrid (8 B) backward; the
// taps come mostly from L1 and L2 (neighbouring pixels share them), and the
// operations are a few dozen FLOPs a pixel. Measured (PERF.md), both run at
// about half the bytes bound: a pixel costs some 200 instructions, most of
// them the 4 x C gathers' addresses and predicates, and each pixel's taps
// wait on its grid load.
//
// Design: one thread per pixel (dgrid) or two (forward), 256 threads a
// block, one image a blockIdx.y (no division to find the batch); the
// pixels of a thread lie NT apart, so a warp's 32 lanes take 32
// consecutive pixels at each step: the 8-byte grid loads and dgrid stores
// are coalesced, and the gathers of neighbouring lanes hit neighbouring
// taps (a smooth flow keeps a warp's taps in a few 32-byte sectors). A
// thread's grid loads, then all its taps, are issued before the
// arithmetic that needs them. Measured, more warps hide the gathers'
// latency better than more pixels a thread (selfsup (i) bf16, out and
// dgrid over a step: 4 pixels a thread 0.198 ms, 2 0.165, 1 0.163; PERF.md).
// No shared memory: out and g are C values a pixel, C x 2 or 4 bytes
// apart, and a warp's loads of them fill whole sectors through L1 over its
// C channel loads.
//
// C entry points (ctypes): each returns cudaGetLastError() right after the
// launch, or cudaErrorInvalidValue for arguments it does not take. They
// launch on the given stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int OUT_PPT = 2;       // pixels a thread, forward
constexpr int DGRID_PPT = 1;     // pixels a thread, dgrid

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

// The bilinear weights and the four taps' offsets into one image, with
// each tap's validity folded into its offset (-1: reads 0).
struct Taps {
  float wx, wy;
  int o00, o01, o10, o11;        // pixel offsets y * W + x, or -1
};

template <bool BORDER>
__device__ __forceinline__ Taps taps(float2 g, int H, int W) {
  float x = (g.x + 1.f) * 0.5f * (float)(W - 1);
  float y = (g.y + 1.f) * 0.5f * (float)(H - 1);
  if (BORDER) {
    x = fminf(fmaxf(x, 0.f), (float)(W - 1));
    y = fminf(fmaxf(y, 0.f), (float)(H - 1));
  }
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Taps t;
  t.wx = x - x0;
  t.wy = y - y0;
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
  t.o00 = (vya && vxa) ? ya * W + xa : -1;
  t.o01 = (vya && vxb) ? ya * W + xb : -1;
  t.o10 = (vyb && vxa) ? yb * W + xa : -1;
  t.o11 = (vyb && vxb) ? yb * W + xb : -1;
  return t;
}

template <typename T, int C>
__device__ __forceinline__ float tap(const T* __restrict__ img, int o, int c) {
  return o >= 0 ? to_f(__ldg(img + (int64_t)o * C + c)) : 0.f;
}

// the four taps of every channel of one pixel, p[c][tap]
template <typename T, int C>
__device__ __forceinline__ void gather(const T* __restrict__ img,
                                       const Taps& t, float (&p)[C][4]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p[c][0] = tap<T, C>(img, t.o00, c);
    p[c][1] = tap<T, C>(img, t.o01, c);
    p[c][2] = tap<T, C>(img, t.o10, c);
    p[c][3] = tap<T, C>(img, t.o11, c);
  }
}

template <typename T, int C, bool BORDER>
__global__ void __launch_bounds__(NT)
warp_out_kernel(const T* __restrict__ image, const float2* __restrict__ grid,
                T* __restrict__ out, int H, int W, int n_pix) {
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * (NT * OUT_PPT) + threadIdx.x;
  const T* img = image + (int64_t)b * H * W * C;
  const float2* gr = grid + (int64_t)b * n_pix;
  T* o = out + (int64_t)b * n_pix * C;
  float2 g[OUT_PPT];
#pragma unroll
  for (int k = 0; k < OUT_PPT; ++k) {
    const int i = i0 + k * NT;
    g[k] = i < n_pix ? __ldg(gr + i) : make_float2(0.f, 0.f);
  }
  Taps t[OUT_PPT];
  float p[OUT_PPT][C][4];
#pragma unroll
  for (int k = 0; k < OUT_PPT; ++k) {
    t[k] = taps<BORDER>(g[k], H, W);
    gather<T, C>(img, t[k], p[k]);
  }
#pragma unroll
  for (int k = 0; k < OUT_PPT; ++k) {
    const int i = i0 + k * NT;
    if (i < n_pix) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p00 = p[k][c][0], p01 = p[k][c][1];
        const float p10 = p[k][c][2], p11 = p[k][c][3];
        const float top = p00 + diff<T>(p01, p00) * t[k].wx;
        const float bot = p10 + diff<T>(p11, p10) * t[k].wx;
        o[(int64_t)i * C + c] = from_f<T>(top + (bot - top) * t[k].wy);
      }
    }
  }
}

template <typename T, int C, bool BORDER>
__global__ void __launch_bounds__(NT)
warp_dgrid_kernel(const T* __restrict__ image, const float2* __restrict__ grid,
                  const T* __restrict__ gout, float2* __restrict__ dgrid,
                  int H, int W, int n_pix) {
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * (NT * DGRID_PPT) + threadIdx.x;
  const T* img = image + (int64_t)b * H * W * C;
  const float2* gr = grid + (int64_t)b * n_pix;
  const T* go = gout + (int64_t)b * n_pix * C;
  float2* dg = dgrid + (int64_t)b * n_pix;
  float2 g[DGRID_PPT];
  float gv[DGRID_PPT][C];
#pragma unroll
  for (int k = 0; k < DGRID_PPT; ++k) {
    const int i = i0 + k * NT;
    const bool live = i < n_pix;
    g[k] = live ? __ldg(gr + i) : make_float2(0.f, 0.f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      gv[k][c] = live ? to_f(__ldg(go + (int64_t)i * C + c)) : 0.f;
  }
  Taps t[DGRID_PPT];
  float p[DGRID_PPT][C][4];
#pragma unroll
  for (int k = 0; k < DGRID_PPT; ++k) {
    t[k] = taps<BORDER>(g[k], H, W);
    gather<T, C>(img, t[k], p[k]);
  }
  const float sx = 0.5f * (float)(W - 1), sy = 0.5f * (float)(H - 1);
#pragma unroll
  for (int k = 0; k < DGRID_PPT; ++k) {
    const int i = i0 + k * NT;
    if (i < n_pix) {
      const float wx = t[k].wx, wy = t[k].wy;
      float ax = 0.f, ay = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p00 = p[k][c][0], p01 = p[k][c][1];
        const float p10 = p[k][c][2], p11 = p[k][c][3];
        const float A = diff<T>(p01, p00) * (1.f - wy) +
                        diff<T>(p11, p10) * wy;
        const float Bv = diff<T>(p10, p00) * (1.f - wx) +
                         diff<T>(p11, p01) * wx;
        const float tx = gv[k][c] * A, ty = gv[k][c] * Bv;
        ax = c == 0 ? tx : ax + tx;
        ay = c == 0 ? ty : ay + ty;
      }
      float dgx = ax * sx, dgy = ay * sy;
      if (BORDER) {   // the forward clamped: no gradient outside the image
        const float xu = (g[k].x + 1.f) * 0.5f * (float)(W - 1);
        const float yu = (g[k].y + 1.f) * 0.5f * (float)(H - 1);
        dgx = dgx * ((xu >= 0.f && xu <= (float)(W - 1)) ? 1.f : 0.f);
        dgy = dgy * ((yu >= 0.f && yu <= (float)(H - 1)) ? 1.f : 0.f);
      }
      dg[i] = make_float2(dgx, dgy);
    }
  }
}

dim3 blocks(int B, int n_pix, int ppt) {
  return dim3((unsigned)((n_pix + NT * ppt - 1) / (NT * ppt)), (unsigned)B);
}

template <typename T, int C, bool BORDER> struct Out {
  static int run(const void* image, const void* grid, void* out, int B, int H,
                 int W, int n_pix, cudaStream_t s) {
    warp_out_kernel<T, C, BORDER><<<blocks(B, n_pix, OUT_PPT), NT, 0, s>>>(
        static_cast<const T*>(image), static_cast<const float2*>(grid),
        static_cast<T*>(out), H, W, n_pix);
    return (int)cudaGetLastError();
  }
};

template <typename T, int C, bool BORDER> struct Dgrid {
  static int run(const void* image, const void* grid, const void* g,
                 void* dgrid, int B, int H, int W, int n_pix,
                 cudaStream_t s) {
    warp_dgrid_kernel<T, C, BORDER><<<blocks(B, n_pix, DGRID_PPT), NT, 0,
                                       s>>>(
        static_cast<const T*>(image), static_cast<const float2*>(grid),
        static_cast<const T*>(g), static_cast<float2*>(dgrid), H, W, n_pix);
    return (int)cudaGetLastError();
  }
};

// The instantiation for (dtype, C, padding): F<T, C, BORDER>(args...).
template <template <typename, int, bool> class F, typename... Args>
int dispatch(int dtype, int C, int padding, Args... args) {
  if (dtype == 0) {
    if (padding == 0) {
      if (C == 1) return F<float, 1, false>::run(args...);
      if (C == 2) return F<float, 2, false>::run(args...);
      return F<float, 3, false>::run(args...);
    }
    if (C == 1) return F<float, 1, true>::run(args...);
    if (C == 2) return F<float, 2, true>::run(args...);
    return F<float, 3, true>::run(args...);
  }
  if (padding == 0) {
    if (C == 1) return F<__nv_bfloat16, 1, false>::run(args...);
    if (C == 2) return F<__nv_bfloat16, 2, false>::run(args...);
    return F<__nv_bfloat16, 3, false>::run(args...);
  }
  if (C == 1) return F<__nv_bfloat16, 1, true>::run(args...);
  if (C == 2) return F<__nv_bfloat16, 2, true>::run(args...);
  return F<__nv_bfloat16, 3, true>::run(args...);
}

bool bad_args(int B, int H, int W, int C, int Ho, int Wo, int dtype,
              int padding) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || C > 3 ||
         Ho <= 0 || Wo <= 0 ||
         (int64_t)Ho * Wo * C > 2147483647LL - NT * OUT_PPT * C ||
         (int64_t)H * W * C > 2147483647LL || dtype < 0 || dtype > 1 ||
         padding < 0 || padding > 1;
}

}  // namespace

// out [B,Ho,Wo,C] from image [B,H,W,C] and grid [B,Ho,Wo,2].
// dtype: 0 = float32, 1 = bfloat16 (the image's and out's); padding: 0 =
// zeros, 1 = border. Returns 0 on a successful launch.
extern "C" int warp_bilinear_out(const void* image, const void* grid,
                                 void* out, int B, int H, int W, int C,
                                 int Ho, int Wo, int dtype, int padding,
                                 void* stream) {
  if (bad_args(B, H, W, C, Ho, Wo, dtype, padding))
    return (int)cudaErrorInvalidValue;
  return dispatch<Out>(dtype, C, padding, image, grid, out, B, H, W, Ho * Wo,
                       static_cast<cudaStream_t>(stream));
}

// dgrid [B,Ho,Wo,2] fp32 from image, grid and g [B,Ho,Wo,C] (the image's
// dtype). Returns 0 on a successful launch.
extern "C" int warp_bilinear_dgrid(const void* image, const void* grid,
                                   const void* g, void* dgrid, int B, int H,
                                   int W, int C, int Ho, int Wo, int dtype,
                                   int padding, void* stream) {
  if (bad_args(B, H, W, C, Ho, Wo, dtype, padding))
    return (int)cudaErrorInvalidValue;
  return dispatch<Dgrid>(dtype, C, padding, image, grid, g, dgrid, B, H, W,
                         Ho * Wo, static_cast<cudaStream_t>(stream));
}
