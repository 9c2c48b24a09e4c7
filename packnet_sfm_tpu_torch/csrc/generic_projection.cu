// The generic camera's softmax patch projection and its gradient, for Hopper
// (sm_90a).
//
// Inputs: the ray plane ray [B,3,H,W] fp32 and the unit directions already
// divided by the softmax temperature, d [B,3,H,W] fp32 (NCHW). Each pixel
// (y, x) matches d(y, x) against the rays of its (2p+1)^2 window, whose
// start per axis is clip(y - p, 0, H - k1), clip(x - p, 0, W - k1) with
// k1 = 2p + 1: windows are shifted into the image, not clamped, and border
// pixels share a window. The caller guarantees k1 <= H and k1 <= W.
//
// Forward, generic_projection_fwd: with logit_k = d0 g0 + d1 g1 + d2 g2 over
// the window's rays g_k at (row_k, col_k), the softmax weights p_k and
//   rows = sum_k p_k row_k,  cols = sum_k p_k col_k,
// plus the running max m and normaliser s of the online softmax (the
// backward's residuals), all [B,H,W] fp32. The softmax is streamed over the
// window rows as the TPU kernel does: for each window row i, first the max
// of its k1 logits, then one rescale of (s, ey, ex) by exp(m - m_new), then
// the sums in column order. m starts at -1e30.
//
// Backward, generic_projection_bwd: from the cotangents gy, gx of rows and
// cols [B,H,W], with p_k = exp(logit_k - m) / s,
//   glogit_k = p_k * (gy * (row_k - rows) + gx * (col_k - cols)),
//   dd[y, x] = sum_k glogit_k (g_k - g_c),
//   dray[row_k, col_k] += glogit_k d[y, x]   (over every pixel and k),
// with g_c the ray at the window's centre. The glogit_k sum to zero, so
// subtracting g_c leaves dd as the TPU kernel's sum_k glogit_k g_k; but the
// window's rays are nearly parallel (a few 1e-3 rad apart), and without it
// the sum cancels to a few 1e-3 of its terms. On an H100 at the generic
// step's 192x192 plane, sum_k glogit_k g_k put 366 of 110,592 dd values
// outside the JAX package's cross-formulation limits (rtol 5e-3, atol
// 2e-3 x max) of the float64 gradient, max |err| 8.2e-4; against g_c, dd
// lies 2.5e-4 of max from it (float32 autograd of the plain forward:
// 7.9e-5).
//
// Replaces packnet_sfm_tpu/ops/pallas/generic_projection.py `_proj_kernel`
// (:81, pallas_call at :159) and `_proj_bwd_kernel` (:199, pallas_call at
// :287). The TPU kernels keep a whole ray plane in VMEM and build each
// window column with a lane roll plus two border fixes, and the backward
// adds into a VMEM-resident gradient plane while its grid runs in order.
// Here a window is a plain 2D range, and blocks run in no order, so:
// - forward and the dd half of the backward: a block owns a 4x32 pixel tile
//   and stages the union of its pixels' windows (at most (4+2p) x (32+2p)
//   rays, 3 channels: 38 KB at p = 20) in shared memory once; one thread per
//   pixel keeps its sums in registers and walks its window in shared memory
//   (consecutive threads read consecutive rays: no bank conflict);
// - the dray half: a second, ray-major kernel, one thread per ray position
//   (r, c), sums glogit * d over the pixels whose windows hold it. Along
//   each axis they form one range: for a ray column c, x from
//   (c <= 2p ? 0 : c - p) to (c >= W - k1 ? W - 1 : c + p), the same for
//   rows. No atomics: the result is deterministic. The pixel's nine values
//   (d, m, s, rows, cols, gy, gx) are read from global memory, where
//   neighbouring threads read neighbouring pixels and L1 serves the reuse.
// A backward call is two launches. glogit is computed with the same
// operations in the same order in both kernels.
//
// The arithmetic keeps the TPU kernels' order: logit = d0*g0 + d1*g1 + d2*g2
// summed left to right, expf (not __expf), and the file builds with
// -fmad=false, so the logits equal those of the plain PyTorch versions
// (ops/kernels/generic_projection.py) bit for bit; only the order of the
// positive sums of s, ey, ex (and of dd, dray) differs.
//
// What bounds it on this card: operations, and among them the exponentials.
// Per candidate (pixel, k) the forward needs one exp and ~12 fp32 operations
// and moves almost no bytes (the 2 input and 4 output planes, ~1.5 MB at
// B1 192x192). At 192x192 and p = 20 that is 62 M candidates: the exps at
// the SFU rate of 16 per SM per clock (~4.2 T/s on 132 SMs at 1.98 GHz) take
// ~15 us, the other operations ~11 us at 67 TFLOP/s. The backward needs one
// exp and ~24 operations per candidate (~22 us); this design evaluates the
// exp twice (once in each of its two kernels) and the forward's logits twice
// (once for the row max, once for the sums), trading arithmetic for no
// local-memory arrays and no atomics.
//
// C entry points (ctypes): each returns the first nonzero cudaGetLastError()
// of its launches, or cudaErrorInvalidValue for arguments it does not take.
// They launch on the given stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;          // tile width: one warp per tile row
constexpr int TY = 4;           // tile rows
constexpr int NT = TX * TY;
constexpr int MAX_SMEM = 232448;

// the window start along one axis: clip(c - p, 0, n - k1), n >= k1
__device__ __forceinline__ int wstart(int c, int p, int n) {
  const int s = c - p < 0 ? 0 : c - p;
  const int hi = n - (2 * p + 1);
  return s > hi ? hi : s;
}

struct Tile {
  int y0, x0;       // first pixel of the tile
  int ry0, rx0;     // first ray row / column staged
  int nrows, ncols; // staged extent
};

// Stage the rays of the windows of the block's tile into sm [3][RH][RW].
__device__ __forceinline__ Tile stage_rays(const float* __restrict__ ray,
                                           float* sm, int H, int W, int p,
                                           int RH, int RW) {
  const int k1 = 2 * p + 1;
  Tile t;
  t.y0 = blockIdx.y * TY;
  t.x0 = blockIdx.x * TX;
  const int ylast = min(t.y0 + TY, H) - 1;
  const int xlast = min(t.x0 + TX, W) - 1;
  t.ry0 = wstart(t.y0, p, H);
  t.rx0 = wstart(t.x0, p, W);
  t.nrows = wstart(ylast, p, H) + k1 - t.ry0;
  t.ncols = wstart(xlast, p, W) + k1 - t.rx0;
  const int64_t plane = (int64_t)H * W;
  const float* rb = ray + (int64_t)blockIdx.z * 3 * plane;
  const int per_c = t.nrows * t.ncols;
  for (int idx = threadIdx.x; idx < 3 * per_c; idx += NT) {
    const int c = idx / per_c;
    const int rem = idx - c * per_c;
    const int rr = rem / t.ncols;
    const int cc = rem - rr * t.ncols;
    sm[(c * RH + rr) * RW + cc] =
        rb[c * plane + (int64_t)(t.ry0 + rr) * W + t.rx0 + cc];
  }
  return t;
}

__global__ void __launch_bounds__(NT)
proj_fwd_kernel(const float* __restrict__ ray, const float* __restrict__ d,
                float* __restrict__ rows, float* __restrict__ cols,
                float* __restrict__ mo, float* __restrict__ so, int H, int W,
                int p, int RH, int RW) {
  extern __shared__ float sm[];
  const Tile t = stage_rays(ray, sm, H, W, p, RH, RW);
  __syncthreads();
  const int y = t.y0 + threadIdx.x / TX;
  const int x = t.x0 + threadIdx.x % TX;
  if (y >= H || x >= W) return;
  const int k1 = 2 * p + 1;
  const int64_t plane = (int64_t)H * W;
  const int64_t px = (int64_t)y * W + x;
  const float* db = d + (int64_t)blockIdx.z * 3 * plane + px;
  const float d0 = db[0], d1 = db[plane], d2 = db[2 * plane];
  const int sy = wstart(y, p, H), sx = wstart(x, p, W);
  const float* g0 = sm + (sy - t.ry0) * RW + (sx - t.rx0);
  const float* g1 = g0 + RH * RW;
  const float* g2 = g1 + RH * RW;
  float m = -1e30f, s = 0.f, ey = 0.f, ex = 0.f;
  for (int i = 0; i < k1; ++i) {
    const int o = i * RW;
    float mi = -1e30f;
    for (int j = 0; j < k1; ++j) {
      const float logit = d0 * g0[o + j] + d1 * g1[o + j] + d2 * g2[o + j];
      mi = fmaxf(mi, logit);
    }
    const float m_new = fmaxf(m, mi);
    const float alpha = expf(m - m_new);
    s = s * alpha;
    ey = ey * alpha;
    ex = ex * alpha;
    const float rowc = (float)(sy + i);
    for (int j = 0; j < k1; ++j) {
      const float logit = d0 * g0[o + j] + d1 * g1[o + j] + d2 * g2[o + j];
      const float pe = expf(logit - m_new);
      s = s + pe;
      ey = ey + rowc * pe;
      ex = ex + (float)(sx + j) * pe;
    }
    m = m_new;
  }
  const int64_t out = (int64_t)blockIdx.z * plane + px;
  rows[out] = ey / s;
  cols[out] = ex / s;
  mo[out] = m;
  so[out] = s;
}

// dd: pixel-major replay of the window with the saved residuals
__global__ void __launch_bounds__(NT)
proj_bwd_dd_kernel(const float* __restrict__ ray, const float* __restrict__ d,
                   const float* __restrict__ rows,
                   const float* __restrict__ cols,
                   const float* __restrict__ mi_, const float* __restrict__ si,
                   const float* __restrict__ gyi,
                   const float* __restrict__ gxi, float* __restrict__ dd,
                   int H, int W, int p, int RH, int RW) {
  extern __shared__ float sm[];
  const Tile t = stage_rays(ray, sm, H, W, p, RH, RW);
  __syncthreads();
  const int y = t.y0 + threadIdx.x / TX;
  const int x = t.x0 + threadIdx.x % TX;
  if (y >= H || x >= W) return;
  const int k1 = 2 * p + 1;
  const int64_t plane = (int64_t)H * W;
  const int64_t px = (int64_t)y * W + x;
  const int64_t q = (int64_t)blockIdx.z * plane + px;
  const float* db = d + (int64_t)blockIdx.z * 3 * plane + px;
  const float d0 = db[0], d1 = db[plane], d2 = db[2 * plane];
  const float ey = rows[q], ex = cols[q], m = mi_[q], s = si[q];
  const float gy = gyi[q], gx = gxi[q];
  const int sy = wstart(y, p, H), sx = wstart(x, p, W);
  const float* g0 = sm + (sy - t.ry0) * RW + (sx - t.rx0);
  const float* g1 = g0 + RH * RW;
  const float* g2 = g1 + RH * RW;
  const int oc = p * RW + p;   // the window's centre
  const float c0 = g0[oc], c1 = g1[oc], c2 = g2[oc];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int i = 0; i < k1; ++i) {
    const int o = i * RW;
    const float gy_row = gy * ((float)(sy + i) - ey);
    for (int j = 0; j < k1; ++j) {
      const float r0 = g0[o + j], r1 = g1[o + j], r2 = g2[o + j];
      const float logit = d0 * r0 + d1 * r1 + d2 * r2;
      const float pk = expf(logit - m) / s;
      const float gl = pk * (gy_row + gx * ((float)(sx + j) - ex));
      a0 = a0 + gl * (r0 - c0);
      a1 = a1 + gl * (r1 - c1);
      a2 = a2 + gl * (r2 - c2);
    }
  }
  float* ob = dd + (int64_t)blockIdx.z * 3 * plane + px;
  ob[0] = a0;
  ob[plane] = a1;
  ob[2 * plane] = a2;
}

// dray: ray-major, over the range of pixels whose windows hold (r, c)
__global__ void __launch_bounds__(NT)
proj_bwd_dray_kernel(const float* __restrict__ ray,
                     const float* __restrict__ d,
                     const float* __restrict__ rows,
                     const float* __restrict__ cols,
                     const float* __restrict__ mi_,
                     const float* __restrict__ si,
                     const float* __restrict__ gyi,
                     const float* __restrict__ gxi, float* __restrict__ dray,
                     int H, int W, int p) {
  const int r = blockIdx.y * TY + threadIdx.x / TX;
  const int c = blockIdx.x * TX + threadIdx.x % TX;
  if (r >= H || c >= W) return;
  const int k1 = 2 * p + 1;
  const int ylo = r <= 2 * p ? 0 : r - p;
  const int yhi = r >= H - k1 ? H - 1 : r + p;
  const int xlo = c <= 2 * p ? 0 : c - p;
  const int xhi = c >= W - k1 ? W - 1 : c + p;
  const int64_t plane = (int64_t)H * W;
  const int64_t b = blockIdx.z;
  const float* rb = ray + b * 3 * plane + (int64_t)r * W + c;
  const float r0 = rb[0], r1 = rb[plane], r2 = rb[2 * plane];
  const float* D0 = d + b * 3 * plane;
  const float* D1 = D0 + plane;
  const float* D2 = D1 + plane;
  const float* EY = rows + b * plane;
  const float* EX = cols + b * plane;
  const float* M = mi_ + b * plane;
  const float* S = si + b * plane;
  const float* GY = gyi + b * plane;
  const float* GX = gxi + b * plane;
  const float rowc = (float)r, colc = (float)c;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int y = ylo; y <= yhi; ++y) {
    const int64_t rowq = (int64_t)y * W;
    for (int x = xlo; x <= xhi; ++x) {
      const int64_t q = rowq + x;
      const float d0 = D0[q], d1 = D1[q], d2 = D2[q];
      const float logit = d0 * r0 + d1 * r1 + d2 * r2;
      const float pk = expf(logit - M[q]) / S[q];
      const float gy_row = GY[q] * (rowc - EY[q]);
      const float gl = pk * (gy_row + GX[q] * (colc - EX[q]));
      a0 = a0 + gl * d0;
      a1 = a1 + gl * d1;
      a2 = a2 + gl * d2;
    }
  }
  float* ob = dray + b * 3 * plane + (int64_t)r * W + c;
  ob[0] = a0;
  ob[plane] = a1;
  ob[2 * plane] = a2;
}

// the staged extent and its bytes; 0 when the arguments are refused
int smem_layout(int B, int H, int W, int p, int* RH, int* RW) {
  const int k1 = 2 * p + 1;
  if (B <= 0 || B > 65535 || p < 0 || H < k1 || W < k1) return 0;
  *RH = TY + 2 * p < H ? TY + 2 * p : H;
  *RW = TX + 2 * p < W ? TX + 2 * p : W;
  const long long bytes = 3LL * (*RH) * (*RW) * (long long)sizeof(float);
  return bytes > MAX_SMEM ? 0 : (int)bytes;
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// ray, d: [B,3,H,W] fp32; rows, cols, m, s: [B,H,W] fp32. Returns 0 on a
// successful launch.
extern "C" int generic_projection_fwd(const void* ray, const void* d,
                                      void* rows, void* cols, void* m,
                                      void* s, int B, int H, int W, int p,
                                      void* stream) {
  int RH, RW;
  const int bytes = smem_layout(B, H, W, p, &RH, &RW);
  if (!bytes) return (int)cudaErrorInvalidValue;
  int e = allow_smem(proj_fwd_kernel, bytes);
  if (e) return e;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  proj_fwd_kernel<<<grid, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ray), static_cast<const float*>(d),
      static_cast<float*>(rows), static_cast<float*>(cols),
      static_cast<float*>(m), static_cast<float*>(s), H, W, p, RH, RW);
  return (int)cudaGetLastError();
}

// The residuals as the forward gave them, gy, gx: [B,H,W] fp32; dray, dd:
// [B,3,H,W] fp32, every element written. Two launches. Returns 0 when both
// launched.
extern "C" int generic_projection_bwd(const void* ray, const void* d,
                                      const void* rows, const void* cols,
                                      const void* m, const void* s,
                                      const void* gy, const void* gx,
                                      void* dray, void* dd, int B, int H,
                                      int W, int p, void* stream) {
  int RH, RW;
  const int bytes = smem_layout(B, H, W, p, &RH, &RW);
  if (!bytes) return (int)cudaErrorInvalidValue;
  int e = allow_smem(proj_bwd_dd_kernel, bytes);
  if (e) return e;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fr = static_cast<const float*>(ray);
  const float* fd = static_cast<const float*>(d);
  const float* frows = static_cast<const float*>(rows);
  const float* fcols = static_cast<const float*>(cols);
  const float* fm = static_cast<const float*>(m);
  const float* fs = static_cast<const float*>(s);
  const float* fgy = static_cast<const float*>(gy);
  const float* fgx = static_cast<const float*>(gx);
  proj_bwd_dd_kernel<<<grid, NT, bytes, st>>>(
      fr, fd, frows, fcols, fm, fs, fgy, fgx, static_cast<float*>(dd), H, W,
      p, RH, RW);
  e = (int)cudaGetLastError();
  if (e) return e;
  proj_bwd_dray_kernel<<<grid, NT, 0, st>>>(
      fr, fd, frows, fcols, fm, fs, fgy, fgx, static_cast<float*>(dray), H, W,
      p);
  return (int)cudaGetLastError();
}
