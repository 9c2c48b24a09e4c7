// The photometric map (SSIM + L1 over 3x3 windows) and its gradient, for
// Hopper (sm_90a).
//
// Inputs are the reflect-padded images xp, yp [B,3,H+2,W+2] fp32 (NCHW; the
// pad and its gradient fold stay in PyTorch, outside these kernels).
//
// Forward, photometric_fwd: photo [B,H,W] fp32,
//   photo(p) = mean_c [ alpha * clamp01((1 - SSIM_c(p)) / 2)
//                       + (1 - alpha) * |x_c(p) - y_c(p)| ]
// with the raw moments m1 = E[x], m2 = E[y], m3 = E[x^2], m4 = E[y^2],
// m5 = E[xy] over the 3x3 window of p, S = N / D,
//   N = (2 m1 m2 + C1)(2 (m5 - m1 m2) + C2),
//   D = (m1^2 + m2^2 + C1)((m3 - m1^2) + (m4 - m2^2) + C2).
//
// Backward, photometric_bwd: dxp, dyp [B,3,H+2,W+2] from g = d loss/d photo
// [B,H,W], by the raw-moment formula: with Gc(p) = g(p) * (-alpha / 6) where
// 0 < (1 - S) / 2 < 1 (strictly) and 0 elsewhere, and the coefficients
//   S1 = dS/dm1, S2 = dS/dm2, S3 = dS/dm3 = dS/dm4, S5 = dS/dm5,
//   dxp(q) = 1/9 [ bsum(Gc S1) + 2 xp(q) bsum(Gc S3) + yp(q) bsum(Gc S5) ]
//            + sign(xp(q) - yp(q)) * g(q - 1) * (1 - alpha) / 3,
//   dyp(q) = 1/9 [ bsum(Gc S2) + 2 yp(q) bsum(Gc S3) + xp(q) bsum(Gc S5) ]
//            - the same L1 term,
// where bsum is the transpose of the valid 3x3 box sum (q receives from the
// p in [q-2, q] that lie in the valid grid) and g(q - 1) is 0 on the pad.
// The divisions by 3 are the channel mean for C = 3: the wrapper refuses
// other channel counts, as the TPU kernel's literal 3.0 only fits RGB.
//
// Replaces packnet_sfm_tpu/ops/pallas/photometric.py `_fwd_kernel` (:94,
// pallas_call at :115) and `_bwd_kernel` (:133, pallas_call at :224). The
// TPU wrapper cut overlapping row tiles and widened columns on the XLA side
// because Mosaic kernels only narrow widths; here a block stages its own
// tile and halo in shared memory, and nothing crosses blocks. The formulas
// keep the TPU kernels' order of operations, and the file builds with
// -fmad=false, so the results follow the plain PyTorch versions
// (ops/kernels/photometric.py) to the last bits of the sums.
//
// What bounds it on this card: bytes. The forward reads xp and yp once and
// writes photo (~28 MB at B8 192x640, ~8 us at 3.35 TB/s); the backward
// reads xp, yp and g and writes dxp and dyp (~52 MB, ~16 us). The
// arithmetic, ~100 FLOPs per pixel and channel on CUDA cores, is under a
// third of that time at 67 TFLOP/s fp32.
//
// Design (first, simple version):
// - Forward: one block of 256 threads per 8x32 output tile; it stages xp and
//   yp for the tile and a one-pixel halo (3 channels, 10x34 each) in shared
//   memory, and each thread computes one output pixel's moments in
//   registers, channel by channel.
// - Backward: one block of 256 threads per 8x32 tile of q (padded grid), in
//   two phases separated by __syncthreads(): (1) the per-p coefficient maps
//   Gc*S1, Gc*S2, Gc*S3, Gc*S5 over the tile grown by 2 (the p that feed it),
//   read from xp and yp staged over the tile grown by 4; (2) the 3x3
//   transpose box sums into dxp and dyp.
//
// C entry points (ctypes): each returns cudaGetLastError() right after the
// launch, or cudaErrorInvalidValue for arguments it does not take. They
// launch on the given stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 3;             // RGB only (see above)
constexpr int TH = 8;            // tile rows
constexpr int TW = 32;           // tile cols
constexpr int NT = TH * TW;      // threads per block

struct Moments {
  float m1, m2, m3, m4, m5;
};

// The five 3x3 box means at the window whose top-left element is s[0]
// (row stride `ld`), summed in the order of the TPU kernel's
// _boxsum_valid: rows outer, columns inner, then times 1/9.
__device__ __forceinline__ Moments moments(const float* xs, const float* ys,
                                           int ld) {
  float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f, s5 = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float x = xs[dy * ld + dx], y = ys[dy * ld + dx];
      s1 = s1 + x;
      s2 = s2 + y;
      s3 = s3 + x * x;
      s4 = s4 + y * y;
      s5 = s5 + x * y;
    }
  }
  const float inv9 = (float)(1.0 / 9.0);
  return {s1 * inv9, s2 * inv9, s3 * inv9, s4 * inv9, s5 * inv9};
}

struct Terms {
  float N, D, n1, sxy2, d1, d2;
};

__device__ __forceinline__ Terms ssim_terms(const Moments& m, float C1,
                                            float C2) {
  Terms t;
  t.sxy2 = 2.f * (m.m5 - m.m1 * m.m2) + C2;
  t.n1 = 2.f * m.m1 * m.m2 + C1;
  t.d1 = m.m1 * m.m1 + m.m2 * m.m2 + C1;
  t.d2 = (m.m3 - m.m1 * m.m1) + (m.m4 - m.m2 * m.m2) + C2;
  t.N = t.n1 * t.sxy2;
  t.D = t.d1 * t.d2;
  return t;
}

// ---------------------------------------------------------------- forward

constexpr int FH = TH + 2, FW = TW + 2;   // staged tile with its halo

__global__ void __launch_bounds__(NT)
photometric_fwd_kernel(const float* __restrict__ xp,
                       const float* __restrict__ yp, float* __restrict__ out,
                       int H, int W, float alpha, float one_m_alpha,
                       float C1, float C2) {
  __shared__ float xs[C][FH][FW];
  __shared__ float ys[C][FH][FW];
  const int Hp = H + 2, Wp = W + 2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int64_t plane = (int64_t)Hp * Wp;
  const float* xb = xp + (int64_t)b * C * plane;
  const float* yb = yp + (int64_t)b * C * plane;
  for (int i = threadIdx.x; i < C * FH * FW; i += NT) {
    const int c = i / (FH * FW), rest = i % (FH * FW);
    const int r = rest / FW, col = rest % FW;
    const int gr = r0 + r, gc = c0 + col;   // padded coordinates
    float xv = 0.f, yv = 0.f;
    if (gr < Hp && gc < Wp) {
      const int64_t o = c * plane + (int64_t)gr * Wp + gc;
      xv = xb[o];
      yv = yb[o];
    }
    xs[c][r][col] = xv;
    ys[c][r][col] = yv;
  }
  __syncthreads();
  const int tr = threadIdx.x / TW, tc = threadIdx.x % TW;
  const int h = r0 + tr, w = c0 + tc;
  if (h >= H || w >= W) return;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const Moments m = moments(&xs[c][tr][tc], &ys[c][tr][tc], FW);
    const Terms t = ssim_terms(m, C1, C2);
    const float st = fminf(fmaxf((1.f - t.N / t.D) * 0.5f, 0.f), 1.f);
    const float l1 = fabsf(xs[c][tr + 1][tc + 1] - ys[c][tr + 1][tc + 1]);
    const float v = alpha * st + one_m_alpha * l1;
    acc = (c == 0) ? v : acc + v;
  }
  out[((int64_t)b * H + h) * W + w] = acc / 3.f;
}

// --------------------------------------------------------------- backward

constexpr int PH = TH + 2, PW = TW + 2;   // p that feed the tile
constexpr int SH = TH + 4, SW = TW + 4;   // xp, yp under those p's windows

__global__ void __launch_bounds__(NT)
photometric_bwd_kernel(const float* __restrict__ xp,
                       const float* __restrict__ yp,
                       const float* __restrict__ g, float* __restrict__ dxp,
                       float* __restrict__ dyp, int H, int W, float c_ssim,
                       float c_l1, float C1, float C2) {
  __shared__ float xs[C][SH][SW];
  __shared__ float ys[C][SH][SW];
  __shared__ float gs[PH][PW];
  __shared__ float k1[C][PH][PW], k2[C][PH][PW], k3[C][PH][PW], k5[C][PH][PW];
  const int Hp = H + 2, Wp = W + 2;
  const int b = blockIdx.z;
  const int q0r = blockIdx.y * TH, q0c = blockIdx.x * TW;  // padded coords
  const int64_t plane = (int64_t)Hp * Wp;
  const float* xb = xp + (int64_t)b * C * plane;
  const float* yb = yp + (int64_t)b * C * plane;
  const float* gb = g + (int64_t)b * H * W;

  // staged row s is padded row q0r - 2 + s; p row pr is valid row q0r - 2 + pr
  for (int i = threadIdx.x; i < C * SH * SW; i += NT) {
    const int c = i / (SH * SW), rest = i % (SH * SW);
    const int r = rest / SW, col = rest % SW;
    const int gr = q0r - 2 + r, gc = q0c - 2 + col;
    float xv = 0.f, yv = 0.f;
    if (gr >= 0 && gr < Hp && gc >= 0 && gc < Wp) {
      const int64_t o = c * plane + (int64_t)gr * Wp + gc;
      xv = xb[o];
      yv = yb[o];
    }
    xs[c][r][col] = xv;
    ys[c][r][col] = yv;
  }
  for (int i = threadIdx.x; i < PH * PW; i += NT) {
    const int r = i / PW, col = i % PW;
    const int pr = q0r - 2 + r, pc = q0c - 2 + col;
    gs[r][col] = (pr >= 0 && pr < H && pc >= 0 && pc < W)
                     ? gb[(int64_t)pr * W + pc] : 0.f;
  }
  __syncthreads();

  // phase 1: Gc * S{1,2,3,5} at every p of the grown tile (0 off the grid)
  for (int i = threadIdx.x; i < C * PH * PW; i += NT) {
    const int c = i / (PH * PW), rest = i % (PH * PW);
    const int r = rest / PW, col = rest % PW;
    const int pr = q0r - 2 + r, pc = q0c - 2 + col;
    float v1 = 0.f, v2 = 0.f, v3 = 0.f, v5 = 0.f;
    if (pr >= 0 && pr < H && pc >= 0 && pc < W) {
      const Moments m = moments(&xs[c][r][col], &ys[c][r][col], SW);
      const Terms t = ssim_terms(m, C1, C2);
      const float lin = (1.f - t.N / t.D) * 0.5f;
      if (lin > 0.f && lin < 1.f) {
        const float Gc = gs[r][col] * c_ssim;
        const float inv_D = 1.f / t.D;
        const float NDD = t.N * inv_D * inv_D;
        const float S1 = (2.f * m.m2 * (t.sxy2 - t.n1)) * inv_D -
                         NDD * (2.f * m.m1 * (t.d2 - t.d1));
        const float S2 = (2.f * m.m1 * (t.sxy2 - t.n1)) * inv_D -
                         NDD * (2.f * m.m2 * (t.d2 - t.d1));
        const float S3 = -NDD * t.d1;
        const float S5 = 2.f * t.n1 * inv_D;
        v1 = Gc * S1;
        v2 = Gc * S2;
        v3 = Gc * S3;
        v5 = Gc * S5;
      }
    }
    k1[c][r][col] = v1;
    k2[c][r][col] = v2;
    k3[c][r][col] = v3;
    k5[c][r][col] = v5;
  }
  __syncthreads();

  // phase 2: transpose box sums; q (local tr, tc) takes p local rows
  // tr .. tr+2 and cols tc .. tc+2, in that order
  const int tr = threadIdx.x / TW, tc = threadIdx.x % TW;
  const int qr = q0r + tr, qc = q0c + tc;
  if (qr >= Hp || qc >= Wp) return;
  const float inv9 = (float)(1.0 / 9.0);
  const float gq = gs[tr + 1][tc + 1];    // g at p = q - 1, 0 on the pad
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float b1 = 0.f, b2 = 0.f, b3 = 0.f, b5 = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        b1 = b1 + k1[c][tr + a][tc + e];
        b2 = b2 + k2[c][tr + a][tc + e];
        b3 = b3 + k3[c][tr + a][tc + e];
        b5 = b5 + k5[c][tr + a][tc + e];
      }
    }
    b1 = b1 * inv9;
    b2 = b2 * inv9;
    b3 = b3 * inv9;
    b5 = b5 * inv9;
    const float xq = xs[c][tr + 2][tc + 2], yq = ys[c][tr + 2][tc + 2];
    const float d = xq - yq;
    const float sgn = (float)((d > 0.f) - (d < 0.f)) * (gq * c_l1 / 3.f);
    const int64_t o = ((int64_t)b * C + c) * plane + (int64_t)qr * Wp + qc;
    dxp[o] = (b1 + 2.f * xq * b3 + yq * b5) + sgn;
    dyp[o] = (b2 + 2.f * yq * b3 + xq * b5) - sgn;
  }
}

bool bad_dims(int B, int H, int W) {
  return B <= 0 || H <= 0 || W <= 0 || B > 65535 ||
         (H + 2 + TH - 1) / TH > 65535;
}

}  // namespace

// photo [B,H,W] from xp, yp [B,3,H+2,W+2]. one_m_alpha is 1 - alpha as the
// caller computes it. Returns 0 on a successful launch.
extern "C" int photometric_fwd(const void* xp, const void* yp, void* out,
                               int B, int H, int W, float alpha,
                               float one_m_alpha, float C1, float C2,
                               void* stream) {
  if (bad_dims(B, H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  photometric_fwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(yp),
      static_cast<float*>(out), H, W, alpha, one_m_alpha, C1, C2);
  return (int)cudaGetLastError();
}

// dxp, dyp [B,3,H+2,W+2] from xp, yp and g [B,H,W]. c_ssim is
// -0.5 * alpha / 3 and c_l1 is 1 - alpha, as the caller computes them.
// Returns 0 on a successful launch.
extern "C" int photometric_bwd(const void* xp, const void* yp, const void* g,
                               void* dxp, void* dyp, int B, int H, int W,
                               float c_ssim, float c_l1, float C1, float C2,
                               void* stream) {
  if (bad_dims(B, H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + 2 + TW - 1) / TW, (H + 2 + TH - 1) / TH, B);
  photometric_bwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(yp),
      static_cast<const float*>(g), static_cast<float*>(dxp),
      static_cast<float*>(dyp), H, W, c_ssim, c_l1, C1, C2);
  return (int)cudaGetLastError();
}
