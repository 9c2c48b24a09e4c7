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
// because Mosaic kernels only narrow widths; here a forward block stages
// its own tile and halo in shared memory and a backward warp sweeps its own
// strip, and nothing crosses blocks. The formulas
// keep the TPU kernels' order of operations, and the file builds with
// -fmad=false, so the results follow the plain PyTorch versions
// (ops/kernels/photometric.py) to the last bits of the sums.
//
// What bounds them on this card. The forward reads xp and yp once and
// writes photo (~28 MB at B8 192x640, ~8 us at 3.35 TB/s). The backward
// reads xp, yp and g and writes dxp and dyp (~52 MB, ~16 us), but it is
// bound by instruction issue: the box sums keep the TPU kernel's order
// (rows outer, columns inner, one sum after the other), which makes each
// of the five moments of a p and each of the four transpose sums of a q a
// chain of 8 adds; with the products, the SSIM terms and two IEEE
// divisions that is ~200 instructions a pixel and channel, ~20 us a
// launch at 132 SMs x 4 schedulers x 1.98 GHz.
//
// Design:
// - Forward (first, simple version): one block of 256 threads per 8x32
//   output tile; it stages xp and yp for the tile and a one-pixel halo (3
//   channels, 10x34 each) in shared memory, and each thread computes one
//   output pixel's moments in registers, channel by channel.
// - Backward: one warp (a block of its own) sweeps down a strip of 32
//   padded columns X .. X+31 of one image over a segment of rows, all
//   three channels at once, with no shared memory and no barrier. At each
//   staged row t a lane holds xp, yp at columns X+l .. X+l+2 (coalesced
//   loads; L1 serves the overlap), forms x^2, y^2 and xy there, and adds
//   the row into the moment sums of the p rows t-2, t-1 and t that are
//   open in its registers: p row t-2's sums close, in the order of the
//   plain version's sum. From those moments it forms the four coefficients
//   Gc*S of p (t-2, X+l) (one IEEE division and one reciprocal; the L1
//   term g * (1 - alpha) / 3 once a p for all channels), takes its right
//   neighbours' coefficients by two shuffles, and adds them into the
//   transpose sums of the q rows t-2, t-1 and t that are open, of which q
//   row t-2 closes and is written (lanes 0..29; the last two lanes are the
//   strip's halo). A channel's next row is loaded as soon as its products
//   are formed, so the loads fly while the rest of the step runs, with no
//   second set of registers. So every staged pixel's products are formed
//   by three lanes instead of nine windows, the halo is 2 of 32 columns
//   and 4 rows a segment, and the segments are cut so that every SM holds
//   the same number of warps in one wave (the occupancy is asked once; the
//   kernel is held to 128 registers, 16 warps an SM).
//
// C entry points (ctypes): each returns cudaGetLastError() right after the
// launch, or cudaErrorInvalidValue for arguments it does not take. They
// launch on the given stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

constexpr int STRIP = 30;                 // q columns a warp writes
constexpr int BWD_MIN_WARPS = 16;         // warps an SM holds: <= 128 registers

// What a lane carries, per channel, from one staged row to the next.
struct Open {
  float a[5];     // x, y, xx, yy, xy sums of p row t-1: its first row
  float b[5];     // the same of p row t-2: its first two rows
  float ka[4];    // transpose sums of q row t-1 (p row t-3 so far)
  float kb[4];    // the same of q row t-2 (p rows t-4, t-3)
  float xq[2];    // x at column X+2 of staged rows t-1 and t-2
  float yq[2];
};

// a += (v0 + v1 + v2) in that order, or a = (v0 + v1) + v2 to open a sum
__device__ __forceinline__ float add3(float a, const float* v) {
  return ((a + v[0]) + v[1]) + v[2];
}
__device__ __forceinline__ float open3(const float* v) {
  return (v[0] + v[1]) + v[2];
}

// One warp a block, so that a block is one (image, segment, strip) and no
// lane of a warp leaves early: the shuffles stay converged.
__global__ void __launch_bounds__(32, BWD_MIN_WARPS)
photometric_bwd_kernel(const float* __restrict__ xp,
                       const float* __restrict__ yp,
                       const float* __restrict__ g, float* __restrict__ dxp,
                       float* __restrict__ dyp, int H, int W, int n_strips,
                       int n_segs, float c_ssim, float c_l1, float C1,
                       float C2) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x / (n_strips * n_segs);
  const int seg = (blockIdx.x / n_strips) % n_segs;
  const int strip = blockIdx.x % n_strips;
  const int Hp = H + 2, Wp = W + 2;
  // the segment's q rows [q0, q1): Hp rows cut into n_segs near-equal parts
  const int base = Hp / n_segs, extra = Hp % n_segs;
  const int q0 = seg * base + min(seg, extra);
  const int q1 = q0 + base + (seg < extra ? 1 : 0);
  // this lane's column: staged columns X..X+2, p column X (valid
  // coordinates), q column X+2 (padded)
  const int X = strip * STRIP - 2 + lane;
  const int plane = Hp * Wp;
  const float* xb = xp + (int64_t)b * C * plane;
  const float* yb = yp + (int64_t)b * C * plane;
  const float* gb = g + (int64_t)b * H * W;
  float* dxb = dxp + (int64_t)b * C * plane;
  float* dyb = dyp + (int64_t)b * C * plane;
  const bool p_col = X >= 0 && X < W;
  const bool q_col = lane < STRIP && X + 2 < Wp;
  const float inv9 = (float)(1.0 / 9.0);
  // Loads read columns Xc .. Xc+2, Xc = X clamped into [0, Wp-3], and rows
  // clamped into the image: no load leaves the image, and none waits on a
  // branch. A lane whose X was clamped (X < 0 or X > W-1) has no p in the
  // grid, so the values only enter sums whose coefficients the gate sets to
  // 0; its q column X+2 (the first two, at the left edge) is column jq of
  // what it holds.
  const int Xc = min(max(X, 0), Wp - 3);
  const int jq = min(X + 2 - Xc, 2);
  const int Xg = min(max(X, 0), W - 1);

  // x, y of channel c at staged row t, columns Xc..Xc+2
  float cx[C][3], cy[C][3];
  auto load = [&](int c, int t) {
    const int o = c * plane + min(max(t, 0), Hp - 1) * Wp + Xc;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cx[c][j] = __ldg(xb + o + j);
      cy[c][j] = __ldg(yb + o + j);
    }
  };
  // g at p (r, X), 0 off the grid
  auto load_g = [&](int r) {
    const float v = __ldg(gb + min(max(r, 0), H - 1) * W + Xg);
    return (p_col && r >= 0 && r < H) ? v : 0.f;
  };

  Open st[C] = {};          // every sum opens at 0 (the first rows' are unused)
  float l1_next = 0.f;      // the L1 term of p (t-3, X+1), for q (t-2, X+2)
#pragma unroll
  for (int c = 0; c < C; ++c) load(c, q0 - 2);
  float cg = load_g(q0 - 4);
  for (int t = q0 - 2; t < q1 + 2; ++t) {
    const bool more = t + 1 < q1 + 2;
    const int r = t - 2;                 // the p row and q row that close
    const bool p_live = t >= q0;         // p rows q0-2 .. q1-1 feed the tile
    const bool p_ok = p_col && r >= 0 && r < H;
    const bool q_out = t >= q0 + 2 && q_col;
    const float Gc = cg * c_ssim;
    const float l1 = cg * c_l1 / 3.f;    // g at p, 0 off the grid
    const float l1_q = l1_next;
    l1_next = __shfl_down_sync(0xffffffffu, l1, 1);
    if (more) cg = load_g(r + 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Open& o = st[c];
      float v[5][3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float x = cx[c][j], y = cy[c][j];
        v[0][j] = x;
        v[1][j] = y;
        v[2][j] = x * x;
        v[3][j] = y * y;
        v[4][j] = x * y;
      }
      const float xq = o.xq[1], yq = o.yq[1];   // x, y at (t-2, X+2)
      o.xq[1] = o.xq[0];
      o.yq[1] = o.yq[0];
      o.xq[0] = jq == 2 ? cx[c][2] : (jq == 1 ? cx[c][1] : cx[c][0]);
      o.yq[0] = jq == 2 ? cy[c][2] : (jq == 1 ? cy[c][1] : cy[c][0]);
      // this channel's next row, in flight while the rest of the step runs
      if (more) load(c, t + 1);
      float m[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        m[i] = add3(o.b[i], v[i]) * inv9;     // p row t-2 closes
        o.b[i] = add3(o.a[i], v[i]);
        o.a[i] = open3(v[i]);
      }
      if (!p_live) continue;
      // Gc * S{1,2,3,5} of p (t-2, X): 0 off the grid and outside the gate
      const Moments mm = {m[0], m[1], m[2], m[3], m[4]};
      const Terms tt = ssim_terms(mm, C1, C2);
      const float lin = (1.f - tt.N / tt.D) * 0.5f;
      const float inv_D = 1.f / tt.D;
      const float NDD = tt.N * inv_D * inv_D;
      const float S1 = (2.f * mm.m2 * (tt.sxy2 - tt.n1)) * inv_D -
                       NDD * (2.f * mm.m1 * (tt.d2 - tt.d1));
      const float S2 = (2.f * mm.m1 * (tt.sxy2 - tt.n1)) * inv_D -
                       NDD * (2.f * mm.m2 * (tt.d2 - tt.d1));
      const float S3 = -NDD * tt.d1;
      const float S5 = 2.f * tt.n1 * inv_D;
      const float gc = (p_ok && lin > 0.f && lin < 1.f) ? Gc : 0.f;
      const float k[4] = {gc * S1, gc * S2, gc * S3, gc * S5};
      float bs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // p columns X, X+1, X+2 of q column X+2, from this lane and the
        // next two
        const float kv[3] = {k[i], __shfl_down_sync(0xffffffffu, k[i], 1),
                             __shfl_down_sync(0xffffffffu, k[i], 2)};
        bs[i] = add3(o.kb[i], kv) * inv9;     // q row t-2 closes
        o.kb[i] = add3(o.ka[i], kv);
        o.ka[i] = open3(kv);
      }
      if (q_out) {
        const float d = xq - yq;
        const float sgn = (float)((d > 0.f) - (d < 0.f)) * l1_q;
        const int oq = c * plane + r * Wp + X + 2;
        dxb[oq] = (bs[0] + 2.f * xq * bs[2] + yq * bs[3]) + sgn;
        dyb[oq] = (bs[1] + 2.f * yq * bs[2] + xq * bs[3]) - sgn;
      }
    }
  }
}

// Warps (one a block) an SM holds of the backward kernel, asked once.
int bwd_warps_per_sm() {
  static int warps = 0;
  if (warps == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &warps, photometric_bwd_kernel, 32, 0) != cudaSuccess ||
        warps <= 0)
      warps = 1;
  }
  return warps;
}

int n_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 1;
  }
  return sms;
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
  if (B <= 0 || H <= 0 || W <= 0 || (int64_t)3 * (H + 2) * (W + 2) >
      2147483647LL)
    return (int)cudaErrorInvalidValue;
  // strips of STRIP q columns; the rows cut into segments so that the
  // warps fill every SM's slots in one wave (at least 4 rows a segment)
  const int n_strips = (W + 2 + STRIP - 1) / STRIP;
  const int64_t slots = (int64_t)bwd_warps_per_sm() * n_sms();
  int n_segs = (int)std::max<int64_t>(1, slots / ((int64_t)B * n_strips));
  n_segs = std::min(n_segs, std::max(1, (H + 2) / 4));
  const int64_t items = (int64_t)B * n_strips * n_segs;
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;
  photometric_bwd_kernel<<<(unsigned)items, 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(yp),
      static_cast<const float*>(g), static_cast<float*>(dxp),
      static_cast<float*>(dyp), H, W, n_strips, n_segs, c_ssim, c_l1, C1,
      C2);
  return (int)cudaGetLastError();
}
