// The photometric map (SSIM + L1 over 3x3 reflect-padded windows) and its
// gradient, for Hopper (sm_90a).
//
// Inputs are the images x, y [B,H,W,3] fp32 as the caller holds them:
// NHWC with channel stride 1 and pixel stride 3, and any batch and row
// strides (the warp's output is four row-slices of one tensor, read in
// place). The reflect pad is in the loads: padded row t, column q of an
// image is its row refl(t - 1, H), column refl(q - 1, W), where
// refl(i, n) = -i for i < 0 and 2n - 2 - i for i >= n (n >= 2); nothing
// writes a padded copy.
//
// Forward, photometric_fwd: photo [B,H,W] fp32,
//   photo(p) = mean_c [ alpha * clamp01((1 - SSIM_c(p)) / 2)
//                       + (1 - alpha) * |x_c(p) - y_c(p)| ]
// with the raw moments m1 = E[x], m2 = E[y], m3 = E[x^2], m4 = E[y^2],
// m5 = E[xy] over the 3x3 window of p, S = N / D,
//   N = (2 m1 m2 + C1)(2 (m5 - m1 m2) + C2),
//   D = (m1^2 + m2^2 + C1)((m3 - m1^2) + (m4 - m2^2) + C2).
//
// Backward, photometric_bwd: dx (and dy when asked) [B,H,W,3] from
// g = d loss/d photo [B,H,W] of any strides (0 included), by the raw-moment
// formula over the padded grid: with Gc(p) = g(p) * (-alpha / 6) where
// 0 < (1 - S) / 2 < 1 (strictly) and 0 elsewhere, and the coefficients
//   S1 = dS/dm1, S2 = dS/dm2, S3 = dS/dm3 = dS/dm4, S5 = dS/dm5,
//   dxp(q) = 1/9 [ bsum(Gc S1) + 2 xp(q) bsum(Gc S3) + yp(q) bsum(Gc S5) ]
//            + sign(xp(q) - yp(q)) * g(q - 1) * (1 - alpha) / 3,
//   dyp(q) = 1/9 [ bsum(Gc S2) + 2 yp(q) bsum(Gc S3) + xp(q) bsum(Gc S5) ]
//            - the same L1 term,
// where bsum is the transpose of the valid 3x3 box sum (q receives from the
// p in [q-2, q] that lie in the valid grid) and g(q - 1) is 0 on the pad;
// then the reflect pad's adjoint, in the stores: rows first (padded row 0
// added into row 2, row H+1 into row H-1), then columns (0 into 2, W+1
// into W-1), so a corner is (a22 + a02) + (a20 + a00), the order of
// ops/kernels/photometric.py `reflect_fold`.
// The divisions by 3 are the channel mean for C = 3: the wrapper refuses
// other channel counts, as the TPU kernel's literal 3.0 only fits RGB.
//
// Replaces packnet_sfm_tpu/ops/pallas/photometric.py `_fwd_kernel` (:94,
// pallas_call at :115) and `_bwd_kernel` (:133, pallas_call at :224). The
// TPU wrapper cut overlapping row tiles and widened columns on the XLA side
// because Mosaic kernels only narrow widths, and JAX padded and folded
// around the kernels; here a warp sweeps its own strip, reflecting its own
// indices, and nothing crosses warps. The formulas keep the TPU kernels'
// order of operations, and the file builds with -fmad=false, so the
// results follow the plain PyTorch versions (ops/kernels/photometric.py)
// to the last bits of the sums.
//
// What bounds them on this card. The forward reads x and y once and
// writes photo (27.5 MB at B8 192x640, 8.2 us at 3.35 TB/s). The backward
// reads x, y and g and writes dx (39.3 MB, 11.7 us; dy adds 11.8 MB). Both
// are bound by instruction issue: the box sums keep the TPU kernel's
// order (rows outer, columns inner, one sum after the other), which makes
// each of the five moments of a p and each transpose sum of a q a chain of
// 8 adds. With the products, the SSIM terms and the IEEE divisions, the
// forward's SASS issues ~120 instructions a pixel and channel (~360 a lane
// a closing row), ~14.4 M warp-instructions a launch at B8 192x640 with
// the strips' and segments' halos: 13.8 us at 132 SMs x 4 schedulers x
// 1.98 GHz. The backward issues more a pixel: its transpose sums are a
// second set of chains.
//
// Design: one warp (a block of its own, so that the shuffles stay
// converged) sweeps down a strip of 32 padded columns of one image over a
// segment of rows, all three channels at once, with no barrier. At each
// staged row t a lane loads its own pixel (its row reflected once a row,
// its column once a lane), and the row is added into the moment sums of
// the p rows t-2, t-1 and t that are open in its registers: p row t-2's
// sums close, in the order of the plain version's sum. The next row's
// loads are issued before the current row's arithmetic. The rows are cut
// into segments (at least 4 rows each) so that the warps fill every SM's
// slots in one wave (the occupancy is asked once per kernel).
// - Forward: lane l holds padded column X+l and takes columns X+l+1 and
//   X+l+2 from its neighbours by shuffles; it forms each product of a
//   staged pixel once a column, closes p (t-2, X+l) with the SSIM terms,
//   one IEEE division, the clamp, the L1 term and the channel mean, and
//   lanes 0..29 write it (the last two lanes are the strip's halo).
// - Backward: lane l holds staged columns X..X+2 (loads of its own; L1
//   serves the overlap), forms the four coefficients Gc*S of p (t-2, X)
//   (one IEEE division and one reciprocal), takes its right neighbours'
//   by two shuffles, and adds them into the transpose sums of the q rows
//   that are open, of which q row t-2 closes. Its value is folded and
//   written: q row 0 and q row H-1 wait in shared memory (one slot a lane)
//   for the rows added into them, then a column fold takes q column 0 or
//   W+1 from two lanes away. Each segment holds at least 4 rows, so both
//   row folds stay in one warp; the strips start where no cut separates
//   q columns 0 and 2 or W-1 and W+1 (`strip_origin`), so both column
//   folds do too, and no store is atomic. Without dy the S2 sums and the
//   dy stores are compiled out. Held to 128 registers, 16 warps an SM.
//
// C entry points (ctypes): each returns cudaGetLastError() right after the
// launch, or cudaErrorInvalidValue for arguments it does not take. They
// launch on the given stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int C = 3;                      // RGB only (see above)
constexpr int STRIP = 30;                 // columns a warp writes
constexpr int MIN_SEG_ROWS = 4;           // rows a segment holds at least
constexpr int FWD_MIN_WARPS = 24;         // forward: <= 85 registers
constexpr int BWD_MIN_WARPS = 16;         // backward: <= 128 registers
constexpr unsigned FULL = 0xffffffffu;

struct Moments {
  float m1, m2, m3, m4, m5;
};

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

// the image index that padded index i + 1 reflects onto, n >= 2
__device__ __forceinline__ int refl(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// a += (v0 + v1 + v2) in that order, or a = (v0 + v1) + v2 to open a sum
__device__ __forceinline__ float add3(float a, const float* v) {
  return ((a + v[0]) + v[1]) + v[2];
}
__device__ __forceinline__ float open3(const float* v) {
  return (v[0] + v[1]) + v[2];
}

// The rows [r0, r1) of segment `seg` of n rows cut into n_segs near-equal
// parts.
__device__ __forceinline__ void segment(int n, int n_segs, int seg, int& r0,
                                        int& r1) {
  const int base = n / n_segs, extra = n % n_segs;
  r0 = seg * base + min(seg, extra);
  r1 = r0 + base + (seg < extra ? 1 : 0);
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(32, FWD_MIN_WARPS)
photometric_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ y, float* __restrict__ out,
                       int H, int W, int sxb, int sxh, int syb, int syh,
                       int n_strips, int n_segs, float alpha,
                       float one_m_alpha, float C1, float C2) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x / (n_strips * n_segs);
  const int seg = (blockIdx.x / n_strips) % n_segs;
  const int strip = blockIdx.x % n_strips;
  int r0, r1;                    // the segment's p rows
  segment(H, n_segs, seg, r0, r1);
  // this lane's padded column q, the left column of p (t-2, q); a lane past
  // column W+1 reads column W+1 and writes nothing
  const int q = strip * STRIP + lane;
  const int col = refl(min(q, W + 1) - 1, W) * C;
  const float* xb = x + (int64_t)b * sxb + col;
  const float* yb = y + (int64_t)b * syb + col;
  float* ob = out + (int64_t)b * H * W + q;
  const bool out_col = lane < STRIP && q < W;
  const float inv9 = (float)(1.0 / 9.0);

  // x, y of staged row t (padded) at this lane's column
  auto load = [&](int t, float* vx, float* vy) {
    const int r = refl(t - 1, H);
    const float* px = xb + r * sxh;
    const float* py = yb + r * syh;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      vx[c] = __ldg(px + c);
      vy[c] = __ldg(py + c);
    }
  };

  float sa[C][5] = {};   // x, y, xx, yy, xy sums of p row t-1: its first row
  float sb[C][5] = {};   // the same of p row t-2: its first two rows
  float l1[C] = {};      // |x - y| at (t-1, q+1): the L1 term of p (t-2, q)
  float cx[C], cy[C];
  load(r0, cx, cy);
  for (int t = r0; t < r1 + 2; ++t) {
    // the next row, in flight while this one's arithmetic runs (the last
    // step loads its own row again)
    float nx[C], ny[C];
    load(min(t + 1, r1 + 1), nx, ny);
    const bool closes = t >= r0 + 2;    // p row t-2 is the segment's
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float x0 = cx[c], y0 = cy[c];
      const float x1 = __shfl_down_sync(FULL, x0, 1);
      const float x2 = __shfl_down_sync(FULL, x0, 2);
      const float y1 = __shfl_down_sync(FULL, y0, 1);
      const float y2 = __shfl_down_sync(FULL, y0, 2);
      const float v[5][3] = {{x0, x1, x2},
                             {y0, y1, y2},
                             {x0 * x0, x1 * x1, x2 * x2},
                             {y0 * y0, y1 * y1, y2 * y2},
                             {x0 * y0, x1 * y1, x2 * y2}};
      float m[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        m[i] = add3(sb[c][i], v[i]) * inv9;     // p row t-2 closes
        sb[c][i] = add3(sa[c][i], v[i]);
        sa[c][i] = open3(v[i]);
      }
      if (closes) {
        const Terms tt = ssim_terms({m[0], m[1], m[2], m[3], m[4]}, C1, C2);
        const float st =
            fminf(fmaxf((1.f - tt.N / tt.D) * 0.5f, 0.f), 1.f);
        const float val = alpha * st + one_m_alpha * l1[c];
        acc = c == 0 ? val : acc + val;
      }
      l1[c] = fabsf(x1 - y1);
    }
    if (closes && out_col) ob[(int64_t)(t - 2) * W] = acc / 3.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cx[c] = nx[c];
      cy[c] = ny[c];
    }
  }
}

// --------------------------------------------------------------- backward

// What a lane carries, per channel, from one staged row to the next.
struct Open {
  float a[5];     // x, y, xx, yy, xy sums of p row t-1: its first row
  float b[5];     // the same of p row t-2: its first two rows
  float ka[4];    // transpose sums of q row t-1 (p row t-3 so far)
  float kb[4];    // the same of q row t-2 (p rows t-4, t-3)
  float xq[2];    // x at column X+2 of staged rows t-1 and t-2
  float yq[2];
};

// One warp a block, so that a block is one (image, segment, strip) and no
// lane of a warp leaves early: the shuffles stay converged. DY: dy is
// computed and written.
template <bool DY>
__global__ void __launch_bounds__(32, BWD_MIN_WARPS)
photometric_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ g, float* __restrict__ dx,
                       float* __restrict__ dy, int H, int W, int sxb,
                       int sxh, int syb, int syh, int sgb, int sgh, int sgw,
                       int n_strips, int n_segs, int org, float c_ssim,
                       float c_l1, float C1, float C2) {
  constexpr int ND = DY ? 2 : 1;
  // q rows 0 and H-1 of dx (and dy), one slot a lane and channel, until
  // the rows folded into them close
  __shared__ float held[2][ND][C][32];
  const int lane = threadIdx.x;
  const int b = blockIdx.x / (n_strips * n_segs);
  const int seg = (blockIdx.x / n_strips) % n_segs;
  const int strip = blockIdx.x % n_strips;
  const int Hp = H + 2, Wp = W + 2;
  int q0, q1;                    // the segment's q rows (padded)
  segment(Hp, n_segs, seg, q0, q1);
  // this lane's column: staged columns X..X+2, p column X (valid
  // coordinates), q column qc = X+2 (padded); strip 0 starts at q column
  // -org
  const int X = strip * STRIP - org - 2 + lane;
  const int qc = X + 2;
  const bool p_col = X >= 0 && X < W;
  const bool q_col = lane < STRIP && qc >= 1 && qc <= W;   // written
  const float inv9 = (float)(1.0 / 9.0);
  // Loads read staged columns Xc .. Xc+2, Xc = X clamped into [0, Wp-3],
  // and rows clamped into the padded image: no load leaves the image, and
  // none waits on a branch. A lane whose X was clamped (X < 0 or X > W-1)
  // has no p in the grid, so the values only enter sums whose coefficients
  // the gate sets to 0; its q column (the first two, at the left edge) is
  // column jq of what it holds.
  const int Xc = min(max(X, 0), Wp - 3);
  const int jq = min(max(qc - Xc, 0), 2);
  int ocol[3];                   // image offsets of the staged columns
#pragma unroll
  for (int j = 0; j < 3; ++j) ocol[j] = refl(Xc + j - 1, W) * C;
  const float* xb = x + (int64_t)b * sxb;
  const float* yb = y + (int64_t)b * syb;
  const float* gb = g + (int64_t)b * sgb + min(max(X, 0), W - 1) * sgw;
  float* dxb = dx + (int64_t)b * H * W * C;
  float* dyb = DY ? dy + (int64_t)b * H * W * C : nullptr;

  // x, y of channel c at the staged row that starts at xrow, yrow (one
  // 64-bit product a row and a column, the channel an immediate offset)
  float cx[C][3], cy[C][3];
  const float *xrow, *yrow;
  auto row = [&](int t) {
    const int r = refl(min(max(t, 0), Hp - 1) - 1, H);
    xrow = xb + r * sxh;
    yrow = yb + r * syh;
  };
  auto load = [&](int c) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cx[c][j] = __ldg(xrow + ocol[j] + c);
      cy[c][j] = __ldg(yrow + ocol[j] + c);
    }
  };
  // g at p (r, X), 0 off the grid
  auto load_g = [&](int r) {
    const float v = __ldg(gb + min(max(r, 0), H - 1) * sgh);
    return (p_col && r >= 0 && r < H) ? v : 0.f;
  };
  // q row r of channel c (d = 0: dx, 1: dy), folded and written at pixel
  // offset `off` of its image row: q row 0 waits for row 2, q row H-1
  // (after its own fold from row 0 when H = 3) for row H+1; then columns,
  // 0 into 2 and W+1 into W-1. r is the same on every lane, so every lane
  // reaches the shuffles.
  auto store = [&](int d, int c, int r, int off, float v) {
    if (r == 0) {
      held[0][d][c][lane] = v;
      return;
    }
    if (r == 2) v = v + held[0][d][c][lane];
    if (r == H - 1) {
      held[1][d][c][lane] = v;
      return;
    }
    if (r == H + 1) v = held[1][d][c][lane] + v;
    const float up = __shfl_up_sync(FULL, v, 2);
    const float dn = __shfl_down_sync(FULL, v, 2);
    if (qc == 2) v = v + up;
    if (qc == W - 1) v = v + dn;
    float* base = d == 0 ? dxb : dyb;
    if (q_col) base[off + c] = v;
  };

  Open st[C] = {};          // every sum opens at 0 (the first rows' are unused)
  float l1_next = 0.f;      // the L1 term of p (t-3, X+1), for q (t-2, X+2)
  row(q0 - 2);
#pragma unroll
  for (int c = 0; c < C; ++c) load(c);
  float cg = load_g(q0 - 4);
  for (int t = q0 - 2; t < q1 + 2; ++t) {
    const bool more = t + 1 < q1 + 2;
    const int r = t - 2;                 // the p row and q row that close
    const bool p_live = t >= q0;         // p rows q0-2 .. q1-1 feed the tile
    const bool p_ok = p_col && r >= 0 && r < H;
    const bool q_out = t >= q0 + 2;
    // the pixel q (r, X+2) folds into: image row r-1, or H-2 for q row H+1
    const int off = ((r == H + 1 ? H - 2 : r - 1) * W + qc - 1) * C;
    const float Gc = cg * c_ssim;
    const float l1 = cg * c_l1 / 3.f;    // g at p, 0 off the grid
    const float l1_q = l1_next;
    l1_next = __shfl_down_sync(FULL, l1, 1);
    if (more) {
      cg = load_g(r + 1);
      row(t + 1);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Open& o = st[c];
      float v[5][3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float xv = cx[c][j], yv = cy[c][j];
        v[0][j] = xv;
        v[1][j] = yv;
        v[2][j] = xv * xv;
        v[3][j] = yv * yv;
        v[4][j] = xv * yv;
      }
      const float xq = o.xq[1], yq = o.yq[1];   // x, y at (t-2, X+2)
      o.xq[1] = o.xq[0];
      o.yq[1] = o.yq[0];
      o.xq[0] = jq == 2 ? cx[c][2] : (jq == 1 ? cx[c][1] : cx[c][0]);
      o.yq[0] = jq == 2 ? cy[c][2] : (jq == 1 ? cy[c][1] : cy[c][0]);
      // this channel's next row, in flight while the rest of the step runs
      if (more) load(c);
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
      const float S2 = DY ? (2.f * mm.m1 * (tt.sxy2 - tt.n1)) * inv_D -
                                NDD * (2.f * mm.m2 * (tt.d2 - tt.d1))
                          : 0.f;
      const float S3 = -NDD * tt.d1;
      const float S5 = 2.f * tt.n1 * inv_D;
      const float gc = (p_ok && lin > 0.f && lin < 1.f) ? Gc : 0.f;
      const float k[4] = {gc * S1, gc * S2, gc * S3, gc * S5};
      float bs[4] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!DY && i == 1) continue;
        // p columns X, X+1, X+2 of q column X+2, from this lane and the
        // next two
        const float kv[3] = {k[i], __shfl_down_sync(FULL, k[i], 1),
                             __shfl_down_sync(FULL, k[i], 2)};
        bs[i] = add3(o.kb[i], kv) * inv9;     // q row t-2 closes
        o.kb[i] = add3(o.ka[i], kv);
        o.ka[i] = open3(kv);
      }
      if (q_out) {
        const float d = xq - yq;
        const float sgn = (float)((d > 0.f) - (d < 0.f)) * l1_q;
        store(0, c, r, off, (bs[0] + 2.f * xq * bs[2] + yq * bs[3]) + sgn);
        if (DY)
          store(ND - 1, c, r, off,
                (bs[1] + 2.f * yq * bs[2] + xq * bs[3]) - sgn);
      }
    }
  }
}

template <typename Kernel>
int warps_per_sm(Kernel kernel) {
  int warps = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&warps, kernel, 32, 0) !=
          cudaSuccess ||
      warps <= 0)
    warps = 1;
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

// Segments of at least MIN_SEG_ROWS of n rows such that B * n_strips *
// n_segs warps fill `slots` in one wave.
int n_segments(int64_t slots, int B, int n_strips, int n) {
  const int64_t fill = std::max<int64_t>(1, slots / ((int64_t)B * n_strips));
  return (int)std::min<int64_t>(fill, std::max(1, n / MIN_SEG_ROWS));
}

// The offset org of strip 0 (it starts at q column -org): the cuts, at q
// columns congruent to -org mod STRIP, fall on none of q columns 1, 2 (the
// fold of column 0 into 2) and W, W+1 (W+1 into W-1), so a column fold
// never crosses a warp. Four of the STRIP residues are excluded.
int strip_origin(int W) {
  for (int k = 0; k < STRIP; ++k)
    if (k != 1 && k != 2 && k != W % STRIP && k != (W + 1) % STRIP)
      return (STRIP - k) % STRIP;
  return 0;
}

bool bad_dims(int B, int H, int W) {
  return B <= 0 || H < 2 || W < 2 || (int64_t)H * W * C > 2147483647LL;
}

}  // namespace

// photo [B,H,W] from x, y [B,H,W,3] (element strides sxb, sxh of x and
// syb, syh of y; pixel stride 3, channel stride 1). one_m_alpha is
// 1 - alpha as the caller computes it. Returns 0 on a successful launch.
extern "C" int photometric_fwd(const void* x, const void* y, void* out,
                               int B, int H, int W, int sxb, int sxh,
                               int syb, int syh, float alpha,
                               float one_m_alpha, float C1, float C2,
                               void* stream) {
  if (bad_dims(B, H, W)) return (int)cudaErrorInvalidValue;
  static const int warps = warps_per_sm(photometric_fwd_kernel);
  const int n_strips = (W + STRIP - 1) / STRIP;
  const int n_segs = n_segments((int64_t)warps * n_sms(), B, n_strips, H);
  const int64_t items = (int64_t)B * n_strips * n_segs;
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;
  photometric_fwd_kernel<<<(unsigned)items, 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), H, W, sxb, sxh, syb, syh, n_strips, n_segs,
      alpha, one_m_alpha, C1, C2);
  return (int)cudaGetLastError();
}

// dx and, when need_dy, dy [B,H,W,3] (contiguous) from x, y as above and
// g [B,H,W] (element strides sgb, sgh, sgw). c_ssim is -0.5 * alpha / 3
// and c_l1 is 1 - alpha, as the caller computes them. Returns 0 on a
// successful launch.
extern "C" int photometric_bwd(const void* x, const void* y, const void* g,
                               void* dx, void* dy, int B, int H, int W,
                               int sxb, int sxh, int syb, int syh, int sgb,
                               int sgh, int sgw, int need_dy, float c_ssim,
                               float c_l1, float C1, float C2,
                               void* stream) {
  if (bad_dims(B, H, W) || (need_dy && dy == nullptr))
    return (int)cudaErrorInvalidValue;
  static const int warps[2] = {warps_per_sm(photometric_bwd_kernel<false>),
                               warps_per_sm(photometric_bwd_kernel<true>)};
  const int org = strip_origin(W);
  const int n_strips = (W + 2 + org + STRIP - 1) / STRIP;
  const int n_segs = n_segments((int64_t)warps[need_dy ? 1 : 0] * n_sms(),
                                B, n_strips, H + 2);
  const int64_t items = (int64_t)B * n_strips * n_segs;
  if (items > 2147483647LL) return (int)cudaErrorInvalidValue;
  auto kernel = need_dy ? photometric_bwd_kernel<true>
                        : photometric_bwd_kernel<false>;
  kernel<<<(unsigned)items, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(g), static_cast<float*>(dx),
      static_cast<float*>(dy), H, W, sxb, sxh, syb, syh, sgb, sgh, sgw,
      n_strips, n_segs, org, c_ssim, c_l1, C1, C2);
  return (int)cudaGetLastError();
}
