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
// backward's residuals), all [B,H,W] fp32. m is the max of the logits;
// s, rows and cols are the online softmax's sums, taken in another order
// than the plain version's (see below).
//
// Backward, generic_projection_bwd: from the cotangents gy, gx of rows and
// cols [B,H,W], with p_k = exp(logit_k - m) * (1 / s),
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
// 7.9e-5). The differences (row_k - rows), (col_k - cols), (g_k - g_c) are
// kept as differences for the same reason.
//
// Replaces packnet_sfm_tpu/ops/pallas/generic_projection.py `_proj_kernel`
// (:81, pallas_call at :159) and `_proj_bwd_kernel` (:199, pallas_call at
// :287). The TPU kernels keep a whole ray plane in VMEM and build each
// window column with a lane roll plus two border fixes, and the backward
// adds into a VMEM-resident gradient plane while its grid runs in order.
// Here a window is a plain 2D range, and blocks run in no order.
//
// What bounds it on this card: instruction issue. Per candidate (pixel,
// window position) the forward needs one exp and ~12 fp32 operations and
// moves almost no bytes (the 2 input and 4 output planes, ~1.5 MB at B1
// 192x192); the backward needs the exp again and ~24 operations. At the
// generic step's planes, B1 192x192 and 384x384 at p = 20, that is 62 M
// and 248 M candidates. expf is ~9 instructions (one on the SFU), so the
// issue slots, not the SFU's 16 exps an SM a clock, set the pace: ~24
// instructions a candidate forward, ~25 for dd and ~25 for dray. The
// design spends its effort on filling the card and on issuing few
// instructions a candidate:
// - pixel-major (forward, dd): a block of 128 threads owns a pixel tile,
//   4 rows (one a warp) by 8 pixels (forward) or 4 (dd), and stages the
//   union of its windows' rays (at most 44 x 48 at p = 20, 25.3 KB) in
//   shared memory once, (g0, g1) as float2 and g2 as float. Each pixel's
//   window columns are split over 4 lanes, j = tc + 4u (11 or 10 at
//   p = 20); dd also splits the window rows into halves [0, h) and
//   [h, k1), h = (k1 + 1) / 2, 8 lanes a pixel. That gives 1,152 forward
//   and 2,304 dd blocks at 192x192 on 132 SMs. dd's row stride of the
//   staged rays is padded so that its two halves' loads fall in distinct
//   banks.
// - forward: the window rows run in order, each as the plain version does
//   it, so its sums stay as close to the plain version's as a split can:
//   a lane's logits of the row held in registers (up to 11; wider windows
//   take the row in chunks of 11, computing the logits again), the row's
//   max over the 4 lanes by shuffles, m_new = max(m, row max), the same
//   exps exp(logit - m_new), the row's sums over the lane's columns and
//   then over the 4 lanes by shuffles (every lane adds the same two terms,
//   so all agree bit for bit), then s = s * alpha + psum, ey = ey * alpha +
//   row * psum, ex = ex * alpha + sum exp * col. (A first design gave each
//   lane its own online softmax over a row half and combined the 8 states
//   at the end, 3-5% faster; it moved the generic step's fp32 check on a
//   one-element bias gradient from 1.4e-3 to 1.6e-2-2.9e-2, against 2e-2.)
// - dd: 1 / s once a pixel, then per candidate one exp, one multiply and
//   the sums against g_c; gx * (col_k - cols) of the lane's columns is
//   held in registers across the window rows. The 8 partial sums are
//   combined by shuffles over lane bits 0, 1 and 4.
// - dray: ray-major, no atomics. A ray (r, c) sums over the pixels whose
//   windows hold it; along each axis they form one range: for a ray
//   column c, x from (c <= 2p ? 0 : c - p) to (c >= W - k1 ? W - 1 : c + p),
//   the same for rows. A block of 128 threads owns an 8x8 ray tile, warp
//   w its ray rows 2w and 2w + 1 (which of the two a pixel row feeds is
//   the same for the whole warp); lane tc*8 + rx takes ray column rx of
//   both rows and the pixel columns xlo + tc + 4u. The per-pixel values
//   (d0, d1, d2, m | 1/s, gy, gx, rows | cols) are staged in shared memory
//   8 pixel rows at a time over the tile's pixel columns (at most 4p + 8
//   wide), as two float4 and a float, read with three loads and used for
//   both rays. The 4 column lanes' sums are combined by shuffles over lane
//   bits 3 and 4. Near the borders a ray's range grows to 3p + 1 pixels a
//   side, so dray tiles there take up to ~2x an interior tile's work.
// - the backward is one launch: its first blocks each take a dray tile
//   (the uneven ones first), the rest each a dd tile, all alike, which
//   fill in behind them (0.194 ms a call at 192x192 against 0.235 for dd
//   and dray as two launches). generic_projection_bwd_dd and
//   generic_projection_bwd_dray launch it with one kind of block, for
//   timing each apart.
// - every inner loop runs over chunks of 11 slots (columns tc + 4u) whose
//   first 10 are in the window whenever the chunk is full, as at p = 20;
//   the last slot is computed on a clamped column and masked, so the
//   chunk has no branch and its candidates interleave (a branch a slot
//   serialised them: 0.37 ms against 0.25 for a forward at 384x384).
// glogit is computed with the same operations in the same order in dd
// and dray.
//
// Deterministic: every output element is written by one thread, and every
// sum runs in an order fixed by the shapes alone; no atomics. Two calls
// give the same bits.
//
// The arithmetic keeps the TPU kernels' order for the logits: logit =
// d0*g0 + d1*g1 + d2*g2 summed left to right, expf (not __expf), and the
// file builds with -fmad=false, so the logits, and so m and the forward's
// exps, equal those of the plain PyTorch versions
// (ops/kernels/generic_projection.py) bit for bit; only the order of the
// positive sums inside a window row (forward) and of the signed sums of
// dd and dray (explicit fmaf) differs.
//
// C entry points (ctypes): each returns the first nonzero cudaGetLastError()
// of its launches, or cudaErrorInvalidValue for arguments it does not take
// (including a window whose staged rays exceed 227 KB of shared memory,
// p > 66). They launch on the given stream, allocate nothing and do not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;         // threads a block, 4 warps
constexpr int MAX_SMEM = 232448;
// resident blocks an SM each kernel is compiled for (registers a thread:
// 56 at 9, 64 at 8)
constexpr int FWD_MIN_BLOCKS = 8;
constexpr int BWD_MIN_BLOCKS = 8;
// pixel-major kernels (forward, dd)
constexpr int FTX = 8;          // forward tile columns (pixels a warp)
constexpr int PTX = 4;          // dd tile columns (pixels a warp)
constexpr int PTY = 4;          // tile rows (one a warp)
constexpr int CW = 11;          // window columns a lane holds a chunk
// ray-major kernel (dray)
constexpr int RTX = 8;          // tile columns (rays a warp)
constexpr int RTY = 8;          // tile rows (two a warp)
constexpr int BAND = 8;         // pixel rows staged at a time

// the window start along one axis: clip(c - p, 0, n - k1), n >= k1
__device__ __host__ __forceinline__ int wstart(int c, int p, int n) {
  const int s = c - p < 0 ? 0 : c - p;
  const int hi = n - (2 * p + 1);
  return s > hi ? hi : s;
}

// the first and last pixel along one axis whose windows hold ray c
__device__ __host__ __forceinline__ int plo(int c, int p) {
  return c <= 2 * p ? 0 : c - p;
}
__device__ __host__ __forceinline__ int phi(int c, int p, int n) {
  return c >= n - (2 * p + 1) ? n - 1 : c + p;
}

// One lane of a pixel-major kernel: its pixel, window and share of it.
struct PixelLane {
  int y, x;          // the pixel (clamped into the image)
  bool valid;        // the pixel is in the image
  bool writer;       // the lane that writes the pixel's results
  int sy, sx;        // window start
  int ia, ib;        // the window rows of this lane
  int tc;            // column phase: window columns tc + 4u
  int off;           // the window's first ray in the staged tile
};

// Stage the rays of the windows of the block's PTY x TXW pixel tile into
// shared memory, (g0, g1) as s01 [RH][RW] float2 and g2 as s2 [RH][RW],
// and place this thread's lane: warp w is tile row w; lane = px*4 + tc
// (TXW = 8, every window row) or th*16 + px*4 + tc (TXW = 4, window-row
// half th).
template <int TXW>
__device__ __forceinline__ PixelLane stage_rays(
    const float* __restrict__ ray, float2* s01, float* s2, int H, int W,
    int p, int RW, int bx, int by, int bz) {
  const int k1 = 2 * p + 1;
  const int y0 = by * PTY, x0 = bx * TXW;
  const int ry0 = wstart(y0, p, H), rx0 = wstart(x0, p, W);
  const int nrows = wstart(min(y0 + PTY, H) - 1, p, H) + k1 - ry0;
  const int ncols = wstart(min(x0 + TXW, W) - 1, p, W) + k1 - rx0;
  const int64_t plane = (int64_t)H * W;
  const float* rb = ray + (int64_t)bz * 3 * plane;
  for (int idx = threadIdx.x; idx < nrows * ncols; idx += NT) {
    const int rr = idx / ncols;
    const int cc = idx - rr * ncols;
    const int64_t g = (int64_t)(ry0 + rr) * W + rx0 + cc;
    s01[rr * RW + cc] = make_float2(rb[g], rb[plane + g]);
    s2[rr * RW + cc] = rb[2 * plane + g];
  }
  const int lane = threadIdx.x & 31;
  const int th = TXW == 4 ? lane >> 4 : 0;
  const int px = (lane >> 2) & (TXW - 1);
  PixelLane l;
  l.valid = y0 + (int)(threadIdx.x >> 5) < H && x0 + px < W;
  l.y = min(y0 + (int)(threadIdx.x >> 5), H - 1);
  l.x = min(x0 + px, W - 1);
  l.tc = lane & 3;
  l.writer = l.valid && th == 0 && l.tc == 0;
  l.sy = wstart(l.y, p, H);
  l.sx = wstart(l.x, p, W);
  const int h = TXW == 4 ? (k1 + 1) / 2 : k1;
  l.ia = th ? h : 0;
  l.ib = th ? k1 : h;
  l.off = (l.sy - ry0) * RW + (l.sx - rx0);
  return l;
}

// The slots of a chunk: u < FM are in the window by construction (FM is a
// compile-time bound the caller has checked for the whole chunk); a slot
// u >= FM is tested, computed on a clamped column and masked. So the
// chunk's body has no branch and its CW candidates interleave.
template <int FM>
__device__ __forceinline__ bool in_window(int u, int j, int limit) {
  return u < FM || j < limit;
}

// The logits of a chunk of window row q (columns jc + 4u) into L, masked
// slots at -1e30; returns their max.
template <int FM>
__device__ __forceinline__ float chunk_logits(
    const float2* __restrict__ q01, const float* __restrict__ q2, int jc,
    int k1, float d0, float d1, float d2, float (&L)[CW]) {
  float mi0 = -1e30f, mi1 = -1e30f;
#pragma unroll
  for (int u = 0; u < CW; ++u) {
    const int j = jc + 4 * u;
    const int jj = u < FM ? j : min(j, k1 - 1);
    const float2 g = q01[jj];
    const float logit = d0 * g.x + d1 * g.y + d2 * q2[jj];
    L[u] = in_window<FM>(u, j, k1) ? logit : -1e30f;
    if (u & 1)
      mi1 = fmaxf(mi1, L[u]);
    else
      mi0 = fmaxf(mi0, L[u]);
  }
  return fmaxf(mi0, mi1);
}

// The chunk's exps against the row's max m_new and their sums into cs
// and cx (sum of exp * col, each product rounded as the plain version
// rounds it).
__device__ __forceinline__ void chunk_sums(const float (&L)[CW],
                                           const float (&colf)[CW],
                                           float m_new, float& cs,
                                           float& cx) {
#pragma unroll
  for (int u = 0; u < CW; ++u) {
    const float pe = expf(L[u] - m_new);
    cs = cs + pe;
    cx = cx + pe * colf[u];
  }
}

// Forward. Each window row is done as the plain version does it: the
// row's max over all its columns (4 lanes, then a shuffle), m_new =
// max(m, row max), the same exps exp(logit - m_new), the row's sums, then
// s = s * alpha + psum, ey = ey * alpha + row * psum, ex = ex * alpha +
// sum exp * col; only the order inside a row's sums differs (a lane's
// columns, then the 4 lanes by shuffles). The rows run in order.
__global__ void __launch_bounds__(NT, FWD_MIN_BLOCKS)
proj_fwd_kernel(const float* __restrict__ ray, const float* __restrict__ d,
                float* __restrict__ rows, float* __restrict__ cols,
                float* __restrict__ mo, float* __restrict__ so, int H, int W,
                int p, int RH, int RW) {
  extern __shared__ float4 smem[];
  float2* s01 = reinterpret_cast<float2*>(smem);
  float* s2 = reinterpret_cast<float*>(s01 + RH * RW);
  const PixelLane l = stage_rays<FTX>(ray, s01, s2, H, W, p, RW,
                                      blockIdx.x, blockIdx.y, blockIdx.z);
  __syncthreads();
  const int k1 = 2 * p + 1;
  const int64_t plane = (int64_t)H * W;
  const int64_t px = (int64_t)l.y * W + l.x;
  const float* db = d + (int64_t)blockIdx.z * 3 * plane + px;
  const float d0 = db[0], d1 = db[plane], d2 = db[2 * plane];
  float colf[CW];
#pragma unroll
  for (int u = 0; u < CW; ++u) colf[u] = (float)(l.sx + l.tc + 4 * u);
  // all but the last slot of the first chunk in the window (p <= 21 has
  // one chunk a row)
  const bool fast = l.tc + 4 * (CW - 2) < k1;
  float m = -1e30f, s = 0.f, ey = 0.f, ex = 0.f;
  for (int i = 0; i < k1; ++i) {
    const float2* q01 = s01 + l.off + i * RW;
    const float* q2 = s2 + l.off + i * RW;
    float L[CW];
    float mi = fast ? chunk_logits<CW - 1>(q01, q2, l.tc, k1, d0, d1, d2, L)
                    : chunk_logits<0>(q01, q2, l.tc, k1, d0, d1, d2, L);
    for (int jc = l.tc + 4 * CW; jc < k1; jc += 4 * CW) {
      float Lx[CW];
      mi = fmaxf(mi, chunk_logits<0>(q01, q2, jc, k1, d0, d1, d2, Lx));
    }
    mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, 1));
    mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, 2));
    const float m_new = fmaxf(m, mi);
    const float alpha = expf(m - m_new);
    float cs = 0.f, cx = 0.f;
    chunk_sums(L, colf, m_new, cs, cx);
    for (int jc = l.tc + 4 * CW; jc < k1; jc += 4 * CW) {
      float Lx[CW], colx[CW];
      chunk_logits<0>(q01, q2, jc, k1, d0, d1, d2, Lx);
#pragma unroll
      for (int u = 0; u < CW; ++u) colx[u] = (float)(l.sx + jc + 4 * u);
      chunk_sums(Lx, colx, m_new, cs, cx);
    }
    // the row's sums over its 4 lanes; every lane adds the same two terms
    cs = cs + __shfl_xor_sync(0xffffffffu, cs, 1);
    cx = cx + __shfl_xor_sync(0xffffffffu, cx, 1);
    cs = cs + __shfl_xor_sync(0xffffffffu, cs, 2);
    cx = cx + __shfl_xor_sync(0xffffffffu, cx, 2);
    s = s * alpha + cs;
    ey = ey * alpha + (float)(l.sy + i) * cs;
    ex = ex * alpha + cx;
    m = m_new;
  }
  if (l.writer) {
    const int64_t out = (int64_t)blockIdx.z * plane + px;
    rows[out] = ey / s;
    cols[out] = ex / s;
    mo[out] = m;
    so[out] = s;
  }
}

// One chunk of dd over the lane's window rows, gx * (col - cols) of the
// chunk's columns held in registers.
template <int FM>
__device__ __forceinline__ void dd_chunk(
    const float2* __restrict__ s01, const float* __restrict__ s2, int RW,
    const PixelLane& l, int jc, int k1, float d0, float d1, float d2,
    float c0, float c1, float c2, float m, float inv_s, float ey, float ex,
    float gy, float gx, float& a0, float& a1, float& a2) {
  float gxc[CW];
#pragma unroll
  for (int u = 0; u < CW; ++u)
    gxc[u] = gx * ((float)(l.sx + jc + 4 * u) - ex);
  for (int i = l.ia; i < l.ib; ++i) {
    const float2* q01 = s01 + l.off + i * RW;
    const float* q2 = s2 + l.off + i * RW;
    const float gy_row = gy * ((float)(l.sy + i) - ey);
#pragma unroll
    for (int u = 0; u < CW; ++u) {
      const int j = jc + 4 * u;
      const int jj = u < FM ? j : min(j, k1 - 1);
      const float2 g = q01[jj];
      const float g2 = q2[jj];
      const float logit = d0 * g.x + d1 * g.y + d2 * g2;
      const float pk = expf(logit - m) * inv_s;
      float gl = pk * (gy_row + gxc[u]);
      gl = in_window<FM>(u, j, k1) ? gl : 0.f;
      a0 = fmaf(gl, g.x - c0, a0);
      a1 = fmaf(gl, g.y - c1, a1);
      a2 = fmaf(gl, g2 - c2, a2);
    }
  }
}

// dd of one 4x4 pixel tile (bx, by) of image bz: pixel-major replay of
// the window with the saved residuals
__device__ __forceinline__ void bwd_dd_tile(
    const float* __restrict__ ray, const float* __restrict__ d,
    const float* __restrict__ rows, const float* __restrict__ cols,
    const float* __restrict__ mi_, const float* __restrict__ si,
    const float* __restrict__ gyi, const float* __restrict__ gxi,
    float* __restrict__ dd, int H, int W, int p, int RH, int RW, int bx,
    int by, int bz) {
  extern __shared__ float4 smem[];
  float2* s01 = reinterpret_cast<float2*>(smem);
  float* s2 = reinterpret_cast<float*>(s01 + RH * RW);
  const PixelLane l = stage_rays<PTX>(ray, s01, s2, H, W, p, RW, bx, by, bz);
  __syncthreads();
  const int k1 = 2 * p + 1;
  const int64_t plane = (int64_t)H * W;
  const int64_t px = (int64_t)l.y * W + l.x;
  const int64_t q = (int64_t)bz * plane + px;
  const float* db = d + (int64_t)bz * 3 * plane + px;
  const float d0 = db[0], d1 = db[plane], d2 = db[2 * plane];
  const float ey = rows[q], ex = cols[q], m = mi_[q];
  const float inv_s = 1.f / si[q];
  const float gy = gyi[q], gx = gxi[q];
  const int oc = l.off + p * RW + p;   // the window's centre
  const float c0 = s01[oc].x, c1 = s01[oc].y, c2 = s2[oc];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int jc = l.tc; jc < k1; jc += 4 * CW) {
    if (jc + 4 * (CW - 2) < k1)
      dd_chunk<CW - 1>(s01, s2, RW, l, jc, k1, d0, d1, d2, c0, c1, c2, m,
                       inv_s, ey, ex, gy, gx, a0, a1, a2);
    else
      dd_chunk<0>(s01, s2, RW, l, jc, k1, d0, d1, d2, c0, c1, c2, m, inv_s,
                  ey, ex, gy, gx, a0, a1, a2);
  }
#pragma unroll
  for (int mask = 1; mask <= 16; mask <<= 1) {
    if (mask == 4 || mask == 8) continue;
    a0 = a0 + __shfl_xor_sync(0xffffffffu, a0, mask);
    a1 = a1 + __shfl_xor_sync(0xffffffffu, a1, mask);
    a2 = a2 + __shfl_xor_sync(0xffffffffu, a2, mask);
  }
  if (l.writer) {
    float* ob = dd + (int64_t)bz * 3 * plane + px;
    ob[0] = a0;
    ob[plane] = a1;
    ob[2 * plane] = a2;
  }
}

// One chunk of dray along a staged pixel row: pixel columns xc + 4u, for
// the NR rays of the lane (one column, NR consecutive rows) whose pixel
// ranges hold this row. Each staged value is read once for the NR rays.
template <int NR, int FM>
__device__ __forceinline__ void dray_chunk(
    const float4* __restrict__ qa, const float4* __restrict__ qb,
    const float* __restrict__ qe, int xc, int xhi, const float (&rv)[NR][3],
    const float (&rowc)[NR], float colc, float (&acc)[NR][3]) {
#pragma unroll
  for (int u = 0; u < CW; ++u) {
    const int x = xc + 4 * u;
    const int xx = u < FM ? x : min(x, xhi);
    const float4 A = qa[xx];
    const float4 Bv = qb[xx];
    const float gxc = Bv.z * (colc - qe[xx]);
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const float logit = A.x * rv[n][0] + A.y * rv[n][1] + A.z * rv[n][2];
      const float pk = expf(logit - A.w) * Bv.x;
      const float gy_row = Bv.y * (rowc[n] - Bv.w);
      float gl = pk * (gy_row + gxc);
      gl = in_window<FM>(u, x, xhi + 1) ? gl : 0.f;
      acc[n][0] = fmaf(gl, A.x, acc[n][0]);
      acc[n][1] = fmaf(gl, A.y, acc[n][1]);
      acc[n][2] = fmaf(gl, A.z, acc[n][2]);
    }
  }
}

// A staged pixel row y for NR rays, in chunks of CW slots.
template <int NR>
__device__ __forceinline__ void dray_row(
    const float4* qa, const float4* qb, const float* qe, int xlo, int xhi,
    int tc, const float (&rv)[NR][3], const float (&rowc)[NR], float colc,
    float (&acc)[NR][3]) {
  for (int xc = xlo + tc; xc <= xhi; xc += 4 * CW) {
    if (xc + 4 * (CW - 2) <= xhi)
      dray_chunk<NR, CW - 1>(qa, qb, qe, xc, xhi, rv, rowc, colc, acc);
    else
      dray_chunk<NR, 0>(qa, qb, qe, xc, xhi, rv, rowc, colc, acc);
  }
}

// dray of one 8x8 ray tile (bx, by) of image bz: ray-major, over the
// range of pixels whose windows hold (r, c), the pixels' values staged BAND
// rows at a time
__device__ __forceinline__ void bwd_dray_tile(
    const float* __restrict__ ray, const float* __restrict__ d,
    const float* __restrict__ rows, const float* __restrict__ cols,
    const float* __restrict__ mi_, const float* __restrict__ si,
    const float* __restrict__ gyi, const float* __restrict__ gxi,
    float* __restrict__ dray, int H, int W, int p, int PW, int bx, int by,
    int bz) {
  extern __shared__ float4 smem[];
  float4* sa = smem;                  // (d0, d1, d2, m)    [BAND][PW]
  float4* sb = sa + BAND * PW;        // (1/s, gy, gx, rows) [BAND][PW]
  float* se = reinterpret_cast<float*>(sb + BAND * PW);   // cols
  const int r0 = by * RTY, c0 = bx * RTX;
  const int lane = threadIdx.x & 31;
  const int tc = lane >> 3, rx = lane & 7;
  // the warp's two ray rows (the second may lie past the last row: it is
  // computed on the last row and not written)
  const int ra = r0 + 2 * (int)(threadIdx.x >> 5), cw = c0 + rx;
  const int c = min(cw, W - 1);
  int r[2];
  bool valid[2];
  float rv[2][3], rowc[2], acc[2][3];
  const int64_t plane = (int64_t)H * W;
  const int64_t b = bz;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    valid[n] = ra + n < H && cw < W;
    r[n] = min(ra + n, H - 1);
    const float* rb = ray + b * 3 * plane + (int64_t)r[n] * W + c;
    rv[n][0] = rb[0];
    rv[n][1] = rb[plane];
    rv[n][2] = rb[2 * plane];
    rowc[n] = (float)r[n];
    acc[n][0] = acc[n][1] = acc[n][2] = 0.f;
  }
  const int ylo0 = plo(r[0], p), yhi0 = phi(r[0], p, H);
  const int ylo1 = plo(r[1], p), yhi1 = phi(r[1], p, H);
  const int xlo = plo(c, p), xhi = phi(c, p, W);
  // the tile's pixel range
  const int Y0 = plo(r0, p), Y1 = phi(min(r0 + RTY, H) - 1, p, H);
  const int X0 = plo(c0, p), X1 = phi(min(c0 + RTX, W) - 1, p, W);
  const int ncols = X1 - X0 + 1;
  const float* D0 = d + b * 3 * plane;
  const float* D1 = D0 + plane;
  const float* D2 = D1 + plane;
  const float* EY = rows + b * plane;
  const float* EX = cols + b * plane;
  const float* M = mi_ + b * plane;
  const float* S = si + b * plane;
  const float* GY = gyi + b * plane;
  const float* GX = gxi + b * plane;
  const float colc = (float)c;
  for (int yb = Y0; yb <= Y1; yb += BAND) {
    const int nb = min(BAND, Y1 - yb + 1);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * ncols; idx += NT) {
      const int rr = idx / ncols;
      const int cc = idx - rr * ncols;
      const int64_t q = (int64_t)(yb + rr) * W + X0 + cc;
      sa[rr * PW + cc] = make_float4(D0[q], D1[q], D2[q], M[q]);
      sb[rr * PW + cc] = make_float4(1.f / S[q], GY[q], GX[q], EY[q]);
      se[rr * PW + cc] = EX[q];
    }
    __syncthreads();
    // the warp's rows: ylo0 <= ylo1 and yhi0 <= yhi1; which of the two
    // rays a row feeds is the same for the whole warp
    const int ya = max(yb, ylo0), yz = min(yb + nb - 1, yhi1);
    for (int y = ya; y <= yz; ++y) {
      const int o = (y - yb) * PW - X0;
      const bool in0 = y <= yhi0, in1 = y >= ylo1;
      if (in0 && in1) {
        dray_row<2>(sa + o, sb + o, se + o, xlo, xhi, tc, rv, rowc, colc,
                    acc);
      } else {
        // one of the two rays, chosen by selects (no indexing by a runtime
        // value, which would put the arrays in local memory)
        float rv1[1][3], rowc1[1] = {in0 ? rowc[0] : rowc[1]}, acc1[1][3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          rv1[0][k] = in0 ? rv[0][k] : rv[1][k];
          acc1[0][k] = in0 ? acc[0][k] : acc[1][k];
        }
        dray_row<1>(sa + o, sb + o, se + o, xlo, xhi, tc, rv1, rowc1, colc,
                    acc1);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          acc[0][k] = in0 ? acc1[0][k] : acc[0][k];
          acc[1][k] = in0 ? acc[1][k] : acc1[0][k];
        }
      }
    }
  }
  // the 4 column lanes of each ray: lane bits 3 and 4
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      acc[n][k] = acc[n][k] + __shfl_xor_sync(0xffffffffu, acc[n][k], 8);
      acc[n][k] = acc[n][k] + __shfl_xor_sync(0xffffffffu, acc[n][k], 16);
    }
    if (valid[n] && tc == 0) {
      float* ob = dray + b * 3 * plane + (int64_t)r[n] * W + c;
      ob[0] = acc[n][0];
      ob[plane] = acc[n][1];
      ob[2 * plane] = acc[n][2];
    }
  }
}

// The backward: one launch whose first n_dray blocks each take a dray
// ray tile and whose other blocks each take a dd pixel tile (dray's, whose
// work varies near the borders, first; dd's, all alike, fill in behind).
__global__ void __launch_bounds__(NT, BWD_MIN_BLOCKS)
proj_bwd_kernel(const float* __restrict__ ray, const float* __restrict__ d,
                const float* __restrict__ rows,
                const float* __restrict__ cols,
                const float* __restrict__ mi_, const float* __restrict__ si,
                const float* __restrict__ gyi,
                const float* __restrict__ gxi, float* __restrict__ dray,
                float* __restrict__ dd, int H, int W, int p, int RH, int RW,
                int PW, int n_dray) {
  const int t = blockIdx.x;
  if (t < n_dray) {
    const int tx = (W + RTX - 1) / RTX, ty = (H + RTY - 1) / RTY;
    bwd_dray_tile(ray, d, rows, cols, mi_, si, gyi, gxi, dray, H, W, p, PW,
                  t % tx, (t / tx) % ty, t / (tx * ty));
  } else {
    const int u = t - n_dray;
    const int tx = (W + PTX - 1) / PTX, ty = (H + PTY - 1) / PTY;
    bwd_dd_tile(ray, d, rows, cols, mi_, si, gyi, gxi, dd, H, W, p, RH, RW,
                u % tx, (u / tx) % ty, u / (tx * ty));
  }
}

struct Layout {
  int RH;                  // staged ray rows (forward and dd)
  int RWF, fwd_bytes;      // forward's staged ray row stride, bytes
  int RW, ray_bytes;       // dd's (padded for its two row halves), bytes
  int PW, pix_bytes;       // dray's staged pixel band
};

// The staged extents and their bytes; false when the arguments are refused.
bool layout(int B, int H, int W, int p, Layout* L) {
  const int k1 = 2 * p + 1;
  if (B <= 0 || B > 65535 || p < 0 || H < k1 || W < k1) return false;
  L->RH = PTY - 1 + k1 < H ? PTY - 1 + k1 : H;
  L->RWF = FTX - 1 + k1 < W ? FTX - 1 + k1 : W;
  const int ncols = PTX - 1 + k1 < W ? PTX - 1 + k1 : W;
  // pad dd's row stride so that the two row halves' loads (h rows apart)
  // fall in distinct banks: (h * RW) mod 32 in [7, 25]
  const int h = (k1 + 1) / 2;
  L->RW = ncols;
  for (int rw = ncols; rw < ncols + 32; ++rw) {
    const int bank = (h * rw) % 32;
    if (bank >= 7 && bank <= 25) {
      L->RW = rw;
      break;
    }
  }
  const long long fwd_bytes = (long long)L->RH * L->RWF * 12;
  const long long ray_bytes = (long long)L->RH * L->RW * 12;
  // the widest pixel range of a dray tile
  int pw = 0;
  for (int c0 = 0; c0 < W; c0 += RTX) {
    const int c1 = c0 + RTX < W ? c0 + RTX - 1 : W - 1;
    const int n = phi(c1, p, W) - plo(c0, p) + 1;
    pw = n > pw ? n : pw;
  }
  L->PW = pw;
  const long long pix_bytes = (long long)BAND * pw * 36;
  if (fwd_bytes > MAX_SMEM || ray_bytes > MAX_SMEM || pix_bytes > MAX_SMEM)
    return false;
  L->fwd_bytes = (int)fwd_bytes;
  L->ray_bytes = (int)ray_bytes;
  L->pix_bytes = (int)pix_bytes;
  return true;
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct BwdArgs {
  const float *ray, *d, *rows, *cols, *m, *s, *gy, *gx;
  float *dray, *dd;
};

// The backward launch with dray's tiles, dd's, or both.
int launch_bwd(const BwdArgs& a, int B, int H, int W, int p,
               const Layout& L, bool with_dray, bool with_dd,
               cudaStream_t st) {
  const int bytes = L.ray_bytes > L.pix_bytes ? L.ray_bytes : L.pix_bytes;
  const int e = allow_smem(proj_bwd_kernel, bytes);
  if (e) return e;
  const long long n_dray = with_dray ? (long long)((W + RTX - 1) / RTX) *
                                           ((H + RTY - 1) / RTY) * B : 0;
  const long long n_dd = with_dd ? (long long)((W + PTX - 1) / PTX) *
                                       ((H + PTY - 1) / PTY) * B : 0;
  if (n_dray + n_dd > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  proj_bwd_kernel<<<(unsigned)(n_dray + n_dd), NT, bytes, st>>>(
      a.ray, a.d, a.rows, a.cols, a.m, a.s, a.gy, a.gx, a.dray, a.dd, H, W,
      p, L.RH, L.RW, L.PW, (int)n_dray);
  return (int)cudaGetLastError();
}

BwdArgs bwd_args(const void* ray, const void* d, const void* rows,
                 const void* cols, const void* m, const void* s,
                 const void* gy, const void* gx, void* dray, void* dd) {
  return {static_cast<const float*>(ray), static_cast<const float*>(d),
          static_cast<const float*>(rows), static_cast<const float*>(cols),
          static_cast<const float*>(m),    static_cast<const float*>(s),
          static_cast<const float*>(gy),   static_cast<const float*>(gx),
          static_cast<float*>(dray),       static_cast<float*>(dd)};
}

}  // namespace

// ray, d: [B,3,H,W] fp32; rows, cols, m, s: [B,H,W] fp32. Returns 0 on a
// successful launch.
extern "C" int generic_projection_fwd(const void* ray, const void* d,
                                      void* rows, void* cols, void* m,
                                      void* s, int B, int H, int W, int p,
                                      void* stream) {
  Layout L;
  if (!layout(B, H, W, p, &L)) return (int)cudaErrorInvalidValue;
  int e = allow_smem(proj_fwd_kernel, L.fwd_bytes);
  if (e) return e;
  const dim3 grid((W + FTX - 1) / FTX, (H + PTY - 1) / PTY, B);
  proj_fwd_kernel<<<grid, NT, L.fwd_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ray), static_cast<const float*>(d),
      static_cast<float*>(rows), static_cast<float*>(cols),
      static_cast<float*>(m), static_cast<float*>(s), H, W, p, L.RH, L.RWF);
  return (int)cudaGetLastError();
}

// The residuals as the forward gave them, gy, gx: [B,H,W] fp32; dray, dd:
// [B,3,H,W] fp32, every element written. One launch (dray's tiles, then
// dd's). Returns 0 when it launched.
extern "C" int generic_projection_bwd(const void* ray, const void* d,
                                      const void* rows, const void* cols,
                                      const void* m, const void* s,
                                      const void* gy, const void* gx,
                                      void* dray, void* dd, int B, int H,
                                      int W, int p, void* stream) {
  Layout L;
  if (!layout(B, H, W, p, &L)) return (int)cudaErrorInvalidValue;
  return launch_bwd(bwd_args(ray, d, rows, cols, m, s, gy, gx, dray, dd), B,
                    H, W, p, L, true, true, static_cast<cudaStream_t>(stream));
}

// The backward's two halves one at a time, with generic_projection_bwd's
// arguments: dd alone (dray untouched) and dray alone (dd untouched).
extern "C" int generic_projection_bwd_dd(const void* ray, const void* d,
                                         const void* rows, const void* cols,
                                         const void* m, const void* s,
                                         const void* gy, const void* gx,
                                         void* dray, void* dd, int B, int H,
                                         int W, int p, void* stream) {
  Layout L;
  if (!layout(B, H, W, p, &L)) return (int)cudaErrorInvalidValue;
  return launch_bwd(bwd_args(ray, d, rows, cols, m, s, gy, gx, dray, dd), B,
                    H, W, p, L, false, true,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int generic_projection_bwd_dray(const void* ray, const void* d,
                                           const void* rows,
                                           const void* cols, const void* m,
                                           const void* s, const void* gy,
                                           const void* gx, void* dray,
                                           void* dd, int B, int H, int W,
                                           int p, void* stream) {
  Layout L;
  if (!layout(B, H, W, p, &L)) return (int)cudaErrorInvalidValue;
  return launch_bwd(bwd_args(ray, d, rows, cols, m, s, gy, gx, dray, dd), B,
                    H, W, p, L, true, false,
                    static_cast<cudaStream_t>(stream));
}

// Resident blocks an SM of the forward and the backward kernels at (H, W,
// p) into out[0..1], and the dynamic shared memory bytes of the forward's
// and dd's ray tiles and of dray's pixel band into out[2..4]. Returns 0 on
// success.
extern "C" int generic_projection_occupancy(int H, int W, int p, int* out) {
  Layout L;
  if (!layout(1, H, W, p, &L)) return (int)cudaErrorInvalidValue;
  const int bwd_bytes = L.ray_bytes > L.pix_bytes ? L.ray_bytes : L.pix_bytes;
  int e = allow_smem(proj_fwd_kernel, L.fwd_bytes);
  if (!e) e = allow_smem(proj_bwd_kernel, bwd_bytes);
  if (!e)
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], proj_fwd_kernel, NT, L.fwd_bytes);
  if (!e)
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], proj_bwd_kernel, NT, bwd_bytes);
  out[2] = L.fwd_bytes;
  out[3] = L.ray_bytes;
  out[4] = L.pix_bytes;
  return e;
}
