// Lane-gather probes for Hopper (sm_90a): a row gather and a loop of
// 128-lane chunk gathers summed in order.
//
//   lane_gather:       out[s, j] = x[s, idx[s, j]]
//                      x [S, L] fp32, idx [S, L] int32 in [0, L), out [S, L]
//   lane_gather_loop:  out[s, j] = sum_{i < n} x[s, c + idx[s, c + j]],
//                      c = 128 (i % 4),
//                      x [S, 512] fp32, idx [S, 512] int32 in [0, 128),
//                      out [S, 128], summed in the order i = 0 .. n-1
//
// Replace the microbenchmark kernels of scripts/bench_dynamic_gather.py,
// `_gather_kernel` (pallas_call at :28) and `_loop_kernel` (pallas_call at
// :78), which probe Mosaic's `dynamic_gather` (take_along_axis on the lanes
// of a vreg), the primitive under the TPU warp. On Hopper a gather is a
// plain indexed load.
//
// What bounds them on this card:
// - gather: bytes. x and idx read once, out written once: 12 S L bytes,
//   61,440 B at [8, 640], 0.018 us at 3.35 TB/s; a launch costs far more,
//   so the probe measures launch latency as much as the gather.
// - loop: the n S 128 fp32 adds, one instruction each, at 132 SMs x 128
//   lanes x 1.98 GHz (3.35e13 adds/s): 0.016 us at S = 8, n = 512, 0.063
//   us at S = 32. The function needs one load of each of an output's four
//   chunk values, not n: a gather does no arithmetic, so the TPU kernel's
//   n `dynamic_gather`s of four distinct values are four reads here.
//   Device-memory traffic is S x 4.5 KB.
//
// Design (first, simple versions):
// - gather: one thread per output, 256 a block; consecutive threads take
//   consecutive outputs, so the idx reads and the out writes are coalesced;
//   the x reads hit one row's 4 S L bytes, which L1 holds.
// - loop: one block of 128 threads per row; each thread reads its four
//   chunk indices and the four x values they pick (L1 holds the row's 2 KB)
//   into registers, then adds value i % 4 at step i for i = 0 .. n-1, so the
//   result equals the plain version bit for bit. The n adds of an output
//   form one dependent chain, ~4 clocks each (~1 us at n = 512), which no
//   order-keeping design shortens.
//
// An index outside its range is not read: the output there is NaN.
//
// C entry points (ctypes): each returns cudaGetLastError() right after the
// launch, or cudaErrorInvalidValue for arguments it does not take. Each
// launches on the given stream, allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int CHUNK = 128;
constexpr int CHUNKS = 4;
constexpr int ROW = CHUNK * CHUNKS;

__global__ void __launch_bounds__(NT)
gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
              float* __restrict__ out, int L, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const int j = idx[i];
  const int64_t row = i - i % L;
  out[i] = (unsigned)j < (unsigned)L ? x[row + j] : NAN;
}

__global__ void __launch_bounds__(CHUNK)
gather_loop_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int n_gathers) {
  const int64_t row = (int64_t)blockIdx.x * ROW;
  const int j = threadIdx.x;
  float v[CHUNKS];
  bool ok = true;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int k = idx[row + c * CHUNK + j];
    const bool in = (unsigned)k < (unsigned)CHUNK;
    v[c] = in ? x[row + c * CHUNK + k] : 0.0f;
    ok = ok && in;
  }
  float acc = 0.0f;
  int i = 0;
  for (; i + CHUNKS <= n_gathers; i += CHUNKS) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) acc = acc + v[c];
  }
#pragma unroll
  for (int c = 0; c < CHUNKS - 1; ++c)
    if (i + c < n_gathers) acc = acc + v[c];
  out[row / CHUNKS + j] = ok ? acc : NAN;
}

}  // namespace

extern "C" int lane_gather(const float* x, const int* idx, float* out,
                           int S, int L, void* stream) {
  if (S < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)S * L;
  const int64_t blocks = (n + NT - 1) / NT;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      x, idx, out, L, n);
  return (int)cudaGetLastError();
}

extern "C" int lane_gather_loop(const float* x, const int* idx, float* out,
                                int S, int n_gathers, void* stream) {
  if (S < 1 || S > 0x7fffffff / ROW || n_gathers < 0)
    return (int)cudaErrorInvalidValue;
  gather_loop_kernel<<<S, CHUNK, 0, (cudaStream_t)stream>>>(
      x, idx, out, n_gathers);
  return (int)cudaGetLastError();
}
