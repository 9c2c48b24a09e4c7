#!/usr/bin/env python3
"""
Design study of the lane-gather loop kernel on one CUDA card: the shipped
kernel (packnet_sfm_tpu_torch/csrc/lane_gather.cu, four loads an output,
then n adds in order) beside two designs that load from shared memory at
every one of the n steps, as the TPU kernel gathers at every step:

- `chain`: one volatile shared-memory load, then one add, n times;
- `group16`: 16 volatile loads issued back to back, then their 16 adds.

    python3 scripts/torch_lane_gather_designs.py

Each design is checked bit-equal to the plain version, then timed at the
probe's throughput shapes (S = 8 and 32, n = 512) in a CUDA graph (device
time, no host issue; scripts/torch_bench_dynamic_gather.py
`graph_time_ms`). Prints one JSON line last.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

template <int GROUP>
__global__ void __launch_bounds__(128)
loop_kernel(const float* __restrict__ x, const int* __restrict__ idx,
            float* __restrict__ out, int n) {
  __shared__ float xs[512];
  const int64_t row = (int64_t)blockIdx.x * 512;
  const int j = threadIdx.x;
  int off[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    xs[c * 128 + j] = x[row + c * 128 + j];
    off[c] = c * 128 + idx[row + c * 128 + j];
  }
  __syncthreads();
  const volatile float* g = xs;
  float acc = 0.0f;
  int i = 0;
  for (; i + GROUP <= n; i += GROUP) {
    float v[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      v[k] = g[off[(GROUP % 4 == 0 ? k : i + k) % 4]];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) acc = acc + v[k];
  }
  for (; i < n; ++i) acc = acc + g[off[i % 4]];
  out[row / 4 + j] = acc;
}

extern "C" int chain(const float* x, const int* idx, float* out, int S,
                     int n, void* stream) {
  loop_kernel<1><<<S, 128, 0, (cudaStream_t)stream>>>(x, idx, out, n);
  return (int)cudaGetLastError();
}

extern "C" int group16(const float* x, const int* idx, float* out, int S,
                       int n, void* stream) {
  loop_kernel<16><<<S, 128, 0, (cudaStream_t)stream>>>(x, idx, out, n);
  return (int)cudaGetLastError();
}
'''


def build_designs():
    """Compile SOURCE with the port's flags into build/kernels/; returns
    the ctypes library."""
    from packnet_sfm_tpu_torch.ops.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / 'lane_gather_designs.cu'
    lib = build.BUILD_DIR / 'lane_gather_designs.so'
    src.write_text(SOURCE)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, '-o', str(lib),
                    str(src)], check=True)
    return ctypes.CDLL(str(lib))


def main():
    import torch
    if not torch.cuda.is_available():
        print('torch_lane_gather_designs: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, 'scripts'))
    from packnet_sfm_tpu_torch.ops.kernels import lane_gather as lg
    from torch_bench_dynamic_gather import THROUGHPUT, graph_time_ms, inputs

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    lib = build_designs()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    designs = {}
    for name in ('chain', 'group16'):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        designs[name] = fn
    rows = []
    for S, n in THROUGHPUT:
        x, idx = inputs(S, 512, 128, 'cuda')
        want = lg.lane_gather_loop_reference(x, idx, n)
        out = torch.empty(S, 128, device='cuda')

        def shipped():      # the raw launch raises on a failed launch
            lg._launch('lane_gather_loop', x, idx, out, n)
            return 0

        calls = {'shipped': shipped}
        for name, fn in designs.items():
            calls[name] = (lambda fn=fn: fn(x.data_ptr(), idx.data_ptr(),
                                            out.data_ptr(), S, n, stream()))
        row = {'S': S, 'n_gathers': n}
        for name, call in calls.items():
            out.fill_(float('nan'))
            if call() != 0:
                raise RuntimeError('{} launch failed'.format(name))
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError('{} differs from the plain version at '
                                     'S={}'.format(name, S))
            row[name + '_us'] = graph_time_ms(call) * 1e3
        rows.append(row)
        print('S={} n={}: {} (us a call in a CUDA graph, all bit-equal)'
              .format(S, n, ', '.join('{} {:.3f}'.format(k[:-3], v)
                                      for k, v in row.items()
                                      if k.endswith('_us'))))
    print(card)
    print(json.dumps({'card': card, 'rows': rows}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
