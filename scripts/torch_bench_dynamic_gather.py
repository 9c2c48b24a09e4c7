#!/usr/bin/env python3
"""
Lane-gather probe of the PyTorch port: the counterpart of
scripts/bench_dynamic_gather.py, on the port's Hopper kernels
(packnet_sfm_tpu_torch/ops/kernels/lane_gather.py).

    python3 scripts/torch_bench_dynamic_gather.py [--device cpu] [--iters 200]

It asks the questions of the JAX probe:
1. semantics: does the row gather give take_along_axis(x, idx, axis=1) with
   global indices at [8,128], [8,256], [8,640], [16,128] and [32,128]?
2. throughput: the loop of 512 chunk gathers at S = 8 and S = 32, in
   us/call, ns/gather-op and ns/idx.
On the card the loop is timed with CUDA events over `--iters` launches
issued one by one through the wrapper (what a caller pays, host issue
included: 'us_per_call'); both kernels are also timed at each of their
shapes in a CUDA graph of the kernel's launches, replayed (the device's
time: 'graph_us'). A graph's launches do not go through the wrapper and
are not in its launch count. With --device cpu the plain versions run, the
times are the host's clock and there is no device number. Prints one JSON
line of the results last.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEMANTIC_SHAPES = ((8, 128), (8, 256), (8, 640), (16, 128), (32, 128))
THROUGHPUT = ((8, 512), (32, 512))      # (S, n_gathers)
GRAPH_WARMUP, GRAPH_CALLS = 3, 100     # calls before and in a timed graph


def _time_ms(fn, iters, device):
    import torch
    fn()
    if device.type == 'cuda':
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def graph_time_ms(fn, n=GRAPH_CALLS, reps=5):
    """Device time of one call of `fn` on the card: GRAPH_WARMUP calls on
    a side stream, then n calls captured in a CUDA graph, the graph
    replayed `reps` times between CUDA events. No host issue cost; about a
    microsecond of gap between graph nodes remains."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(GRAPH_WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def inputs(S, L, hi, device):
    """The probe's x [S, L] float32 and idx [S, L] int32 in [0, hi), from
    numpy seed 0."""
    import torch
    rng = np.random.RandomState(0)
    x = rng.randn(S, L).astype(np.float32)
    idx = rng.randint(0, hi, size=(S, L)).astype(np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(idx).to(device)


def kernel_graph_us(symbol, x, idx, out, n):
    """Device time of one launch of lane_gather.cu's `symbol`, in us, from
    a CUDA graph of its launches (the wrapper's launch count stays)."""
    from packnet_sfm_tpu_torch.ops.kernels.lane_gather import _launch
    return graph_time_ms(lambda: _launch(symbol, x, idx, out, n)) * 1e3


def check_semantics(S, L, device):
    """{'S', 'L', 'ok'}: ok when lane_gather gives np.take_along_axis
    exactly; on the card also the kernel's 'graph_us'."""
    import torch
    from packnet_sfm_tpu_torch.ops.kernels.lane_gather import lane_gather
    x, idx = inputs(S, L, L, device)
    got = lane_gather(x, idx).cpu().numpy()
    ok = np.array_equal(got, np.take_along_axis(x.cpu().numpy(),
                                                idx.cpu().numpy(), axis=1))
    row = {'S': S, 'L': L, 'ok': ok}
    if device.type == 'cuda':
        row['graph_us'] = kernel_graph_us('lane_gather', x, idx,
                                          torch.empty_like(x), L)
    print('[{}x{}] {}{}'.format(
        S, L, 'OK (global indices correct)' if ok else
        'WRONG vs global take_along_axis',
        '; {:.3f} us a launch in a CUDA graph'.format(row['graph_us'])
        if 'graph_us' in row else ''))
    return row


def bench_throughput(S, n_gathers, iters, device):
    """us per call of the loop probe, per gather-op and per index."""
    import torch
    from packnet_sfm_tpu_torch.ops.kernels.lane_gather import (
        lane_gather_loop)
    x, idx = inputs(S, 512, 128, device)
    call = lambda: lane_gather_loop(x, idx, n_gathers)  # noqa: E731
    row = {'S': S, 'n_gathers': n_gathers,
           'us_per_call': _time_ms(call, iters, device) * 1e3}
    if device.type == 'cuda':
        row['graph_us'] = kernel_graph_us(
            'lane_gather_loop', x, idx,
            torch.empty(S, 128, device=device), n_gathers)
    us = row.get('graph_us', row['us_per_call'])
    row['ns_per_gather_op'] = us * 1e3 / n_gathers
    row['ns_per_idx'] = us * 1e3 / (n_gathers * S * 128)
    print('loop probe [{}x128 gathers x{}]: {:.2f} us/call ({}) -> {:.2f} '
          'ns/gather-op, {:.4f} ns/idx'.format(
              S, n_gathers, us, 'in a CUDA graph; {:.2f} issued one by one'
              .format(row['us_per_call']) if 'graph_us' in row
              else 'host clock', row['ns_per_gather_op'], row['ns_per_idx']))
    return row


def run(device='cuda', iters=200):
    """Both questions on `device`; returns {'device', 'semantics' (a row a
    shape), 'throughput' (a row a shape)}. Raises when the card is asked
    for and absent. Through the wrappers it launches the gather once a
    semantic shape and the loop 1 + iters times a throughput shape."""
    sys.path.insert(0, ROOT)
    import torch
    from packnet_sfm_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'
    print('device:', name)
    semantics = [check_semantics(S, L, dev) for S, L in SEMANTIC_SHAPES]
    throughput = []
    if semantics[0]['ok']:
        throughput = [bench_throughput(S, n, iters, dev)
                      for S, n in THROUGHPUT]
    return {'device': name, 'semantics': semantics, 'throughput': throughput}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--iters', type=int, default=200)
    args = ap.parse_args()
    result = run(args.device, args.iters)
    print(json.dumps(result))
    return 0 if all(r['ok'] for r in result['semantics']) else 1


if __name__ == '__main__':
    sys.exit(main())
