"""
Lane-gather probes: the port's counterparts of the two Pallas kernels of
the JAX package's scripts/bench_dynamic_gather.py, which probe Mosaic's
`dynamic_gather`, the primitive under the TPU warp:

    lane_gather(x [S,L] f32, idx [S,L] i32 in [0, L)) -> x[s, idx[s, j]]
        (`_gather_kernel`, take_along_axis along the lanes)
    lane_gather_loop(x [S,512] f32, idx [S,512] i32 in [0, 128), n) -> [S,128]
        out[s, j] = sum_{i<n} x[s, 128*(i%4) + idx[s, 128*(i%4) + j]],
        summed in the order i = 0 .. n-1 (`_loop_kernel`)

The hand-written Hopper kernels are `packnet_sfm_tpu_torch/csrc/lane_gather.cu`
(their note gives the bounds). On a CPU tensor each wrapper runs its plain
version; there is no other fall back. Each counts its kernel launches in
`<wrapper>.launches`.
"""

import torch

from packnet_sfm_tpu_torch.ops.kernels import build

CHUNK = 128
ROW = 4 * CHUNK


def lane_gather_reference(x, idx):
    """Plain PyTorch version: advanced indexing along the rows."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx.long()]


def lane_gather_loop_reference(x, idx, n_gathers):
    """Plain PyTorch version: the four chunk gathers, then their sum over
    i = 0 .. n-1 in that order (a gather does no arithmetic, so gathering
    each chunk once gives the same sum)."""
    chunks = [lane_gather_reference(x[:, c * CHUNK:(c + 1) * CHUNK],
                                    idx[:, c * CHUNK:(c + 1) * CHUNK])
              for c in range(4)]
    acc = torch.zeros_like(chunks[0])
    for i in range(n_gathers):
        acc = acc + chunks[i % 4]
    return acc


def _check(x, idx, width=None):
    if x.dim() != 2 or tuple(idx.shape) != tuple(x.shape):
        raise ValueError('lane gather expects x and idx [S, L] of one shape, '
                         'got {} and {}'.format(tuple(x.shape),
                                                tuple(idx.shape)))
    if width is not None and x.shape[1] != width:
        raise ValueError('the loop probe takes [S, {}] rows, got {}'.format(
            width, tuple(x.shape)))
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError('lane gather takes float32 x and int32 idx, got {} '
                        'and {}'.format(x.dtype, idx.dtype))


def _launch(symbol, x, idx, out, n):
    """Launch csrc/lane_gather.cu's `symbol`; raises on anything it does not
    take."""
    if not (x.is_cuda and idx.is_cuda) or x.device != idx.device:
        raise ValueError('the lane-gather kernels need CUDA tensors on one '
                         'device')
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError('the lane-gather kernels need contiguous tensors')
    fn = build.function('lane_gather', symbol, 3, 2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], n,
                stream)
    if rc != 0:
        raise RuntimeError('{} launch failed: cudaError {}'.format(symbol, rc))
    return out


def lane_gather(x, idx):
    """x[s, idx[s, j]] for x [S, L] float32 and idx [S, L] int32 in [0, L).
    CUDA tensors go to the Hopper kernel (counted in
    `lane_gather.launches`), CPU tensors to `lane_gather_reference`."""
    _check(x, idx)
    if x.device.type == 'cpu':
        return lane_gather_reference(x, idx)
    out = _launch('lane_gather', x, idx, torch.empty_like(x), x.shape[1])
    lane_gather.launches += 1
    return out


lane_gather.launches = 0


def lane_gather_loop(x, idx, n_gathers):
    """[S, 128]: the sum of `n_gathers` 128-lane chunk gathers of x [S, 512]
    float32 by idx [S, 512] int32 in [0, 128), chunk i % 4 at step i, in the
    order i = 0 .. n-1. CUDA tensors go to the Hopper kernel (counted in
    `lane_gather_loop.launches`), CPU tensors to
    `lane_gather_loop_reference`."""
    _check(x, idx, ROW)
    if n_gathers < 0:
        raise ValueError('n_gathers must be >= 0, got {}'.format(n_gathers))
    if x.device.type == 'cpu':
        return lane_gather_loop_reference(x, idx, n_gathers)
    out = torch.empty((x.shape[0], CHUNK), dtype=x.dtype, device=x.device)
    _launch('lane_gather_loop', x, idx, out, n_gathers)
    lane_gather_loop.launches += 1
    return out


lane_gather_loop.launches = 0
