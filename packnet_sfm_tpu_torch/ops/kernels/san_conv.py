"""
Block-sparse masked conv under the SAN LiDAR branch, and its gradient:

    out = (conv_same(x, kernel) + bias) * mask

x [B,H,W,Cin] NHWC, mask [B,H,W,1], kernel [k,k,Cin,Cout] HWIO (k in
{3,5}), bias [Cout]; 'SAME' padding is k//2 zeros per side.

Two hand-written Hopper kernels in `packnet_sfm_tpu_torch/csrc/san_conv.cu`:
- `masked_conv2d`, the forward. It replaces the JAX package's Pallas kernel
  (ops/pallas/san_conv.py `_conv_kernel` / `masked_conv2d_pallas`).
- `masked_conv2d_dgrad`, the input gradient
  dx = conv_same(gm, flip(kernel, (0,1)) with I/O swapped), gm = g * mask,
  read from the forward's own kernel at the flipped tap (no copy). It
  replaces the dx half of `_mc_bwd`, which reused the same Pallas call. dx
  is not masked: it is nonzero in the halo around active sites.

The kernels' source note gives their bound on the H100 and their design:
tiles with no active site (for dx: none within the halo) are written as
exact zeros and skip their math, which is the work projected LiDAR lets a
kernel skip above the horizon. `plan` picks each launch's path from dtype
and shape: bf16 with both channel counts multiples of 8 goes to the
tensor cores (an implicit GEMM on mma.sync; tile, output-channel block and
split of K by shape), float32 and Cin = 1 to the CUDA cores. Where K is
split, the wrapper allocates the fp32 workspace of the partials and
launches the reduction that sums them in a fixed order (the C entry points
allocate nothing). On a CPU tensor each wrapper runs its plain version
(`masked_conv2d_reference`, `masked_conv2d_dgrad_reference`); on a CUDA
tensor it launches the kernel or raises: there is no other fall back. Each
wrapper counts its conv launches in its own `launches` attribute, one a
call, and the split-K reductions apart in `reduce_launches`.

`masked_conv2d_fn` is the differentiable op (`MaskedConv2dFunction`, the
counterpart of the JAX `masked_conv2d` custom VJP): forward through
`masked_conv2d`, dx through `masked_conv2d_dgrad`, and dW / db as PyTorch
calls (`filter_grad`, a cuDNN filter gradient over float32 copies, and a
sum), as the JAX package leaves them to XLA outside any Pallas kernel. The
backward returns the primal dtype, as `_mc_bwd` does; dW is one rounding
of a float32 sum, as the TPU computes it.
"""

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from packnet_sfm_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def masked_conv2d_reference(x, mask, kernel, bias):
    """Plain PyTorch version: F.conv2d on the zero-padded NCHW view, + bias,
    times mask. Accumulates in fp32 and returns x's dtype (the kernel's
    arithmetic). Used by the CPU path and to check the kernel."""
    p = kernel.shape[0] // 2
    xc = F.pad(x.permute(0, 3, 1, 2).float(), (p, p, p, p))
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1).float(), bias.float())
    return (y.permute(0, 2, 3, 1) * mask.float()).to(x.dtype)


def masked_conv2d_dgrad_reference(gm, mask, kernel):
    """Plain PyTorch version of dx: the 'SAME' conv of gm [B,H,W,Cout] with
    the kernel flipped in both spatial axes and I/O swapped, in fp32,
    rounded once to gm's dtype. `mask` is unused: it only lets the kernel
    skip tiles, and gm is already zero wherever it is 0."""
    p = kernel.shape[0] // 2
    g = F.pad(gm.permute(0, 3, 1, 2).float(), (p, p, p, p))
    # flipped HWIO [k,k,Cin,Cout] -> OIHW of the transposed conv [Cin,Cout,k,k]
    w = kernel.flip((0, 1)).permute(2, 3, 0, 1).float()
    return F.conv2d(g, w).permute(0, 2, 3, 1).to(gm.dtype)


def _check(data, mask, kernel, channels):
    """Shapes both directions take: data [B,H,W,C] (x, or gm for dx), mask
    [B,H,W,1], kernel [k,k,Cin,Cout] with k in (3, 5); `channels` holds the
    (data channels, kernel channels) pairs that must agree."""
    if data.dim() != 4 or mask.dim() != 4 or kernel.dim() != 4:
        raise ValueError('masked_conv2d expects data [B,H,W,C], mask '
                         '[B,H,W,1], kernel [k,k,Cin,Cout]')
    k, k2 = kernel.shape[:2]
    if k != k2 or k not in (3, 5):
        raise ValueError('kernel must be k x k with k in (3, 5), got '
                         '{}'.format(tuple(kernel.shape)))
    if any(a != b for a, b in channels):
        raise ValueError('channel mismatch: data {}, kernel {}'.format(
            tuple(data.shape), tuple(kernel.shape)))
    if tuple(mask.shape) != tuple(data.shape[:3]) + (1,):
        raise ValueError('mask must be [B,H,W,1], got {}'.format(
            tuple(mask.shape)))


def _check_launch(name, x, mask, weights):
    """What both kernels take: CUDA tensors on one device, fp32 or bf16
    data and weights of one dtype, an fp32 mask, contiguous memory."""
    tensors = (x, mask) + tuple(weights)
    if not all(t.is_cuda for t in tensors):
        raise ValueError('the {} kernel needs CUDA tensors'.format(name))
    if len({t.device for t in tensors}) != 1:
        raise ValueError('{} inputs lie on different devices'.format(name))
    if x.dtype not in _DTYPES:
        raise TypeError('{} takes float32 or bfloat16, got {}'.format(
            name, x.dtype))
    if any(t.dtype != x.dtype for t in weights):
        raise TypeError('{}: weights must have the dtype of the data'
                        .format(name))
    if mask.dtype != torch.float32:
        raise TypeError('mask must be float32, got {}'.format(mask.dtype))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('{} needs contiguous tensors'.format(name))


# The tensor-core path (csrc/san_conv.cu, namespace tc): tiles of the same
# tile_h x tile_w output pixels of tile_n images, largest first (the 8-wide
# ones for k = 3 only); 128 or 64 output channels a block; input channels
# in chunks of 32
TC_TILES = ((8, 16, 1), (8, 8, 2), (4, 8, 4), (4, 16, 1), (8, 8, 1),
            (4, 8, 1))
TC_CK = 32


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(B, H, W, kc, nc, k, dtype, n_sm=132):
    """(path, (tile_h, tile_w, tile_n), block_n, splits) of one launch: kc
    / nc are the channels the kernel reads and writes (forward Cin, Cout;
    dgrad Cout, Cin), k the kernel size.

    'cuda-core' (tile (0, 0, 0)) for float32 and for channel counts that
    are not multiples of 8 (Cin = 1). Else the tensor cores: the largest
    tile of those that compute the fewest pixels outside the batch (the
    4x8 one only where it alone computes fewer: a block of fewer pixels
    rereads the weights more often), 128 output channels a block where nc
    allows, else 64; then, where the grid has fewer than 1.5 blocks an
    SM, K split over ranges of 32-channel chunks ('split-K') to about 2
    blocks an SM. These choices are the fastest or close to it at the
    slices' shapes (scripts/torch_san_conv_levels.py --plans times every
    plan), where splitting a fuller grid costs more in the pass over the
    fp32 partials than it gains."""
    if dtype != torch.bfloat16 or kc % 8 or nc % 8:
        return 'cuda-core', (0, 0, 0), 0, 1

    def computed(t):
        return (_cdiv(B, t[2]) * t[2] * _cdiv(H, t[0]) * t[0] *
                _cdiv(W, t[1]) * t[1])

    tiles = TC_TILES if k == 3 else (TC_TILES[0], TC_TILES[3])
    least = min(map(computed, tiles))
    fits = [t for t in tiles if computed(t) == least]
    tile = next((t for t in fits if t[0] * t[1] * t[2] >= 64), fits[0])
    block_n = 128 if nc % 128 == 0 else 64
    n = (_cdiv(B, tile[2]) * _cdiv(H, tile[0]) * _cdiv(W, tile[1]) *
         _cdiv(nc, block_n))
    chunks = _cdiv(kc, TC_CK)
    if chunks == 1 or 2 * n >= 3 * n_sm:
        return 'tensor-core', tile, block_n, 1
    per_split = _cdiv(chunks, min(chunks, _cdiv(2 * n_sm, n)))
    splits = _cdiv(chunks, per_split)
    return ('split-K' if splits > 1 else 'tensor-core'), tile, block_n, splits


_N_SM = {}


def _n_sm(device):
    if device not in _N_SM:
        _N_SM[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _N_SM[device]


def _run(name, fn, data, mask, weights, nc, counter):
    """Plan, allocate the output and any split-K workspace, launch `fn`
    (the forward or the dgrad entry point) and, where K was split, the
    reduction. Raises on any error code."""
    B, H, W, kc = data.shape
    k = weights[0].shape[0]
    _, tile, block_n, splits = plan(B, H, W, kc, nc, k, data.dtype,
                                    _n_sm(data.device))
    out = torch.empty((B, H, W, nc), dtype=data.dtype, device=data.device)
    ws = None
    if splits > 1:
        ws = torch.empty((splits, B * H * W, nc), dtype=torch.float32,
                         device=data.device)
    bias = weights[1] if len(weights) > 1 else None
    # the launch goes to the runtime's current device: switch only when the
    # data lies on another (the switch costs host time on every call)
    dev = data.device
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), mask.data_ptr(),
                *(t.data_ptr() for t in weights), out.data_ptr(),
                ws.data_ptr() if splits > 1 else None, B, H, W, kc, nc, k,
                _DTYPES[data.dtype], *tile, block_n, splits, stream)
        if rc != 0:
            raise RuntimeError('{} launch failed: cudaError {}'.format(
                name, rc))
        counter.launches += 1
        if splits > 1:
            rc = _library().san_splitk_reduce(
                ws.data_ptr(), mask.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), B * H * W, nc, splits, stream)
            if rc != 0:
                raise RuntimeError('san_splitk_reduce launch failed: '
                                   'cudaError {}'.format(rc))
            counter.reduce_launches += 1
    return out


def _launch(x, mask, kernel, bias):
    """Launch the forward kernel; raises on anything it does not take."""
    _check_launch('masked_conv2d', x, mask, (kernel, bias))
    return _run('san_masked_conv2d', _library().san_masked_conv2d, x, mask,
                (kernel, bias), kernel.shape[3], masked_conv2d)


def _launch_dgrad(gm, mask, kernel):
    """Launch the dx kernel on the forward's own weights; raises on
    anything it does not take."""
    _check_launch('masked_conv2d_dgrad', gm, mask, (kernel,))
    return _run('san_masked_conv2d_dgrad',
                _library().san_masked_conv2d_dgrad, gm, mask, (kernel,),
                kernel.shape[2], masked_conv2d_dgrad)


def _library():
    lib = build.load('san_conv')
    # pointers and the stream as c_void_p: a default int would cut them
    for name, n_ptr, n_int in (('san_masked_conv2d', 6, 12),
                               ('san_masked_conv2d_dgrad', 5, 12)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    fn = lib.san_splitk_reduce
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def masked_conv2d(x, mask, kernel, bias):
    """(conv_same(x, kernel) + bias) * mask in x's dtype, without autograd.

    CUDA tensors go to the Hopper kernel (counted in
    `masked_conv2d.launches`); CPU tensors to `masked_conv2d_reference`."""
    if bias.dim() != 1:
        raise ValueError('bias must be [Cout], got {}'.format(
            tuple(bias.shape)))
    _check(x, mask, kernel, ((x.shape[-1], kernel.shape[2]),
                             (bias.shape[0], kernel.shape[-1])))
    if x.device.type == 'cpu':
        return masked_conv2d_reference(x, mask, kernel, bias)
    return _launch(x, mask, kernel, bias)


def masked_conv2d_dgrad(gm, mask, kernel):
    """dx [B,H,W,Cin] of the masked conv from gm = g * mask [B,H,W,Cout],
    in gm's dtype. CUDA tensors go to the Hopper kernel (counted in
    `masked_conv2d_dgrad.launches`); CPU tensors to
    `masked_conv2d_dgrad_reference`."""
    _check(gm, mask, kernel, ((gm.shape[-1], kernel.shape[-1]),))
    if gm.device.type == 'cpu':
        return masked_conv2d_dgrad_reference(gm, mask, kernel)
    return _launch_dgrad(gm, mask, kernel)


masked_conv2d.launches = 0
masked_conv2d_dgrad.launches = 0
# the split-K reductions, counted apart from the conv calls
masked_conv2d.reduce_launches = 0
masked_conv2d_dgrad.reduce_launches = 0


def filter_grad(x, gm, kernel):
    """dW [k,k,Cin,Cout] of the masked conv from the saved x and gm = g *
    mask: the conv filter-gradient of exact float32 copies, rounded once to
    the kernel's dtype. That is what the TPU's MXU gives the JAX package's
    bf16 filter gradient (fp32 sums); cuDNN's bf16 filter gradient rounds
    more and misses the bf16 rule (rtol 2e-2, atol 1e-2 x max) on some
    elements of the 96x160 k5 convs."""
    k, _, cin, cout = kernel.shape
    return torch.nn.grad.conv2d_weight(
        x.permute(0, 3, 1, 2).float(), (cout, cin, k, k),
        gm.permute(0, 3, 1, 2).float(), padding=k // 2).permute(
            2, 3, 1, 0).to(kernel.dtype)


class MaskedConv2dFunction(torch.autograd.Function):
    """The masked conv under autograd, with `_mc_fwd` / `_mc_bwd`'s
    semantics: gm = (g * mask) in x's dtype; dx by the dgrad kernel (skipped
    when x needs no gradient, as for the LiDAR depth itself); dW the conv
    filter-gradient of the saved x against gm; db = gm summed; no gradient
    for the mask."""

    @staticmethod
    def forward(ctx, x, mask, kernel, bias):
        ctx.save_for_backward(x, mask, kernel)
        return masked_conv2d(x, mask, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, mask, kernel = ctx.saved_tensors
        # g may come as a permuted view (the NCHW fusion): contiguous here
        gm = (g * mask.to(g.dtype)).to(x.dtype).contiguous()
        dx = dkernel = dbias = None
        if ctx.needs_input_grad[0]:
            dx = masked_conv2d_dgrad(gm, mask, kernel)
        if ctx.needs_input_grad[2]:
            dkernel = filter_grad(x, gm, kernel)
        if ctx.needs_input_grad[3]:
            dbias = gm.sum((0, 1, 2))
        return dx, None, dkernel, dbias


def masked_conv2d_fn(x, mask, kernel, bias):
    """Differentiable (conv_same(x, kernel) + bias) * mask."""
    return MaskedConv2dFunction.apply(x, mask, kernel, bias)
