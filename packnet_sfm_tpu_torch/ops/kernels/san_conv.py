"""
Block-sparse masked conv under the SAN LiDAR branch, and its gradient:

    out = (conv_same(x, kernel) + bias) * mask

x [B,H,W,Cin] NHWC, mask [B,H,W,1], kernel [k,k,Cin,Cout] HWIO (k in
{3,5}), bias [Cout]; 'SAME' padding is k//2 zeros per side.

Two hand-written Hopper kernels in `packnet_sfm_tpu_torch/csrc/san_conv.cu`:
- `masked_conv2d`, the forward. It replaces the JAX package's Pallas kernel
  (ops/pallas/san_conv.py `_conv_kernel` / `masked_conv2d_pallas`).
- `masked_conv2d_dgrad`, the input gradient
  dx = conv_same(gm, flip(kernel, (0,1)) with I/O swapped), gm = g * mask.
  It replaces the dx half of `_mc_bwd`, which reused the same Pallas call.
  dx is not masked: it is nonzero in the halo around active sites.

The kernels' source note gives their bound on the H100 and their design:
tiles with no active site (for dx: none within the halo) are written as
exact zeros and skip their math, which is the work projected LiDAR lets a
kernel skip above the horizon. On a CPU tensor each wrapper runs its plain
version (`masked_conv2d_reference`, `masked_conv2d_dgrad_reference`); there
is no other fall back. Each wrapper counts its kernel launches in its own
`launches` attribute.

`masked_conv2d_fn` is the differentiable op (`MaskedConv2dFunction`, the
counterpart of the JAX `masked_conv2d` custom VJP): forward through
`masked_conv2d`, dx through `masked_conv2d_dgrad`, and dW / db as PyTorch
calls (`torch.nn.grad.conv2d_weight` and a sum), as the JAX package leaves
them to XLA outside any Pallas kernel. The whole backward runs in the
primal dtype, as `_mc_bwd` does.
"""

import ctypes

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


def _launch(x, mask, kernel, bias):
    """Launch the forward kernel; raises on anything it does not take."""
    _check_launch('masked_conv2d', x, mask, (kernel, bias))
    B, H, W, Cin = x.shape
    k, Cout = kernel.shape[0], kernel.shape[3]
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    fn = _library().san_masked_conv2d
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), mask.data_ptr(), kernel.data_ptr(),
                bias.data_ptr(), out.data_ptr(), B, H, W, Cin, Cout, k,
                _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError('san_masked_conv2d launch failed: cudaError {}'
                           .format(rc))
    masked_conv2d.launches += 1
    return out


def _launch_dgrad(gm, mask, kernel):
    """Launch the dx kernel; raises on anything it does not take. The
    flipped, I/O-swapped weight copy is made here, once per call."""
    _check_launch('masked_conv2d_dgrad', gm, mask, (kernel,))
    B, H, W, Cout = gm.shape
    k, Cin = kernel.shape[0], kernel.shape[2]
    wt = kernel.flip((0, 1)).transpose(2, 3).contiguous()
    dx = torch.empty((B, H, W, Cin), dtype=gm.dtype, device=gm.device)
    fn = _library().san_masked_conv2d_dgrad
    with torch.cuda.device(gm.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(gm.data_ptr(), mask.data_ptr(), wt.data_ptr(), dx.data_ptr(),
                B, H, W, Cout, Cin, k, _DTYPES[gm.dtype], stream)
    if rc != 0:
        raise RuntimeError('san_masked_conv2d_dgrad launch failed: '
                           'cudaError {}'.format(rc))
    masked_conv2d_dgrad.launches += 1
    return dx


def _library():
    lib = build.load('san_conv')
    # pointers and the stream as c_void_p: a default int would cut them
    for name, n_ptr, n_int in (('san_masked_conv2d', 5, 7),
                               ('san_masked_conv2d_dgrad', 4, 7)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
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
            k, _, cin, cout = kernel.shape
            dkernel = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (cout, cin, k, k),
                gm.permute(0, 3, 1, 2), padding=k // 2).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[3]:
            dbias = gm.sum((0, 1, 2))
        return dx, None, dkernel, dbias


def masked_conv2d_fn(x, mask, kernel, bias):
    """Differentiable (conv_same(x, kernel) + bias) * mask."""
    return MaskedConv2dFunction.apply(x, mask, kernel, bias)
