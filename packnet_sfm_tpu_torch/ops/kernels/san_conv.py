"""
Block-sparse masked conv under the SAN LiDAR branch:

    out = (conv_same(x, kernel) + bias) * mask

x [B,H,W,Cin] NHWC, mask [B,H,W,1], kernel [k,k,Cin,Cout] HWIO (k in
{3,5}), bias [Cout]; 'SAME' padding is k//2 zeros per side.

On a CUDA tensor `masked_conv2d` launches the hand-written Hopper kernel in
`packnet_sfm_tpu_torch/csrc/san_conv.cu` (it replaces the JAX package's
Pallas kernel, ops/pallas/san_conv.py `_conv_kernel` /
`masked_conv2d_pallas`). The kernel's source note gives its bound on the
H100 and its design: output tiles whose own mask sites are all inactive are
written as exact zeros and skip their math, which is the work projected
LiDAR lets a kernel skip above the horizon. On a CPU tensor the wrapper runs
the plain version `masked_conv2d_reference`; there is no other fall back.
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


def _check(x, mask, kernel, bias):
    if x.dim() != 4 or mask.dim() != 4 or kernel.dim() != 4 or bias.dim() != 1:
        raise ValueError('masked_conv2d expects x [B,H,W,Cin], mask '
                         '[B,H,W,1], kernel [k,k,Cin,Cout], bias [Cout]')
    B, H, W, Cin = x.shape
    k, k2, kcin, Cout = kernel.shape
    if k != k2 or k not in (3, 5):
        raise ValueError('kernel must be k x k with k in (3, 5), got '
                         '{}'.format(tuple(kernel.shape)))
    if kcin != Cin or tuple(bias.shape) != (Cout,):
        raise ValueError('channel mismatch: x {}, kernel {}, bias {}'.format(
            tuple(x.shape), tuple(kernel.shape), tuple(bias.shape)))
    if tuple(mask.shape) != (B, H, W, 1):
        raise ValueError('mask must be [B,H,W,1], got {}'.format(
            tuple(mask.shape)))


def _launch(x, mask, kernel, bias):
    """Launch the CUDA kernel; raises on anything it does not take."""
    tensors = (x, mask, kernel, bias)
    if not all(t.is_cuda for t in tensors):
        raise ValueError('the masked-conv kernel needs CUDA tensors')
    if len({t.device for t in tensors}) != 1:
        raise ValueError('masked_conv2d inputs lie on different devices')
    if x.dtype not in _DTYPES:
        raise TypeError('masked_conv2d takes float32 or bfloat16, got '
                        '{}'.format(x.dtype))
    if kernel.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError('kernel and bias must have the dtype of x')
    if mask.dtype != torch.float32:
        raise TypeError('mask must be float32, got {}'.format(mask.dtype))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('masked_conv2d needs contiguous tensors')
    B, H, W, Cin = x.shape
    k, Cout = kernel.shape[0], kernel.shape[3]
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.san_masked_conv2d(
            x.data_ptr(), mask.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, W, Cin, Cout, k, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError('san_masked_conv2d launch failed: cudaError {}'
                           .format(rc))
    masked_conv2d.launches += 1
    return out


def _library():
    lib = build.load('san_conv')
    fn = lib.san_masked_conv2d
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: a default int would cut them
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def masked_conv2d(x, mask, kernel, bias):
    """(conv_same(x, kernel) + bias) * mask in x's dtype.

    CUDA tensors go to the Hopper kernel (counted in
    `masked_conv2d.launches`); CPU tensors to `masked_conv2d_reference`."""
    _check(x, mask, kernel, bias)
    if x.device.type == 'cpu':
        return masked_conv2d_reference(x, mask, kernel, bias)
    return _launch(x, mask, kernel, bias)


masked_conv2d.launches = 0
