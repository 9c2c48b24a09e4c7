"""
The fused photometric map (SSIM + L1 over 3x3 reflect-padded windows) and
its analytic gradient, with the JAX package's semantics
(ops/pallas/photometric.py):

    photo(p) = alpha * mean_c clamp01((1 - SSIM_c(p)) / 2)
             + (1 - alpha) * mean_c |x_c(p) - y_c(p)|

Two hand-written Hopper kernels in `packnet_sfm_tpu_torch/csrc/photometric.cu`:
- `photometric_fwd` replaces the Pallas `_fwd_kernel`;
- `photometric_bwd` replaces `_bwd_kernel`: dx (and dy when asked) by the
  raw-moment formula, with the strict gate 0 < (1 - SSIM) / 2 < 1 and the
  L1 sign term, and the reflect pad's adjoint (`reflect_fold`).

Both take the images x, y [B,H,W,3] float32 as they come: NHWC with channel
stride 1 and pixel stride 3, any batch and row strides (the warp's
row-slices are read in place), H, W >= 2 as the reflect pad needs. The pad,
the layout change and the pad's gradient are in the kernels' loads and
stores; g may have any strides, 0 included. The TPU kernel divides the
channel mean by a literal 3, so the kernels take RGB only and the wrappers
raise for another channel count. On CPU tensors the wrappers run the plain
composition (`_padded`, then `photometric_fwd_reference` or
`photometric_bwd_reference` and `reflect_fold`); there is no other fall
back. Each wrapper counts its kernel launches in its `launches` attribute.

`photometric_map_fn` is the NHWC map through the Function (the loss's
`use_pallas` path). It takes x, y in any layout and float dtype: the
loss's full-resolution images and the warp's row-slices pass as they are,
anything else (an image resized by `ops/image.py` `interpolate`, an NCHW
tensor seen through a permute) is copied to the layout the kernels read.
`photometric_map_reference` is the same composition under plain autograd,
without kernels or Function.
"""

import torch
import torch.nn.functional as F

from packnet_sfm_tpu_torch.ops.kernels import build


def _boxsum_valid(v, H, W):
    """Sum of the 3x3 windows of [..., H+2, W+2] -> [..., H, W], rows outer
    and columns inner, as the TPU kernel sums."""
    out = v[..., :H, :W]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                out = out + v[..., dy:dy + H, dx:dx + W]
    return out


def _moments(xp, yp, H, W):
    inv9 = 1.0 / 9.0
    return (_boxsum_valid(xp, H, W) * inv9, _boxsum_valid(yp, H, W) * inv9,
            _boxsum_valid(xp * xp, H, W) * inv9,
            _boxsum_valid(yp * yp, H, W) * inv9,
            _boxsum_valid(xp * yp, H, W) * inv9)


def _ssim_terms(m1, m2, m3, m4, m5, C1, C2):
    sxy2 = 2.0 * (m5 - m1 * m2) + C2
    n1 = 2.0 * m1 * m2 + C1
    d1 = m1 * m1 + m2 * m2 + C1
    d2 = (m3 - m1 * m1) + (m4 - m2 * m2) + C2
    return n1 * sxy2, d1 * d2, n1, sxy2, d1, d2


def photometric_fwd_reference(xp, yp, alpha=0.85, C1=1e-4, C2=9e-4):
    """Plain PyTorch version of the forward: photo [B,H,W]. Differentiable;
    the SSIM term passes a gradient only strictly inside (0, 1), as the
    backward kernel's gate does."""
    H, W = xp.shape[2] - 2, xp.shape[3] - 2
    N, D = _ssim_terms(*_moments(xp, yp, H, W), C1, C2)[:2]
    lin = (1.0 - N / D) * 0.5
    inside = (lin > 0.0) & (lin < 1.0)
    ssim_term = torch.where(inside, lin, lin.detach().clamp(0.0, 1.0))
    l1 = torch.abs(xp[:, :, 1:1 + H, 1:1 + W] - yp[:, :, 1:1 + H, 1:1 + W])
    t = alpha * ssim_term + (1.0 - alpha) * l1
    return (t[:, 0] + t[:, 1] + t[:, 2]) / 3.0


def photometric_bwd_reference(xp, yp, g, alpha=0.85, C1=1e-4, C2=9e-4):
    """Plain PyTorch version of the backward: (dxp, dyp) [B,3,H+2,W+2] from
    g [B,H,W], the formula of `_bwd_kernel` over whole images."""
    Hp, Wp = xp.shape[2], xp.shape[3]
    H, W = Hp - 2, Wp - 2
    m1, m2, m3, m4, m5 = _moments(xp, yp, H, W)
    N, D, n1, sxy2, d1, d2 = _ssim_terms(m1, m2, m3, m4, m5, C1, C2)
    lin = (1.0 - N / D) * 0.5
    inside = (lin > 0.0) & (lin < 1.0)
    Gc = torch.where(inside, g[:, None] * (-0.5 * alpha / 3.0), 0.0)
    inv_D = 1.0 / D
    NDD = N * inv_D * inv_D
    S1 = (2.0 * m2 * (sxy2 - n1)) * inv_D - NDD * (2.0 * m1 * (d2 - d1))
    S2 = (2.0 * m1 * (sxy2 - n1)) * inv_D - NDD * (2.0 * m2 * (d2 - d1))
    S3 = -NDD * d1
    S5 = 2.0 * n1 * inv_D
    inv9 = 1.0 / 9.0

    def bsum(v):
        """Transpose of the valid box sum: q sums p in [q-2, q]."""
        vp = F.pad(v, (2, 2, 2, 2))
        return _boxsum_valid(vp, Hp, Wp) * inv9

    b1, b2, b3, b5 = (bsum(Gc * S) for S in (S1, S2, S3, S5))
    dx = b1 + 2.0 * xp * b3 + yp * b5
    dy = b2 + 2.0 * yp * b3 + xp * b5
    g_q = F.pad(g, (1, 1, 1, 1))[:, None]      # g at p = q - 1, 0 on the pad
    sgn = torch.sign(xp - yp) * (g_q * (1.0 - alpha) / 3.0)
    return dx + sgn, dy - sgn


def reflect_fold(dp):
    """The adjoint of the reflect pad by 1: [..., H+2, W+2] -> [..., H, W].
    Rows first (padded row 0 added into row 2, row H+1 into row H-1), then
    columns (0 into 2, W+1 into W-1), each in that order, so a corner is
    (a22 + a02) + (a20 + a00); photometric_bwd's kernel folds in the same
    order."""
    H, W = dp.shape[-2] - 2, dp.shape[-1] - 2
    r = dp.clone()
    r[..., 2, :] = r[..., 2, :] + r[..., 0, :]
    r[..., H - 1, :] = r[..., H - 1, :] + r[..., H + 1, :]
    r[..., :, 2] = r[..., :, 2] + r[..., :, 0]
    r[..., :, W - 1] = r[..., :, W - 1] + r[..., :, W + 1]
    return r[..., 1:H + 1, 1:W + 1]


def _padded(x):
    """NHWC [B,H,W,3] -> reflect-padded float32 NCHW [B,3,H+2,W+2]."""
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                 mode='reflect').float().contiguous()


def photometric_fwd_plain(x, y, alpha=0.85, C1=1e-4, C2=9e-4):
    """The plain composition of the forward kernel: photo [B,H,W] from
    x, y [B,H,W,3]."""
    return photometric_fwd_reference(_padded(x), _padded(y), alpha, C1, C2)


def photometric_bwd_plain(x, y, g, need_dy=True, alpha=0.85, C1=1e-4,
                          C2=9e-4):
    """The plain composition of the backward kernel: (dx, dy or None)
    [B,H,W,3] from g [B,H,W]."""
    dxp, dyp = photometric_bwd_reference(_padded(x), _padded(y), g, alpha,
                                         C1, C2)
    dx = reflect_fold(dxp).permute(0, 2, 3, 1)
    return dx, (reflect_fold(dyp).permute(0, 2, 3, 1) if need_dy else None)


def _check(x, y, g=None):
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError('photometric map expects x, y [B,H,W,3] of one '
                         'shape, got {} and {}'.format(tuple(x.shape),
                                                       tuple(y.shape)))
    if x.shape[3] != 3:
        raise ValueError('the photometric kernels take 3 channels (their '
                         'channel mean divides by 3), got {}'.format(
                             x.shape[3]))
    if x.shape[1] < 2 or x.shape[2] < 2:
        raise ValueError('the reflect pad needs H, W >= 2, got {}x{}'.format(
            x.shape[1], x.shape[2]))
    if g is not None and tuple(g.shape) != tuple(x.shape[:3]):
        raise ValueError('g must be [B,H,W], got {}'.format(tuple(g.shape)))
    tensors = (x, y) if g is None else (x, y, g)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError('the photometric kernels take float32 tensors, got '
                        '{}'.format([t.dtype for t in tensors]))
    if len({t.device for t in tensors}) != 1:
        raise ValueError('the photometric kernels need tensors on one device')


_INT32 = 2 ** 31 - 1


def _check_launch(name, images, g=None):
    tensors = images if g is None else images + (g,)
    if not all(t.is_cuda for t in tensors):
        raise ValueError('the {} kernel needs CUDA tensors on one device'
                         .format(name))
    _, H, W, _ = images[0].shape
    for t in tensors:
        s = t.stride()
        if len(s) == 4 and (s[3] != 1 or s[2] != 3):
            raise ValueError('{} needs NHWC images with channel stride 1 and '
                             'pixel stride 3, got strides {}'.format(name, s))
        # the kernels index within an image in 32 bits
        if max(s) > _INT32 or (H - 1) * s[1] + (W - 1) * s[2] + 2 > _INT32:
            raise ValueError('{} indexes an image in 32 bits: strides {} '
                             'too large'.format(name, s))


def _launch_fwd(x, y, alpha, C1, C2):
    _check_launch('photometric_fwd', (x, y))
    B, H, W, _ = x.shape
    out = torch.empty((B, H, W), dtype=torch.float32, device=x.device)
    fn = build.function('photometric', 'photometric_fwd', 3, 7, 4)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), B, H, W,
                x.stride(0), x.stride(1), y.stride(0), y.stride(1), alpha,
                1.0 - alpha, C1, C2, stream)
    if rc != 0:
        raise RuntimeError('photometric_fwd launch failed: cudaError {}'
                           .format(rc))
    photometric_fwd.launches += 1
    return out


def _launch_bwd(x, y, g, need_dy, alpha, C1, C2):
    _check_launch('photometric_bwd', (x, y), g)
    B, H, W, _ = x.shape
    dx = torch.empty((B, H, W, 3), dtype=torch.float32, device=x.device)
    dy = torch.empty_like(dx) if need_dy else None
    fn = build.function('photometric', 'photometric_bwd', 5, 11, 4)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(),
                dy.data_ptr() if need_dy else None, B, H, W, x.stride(0),
                x.stride(1), y.stride(0), y.stride(1), *g.stride(),
                int(need_dy), -0.5 * alpha / 3.0, 1.0 - alpha, C1, C2,
                stream)
    if rc != 0:
        raise RuntimeError('photometric_bwd launch failed: cudaError {}'
                           .format(rc))
    photometric_bwd.launches += 1
    return dx, dy


def photometric_fwd(x, y, alpha=0.85, C1=1e-4, C2=9e-4):
    """photo [B,H,W] from x, y [B,H,W,3], without autograd. CUDA tensors go
    to the Hopper kernel (counted in `photometric_fwd.launches`); CPU
    tensors to the plain composition."""
    _check(x, y)
    if x.device.type == 'cpu':
        with torch.no_grad():
            return photometric_fwd_plain(x, y, alpha, C1, C2)
    return _launch_fwd(x, y, alpha, C1, C2)


def photometric_bwd(x, y, g, need_dy=True, alpha=0.85, C1=1e-4, C2=9e-4):
    """(dx, dy, or None without need_dy) [B,H,W,3] from g = d loss / d photo
    [B,H,W], the reflect pad's gradient included. CUDA tensors go to the
    Hopper kernel (counted in `photometric_bwd.launches`); CPU tensors to
    the plain composition."""
    _check(x, y, g)
    if x.device.type == 'cpu':
        return photometric_bwd_plain(x, y, g, need_dy, alpha, C1, C2)
    return _launch_bwd(x, y, g, need_dy, alpha, C1, C2)


photometric_fwd.launches = 0
photometric_bwd.launches = 0


class PhotometricFunction(torch.autograd.Function):
    """The photometric map [B,H,W] of x, y [B,H,W,3] under autograd, as the
    JAX custom VJP with the pad before it: forward by `photometric_fwd`,
    the cotangents by `photometric_bwd` (dy only when y needs one)."""

    @staticmethod
    def forward(ctx, x, y, alpha, C1, C2):
        ctx.consts = (alpha, C1, C2)
        ctx.save_for_backward(x, y)
        return photometric_fwd(x, y, alpha, C1, C2)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dx, dy = photometric_bwd(x, y, g, ctx.needs_input_grad[1],
                                 *ctx.consts)
        return dx, dy, None, None, None


def _kernel_layout(t):
    """t as float32 with channel stride 1 and pixel stride 3, the layout
    the kernels read: t itself when it already is, else a copy (under
    autograd, so its gradient goes back through the cast and the copy)."""
    if t.dtype != torch.float32:
        t = t.float()
    if t.dim() == 4 and (t.stride(3) != 1 or t.stride(2) != 3):
        t = t.contiguous()
    return t


def photometric_map_fn(x, y, alpha=0.85, C1=1e-4, C2=9e-4):
    """Fused photometric map of x, y [B,H,W,3] -> [B,H,W,1] float32,
    differentiable through the kernels."""
    return PhotometricFunction.apply(_kernel_layout(x), _kernel_layout(y),
                                     float(alpha), float(C1),
                                     float(C2))[..., None]


def photometric_map_reference(x, y, alpha=0.85, C1=1e-4, C2=9e-4):
    """The same map through the plain forward under plain autograd (the
    pad's gradient by F.pad's own backward)."""
    _check(x, y)
    return photometric_fwd_reference(_padded(x), _padded(y), float(alpha),
                                     float(C1), float(C2))[..., None]
