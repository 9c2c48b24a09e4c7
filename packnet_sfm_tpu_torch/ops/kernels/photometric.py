"""
The fused photometric map (SSIM + L1 over 3x3 reflect-padded windows) and
its analytic gradient, with the JAX package's semantics
(ops/pallas/photometric.py):

    photo(p) = alpha * mean_c clamp01((1 - SSIM_c(p)) / 2)
             + (1 - alpha) * mean_c |x_c(p) - y_c(p)|

Two hand-written Hopper kernels in `packnet_sfm_tpu_torch/csrc/photometric.cu`:
- `photometric_fwd` replaces the Pallas `_fwd_kernel`;
- `photometric_bwd` replaces `_bwd_kernel`: dxp, dyp by the raw-moment
  formula, with the strict gate 0 < (1 - SSIM) / 2 < 1 and the L1 sign term.

Both take the reflect-padded float32 xp, yp [B,3,H+2,W+2] (NCHW). As the
JAX custom VJP sits after jnp.pad, the pad and its gradient fold stay in
PyTorch around `PhotometricFunction`. The TPU kernel divides the channel
mean by a literal 3, so the kernels take RGB only and the wrappers raise for
another channel count. On CPU tensors the wrappers run the plain versions
(`photometric_fwd_reference`, `photometric_bwd_reference`); there is no
other fall back. Each wrapper counts its kernel launches in its `launches`
attribute.

`photometric_map_fn` is the NHWC map through the Function (the loss's
`use_pallas` path); `photometric_map_reference` is the same composition
under plain autograd, without kernels or Function.
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


def _check(xp, yp, g=None):
    if xp.dim() != 4 or xp.shape != yp.shape or xp.shape[2] < 3 or \
            xp.shape[3] < 3:
        raise ValueError('photometric map expects xp, yp [B,3,H+2,W+2] of '
                         'one shape, got {} and {}'.format(
                             tuple(xp.shape), tuple(yp.shape)))
    if xp.shape[1] != 3:
        raise ValueError('the photometric kernels take 3 channels (their '
                         'channel mean divides by 3), got {}'.format(
                             xp.shape[1]))
    if g is not None and tuple(g.shape) != (xp.shape[0], xp.shape[2] - 2,
                                            xp.shape[3] - 2):
        raise ValueError('g must be [B,H,W], got {}'.format(tuple(g.shape)))


def _check_launch(name, tensors):
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError('the {} kernel needs CUDA tensors on one device'
                         .format(name))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError('{} takes float32 tensors'.format(name))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('{} needs contiguous tensors'.format(name))


def _launch_fwd(xp, yp, alpha, C1, C2):
    _check_launch('photometric_fwd', (xp, yp))
    B, _, Hp, Wp = xp.shape
    out = torch.empty((B, Hp - 2, Wp - 2), dtype=torch.float32,
                      device=xp.device)
    fn = build.function('photometric', 'photometric_fwd', 3, 3, 4)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xp.data_ptr(), yp.data_ptr(), out.data_ptr(), B, Hp - 2,
                Wp - 2, alpha, 1.0 - alpha, C1, C2, stream)
    if rc != 0:
        raise RuntimeError('photometric_fwd launch failed: cudaError {}'
                           .format(rc))
    photometric_fwd.launches += 1
    return out


def _launch_bwd(xp, yp, g, alpha, C1, C2):
    _check_launch('photometric_bwd', (xp, yp, g))
    B, _, Hp, Wp = xp.shape
    dxp, dyp = torch.empty_like(xp), torch.empty_like(yp)
    fn = build.function('photometric', 'photometric_bwd', 5, 3, 4)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xp.data_ptr(), yp.data_ptr(), g.data_ptr(), dxp.data_ptr(),
                dyp.data_ptr(), B, Hp - 2, Wp - 2, -0.5 * alpha / 3.0,
                1.0 - alpha, C1, C2, stream)
    if rc != 0:
        raise RuntimeError('photometric_bwd launch failed: cudaError {}'
                           .format(rc))
    photometric_bwd.launches += 1
    return dxp, dyp


def photometric_fwd(xp, yp, alpha=0.85, C1=1e-4, C2=9e-4):
    """photo [B,H,W] from the padded xp, yp [B,3,H+2,W+2], without
    autograd. CUDA tensors go to the Hopper kernel (counted in
    `photometric_fwd.launches`); CPU tensors to the plain version."""
    _check(xp, yp)
    if xp.device.type == 'cpu':
        with torch.no_grad():
            return photometric_fwd_reference(xp, yp, alpha, C1, C2)
    return _launch_fwd(xp, yp, alpha, C1, C2)


def photometric_bwd(xp, yp, g, alpha=0.85, C1=1e-4, C2=9e-4):
    """(dxp, dyp) from g = d loss / d photo [B,H,W]. CUDA tensors go to the
    Hopper kernel (counted in `photometric_bwd.launches`); CPU tensors to
    the plain version."""
    _check(xp, yp, g)
    if xp.device.type == 'cpu':
        return photometric_bwd_reference(xp, yp, g, alpha, C1, C2)
    return _launch_bwd(xp, yp, g, alpha, C1, C2)


photometric_fwd.launches = 0
photometric_bwd.launches = 0


class PhotometricFunction(torch.autograd.Function):
    """The padded photometric map under autograd, as `_photo_padded`'s
    custom VJP: forward by `photometric_fwd`, both cotangents by
    `photometric_bwd` (float32, as the kernels are)."""

    @staticmethod
    def forward(ctx, xp, yp, alpha, C1, C2):
        ctx.consts = (alpha, C1, C2)
        ctx.save_for_backward(xp, yp)
        return photometric_fwd(xp, yp, alpha, C1, C2)

    @staticmethod
    def backward(ctx, g):
        xp, yp = ctx.saved_tensors
        # g may come expanded (a mean's gradient): contiguous here
        dxp, dyp = photometric_bwd(xp, yp, g.float().contiguous(),
                                   *ctx.consts)
        return dxp, dyp, None, None, None


def _padded(x):
    """NHWC [B,H,W,3] -> reflect-padded float32 NCHW [B,3,H+2,W+2]."""
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                 mode='reflect').float().contiguous()


def photometric_map_fn(x, y, alpha=0.85, C1=1e-4, C2=9e-4):
    """Fused photometric map of x, y [B,H,W,3] -> [B,H,W,1] float32,
    differentiable through the kernels."""
    return PhotometricFunction.apply(_padded(x), _padded(y), float(alpha),
                                     float(C1), float(C2))[..., None]


def photometric_map_reference(x, y, alpha=0.85, C1=1e-4, C2=9e-4):
    """The same map through the plain forward under plain autograd."""
    xp, yp = _padded(x), _padded(y)
    _check(xp, yp)
    return photometric_fwd_reference(xp, yp, float(alpha), float(C1),
                                     float(C2))[..., None]
