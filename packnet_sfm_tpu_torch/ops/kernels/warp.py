"""
Bilinear warp under grid_sample (align_corners=True, 'zeros' or 'border'
padding) and its gradient, with the semantics of the JAX package's XLA
warp path (ops/image.py `_gs_patches`, `_gs_combine`, `_gs_derivs`,
`_gs_fwd`, `_gs_bwd`):

    bilinear_warp(image [B,H,W,C], grid [B,Ho,Wo,2]) -> (out, A, B)

out [B,Ho,Wo,C] in the image dtype; A = d out/dx and B = d out/dy in pixel
coordinates, [B,Ho,Wo,C] float32 (the XLA path promotes them to float32).

The hand-written Hopper kernel is `packnet_sfm_tpu_torch/csrc/warp.cu`; it
replaces the JAX package's Pallas `_warp_kernel` (ops/pallas/warp.py). On a
CPU tensor `bilinear_warp` runs its plain version `bilinear_warp_reference`;
there is no other fall back. It counts its kernel launches in
`bilinear_warp.launches`.

`grid_sample_fn` is the differentiable op (`WarpFunction`, the counterpart
of the JAX `grid_sample` custom VJP): forward through `bilinear_warp`, which
saves A and B, and the grid cotangent as elementwise math over them, with
no gather and no second kernel run. The image cotangent, needed only when
the sampled image requires a gradient (never on the loss path, where the
reference frames are data), comes from autograd through the plain version,
as JAX takes it from autodiff of its XLA formulation; `WarpFunction.image_grads`
counts those. `grid_sample_reference` is the plain version under plain
autograd.
"""

import torch

from packnet_sfm_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PADDING = {'zeros': 0, 'border': 1}


def bilinear_warp_reference(image, grid, padding_mode='zeros'):
    """Plain PyTorch version: the four taps by gather, the formulas of
    `_gs_combine` and `_gs_derivs` in their order (tap differences in the
    image dtype, the rest in float32). Differentiable in both inputs."""
    B, H, W, C = image.shape
    _, Ho, Wo, _ = grid.shape
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    border = padding_mode == 'border'
    if border:
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    # clamp in float before the conversion, so that both taps of a pair far
    # outside the image stay outside
    xa = x0.detach().clamp(-2, W).long()
    ya = y0.detach().clamp(-2, H).long()
    flat = image.reshape(B, H * W, C)

    def tap(yy, xx):
        if border:
            yy, xx = yy.clamp(max=H - 1), xx.clamp(max=W - 1)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(B, -1, 1)
        v = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(
            B, Ho, Wo, C)
        if border:
            return v
        valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        return torch.where(valid[..., None], v, 0.0)

    p00, p01 = tap(ya, xa), tap(ya, xa + 1)
    p10, p11 = tap(ya + 1, xa), tap(ya + 1, xa + 1)
    top = p00 + (p01 - p00) * wx
    bot = p10 + (p11 - p10) * wx
    out = (top + (bot - top) * wy).to(image.dtype)
    A = (p01 - p00) * (1.0 - wy) + (p11 - p10) * wy
    Bv = (p10 - p00) * (1.0 - wx) + (p11 - p01) * wx
    return out, A.float(), Bv.float()


def _check(image, grid, padding_mode):
    if image.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2 or \
            grid.shape[0] != image.shape[0]:
        raise ValueError('warp expects image [B,H,W,C] and grid [B,Ho,Wo,2], '
                         'got {} and {}'.format(tuple(image.shape),
                                                tuple(grid.shape)))
    if not 1 <= image.shape[-1] <= 3:
        raise ValueError('warp takes 1 to 3 channels, got {}'.format(
            image.shape[-1]))
    if padding_mode not in _PADDING:
        raise ValueError('Unknown padding mode {}'.format(padding_mode))


def _launch(image, grid, padding_mode):
    """Launch the warp kernel; raises on anything it does not take."""
    if not (image.is_cuda and grid.is_cuda) or image.device != grid.device:
        raise ValueError('the warp kernel needs CUDA tensors on one device')
    if image.dtype not in _DTYPES:
        raise TypeError('warp takes float32 or bfloat16 images, got {}'
                        .format(image.dtype))
    if grid.dtype != torch.float32:
        raise TypeError('warp takes a float32 grid, got {}'.format(grid.dtype))
    if not (image.is_contiguous() and grid.is_contiguous()):
        raise ValueError('the warp kernel needs contiguous tensors')
    B, H, W, C = image.shape
    _, Ho, Wo, _ = grid.shape
    out = torch.empty((B, Ho, Wo, C), dtype=image.dtype, device=image.device)
    A = torch.empty((B, Ho, Wo, C), dtype=torch.float32, device=image.device)
    Bv = torch.empty_like(A)
    fn = build.function('warp', 'warp_bilinear', 5, 8)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(image.data_ptr(), grid.data_ptr(), out.data_ptr(),
                A.data_ptr(), Bv.data_ptr(), B, H, W, C, Ho, Wo,
                _DTYPES[image.dtype], _PADDING[padding_mode], stream)
    if rc != 0:
        raise RuntimeError('warp_bilinear launch failed: cudaError {}'
                           .format(rc))
    bilinear_warp.launches += 1
    return out, A, Bv


def bilinear_warp(image, grid, padding_mode='zeros'):
    """(out, A, B) of the bilinear warp, without autograd. CUDA tensors go
    to the Hopper kernel (counted in `bilinear_warp.launches`); CPU tensors
    to `bilinear_warp_reference`."""
    _check(image, grid, padding_mode)
    if image.device.type == 'cpu':
        with torch.no_grad():
            return bilinear_warp_reference(image, grid, padding_mode)
    return _launch(image, grid, padding_mode)


bilinear_warp.launches = 0


class WarpFunction(torch.autograd.Function):
    """grid_sample under autograd with `_gs_fwd` / `_gs_bwd`'s semantics:
    the forward saves (image, grid, A, B); dgrid = (sum_c g*A, sum_c g*B)
    times (W-1)/2 and (H-1)/2, zero where 'border' clamped the coordinate;
    the image cotangent by autograd through the plain version."""

    image_grads = 0

    @staticmethod
    def forward(ctx, image, grid, padding_mode):
        out, A, Bv = bilinear_warp(image, grid, padding_mode)
        ctx.padding_mode = padding_mode
        ctx.save_for_backward(image, grid, A, Bv)
        return out

    @staticmethod
    def backward(ctx, g):
        image, grid, A, Bv = ctx.saved_tensors
        H, W = image.shape[1], image.shape[2]
        dimage = dgrid = None
        if ctx.needs_input_grad[1]:
            g32 = g.float()
            dgx = (g32 * A).sum(-1) * (0.5 * (W - 1))
            dgy = (g32 * Bv).sum(-1) * (0.5 * (H - 1))
            if ctx.padding_mode == 'border':
                xu = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
                yu = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
                dgx = dgx * ((xu >= 0) & (xu <= W - 1)).to(dgx.dtype)
                dgy = dgy * ((yu >= 0) & (yu <= H - 1)).to(dgy.dtype)
            dgrid = torch.stack([dgx, dgy], dim=-1).to(grid.dtype)
        if ctx.needs_input_grad[0]:
            WarpFunction.image_grads += 1
            with torch.enable_grad():
                im = image.detach().requires_grad_(True)
                out = bilinear_warp_reference(im, grid.detach(),
                                              ctx.padding_mode)[0]
                dimage, = torch.autograd.grad(out, im, g.to(out.dtype))
        return dimage, dgrid, None


def grid_sample_fn(image, grid, padding_mode='zeros'):
    """Differentiable bilinear grid_sample through the warp kernel."""
    return WarpFunction.apply(image, grid, padding_mode)


def grid_sample_reference(image, grid, padding_mode='zeros'):
    """The plain version under plain autograd (no kernel, no Function)."""
    _check(image, grid, padding_mode)
    return bilinear_warp_reference(image, grid, padding_mode)[0]
