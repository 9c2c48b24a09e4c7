"""
Bilinear warp under grid_sample (align_corners=True, 'zeros' or 'border'
padding) and its grid gradient, with the semantics of the JAX package's XLA
warp path (ops/image.py `_gs_patches`, `_gs_combine`, `_gs_derivs`,
`_gs_fwd`, `_gs_bwd`):

    warp_bilinear_out(image [B,H,W,C], grid [B,Ho,Wo,2]) -> out
    warp_bilinear_dgrid(image, grid, g [B,Ho,Wo,C]) -> dgrid [B,Ho,Wo,2]

out is in the image dtype; g = d loss / d out in the image dtype; dgrid is
float32, (sum_c g*A * (W-1)/2, sum_c g*B * (H-1)/2) with A = d out/dx and
B = d out/dy in pixel coordinates, zero under 'border' where the coordinate
was clamped.

The two hand-written Hopper kernels are in
`packnet_sfm_tpu_torch/csrc/warp.cu`; together they replace the JAX
package's Pallas `_warp_kernel` (ops/pallas/warp.py) and the grid cotangent
of its custom VJP. The TPU saves A and B as residuals because gathers are
its slowest primitive; on the card the dgrid kernel gathers the four taps
again and forms A and B in registers, which moves fewer bytes than storing
and reading back two float32 maps. On a CPU tensor each wrapper runs its
plain version (`bilinear_warp_reference`, which returns out, A and B, and
`warp_dgrid_reference`); there is no other fall back. Each counts its
kernel launches in its `launches` attribute.

`grid_sample_fn` is the differentiable op (`WarpFunction`, the counterpart
of the JAX `grid_sample` custom VJP): forward through `warp_bilinear_out`,
saving only (image, grid); the grid cotangent through
`warp_bilinear_dgrid`. The image cotangent, needed only when the sampled
image requires a gradient (never on the loss path, where the reference
frames are data), comes from autograd through the plain version, as JAX
takes it from autodiff of its XLA formulation; `WarpFunction.image_grads`
counts those. `grid_sample_reference` is the plain version under plain
autograd.
"""

import torch

from packnet_sfm_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PADDING = {'zeros': 0, 'border': 1}


def bilinear_warp_reference(image, grid, padding_mode='zeros'):
    """Plain PyTorch version: (out, A, B), the four taps by gather, the
    formulas of `_gs_combine` and `_gs_derivs` in their order (tap
    differences in the image dtype, the rest in float32). Differentiable in
    both inputs."""
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


def warp_dgrid_reference(image, grid, g, padding_mode='zeros'):
    """Plain PyTorch version of the grid cotangent, `_gs_bwd`'s formula over
    `bilinear_warp_reference`'s A and B: dgrid [B,Ho,Wo,2] float32."""
    H, W = image.shape[1], image.shape[2]
    with torch.no_grad():
        _, A, Bv = bilinear_warp_reference(image, grid, padding_mode)
        g32 = g.float()
        dgx = (g32 * A).sum(-1) * (0.5 * (W - 1))
        dgy = (g32 * Bv).sum(-1) * (0.5 * (H - 1))
        if padding_mode == 'border':
            xu = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
            yu = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
            dgx = dgx * ((xu >= 0) & (xu <= W - 1)).to(dgx.dtype)
            dgy = dgy * ((yu >= 0) & (yu <= H - 1)).to(dgy.dtype)
        return torch.stack([dgx, dgy], dim=-1).to(grid.dtype)


def _check(image, grid, padding_mode, g=None):
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
    if g is not None and tuple(g.shape) != tuple(grid.shape[:3]) + (
            image.shape[-1],):
        raise ValueError('g must be [B,Ho,Wo,C], got {}'.format(
            tuple(g.shape)))


def _launch_args(image, grid, padding_mode, extra=()):
    """The C entry points' shared arguments; raises on what they do not
    take."""
    tensors = (image, grid) + tuple(extra)
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError('the warp kernels need CUDA tensors on one device')
    if image.dtype not in _DTYPES:
        raise TypeError('warp takes float32 or bfloat16 images, got {}'
                        .format(image.dtype))
    if grid.dtype != torch.float32:
        raise TypeError('warp takes a float32 grid, got {}'.format(grid.dtype))
    if any(t.dtype != image.dtype for t in extra):
        raise TypeError('the warp cotangent must have the image dtype {}'
                        .format(image.dtype))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('the warp kernels need contiguous tensors')
    B, H, W, C = image.shape
    _, Ho, Wo, _ = grid.shape
    if Ho * Wo * C >= 2 ** 31 - 2 ** 12 or H * W * C >= 2 ** 31:
        raise ValueError('warp: an image or an output of 2^31 elements or '
                         'more')
    return (B, H, W, C, Ho, Wo, _DTYPES[image.dtype], _PADDING[padding_mode])


def _launch_out(image, grid, padding_mode):
    """Launch the out-only forward kernel."""
    dims = _launch_args(image, grid, padding_mode)
    out = torch.empty(grid.shape[:3] + image.shape[3:], dtype=image.dtype,
                      device=image.device)
    fn = build.function('warp', 'warp_bilinear_out', 3, 8)
    with torch.cuda.device(image.device):
        rc = fn(image.data_ptr(), grid.data_ptr(), out.data_ptr(), *dims,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError('warp_bilinear_out launch failed: cudaError {}'
                           .format(rc))
    warp_bilinear_out.launches += 1
    return out


def _launch_dgrid(image, grid, g, padding_mode):
    """Launch the grid-gradient kernel."""
    dims = _launch_args(image, grid, padding_mode, (g,))
    dgrid = torch.empty_like(grid)
    fn = build.function('warp', 'warp_bilinear_dgrid', 4, 8)
    with torch.cuda.device(image.device):
        rc = fn(image.data_ptr(), grid.data_ptr(), g.data_ptr(),
                dgrid.data_ptr(), *dims,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError('warp_bilinear_dgrid launch failed: cudaError {}'
                           .format(rc))
    warp_bilinear_dgrid.launches += 1
    return dgrid


def warp_bilinear_out(image, grid, padding_mode='zeros'):
    """out of the bilinear warp, without autograd. CUDA tensors go to the
    Hopper kernel (counted in `warp_bilinear_out.launches`); CPU tensors to
    `bilinear_warp_reference`."""
    _check(image, grid, padding_mode)
    if image.device.type == 'cpu':
        with torch.no_grad():
            return bilinear_warp_reference(image, grid, padding_mode)[0]
    return _launch_out(image, grid, padding_mode)


def warp_bilinear_dgrid(image, grid, g, padding_mode='zeros'):
    """dgrid [B,Ho,Wo,2] float32 from g = d loss / d out (the image dtype).
    CUDA tensors go to the Hopper kernel (counted in
    `warp_bilinear_dgrid.launches`); CPU tensors to `warp_dgrid_reference`."""
    _check(image, grid, padding_mode, g)
    if image.device.type == 'cpu':
        return warp_dgrid_reference(image, grid, g, padding_mode)
    return _launch_dgrid(image, grid, g, padding_mode)


warp_bilinear_out.launches = 0
warp_bilinear_dgrid.launches = 0


class WarpFunction(torch.autograd.Function):
    """grid_sample under autograd with `_gs_fwd` / `_gs_bwd`'s semantics:
    the forward saves (image, grid) only; dgrid from `warp_bilinear_dgrid`
    (one launch on the card); the image cotangent by autograd through the
    plain version."""

    image_grads = 0

    @staticmethod
    def forward(ctx, image, grid, padding_mode):
        out = warp_bilinear_out(image, grid, padding_mode)
        ctx.padding_mode = padding_mode
        ctx.save_for_backward(image, grid)
        return out

    @staticmethod
    def backward(ctx, g):
        image, grid = ctx.saved_tensors
        dimage = dgrid = None
        if ctx.needs_input_grad[1]:
            dgrid = warp_bilinear_dgrid(
                image, grid, g.to(image.dtype).contiguous(),
                ctx.padding_mode).to(grid.dtype)
        if ctx.needs_input_grad[0]:
            WarpFunction.image_grads += 1
            with torch.enable_grad():
                im = image.detach().requires_grad_(True)
                out = bilinear_warp_reference(im, grid.detach(),
                                              ctx.padding_mode)[0]
                dimage, = torch.autograd.grad(out, im, g.to(out.dtype))
        return dimage, dgrid, None


def grid_sample_fn(image, grid, padding_mode='zeros'):
    """Differentiable bilinear grid_sample through the warp kernels."""
    return WarpFunction.apply(image, grid, padding_mode)


def grid_sample_reference(image, grid, padding_mode='zeros'):
    """The plain version under plain autograd (no kernel, no Function)."""
    _check(image, grid, padding_mode)
    return bilinear_warp_reference(image, grid, padding_mode)[0]
