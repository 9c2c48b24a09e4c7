"""
Image ops on NHWC tensors, matching the JAX package's ops/image.py (whose
interpolation follows torch.nn.functional.interpolate conventions).
"""

import torch.nn.functional as F

from packnet_sfm_tpu_torch.ops.kernels import warp


def gradient_x(image):
    """Forward difference along W: [B,H,W,C] -> [B,H,W-1,C]."""
    return image[:, :, :-1, :] - image[:, :, 1:, :]


def gradient_y(image):
    """Forward difference along H: [B,H,W,C] -> [B,H-1,W,C]."""
    return image[:, :-1, :, :] - image[:, 1:, :, :]


def reflect_pad_2d(x, pad=1):
    """Reflection padding of H and W of [B,H,W,C] (ReflectionPad2d)."""
    return F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                 mode='reflect').permute(0, 2, 3, 1)


def avg_pool_3x3(x):
    """3x3 stride-1 valid average pool of [B,H,W,C], as separable shifted
    sums in the JAX package's order."""
    h = x[:, :-2] + x[:, 1:-1] + x[:, 2:]
    s = h[:, :, :-2] + h[:, :, 1:-1] + h[:, :, 2:]
    return s / 9.0


def grid_sample(image, grid, padding_mode='zeros'):
    """Bilinear sampling of [B,H,W,C] at normalised coordinates grid
    [B,Ho,Wo,2] (x, y in [-1, 1]), as F.grid_sample(mode='bilinear',
    align_corners=True) with 'zeros' or 'border' padding. Differentiable:
    the warp kernel's autograd Function on CUDA tensors, its plain version
    on CPU tensors (ops/kernels/warp.py, looked up at call time)."""
    return warp.grid_sample_fn(image, grid, padding_mode)


def flip_lr(image):
    """Horizontal flip of an NHWC image."""
    return image.flip(2)


def interpolate(image, shape, mode='bilinear', align_corners=True):
    """Resize [B,H,W,C] to (H', W') with torch's 'bilinear' (align_corners
    True/False) or 'nearest' (src = floor(i * in/out)) conventions."""
    H, W = int(shape[0]), int(shape[1])
    if tuple(image.shape[1:3]) == (H, W):
        return image
    if mode not in ('bilinear', 'nearest'):
        raise ValueError('Unknown interpolation mode {}'.format(mode))
    x = image.permute(0, 3, 1, 2)
    kw = {'align_corners': align_corners} if mode == 'bilinear' else {}
    return F.interpolate(x, size=(H, W), mode=mode, **kw).permute(0, 2, 3, 1)


def upsample2x_nearest(x):
    """2x nearest upsample [B,H,W,C] -> [B,2H,2W,C]."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def match_scales(image, target_shapes, num_scales, mode='bilinear',
                 align_corners=True):
    """`num_scales` resized copies of `image`, one per (H, W) in
    `target_shapes` (tuples, or tensors [B,H,W,C])."""
    out = []
    for t in target_shapes[:num_scales]:
        hw = t if isinstance(t, tuple) else (t.shape[1], t.shape[2])
        out.append(interpolate(image, hw, mode=mode,
                               align_corners=align_corners))
    return out
