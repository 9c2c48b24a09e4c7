"""
Image ops on NHWC tensors, matching the JAX package's ops/image.py (whose
interpolation follows torch.nn.functional.interpolate conventions).
"""

import torch.nn.functional as F


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
