"""
Depth conversions, flip-TTA fusion and the evaluation metrics (NHWC), as in
the JAX package's ops/depth.py.

Reference semantics: packnet_sfm/utils/post_process_depth.py:13-169,
utils/depth.py:103-160 (converters), :201-255 (flip fusion), :258-483
(metrics: garg crop, median scaling, scale_output).
"""

import math

import torch

from packnet_sfm_tpu_torch.ops.image import (
    flip_lr, gradient_x, gradient_y, interpolate)

METRIC_COUNT = 7


def sigmoid_to_inv_depth(sig, min_depth=0.05, max_depth=80.0,
                         use_log_space=False):
    """Bounded inverse depth from sigmoid in [0,1] (linear or log)."""
    min_inv = 1.0 / max(max_depth, 1e-6)
    max_inv = 1.0 / max(min_depth, 1e-6)
    if use_log_space:
        log_min, log_max = math.log(min_inv), math.log(max_inv)
        return torch.exp(log_min + (log_max - log_min) * sig)
    return min_inv + (max_inv - min_inv) * sig


def sigmoid_to_depth_linear(sig, min_depth=0.05, max_depth=80.0):
    """depth = 1 / (linear bounded inverse depth + 1e-8)."""
    return 1.0 / (sigmoid_to_inv_depth(sig, min_depth, max_depth) + 1e-8)


def sigmoid_to_depth_log(sig, min_depth=0.05, max_depth=80.0):
    """depth from the log-space bounded inverse depth."""
    return 1.0 / (sigmoid_to_inv_depth(sig, min_depth, max_depth, True)
                  + 1e-8)


def disp_to_depth(disp, min_depth, max_depth):
    """monodepth2's sigmoid -> (scaled disparity, depth) in [min, max]."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def inv_depths_normalize(inv_depths):
    """Each [B,H,W,1] map divided by its spatial mean (clamped at 1e-6)."""
    return [d / d.mean(dim=(1, 2), keepdim=True).clamp(min=1e-6)
            for d in inv_depths]


def calc_smoothness(inv_depths, images, num_scales):
    """Edge-aware smoothness terms per scale: the gradients of the
    mean-normalised maps weighted by exp(-mean_c |image gradient|)."""
    inv_norm = inv_depths_normalize(inv_depths)
    sx, sy = [], []
    for i in range(num_scales):
        wx = torch.exp(-gradient_x(images[i]).abs().mean(dim=3, keepdim=True))
        wy = torch.exp(-gradient_y(images[i]).abs().mean(dim=3, keepdim=True))
        sx.append(gradient_x(inv_norm[i]) * wx)
        sy.append(gradient_y(inv_norm[i]) * wy)
    return sx, sy


def inv2depth(inv_depth):
    """1 / clamp(inv_depth, 1e-6) (lists map elementwise)."""
    if isinstance(inv_depth, (list, tuple)):
        return [inv2depth(x) for x in inv_depth]
    return 1.0 / inv_depth.clamp(min=1e-6)


def depth2inv(depth):
    """Inverse depth with zeros kept for invalid (<=0) pixels."""
    if isinstance(depth, (list, tuple)):
        return [depth2inv(x) for x in depth]
    inv = 1.0 / depth.clamp(min=1e-6)
    return torch.where(depth <= 0.0, torch.zeros_like(inv), inv)


def dual_head_to_depth(integer_sig, fractional_sig, max_depth):
    """depth = integer_sig * max_depth + fractional_sig."""
    return integer_sig * max_depth + fractional_sig


def decompose_depth(depth_gt, max_depth):
    """GT -> (integer metres / max_depth, the fractional part)."""
    integer_m = torch.floor(depth_gt)
    return integer_m / max_depth, depth_gt - integer_m


def dual_head_to_inv_depth(integer_sig, fractional_sig, max_depth,
                           min_depth=0.5):
    """1 / the dual-head depth clamped to [min_depth, max_depth + 1]."""
    depth = dual_head_to_depth(integer_sig, fractional_sig, max_depth)
    return 1.0 / depth.clamp(min_depth, max_depth + 1.0)


def fuse_inv_depth(inv_depth, inv_depth_hat, method='mean'):
    if method == 'mean':
        return 0.5 * (inv_depth + inv_depth_hat)
    if method == 'max':
        return torch.maximum(inv_depth, inv_depth_hat)
    if method == 'min':
        return torch.minimum(inv_depth, inv_depth_hat)
    raise ValueError('Unknown fuse method {}'.format(method))


def post_process_inv_depth(inv_depth, inv_depth_flipped, method='mean'):
    """Blend straight and flipped predictions with a lateral ramp mask."""
    W = inv_depth.shape[2]
    inv_hat = flip_lr(inv_depth_flipped)
    fused = fuse_inv_depth(inv_depth, inv_hat, method)
    xs = torch.linspace(0.0, 1.0, W, dtype=inv_depth.dtype,
                        device=inv_depth.device)
    mask = (1.0 - (20.0 * (xs - 0.05)).clamp(0.0, 1.0))[None, None, :, None]
    mask_hat = mask.flip(2)
    return mask_hat * inv_depth + mask * inv_hat + \
        (1.0 - mask - mask_hat) * fused


def scale_depth(pred, gt_shape, scale_fn):
    """Match predicted depth [B,h,w,1] to the GT resolution
    (reference: utils/depth.py:450-483)."""
    H, W = gt_shape[1], gt_shape[2]
    if scale_fn == 'resize' or scale_fn == '':
        return interpolate(pred, (H, W), mode='bilinear', align_corners=True)
    if scale_fn == 'top-center':
        B, h, w, C = pred.shape
        top, left = H - h, (W - w) // 2
        out = pred.new_zeros((B, H, W, C))
        out[:, top:top + h, left:left + w] = pred
        return out
    raise NotImplementedError(
        'scale_output {} not implemented'.format(scale_fn))


def masked_median(x, mask):
    """Median of x over mask == True; the mean of the two middle values for
    an even count, as jnp.nanmedian gives (torch.nanmedian would return the
    lower one). NaN when the mask is empty."""
    vals = x[mask].sort().values
    n = vals.numel()
    if n == 0:
        return x.new_tensor(float('nan'))
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2])


def _single_image_metrics(gt, pred, valid, use_gt_scale):
    """7 metrics for one image ([H,W] maps, boolean valid mask)."""
    n = int(valid.sum())
    if n == 0:
        # images without valid pixels contribute zeros (reference
        # utils/depth.py "continue" on empty masks)
        return gt.new_zeros(METRIC_COUNT)
    if use_gt_scale:
        scale = masked_median(gt, valid) / \
            masked_median(pred, valid).clamp(min=1e-12)
        pred = pred * scale
    g, p = gt[valid], pred[valid]
    thresh = torch.maximum(g / p, p / g)
    diff = g - p
    return torch.stack([
        (diff.abs() / g).mean(),
        (diff ** 2 / g).mean(),
        (diff ** 2).mean().sqrt(),
        ((g.log() - p.log()) ** 2).mean().sqrt(),
        (thresh < 1.25).float().mean(),
        (thresh < 1.25 ** 2).float().mean(),
        (thresh < 1.25 ** 3).float().mean(),
    ])


def compute_depth_metrics(gt, pred, min_depth, max_depth, crop='',
                          scale_output='resize', use_gt_scale=True):
    """
    [abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3] averaged over the batch.
    gt/pred are [B,H,W,1]; the garg-crop bounds truncate with int() exactly
    as the reference does (utils/depth.py:332-339).
    """
    B, H, W, _ = gt.shape
    pred = scale_depth(pred, gt.shape, scale_output)
    valid = (gt > min_depth) & (gt < max_depth)
    if crop == 'garg':
        y1, y2 = int(0.40810811 * H), int(0.99189189 * H)
        x1, x2 = int(0.03594771 * W), int(0.96405229 * W)
        crop_mask = torch.zeros((H, W), dtype=torch.bool, device=gt.device)
        crop_mask[y1:y2, x1:x2] = True
        valid = valid & crop_mask[None, :, :, None]
    per_image = [_single_image_metrics(gt[b, ..., 0], pred[b, ..., 0],
                                       valid[b, ..., 0], use_gt_scale)
                 for b in range(B)]
    return torch.stack(per_image).sum(0) / B
