"""
SSIM distance on NHWC images (the JAX package's ops/ssim.py): reflection
pad 1 and 3x3 average pools for every moment. This is the photometric
loss's default composition; the fused kernel (ops/kernels/photometric.py)
serves the float32 path when `use_pallas` is set.

`clamp_variance` is the low-precision path: float32 moments over (bf16)
inputs, with the variances projected onto >= 0.

Bounds are taken with torch.maximum / torch.minimum, not torch.clamp: at a
tie they split the gradient in halves, as jnp.maximum, jnp.minimum and
jnp.clip do, where torch.clamp passes all of it (identical images put
(1 - SSIM) / 2 exactly on 0).
"""

import torch

from packnet_sfm_tpu_torch.ops.image import avg_pool_3x3, reflect_pad_2d


def clip(x, lo, hi):
    """jnp.clip with its gradient: half at a tie with a bound."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def ssim(x, y, C1=1e-4, C2=9e-4, clamp_variance=False):
    """SSIM map of two [B,H,W,C] images, [B,H,W,C]."""
    xp = reflect_pad_2d(x, 1)
    yp = reflect_pad_2d(y, 1)
    if clamp_variance:
        xp, yp = xp.float(), yp.float()
    mu_x = avg_pool_3x3(xp)
    mu_y = avg_pool_3x3(yp)
    sigma_x = avg_pool_3x3(xp * xp) - mu_x * mu_x
    sigma_y = avg_pool_3x3(yp * yp) - mu_y * mu_y
    if clamp_variance:
        zero = sigma_x.new_zeros(())
        sigma_x = torch.maximum(sigma_x, zero)
        sigma_y = torch.maximum(sigma_y, zero)
    sigma_xy = avg_pool_3x3(xp * yp) - mu_x * mu_y

    v1 = 2.0 * sigma_xy + C2
    v2 = sigma_x + sigma_y + C2
    num = (2.0 * (mu_x * mu_y) + C1) * v1
    den = (mu_x * mu_x + mu_y * mu_y + C1) * v2
    return num / den


def ssim_loss(x, y, C1=1e-4, C2=9e-4, clamp_variance=False):
    """Clamped SSIM distance (1 - SSIM) / 2 in [0, 1]."""
    return clip((1.0 - ssim(x, y, C1, C2, clamp_variance)) * 0.5, 0.0, 1.0)
