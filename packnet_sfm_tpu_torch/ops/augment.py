"""
Colour jitter on the card, inside the train step (`tpu.device_augment`):
the JAX package's ops/augment.py. The host pipeline then ships the
un-jittered images and skips its own jitter.

Per sample: brightness, contrast and saturation factors uniform in
[max(0, 1 - x), 1 + x], then a hue rotation through YIQ by a uniform
[-h, h] turn; the target and its context frames take the same factors.
'rgb_original' and 'rgb_context_original' stay un-jittered for the
photometric loss. The factors are drawn on the host from the step's
torch.Generator (4 x B numbers), so a replayed step draws the same ones.
Plain tensor code: the JAX package has no Pallas kernel here.
"""

import math

import torch


def _rgb_to_gray(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def _adjust(img, fb, fc, fs):
    """brightness -> contrast -> saturation of NHWC images, factors
    [B,1,1,1]."""
    img = (img * fb).clamp(0.0, 1.0)
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    img = ((img - mean) * fc + mean).clamp(0.0, 1.0)
    gray = _rgb_to_gray(img)
    return ((img - gray) * fs + gray).clamp(0.0, 1.0)


def _hue_rotate(img, f):
    """Rotate the hue of NHWC images by `f` [B,1,1,1] turns in YIQ."""
    y = _rgb_to_gray(img)[..., 0]
    i = 0.596 * img[..., 0] - 0.274 * img[..., 1] - 0.322 * img[..., 2]
    q = 0.211 * img[..., 0] - 0.523 * img[..., 1] + 0.312 * img[..., 2]
    ang = 2.0 * math.pi * f[..., 0]
    ci, si = torch.cos(ang), torch.sin(ang)
    i2 = ci * i - si * q
    q2 = si * i + ci * q
    r = y + 0.956 * i2 + 0.621 * q2
    g = y - 0.272 * i2 - 0.647 * q2
    b = y - 1.106 * i2 + 1.703 * q2
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 1.0)


def jitter_factors(batch_size, jittering, generator):
    """(fb, fc, fs, fh), each [B,1,1,1] float32 on the CPU, drawn from
    `generator` (a CPU torch.Generator) in that order."""
    b, c, s, h = (float(x) for x in jittering)

    def uniform(lo, hi):
        u = torch.rand(batch_size, 1, 1, 1, generator=generator)
        return lo + (hi - lo) * u

    return (uniform(max(0.0, 1.0 - b), 1.0 + b),
            uniform(max(0.0, 1.0 - c), 1.0 + c),
            uniform(max(0.0, 1.0 - s), 1.0 + s),
            uniform(-h, h))


def device_color_jitter(batch, jittering, generator):
    """`batch` with 'rgb' and 'rgb_context' jittered on their device with
    per-sample factors from `generator`; 'rgb_original' and
    'rgb_context_original' are kept (or set to the un-jittered images)."""
    rgb = batch['rgb']
    fb, fc, fs, fh = (f.to(rgb.device, rgb.dtype) for f in jitter_factors(
        rgb.shape[0], jittering, generator))

    def jit_img(img):
        img = _adjust(img, fb, fc, fs)
        if float(jittering[3]) > 0:
            img = _hue_rotate(img, fh)
        return img

    out = dict(batch)
    out.setdefault('rgb_original', rgb)
    out['rgb'] = jit_img(rgb)
    if batch.get('rgb_context'):
        out.setdefault('rgb_context_original', list(batch['rgb_context']))
        out['rgb_context'] = [jit_img(im) for im in batch['rgb_context']]
    return out
