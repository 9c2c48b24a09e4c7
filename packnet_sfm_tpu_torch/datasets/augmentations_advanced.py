"""
The advanced augmentations on the host (numpy, HWC float32 in [0, 1]), with
the JAX package's datasets/augmentations_advanced.py semantics (reference:
datasets/augmentations_kitti_compatible.py:20-271, configs
default_config.py:167-189):
- per sample, on 'rgb' after the colour jitter (transforms.TrainTransform,
  `make_sample_augmentations`): `RandAugment`, photometric ops only (depth
  training keeps the geometry), and `RandomErasing`, a rectangle set to
  the dataset mean;
- per batch, in the loader (`make_batch_augment`): `mixup_batch` on the
  images (depth is not mixed) and `cutmix_batch`, whose patch carries the
  depth maps with it.

Every draw comes from the np.random.RandomState handed in: a sample's from
its TrainTransform key, a batch's from the loader's (seed, epoch, batch
index) key. Cutmix takes [B,H,W,3] batches only: on a multi-camera batch
(rgb [B,N,H,W,3]) it raises, where JAX's fails to unpack the shape once the
draw picks the batch.
"""

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from packnet_sfm_tpu_torch.datasets.transforms import (
    _adjust_brightness, _adjust_contrast, _adjust_hue, _adjust_saturation)


def _autocontrast(img, _):
    lo = img.min(axis=(0, 1), keepdims=True)
    hi = img.max(axis=(0, 1), keepdims=True)
    return (img - lo) / np.maximum(hi - lo, 1e-6)


def _equalize(img, _):
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = (img[..., c] * 255).astype(np.uint8)
        cdf = np.bincount(ch.ravel(), minlength=256).cumsum()
        cdf = cdf / max(cdf[-1], 1)
        out[..., c] = cdf[ch]
    return out.astype(np.float32)


def _posterize(img, m):
    bits = max(1, int(8 - 4 * m))
    q = (img * 255).astype(np.uint8) >> (8 - bits) << (8 - bits)
    return q.astype(np.float32) / 255.0


def _solarize(img, m):
    return np.where(img >= 1.0 - m, 1.0 - img, img).astype(np.float32)


def _conv3x3(x, k):
    """x [H,W] convolved with a 3x3 kernel, edge-padded."""
    win = sliding_window_view(np.pad(x, 1, mode='edge'), (3, 3))
    return np.einsum('ijkl,kl->ij', win, k)


def _sharpness(img, m):
    k = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    blurred = np.stack([_conv3x3(img[..., c], k)
                        for c in range(img.shape[-1])], axis=-1)
    return np.clip(blurred + (img - blurred) * (1.0 + m), 0, 1).astype(
        np.float32)


RANDAUGMENT_OPS = [
    ('brightness', lambda img, m: _adjust_brightness(img, 1 + m)),
    ('brightness_down', lambda img, m: _adjust_brightness(img, 1 - 0.5 * m)),
    ('contrast', lambda img, m: _adjust_contrast(img, 1 + m)),
    ('saturation', lambda img, m: _adjust_saturation(img, 1 + m)),
    ('hue', lambda img, m: _adjust_hue(img, 0.1 * m)),
    ('autocontrast', _autocontrast),
    ('equalize', _equalize),
    ('posterize', _posterize),
    ('solarize', _solarize),
    ('sharpness', _sharpness),
]


class RandAugment:
    """With probability `prob`, min(n, 3) distinct ops of RANDAUGMENT_OPS
    at magnitude m, in the drawn order."""

    def __init__(self, n=2, m=0.5, prob=0.5):
        self.n, self.m, self.prob = n, m, prob

    def __call__(self, img, rng):
        if rng.rand() >= self.prob:
            return img
        for i in rng.choice(len(RANDAUGMENT_OPS), size=min(self.n, 3),
                            replace=False):
            img = RANDAUGMENT_OPS[i][1](img, self.m)
        return np.clip(img, 0, 1).astype(np.float32)


class RandomErasing:
    """With probability `probability`, one rectangle of area fraction
    U(sl, sh) and aspect ratio U(r1, 1 / r1) set to `mean`; up to 10 draws
    to find one that fits."""

    def __init__(self, probability=0.1, sl=0.02, sh=0.4, r1=0.3,
                 mean=(0.485, 0.456, 0.406)):
        self.p = probability
        self.sl, self.sh, self.r1 = sl, sh, r1
        self.mean = np.asarray(mean, np.float32)

    def __call__(self, img, rng):
        if rng.rand() >= self.p:
            return img
        H, W = img.shape[:2]
        for _ in range(10):
            target = rng.uniform(self.sl, self.sh) * H * W
            ratio = rng.uniform(self.r1, 1.0 / self.r1)
            h = int(round(np.sqrt(target * ratio)))
            w = int(round(np.sqrt(target / ratio)))
            if h < H and w < W:
                y = rng.randint(0, H - h)
                x = rng.randint(0, W - w)
                img = img.copy()
                img[y:y + h, x:x + w] = self.mean
                return img
        return img


def mixup_batch(batch, alpha=0.2, prob=0.5, rng=None):
    """With probability `prob`: rgb and rgb_original become lam x themselves
    + (1 - lam) x a permutation of the batch, lam = max(l, 1 - l) with
    l ~ Beta(alpha, alpha), so that the dominant sample's depth still
    holds. The permutation runs over the first axis (of a multi-camera
    batch too)."""
    if rng.rand() >= prob:
        return batch
    lam = rng.beta(alpha, alpha)
    lam = max(lam, 1 - lam)
    perm = rng.permutation(batch['rgb'].shape[0])
    for key in ('rgb', 'rgb_original'):
        if key in batch:
            batch[key] = lam * batch[key] + (1 - lam) * batch[key][perm]
    return batch


def cutmix_batch(batch, alpha=1.0, prob=0.5, rng=None):
    """With probability `prob`: a box of side sqrt(1 - lam) of the image,
    lam ~ Beta(alpha, alpha), centred at a uniform pixel and clipped to the
    image, copied into rgb, rgb_original, depth and input_depth from a
    permutation of the batch. Raises on a multi-camera batch, whatever the
    draw."""
    if batch['rgb'].ndim != 4:
        raise ValueError(
            'cutmix takes a [B, H, W, 3] batch; rgb {} is a multi-camera '
            'batch ([B, N, H, W, 3]), whose cameras are folded only on the '
            'way to the device'.format(tuple(batch['rgb'].shape)))
    if rng.rand() >= prob:
        return batch
    lam = rng.beta(alpha, alpha)
    B, H, W, _ = batch['rgb'].shape
    cut = np.sqrt(1 - lam)
    ch, cw = int(H * cut), int(W * cut)
    cy, cx = rng.randint(H), rng.randint(W)
    y1, y2 = np.clip(cy - ch // 2, 0, H), np.clip(cy + ch // 2, 0, H)
    x1, x2 = np.clip(cx - cw // 2, 0, W), np.clip(cx + cw // 2, 0, W)
    perm = rng.permutation(B)
    for key in ('rgb', 'rgb_original', 'depth', 'input_depth'):
        if key in batch:
            batch[key] = batch[key].copy()
            batch[key][:, y1:y2, x1:x2] = batch[key][perm][:, y1:y2, x1:x2]
    return batch


def make_sample_augmentations(aug_cfg):
    """The per-sample augmentations enabled in the datasets.augmentation
    node `aug_cfg`, in order: RandAugment(n, m, prob), then
    RandomErasing(probability, sl, sh, r1, mean)."""
    out = []
    ra = aug_cfg.get('randaugment', {})
    if ra.get('enabled', False):
        out.append(RandAugment(ra.get('n', 2), ra.get('m', 0.5),
                               ra.get('prob', 0.5)))
    er = aug_cfg.get('random_erasing', {})
    if er.get('enabled', False):
        out.append(RandomErasing(
            er.get('probability', 0.1), er.get('sl', 0.02), er.get('sh', 0.4),
            er.get('r1', 0.3), er.get('mean', (0.485, 0.456, 0.406))))
    return out


def make_batch_augment(aug_cfg):
    """batch_augment(batch, rng) applying mixup then cutmix, as enabled in
    the datasets.augmentation node `aug_cfg`, both drawing from `rng`; None
    when neither is enabled."""
    mixup = aug_cfg.get('mixup', {})
    cutmix = aug_cfg.get('cutmix', {})
    if not (mixup.get('enabled', False) or cutmix.get('enabled', False)):
        return None

    def batch_augment(batch, rng):
        if mixup.get('enabled', False):
            batch = mixup_batch(batch, mixup.get('alpha', 0.2),
                                mixup.get('prob', 0.5), rng)
        if cutmix.get('enabled', False):
            batch = cutmix_batch(batch, cutmix.get('alpha', 1.0),
                                 cutmix.get('prob', 0.5), rng)
        return batch
    return batch_augment
