"""
Sample transforms on the host (numpy, HWC float32 in [0,1]): the JAX
package's datasets/transforms.py.

- train: crop (crop_train_borders) -> resize every map (RGB LANCZOS through
  uint8, depth and input depth by the sparse-preserving scatter, a mask
  nearest) and scale the intrinsics and the fisheye principal point ->
  keep un-jittered copies ('rgb_original', 'rgb_context_original') ->
  colour jitter (brightness, contrast, saturation, HSV hue; one set of
  factors for the target and its contexts) -> the advanced augmentations
  enabled in the config (RandAugment, random erasing; on 'rgb' only);
- validation / test: crop the inputs (eval GT depth stays full-size) ->
  resize RGB (Pillow LANCZOS, after the float -> uint8 quantization) and
  the input depth (validation: the sparse-preserving scatter; test:
  nearest); validation also resizes a mask (nearest);
- parse_crop_borders: negative = from the far border, float = centred
  fraction;
- crops and resizes move the intrinsics (3x3) and the fisheye principal
  point (distortion_coeffs ux, uy).

The JAX package draws the jitter from the global `np.random` unless given a
generator, an order its loader threads do not fix. Here the jitter always
takes an explicit `np.random.RandomState`: `TrainTransform` makes one per
sample, keyed by (seed, dataset, epoch, sample index), so an epoch and a
mid-epoch resume replay the same jitter, and the advanced augmentations
draw from the same generator after it. The distributions are the JAX
package's. A multi-camera (DGP) sample runs its transform once per camera,
each keyed by the sample's index: the cameras of one sample share their
draws, as a target and its contexts share the jitter.
"""

import numpy as np
from PIL import Image


def _is_int(x):
    return isinstance(x, (int, np.integer))


def _axis_bounds(start_raw, end_raw, size):
    """One axis of the 4-value crop form as [start, end). Integers: a
    negative start counts back from the far border; an end <= 0 also counts
    from the far border, a positive end is a length from the start. Floats:
    start_raw is a centre fraction of the axis and end_raw an extent in
    pixels centred on it."""
    if _is_int(start_raw):
        start = start_raw + size if start_raw < 0 else start_raw
        end = end_raw + size if end_raw <= 0 else start + end_raw
        return start, end
    center = start_raw * size
    return int(center - end_raw / 2), int(center + end_raw / 2)


def _axis_margin(value, size):
    """One axis of the 2-value crop form: a positive value trims from the
    near border, a negative one from the far border."""
    return max(0, value), size + min(0, value)


def parse_crop_borders(borders, shape):
    """(left, top, right, bottom) crop window from the crop mini-language:
    () keeps the image; (ys, ye, xs, xe) resolves each axis on its own
    (`_axis_bounds`); (extent, value) trims a margin on both axes when value
    is an int, else centres a window of `extent` pixels at fraction value."""
    H, W = shape[0], shape[1]
    if len(borders) == 0:
        return 0, 0, W, H
    if len(borders) == 4:
        ys, ye, xs, xe = borders
        left, right = _axis_bounds(xs, xe, W)
        top, bottom = _axis_bounds(ys, ye, H)
    elif len(borders) == 2:
        extent, value = borders
        if _is_int(value):
            left, right = _axis_margin(value, W)
            top, bottom = _axis_margin(extent, H)
        else:
            left, right = _axis_bounds(value, extent, W)
            top, bottom = _axis_bounds(value, extent, H)
    else:
        raise NotImplementedError('Crop tuple must have 2 or 4 values.')
    if not (0 <= left < right <= W and 0 <= top < bottom <= H):
        raise ValueError('Crop borders {} are invalid'.format(
            (left, top, right, bottom)))
    return left, top, right, bottom


def resize_image(image, shape):
    """LANCZOS resize of an [H,W,3] float image to (H', W') through uint8."""
    pil = Image.fromarray(np.clip(image * 255, 0, 255).astype(np.uint8))
    pil = pil.resize((shape[1], shape[0]), Image.LANCZOS)
    return np.asarray(pil, np.float32) / 255.0


def resize_depth(depth, shape):
    """Nearest-neighbour depth resize [h,w(,1)] -> [H,W,1]."""
    d = np.squeeze(depth)
    h, w = d.shape
    ys = np.floor(np.arange(shape[0]) * (h / shape[0])).astype(int)
    xs = np.floor(np.arange(shape[1]) * (w / shape[1])).astype(int)
    return d[ys][:, xs][..., None].astype(np.float32)


def resize_depth_preserve(depth, shape):
    """Scatter the valid depth points into the resized map (no
    interpolation)."""
    if depth is None:
        return depth
    d = np.squeeze(depth)
    h, w = d.shape
    x = d.reshape(-1)
    uv = np.mgrid[:h, :w].transpose(1, 2, 0).reshape(-1, 2)
    idx = x > 0
    crd, val = uv[idx], x[idx]
    crd = crd.astype(np.float64)
    crd[:, 0] = (crd[:, 0] * (shape[0] / h)).astype(np.int32)
    crd[:, 1] = (crd[:, 1] * (shape[1] / w)).astype(np.int32)
    crd = crd.astype(np.int32)
    inside = (crd[:, 0] < shape[0]) & (crd[:, 1] < shape[1])
    crd, val = crd[inside], val[inside]
    out = np.zeros(shape, np.float32)
    out[crd[:, 0], crd[:, 1]] = val
    return out[..., None]


def scale_intrinsics(K, sx, sy):
    """A 3x3 intrinsics matrix for an image scaled by (sx, sy)."""
    K = np.copy(K)
    K[0, 0] *= sx
    K[1, 1] *= sy
    K[0, 2] *= sx
    K[1, 2] *= sy
    return K


def crop_sample(sample, borders):
    """Crop images, depths, the mask and the principal point."""
    left, top, right, bottom = borders
    for key in ('rgb', 'rgb_original'):
        if key in sample:
            sample[key] = sample[key][top:bottom, left:right]
    for key in ('rgb_context', 'rgb_context_original'):
        if key in sample:
            sample[key] = [im[top:bottom, left:right] for im in sample[key]]
    for key in ('depth', 'input_depth', 'mask'):
        if key in sample and sample[key] is not None:
            sample[key] = sample[key][top:bottom, left:right]
    if 'intrinsics' in sample and \
            np.asarray(sample['intrinsics']).shape == (3, 3):
        K = np.copy(sample['intrinsics'])
        K[0, 2] -= left
        K[1, 2] -= top
        sample['intrinsics'] = K
    if 'distortion_coeffs' in sample:
        dc = dict(sample['distortion_coeffs'])
        dc['ux'] = dc['ux'] - left
        dc['uy'] = dc['uy'] - top
        sample['distortion_coeffs'] = dc
    return sample


def crop_sample_input(sample, borders):
    """Crop only the model inputs, leaving the eval GT depth full-size."""
    keep_depth = sample.pop('depth', None)
    sample = crop_sample(sample, borders)
    if keep_depth is not None:
        sample['depth'] = keep_depth
    return sample


def _eval_transforms(sample, image_shape, crop_eval_borders, preserve):
    if len(crop_eval_borders) > 0:
        borders = parse_crop_borders(crop_eval_borders,
                                     sample['rgb'].shape[:2])
        sample = crop_sample_input(sample, borders)
    if len(image_shape) > 0:
        shape = tuple(image_shape)
        sample['rgb'] = resize_image(sample['rgb'], shape)
        if 'rgb_context' in sample:
            sample['rgb_context'] = [resize_image(im, shape)
                                     for im in sample['rgb_context']]
        if 'input_depth' in sample:
            sample['input_depth'] = (resize_depth_preserve if preserve else
                                     resize_depth)(sample['input_depth'],
                                                   shape)
        if preserve and sample.get('mask') is not None:
            sample['mask'] = resize_depth(sample['mask'], shape)
    return sample


def validation_transforms(sample, image_shape=(), crop_eval_borders=()):
    """Crop the inputs, resize RGB, scatter the input depth, resize a mask."""
    return _eval_transforms(sample, image_shape, crop_eval_borders, True)


def test_transforms(sample, image_shape=(), crop_eval_borders=()):
    """Crop the inputs, resize RGB and (nearest) the input depth."""
    return _eval_transforms(sample, image_shape, crop_eval_borders, False)


def resize_sample(sample, shape):
    """Resize the images, depths and mask of a train sample to `shape` and
    scale its intrinsics and fisheye principal point with them."""
    h, w = sample['rgb'].shape[:2]
    sx, sy = shape[1] / w, shape[0] / h
    if 'intrinsics' in sample and \
            np.asarray(sample['intrinsics']).shape == (3, 3):
        sample['intrinsics'] = scale_intrinsics(
            np.asarray(sample['intrinsics'], np.float32), sx, sy)
    if 'distortion_coeffs' in sample:
        dc = dict(sample['distortion_coeffs'])
        dc['ux'] = dc['ux'] * sx
        dc['uy'] = dc['uy'] * sy
        sample['distortion_coeffs'] = dc
    for key in ('rgb', 'rgb_original'):
        if key in sample:
            sample[key] = resize_image(sample[key], shape)
    for key in ('rgb_context', 'rgb_context_original'):
        if key in sample:
            sample[key] = [resize_image(im, shape) for im in sample[key]]
    for key in ('depth', 'input_depth'):
        if key in sample and sample[key] is not None:
            sample[key] = resize_depth_preserve(sample[key], shape)
    if sample.get('mask') is not None:
        sample['mask'] = resize_depth(sample['mask'], shape)
    return sample


def duplicate_sample(sample):
    """Keep un-jittered copies of the images for the photometric loss."""
    sample['rgb_original'] = sample['rgb'].copy()
    if 'rgb_context' in sample:
        sample['rgb_context_original'] = [im.copy()
                                          for im in sample['rgb_context']]
    return sample


def _adjust_brightness(img, f):
    return np.clip(img * f, 0, 1)


def _adjust_contrast(img, f):
    mean = img.mean(axis=(0, 1), keepdims=True).mean()
    return np.clip((img - mean) * f + mean, 0, 1)


def _adjust_saturation(img, f):
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]
    return np.clip((img - gray) * f + gray, 0, 1)


def _adjust_hue(img, f):
    """Rotate the hue by `f` turns through HSV."""
    maxc = img.max(axis=-1)
    minc = img.min(axis=-1)
    v = maxc
    s = np.where(maxc > 0, (maxc - minc) / np.maximum(maxc, 1e-8), 0)
    span = np.maximum(maxc - minc, 1e-8)
    rc, gc, bc = (np.where(maxc > minc, (maxc - img[..., c]) / span, 0)
                  for c in range(3))
    h = np.where(img[..., 0] == maxc, bc - gc,
                 np.where(img[..., 1] == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = (h + f) % 1.0
    i = np.floor(h * 6.0)
    fr = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * fr)
    t = v * (1 - s * (1 - fr))
    i = i.astype(int) % 6
    conds = [i == k for k in range(6)]
    r = np.select(conds, [v, q, p, p, t, v])
    g = np.select(conds, [t, v, v, q, p, p])
    b = np.select(conds, [p, p, t, v, v, q])
    return np.clip(np.stack([r, g, b], axis=-1), 0, 1).astype(np.float32)


def colorjitter_sample(sample, parameters, rng):
    """Jitter 'rgb' and 'rgb_context' with one set of factors drawn from
    `rng` (an np.random.RandomState): brightness, contrast and saturation
    uniform in [max(0, 1 - x), 1 + x], hue uniform in [-h, h] turns."""
    b, c, s, h = parameters
    fb = rng.uniform(max(0, 1 - b), 1 + b)
    fc = rng.uniform(max(0, 1 - c), 1 + c)
    fs = rng.uniform(max(0, 1 - s), 1 + s)
    fh = rng.uniform(-h, h)

    def jitter(img):
        img = _adjust_brightness(img, fb)
        img = _adjust_contrast(img, fc)
        img = _adjust_saturation(img, fs)
        if h > 0:
            img = _adjust_hue(img, fh)
        return img.astype(np.float32)

    sample['rgb'] = jitter(sample['rgb'])
    if 'rgb_context' in sample:
        sample['rgb_context'] = [jitter(im) for im in sample['rgb_context']]
    return sample


def train_transforms(sample, image_shape=(), jittering=(),
                     crop_train_borders=(), rng=None, advanced=()):
    """Crop, resize, keep the un-jittered copies, jitter, then each of
    `advanced` (callables (rgb, rng) -> rgb) on 'rgb'. `rng` (an
    np.random.RandomState) is required when `jittering` or `advanced` is
    set."""
    if len(crop_train_borders) > 0:
        borders = parse_crop_borders(crop_train_borders,
                                     sample['rgb'].shape[:2])
        sample = crop_sample(sample, borders)
    if len(image_shape) > 0:
        sample = resize_sample(sample, tuple(image_shape))
    sample = duplicate_sample(sample)
    if (len(jittering) > 0 or advanced) and rng is None:
        raise ValueError('the colour jitter and the advanced augmentations '
                         'need an explicit np.random.RandomState')
    if len(jittering) > 0:
        sample = colorjitter_sample(sample, jittering, rng)
    for aug in advanced:
        sample['rgb'] = aug(sample['rgb'], rng)
    return sample


class TrainTransform:
    """`train_transforms` with a generator per sample: the jitter and the
    `advanced` augmentations of sample `idx` in `epoch` are drawn from
    np.random.RandomState([seed, dataset, epoch, idx]). `set_epoch` moves
    it on (DataLoader.set_epoch reaches it through the dataset)."""

    def __init__(self, image_shape=(), jittering=(), crop_train_borders=(),
                 seed=0, dataset=0, advanced=()):
        self.image_shape = tuple(image_shape)
        self.jittering = tuple(jittering)
        self.crop_train_borders = tuple(crop_train_borders)
        self.advanced = list(advanced)
        self.key = (int(seed), int(dataset))
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __call__(self, sample):
        rng = np.random.RandomState(
            self.key + (self.epoch, int(sample['idx'])))
        return train_transforms(sample, self.image_shape, self.jittering,
                                self.crop_train_borders, rng, self.advanced)


def get_transforms(mode, image_shape=(), jittering=(), crop_train_borders=(),
                   crop_eval_borders=(), augmentation=None, seed=0,
                   dataset=0):
    """The sample transform of a split: 'train' (a TrainTransform keyed by
    `seed` and `dataset`, with the advanced augmentations `augmentation`
    enables), 'validation' or 'test'."""
    if mode == 'train':
        # imported here: augmentations_advanced builds on this module
        from packnet_sfm_tpu_torch.datasets.augmentations_advanced import (
            make_sample_augmentations)
        return TrainTransform(image_shape, jittering, crop_train_borders,
                              seed, dataset,
                              make_sample_augmentations(augmentation or {}))
    if mode == 'validation':
        return lambda s: validation_transforms(s, image_shape,
                                               crop_eval_borders)
    if mode == 'test':
        return lambda s: test_transforms(s, image_shape, crop_eval_borders)
    raise ValueError('Unknown transform mode {}'.format(mode))
