"""
A plain folder of images with dummy intrinsics, read on the host with numpy,
with the JAX package's datasets/image_dataset.py semantics (reference:
packnet_sfm/datasets/image_dataset.py:14-60):
- the frames are the lines of the split file under the root, when one is
  given and exists, else every .png, .jpg, .jpeg and .bmp of the root,
  sorted;
- the intrinsics are `dummy_intrinsics` (f = 1000 px, the principal point
  at the image centre less half a pixel);
- context frame j of sample idx is min(max(idx + j, 0), len - 1): at the
  ends of the folder a context repeats the nearest frame.

`write_image_tree` writes such a folder for tests and smoke runs.
"""

import glob
import os

import numpy as np
from PIL import Image

from packnet_sfm_tpu_torch.datasets.io import load_image, write_image

EXTENSIONS = ('.png', '.jpg', '.jpeg', '.bmp')


def dummy_intrinsics(w, h):
    """The 3x3 intrinsics of a w x h image of unknown calibration."""
    return np.array([[1000., 0., w / 2. - 0.5],
                     [0., 1000., h / 2. - 0.5],
                     [0., 0., 1.]], np.float32)


class ImageDataset:
    def __init__(self, path, split='', transform=None, back_context=0,
                 forward_context=0, **kwargs):
        self.path = path
        self.transform = transform
        self.back_context = back_context
        self.forward_context = forward_context
        if split and os.path.isfile(os.path.join(path, split)):
            with open(os.path.join(path, split)) as f:
                self.files = [os.path.join(path, line.strip()) for line in f
                              if line.strip()]
        else:
            self.files = sorted(f for ext in EXTENSIONS
                                for f in glob.glob(os.path.join(path,
                                                                '*' + ext)))

    def set_epoch(self, epoch):
        """Pass the epoch on to a transform keyed by it (TrainTransform)."""
        if hasattr(self.transform, 'set_epoch'):
            self.transform.set_epoch(epoch)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        rgb = load_image(self.files[idx])
        h, w = rgb.shape[:2]
        sample = {
            'idx': idx,
            'filename': os.path.splitext(os.path.basename(
                self.files[idx]))[0],
            'rgb': rgb,
            'intrinsics': dummy_intrinsics(w, h),
        }
        if self.back_context or self.forward_context:
            last = len(self.files) - 1
            sample['rgb_context'] = [
                load_image(self.files[min(max(idx + off, 0), last)])
                for off in range(-self.back_context, self.forward_context + 1)
                if off != 0]
        if self.transform:
            sample = self.transform(sample)
        return sample


def smooth_texture(rng, H, W, cell=8):
    """[H, W, 3] float32 in [0, 1]: uniform noise on a grid of `cell` px,
    upsampled bilinearly (through uint8, as a PNG holds it)."""
    low = rng.rand(H // cell + 2, W // cell + 2, 3).astype(np.float32)
    big = Image.fromarray((low * 255).astype(np.uint8)).resize(
        (W + 2 * cell, H + 2 * cell), Image.BILINEAR)
    return np.asarray(big, np.float32)[cell:cell + H, cell:cell + W] / 255.0


def write_image_tree(root, n, H, W, seed=0, shift=4):
    """Write `n` frames of H x W as <root>/NNNNNN.png (for tests and smoke
    runs): windows of one smooth texture (`smooth_texture`, from numpy seed
    `seed`), each `shift` px right of the one before, so that neighbouring
    frames match as under a small yaw of the camera. Returns `root`."""
    os.makedirs(root, exist_ok=True)
    tex = smooth_texture(np.random.RandomState(seed), H, W + shift * n)
    for i in range(n):
        write_image(os.path.join(root, '{:06d}.png'.format(i)),
                    tex[:, shift * i:shift * i + W])
    return root
