"""
Image and depth file IO on the host (numpy HWC float32), with the JAX
package's datasets/io.py semantics:
- RGB loaded as float32 in [0, 1];
- 16-bit PNG depth maps divided by 256; a PNG whose values all lie at or
  below 255 is refused (not a 16-bit depth map);
- .npz depth under the 'depth' key.

PNG goes through Pillow, as in the JAX package, on the CPU and on the card's
host alike: one path, no native decoder.
"""

import numpy as np
from PIL import Image


def load_image(path):
    """RGB image as float32 [H,W,3] in [0,1]."""
    with Image.open(path) as img:
        return np.asarray(img.convert('RGB'), np.float32) / 255.0


def load_depth(path):
    """Depth map [H,W] float32; invalid pixels are 0."""
    if path.endswith('.npz'):
        return np.load(path)['depth'].astype(np.float32)
    if path.endswith('.png'):
        with Image.open(path) as img:
            depth_png = np.asarray(img, dtype=int)
        if np.max(depth_png) <= 255:
            raise ValueError('Wrong .png depth file: {}'.format(path))
        return depth_png.astype(np.float32) / 256.0
    raise NotImplementedError('Depth extension not supported: ' + path)


def write_depth(path, depth, intrinsics=None):
    """Save depth as .npz (with intrinsics) or as a 16-bit PNG of
    depth x 256."""
    if path.endswith('.npz'):
        np.savez_compressed(path, depth=depth, intrinsics=intrinsics)
    elif path.endswith('.png'):
        # a uint16 array saves as a 16-bit PNG; the values the JAX package
        # writes through an int32 'I' image, whose PNG writer Pillow 13 drops
        Image.fromarray(np.clip(depth * 256, 0, 65535).astype(np.uint16)
                        ).save(path)
    else:
        raise NotImplementedError('Depth filename not valid: ' + path)


def write_image(path, image):
    """Save an [H,W,3] float image in [0,1] as 8-bit RGB."""
    arr = np.clip(image * 255, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
