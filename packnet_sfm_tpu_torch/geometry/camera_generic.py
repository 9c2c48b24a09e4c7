"""
The generic (learned ray-surface) camera with the softmax patch projection
(the JAX package's geometry/camera_generic.py; reference
geometry/camera_generic.py:17-208):

- reconstruct: P(x, y) = depth(x, y) * ray(x, y) with the per-pixel ray;
- project: each target direction is matched, by a softmax at an annealed
  temperature, against the rays of a (2p+1)^2 window of the reference ray
  surface around its pixel (windows shifted into the image); the expected
  window coordinate is the projection. By default at half resolution, then
  upsampled.

The projection always takes the JAX `'pallas'` branch's formulation: the
direction is divided by the temperature before the match, both planes are
NCHW float32, and the expectation comes from
ops/kernels/generic_projection.py `expected_patch_coords_fn` (the CUDA
kernels' Function on CUDA tensors, the plain version on CPU tensors, looked
up at call time). Like the TPU kernel, it needs the window to fit the
image: its wrappers raise where 2p+1 exceeds the projected height or width.

Layout: ray surfaces and points are [B,H,W,3], depth maps [B,H,W,1].
"""

import numpy as np
import torch

from packnet_sfm_tpu_torch.geometry.camera import Camera, image_grid
from packnet_sfm_tpu_torch.geometry.pose import Pose
from packnet_sfm_tpu_torch.ops.image import interpolate
from packnet_sfm_tpu_torch.ops.kernels import generic_projection


def _patch_coords(H, W, p):
    """[H*W, K, 2] in-bounds window coordinates (row, col) of every pixel
    (numpy): the (2p+1)^2 offsets around it, the whole window shifted into
    the image per axis."""
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    centers = np.stack([gy.ravel(), gx.ravel()], 1)
    off = np.arange(-p, p + 1)
    oy, ox = np.meshgrid(off, off, indexing='ij')
    coords = centers[:, None, :] + np.stack([oy.ravel(), ox.ravel()], 1)[None]
    for a, size in ((0, H), (1, W)):
        low, high = coords[:, 0, a], coords[:, -1, a]
        coords[:, :, a] -= np.minimum(low, 0)[:, None]
        coords[:, :, a] -= np.maximum(high - (size - 1), 0)[:, None]
    return coords.astype(np.int32)


def softmax_temperature(progress):
    """max(1e-8, 1e-4 / exp(0.1 * progress)) in float32, as a float."""
    t = 1e-4 / torch.exp(0.1 * torch.tensor(float(progress),
                                            dtype=torch.float32))
    return float(torch.clamp(t, min=1e-8))


class GenericCamera:
    """ray_surface [B,H,W,3] unit rays; Tcw the camera -> world pose
    (identity when not given); patch_side p of the (2p+1)^2 window."""

    def __init__(self, ray_surface, Tcw=None, patch_side=20):
        self.ray_surface = ray_surface
        self.Tcw = Tcw if Tcw is not None else Pose.identity(
            ray_surface.shape[0], ray_surface.dtype, ray_surface.device)
        self.patch_side = patch_side

    @property
    def Twc(self):
        return self.Tcw.inverse()

    def reconstruct(self, depth, frame='w'):
        Xc = self.ray_surface * depth
        if frame == 'c':
            return Xc
        if frame == 'w':
            return self.Twc @ Xc
        raise ValueError('Unknown reference frame {}'.format(frame))

    def project(self, X, progress=0.0, downsample=True, frame='c'):
        """Softmax window projection of [B,H,W,3] points -> [-1, 1] grid
        coordinates [B,H,W,2] in grid_sample's (x = col, y = row) order."""
        B, H, W, _ = X.shape
        if frame == 'w':
            X = self.Tcw @ X
        ray, direction = self.ray_surface, X
        if downsample:
            H2, W2 = H // 2, W // 2
            ray = interpolate(ray, (H2, W2), 'bilinear', True)
            direction = interpolate(direction, (H2, W2), 'bilinear', True)
        else:
            H2, W2 = H, W
        p = self.patch_side
        d = direction / torch.linalg.vector_norm(
            direction, dim=-1, keepdim=True).clamp(min=1e-8)
        temperature = softmax_temperature(progress)
        ray_p = ray.float().permute(0, 3, 1, 2).contiguous()
        d_p = (d / temperature).float().permute(0, 3, 1, 2).contiguous()
        rows, cols = generic_projection.expected_patch_coords_fn(ray_p, d_p,
                                                                 p)
        xnorm = 2.0 * rows / (H2 - 1) - 1.0   # row-normalised (JAX naming)
        ynorm = 2.0 * cols / (W2 - 1) - 1.0
        if downsample:
            xnorm = interpolate(xnorm[..., None], (H, W), 'bilinear',
                                True)[..., 0]
            ynorm = interpolate(ynorm[..., None], (H, W), 'bilinear',
                                True)[..., 0]
        return torch.stack([ynorm, xnorm], dim=-1)


def pinhole_ray_surface(K, H, W, dtype=torch.float32):
    """Unit pinhole rays [B,H,W,3] from intrinsics K [B,3,3]: the generic
    loss's ray template."""
    cam = Camera(K)
    grid = image_grid(cam.K.shape[0], H, W, dtype, K.device)
    rays = torch.einsum('bij,bhwj->bhwi', cam.Kinv.to(dtype), grid)
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
