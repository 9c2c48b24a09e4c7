"""
View synthesis (the JAX package's geometry/camera_utils.py): reconstruct
with the target camera, project with the reference camera, and sample the
reference image there with bilinear grid_sample (align_corners=True).
"""

import torch

from packnet_sfm_tpu_torch.ops.image import grid_sample


def view_synthesis(ref_image, depth, ref_cam, cam, padding_mode='zeros'):
    """Warp `ref_image` [B,H,W,C] into the frame of `cam` with `depth`
    [B,H,W,1]. `ref_cam` carries the target->reference pose as its Tcw."""
    world_points = cam.reconstruct(depth, frame='w')
    ref_coords = ref_cam.project(world_points, frame='w')
    return grid_sample(ref_image, ref_coords, padding_mode=padding_mode)


def view_synthesis_multi(ref_image, depths, ref_cam, cam,
                         padding_mode='zeros'):
    """Warp `ref_image` with several depth maps of its own resolution in ONE
    grid_sample call: the grids are concatenated along the rows into
    [B, n*H, W, 2] (sampling is independent per output pixel), so the
    upsampled-depth training path makes one warp launch per context instead
    of n. Returns the n warped images."""
    n = len(depths)
    if n == 1:
        return [view_synthesis(ref_image, depths[0], ref_cam, cam,
                               padding_mode=padding_mode)]
    coords = [ref_cam.project(cam.reconstruct(d, frame='w'), frame='w')
              for d in depths]
    big = grid_sample(ref_image, torch.cat(coords, dim=1),
                      padding_mode=padding_mode)
    return list(torch.split(big, big.shape[1] // n, dim=1))
