"""
The multi-view photometric loss of the generic (ray-surface) camera (the
JAX package's losses/generic_photometric.py; reference
losses/generic_multiview_photometric_loss.py:92-402):

- the working ray surface is template + coeff * residual, with
  coeff = min((100 * progress)^(4/3) / 100, 1) ramping the learned residual
  in, normalised to unit rays (at progress 0 the residual, and so the
  ray-surface head, gets no gradient);
- the template is `ray_template` ([B,H,W,3] or [H,W,3] rays) when given,
  else the pinhole rays of the batch intrinsics (no caller of either
  package passes a template);
- per context: a GenericCamera and a reference camera at the context pose,
  the depth reconstructed to the world frame, projected by the softmax
  window match (half resolution unless `full_res_projection`) and sampled
  with grid_sample on the warp kernel;
- photometric map, clipping, reduction and smoothness of the pinhole loss
  (losses/photometric.py), on float32 maps through the plain composition:
  the JAX factory gives this loss no `photometric_dtype` or `use_pallas`.
"""

import torch

from packnet_sfm_tpu_torch.geometry.camera_generic import (
    GenericCamera, pinhole_ray_surface)
from packnet_sfm_tpu_torch.losses.photometric import (
    MultiViewPhotometricLoss, ProgressiveScaling)
from packnet_sfm_tpu_torch.ops.depth import inv2depth
from packnet_sfm_tpu_torch.ops.image import (
    grid_sample, interpolate, match_scales)


class GenericMultiViewPhotometricLoss(MultiViewPhotometricLoss):
    """The JAX dataclass's fields: `patch_side` p of the (2p+1)^2 window,
    `full_res_projection` (project at full resolution), and the pinhole
    loss's, with one scale and inverse-depth inputs by default."""

    def __init__(self, num_scales=1, patch_side=20, full_res_projection=False,
                 inputs_are_sigmoids=False, **kwargs):
        super().__init__(num_scales=num_scales,
                         inputs_are_sigmoids=inputs_are_sigmoids, **kwargs)
        self.patch_side = patch_side
        self.full_res_projection = full_res_projection

    def __call__(self, image, context, inv_depths, poses, ray_surface=None,
                 K=None, ray_template=None, progress=0.0):
        """image [B,H,W,3]; context: reference images; inv_depths per scale;
        poses: list of Pose (target -> context); ray_surface: the network's
        {('raysurf', 0): [B,H,W,3]} residual; ray_template: the canonical
        rays the residual is added to, else K [B,3,3]'s pinhole rays.
        Returns {'loss', 'metrics'}."""
        n = ProgressiveScaling(self.progressive_scaling,
                               self.num_scales)(progress)
        inv_depths = inv_depths[:n]
        depths = inv2depth(inv_depths)
        H, W = image.shape[1], image.shape[2]

        residual = ray_surface[('raysurf', 0)]
        if ray_template is not None:
            template = ray_template
        elif K is None:
            raise ValueError('Need intrinsics to derive a ray template')
        else:
            template = pinhole_ray_surface(K, H, W, image.dtype)
        prog = torch.tensor(float(progress), dtype=torch.float32)
        coeff = float(torch.clamp((100.0 * prog) ** (4.0 / 3.0) / 100.0,
                                  max=1.0))
        rmat = template + coeff * residual
        rmat = rmat / torch.linalg.vector_norm(
            rmat, dim=-1, keepdim=True).clamp(min=1e-8)

        scale_shapes = [(d.shape[1], d.shape[2]) for d in depths]
        images = match_scales(image, scale_shapes, n)

        photometric_losses = [[] for _ in range(n)]
        for ref_image, pose in zip(context, poses):
            cam = GenericCamera(rmat, patch_side=self.patch_side)
            ref_cam = GenericCamera(rmat, Tcw=pose,
                                    patch_side=self.patch_side)
            warped = []
            for i, (DH, DW) in enumerate(scale_shapes):
                ref_i = interpolate(ref_image, (DH, DW), 'bilinear', True)
                world = cam.reconstruct(depths[i], frame='w')
                coords = ref_cam.project(
                    world, progress=progress, frame='w',
                    downsample=not self.full_res_projection)
                warped.append(grid_sample(ref_i, coords,
                                          padding_mode=self.padding_mode))
            photo = self._photometric(warped, images, [None] * n)
            for i in range(n):
                photometric_losses[i].append(photo[i])
            if self.automask_loss:
                ref_scales = match_scales(ref_image, scale_shapes, n)
                unwarped = self._photometric(ref_scales, images, [None] * n)
                for i in range(n):
                    photometric_losses[i].append(unwarped[i])

        loss = self._reduce(photometric_losses)
        metrics = {'photometric_loss': loss}
        if self.smooth_loss_weight > 0.0:
            smooth = self._smoothness(inv_depths, images, n)
            metrics['smoothness_loss'] = smooth
            loss = loss + smooth
        return {'loss': loss, 'metrics': metrics}
