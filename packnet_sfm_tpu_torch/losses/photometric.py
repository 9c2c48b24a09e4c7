"""
The multi-view photometric loss for pinhole cameras (the JAX package's
losses/photometric.py; reference losses/multiview_photometric_loss.py) and
the scale-decay schedule it shares with the supervised loss.

- the network's sigmoids become depth by the linear bounded mapping inside
  the loss; smoothness runs on the sigmoids;
- per-scale cameras with the principal-point rescale;
- photometric map = alpha * SSIM distance + (1 - alpha) * L1, channel mean;
  with `photometric_dtype` 'bfloat16' the maps run in bf16 with float32
  SSIM moments (ops/ssim.py `clamp_variance`) and are cast back to float32;
  `use_pallas` runs the fused kernels (ops/kernels/photometric.py) on the
  float32 path only, as the JAX loss does;
- optional mean + c * std clipping with a detached bound and the unbiased
  std, and an optional pixel mask;
- 'mean' or 'min' over the contexts; 'min' with `automask_loss` appends the
  unwarped context's map before the min (monodepth2 automasking);
- edge-aware smoothness on mean-normalised maps, weight / 2^i per scale.

When every scale has the target's resolution (`upsample_depth_maps`), each
context is warped once for all scales (geometry/camera_utils.py
`view_synthesis_multi`). The VADAS fisheye camera is not ported yet: a
`distortion` argument raises NotImplementedError.
"""

import numpy as np
import torch

from packnet_sfm_tpu_torch.geometry.camera import Camera, scale_intrinsics
from packnet_sfm_tpu_torch.geometry.camera_utils import (
    view_synthesis, view_synthesis_multi)
from packnet_sfm_tpu_torch.ops.depth import (
    calc_smoothness, inv2depth, sigmoid_to_depth_linear)
from packnet_sfm_tpu_torch.ops.image import interpolate, match_scales
from packnet_sfm_tpu_torch.ops.kernels import photometric as photo_kernels
from packnet_sfm_tpu_torch.ops.ssim import ssim_loss


class ProgressiveScaling:
    """Decay the number of scales with training progress in [0, 1]."""

    def __init__(self, progressive_scaling, num_scales=4):
        self.num_scales = num_scales
        if progressive_scaling > 0.0:
            self.breaks = np.float32(
                [progressive_scaling * (i + 1) for i in range(num_scales - 1)]
                + [1.0])
        else:
            self.breaks = None

    def __call__(self, progress):
        if self.breaks is None:
            return self.num_scales
        return int(self.num_scales - np.searchsorted(self.breaks,
                                                     float(progress)))


def _abs(x):
    """|x| with jnp.abs's gradient at 0 (+1, where torch.abs gives 0)."""
    return torch.where(x >= 0, x, -x)


class MultiViewPhotometricLoss:
    """The loss as a callable; its fields are the JAX dataclass's, less
    `occ_reg_weight` and `disp_norm`, which that loss never reads."""

    def __init__(self, num_scales=4, ssim_loss_weight=0.85,
                 smooth_loss_weight=0.1, C1=1e-4, C2=9e-4,
                 photometric_reduce_op='min', clip_loss=0.0,
                 progressive_scaling=0.0,
                 padding_mode='zeros', automask_loss=False, min_depth=0.05,
                 max_depth=80.0, inputs_are_sigmoids=True, use_pallas=False,
                 photometric_dtype='float32'):
        if automask_loss and photometric_reduce_op != 'min':
            raise ValueError('Automasking requires min photometric_reduce_op')
        if photometric_dtype not in ('float32', 'bfloat16'):
            raise ValueError('photometric_dtype must be float32 or bfloat16, '
                             'got {!r}'.format(photometric_dtype))
        self.num_scales = num_scales
        self.ssim_loss_weight = ssim_loss_weight
        self.smooth_loss_weight = smooth_loss_weight
        self.C1, self.C2 = C1, C2
        self.photometric_reduce_op = photometric_reduce_op
        self.clip_loss = clip_loss
        self.progressive_scaling = progressive_scaling
        self.padding_mode = padding_mode
        self.automask_loss = automask_loss
        self.min_depth, self.max_depth = min_depth, max_depth
        self.inputs_are_sigmoids = inputs_are_sigmoids
        self.use_pallas = use_pallas
        self.photometric_dtype = photometric_dtype

    # ----------------------------------------------------------- cameras
    @staticmethod
    def _build_cams(shape_full, shape_scaled, K, pose):
        """Per-scale (cam, ref_cam); ref_cam carries the target->ref pose."""
        (H, W), (DH, DW) = shape_full, shape_scaled
        Ks = scale_intrinsics(K, DW / float(W), DH / float(H))
        return Camera(Ks), Camera(Ks, pose)

    # ------------------------------------------------------------- terms
    def _photometric(self, t_est, images, masks):
        """Per-pixel photometric maps [B,h,w,1] per scale."""
        out = []
        lowp = self.photometric_dtype == 'bfloat16'
        if lowp:
            t_est = [t.to(torch.bfloat16) for t in t_est]
            images = [t.to(torch.bfloat16) for t in images]
        alpha = self.ssim_loss_weight
        for est, img, m in zip(t_est, images, masks):
            if self.use_pallas and not lowp and alpha > 0.0:
                photo = photo_kernels.photometric_map_fn(est, img, alpha,
                                                         self.C1, self.C2)
            elif alpha > 0.0:
                l1 = _abs(est - img)
                s = ssim_loss(est, img, self.C1, self.C2, clamp_variance=lowp)
                # under bf16 the L1 term and its channel mean stay bf16
                photo = (alpha * s.mean(dim=3, keepdim=True)
                         + (1 - alpha) * l1.mean(dim=3, keepdim=True))
            else:
                photo = _abs(est - img)
            if self.clip_loss > 0.0:
                # the bound is detached: clipped pixels get no gradient
                bound = (photo.mean() + self.clip_loss * photo.std()).detach()
                photo = torch.minimum(photo, bound)
            if m is not None:
                photo = photo * m
            out.append(photo.float() if lowp else photo)
        return out

    def _reduce(self, photometric_losses):
        def reduce_fn(losses):
            if self.photometric_reduce_op == 'mean':
                return sum(l.mean() for l in losses) / len(losses)
            if self.photometric_reduce_op == 'min':
                # amin splits the gradient over ties, as jnp.min does
                return torch.cat(losses, dim=3).amin(dim=3).mean()
            raise NotImplementedError(self.photometric_reduce_op)
        n = len(photometric_losses)
        return sum(reduce_fn(pl) for pl in photometric_losses) / n

    def _smoothness(self, maps, images, n):
        sx, sy = calc_smoothness(maps, images, n)
        # nearest-upsampled maps are flat over whole blocks: the gradient
        # of |0| must be jnp.abs's
        loss = sum((_abs(sx[i]).mean() + _abs(sy[i]).mean()) / 2 ** i
                   for i in range(n)) / n
        return self.smooth_loss_weight * loss

    # -------------------------------------------------------------- main
    def __call__(self, image, context, inv_depths, poses, K=None,
                 distortion=None, mask=None, progress=0.0):
        """image: target [B,H,W,3]; context: list of reference images;
        inv_depths: per-scale network outputs (sigmoids by default); poses:
        list of Pose (target -> context); K [B,3,3]. Returns {'loss',
        'metrics'}."""
        if distortion is not None:
            raise NotImplementedError(
                'the fisheye (VADAS) camera is not ported yet')
        n = ProgressiveScaling(self.progressive_scaling,
                               self.num_scales)(progress)
        sigmoids = inv_depths[:n]
        if self.inputs_are_sigmoids:
            depths = [sigmoid_to_depth_linear(s, self.min_depth,
                                              self.max_depth)
                      for s in sigmoids]
        else:
            depths = inv2depth(sigmoids)
        H, W = image.shape[1], image.shape[2]
        scale_shapes = [(d.shape[1], d.shape[2]) for d in depths]
        images = match_scales(image, scale_shapes, n)
        masks_scaled = (match_scales(mask, scale_shapes, n, mode='nearest')
                        if mask is not None else [None] * n)

        lowp = self.photometric_dtype == 'bfloat16'
        fuse_scales = all(s == (H, W) for s in scale_shapes) and n > 1
        photometric_losses = [[] for _ in range(n)]
        for ref_image, pose in zip(context, poses):
            if fuse_scales:
                cam, ref_cam = self._build_cams((H, W), (H, W), K, pose)
                ref_i = ref_image.to(torch.bfloat16) if lowp else ref_image
                warped = view_synthesis_multi(ref_i, depths, ref_cam, cam,
                                              padding_mode=self.padding_mode)
            else:
                warped = []
                for i, (DH, DW) in enumerate(scale_shapes):
                    cam, ref_cam = self._build_cams((H, W), (DH, DW), K, pose)
                    ref_i = interpolate(ref_image, (DH, DW), 'bilinear', True)
                    if lowp:
                        ref_i = ref_i.to(torch.bfloat16)
                    warped.append(view_synthesis(
                        ref_i, depths[i], ref_cam, cam,
                        padding_mode=self.padding_mode))
            photo = self._photometric(warped, images, masks_scaled)
            for i in range(n):
                photometric_losses[i].append(photo[i])
            if self.automask_loss:
                ref_scales = match_scales(ref_image, scale_shapes, n)
                # at equal resolutions the n unwarped maps are the same
                # tensors: each distinct (ref, target, mask) once
                uniq = {}
                for i in range(n):
                    key = (id(ref_scales[i]), id(images[i]),
                           id(masks_scaled[i]))
                    if key not in uniq:
                        uniq[key] = self._photometric(
                            [ref_scales[i]], [images[i]],
                            [masks_scaled[i]])[0]
                    photometric_losses[i].append(uniq[key])

        loss = self._reduce(photometric_losses)
        metrics = {'photometric_loss': loss}
        if self.smooth_loss_weight > 0.0:
            smooth = self._smoothness(sigmoids, images, n)
            metrics['smoothness_loss'] = smooth
            loss = loss + smooth
        return {'loss': loss, 'metrics': metrics}
