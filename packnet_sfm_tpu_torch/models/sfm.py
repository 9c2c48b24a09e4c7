"""
SfM model family (the JAX package's models/sfm.py; reference
models/SfmModel.py, SelfSupModel.py, SemiSupModel.py,
SemiSupCompletionModel.py, VelSupModel.py).

Batches are dicts of NHWC tensors: rgb [B,H,W,3], optional input_depth
[B,H,W,1], depth (GT) [B,H,W,1], and for the self-supervised terms
rgb_original, rgb_context and rgb_context_original (lists of [B,H,W,3]) and
intrinsics [B,3,3], or the fisheye camera's 'distortion_coeffs' (a dict
of k [B,7], s, div, ux, uy [B]; the loss then takes no K), and for the
velocity term 'pose_context' (a list of [B,4,4] target -> context poses).
The module's `training` flag picks the branch, as the JAX `train` argument
does.
"""

import torch
import torch.nn as nn

from packnet_sfm_tpu_torch.geometry.pose import Pose
from packnet_sfm_tpu_torch.losses.dual_head import DualHeadDepthLoss
from packnet_sfm_tpu_torch.losses.photometric import MultiViewPhotometricLoss
from packnet_sfm_tpu_torch.losses.supervised import SupervisedLoss
from packnet_sfm_tpu_torch.losses.velocity import velocity_loss
from packnet_sfm_tpu_torch.ops.depth import sigmoid_to_inv_depth, depth2inv
from packnet_sfm_tpu_torch.ops.image import flip_lr, interpolate
from packnet_sfm_tpu_torch.ops.quantization import ste_quant_u8


def _flip_output(output):
    """Flip depth-like outputs back after a flipped forward."""
    flipped = {}
    for k, v in output.items():
        if k in ('inv_depths', 'inv_depths_rgbd'):
            flipped[k] = [flip_lr(d) for d in v]
        elif isinstance(k, tuple):  # dual-head ('integer', i) maps
            flipped[k] = flip_lr(v)
        else:
            flipped[k] = v
    return flipped


class SfmModel(nn.Module):
    """Depth and pose networks, with the training-time random lr-flip of the
    depth net's input (drawn from the `generator` a caller passes; none, no
    flip, as the JAX model without a 'flip' rng) and the optional upsampling
    of every scale to full size. The pose net's parameters must sit under
    the attribute `pose_net`: the optimizer's pose group is chosen by that
    name (parallel/train_step.py make_optimizer)."""

    def __init__(self, depth_net, pose_net=None, rotation_mode='euler',
                 flip_lr_prob=0.0, upsample_depth_maps=False):
        super().__init__()
        self.depth_net = depth_net
        self.pose_net = pose_net
        self.rotation_mode = rotation_mode
        self.flip_lr_prob = flip_lr_prob
        self.upsample_depth_maps = upsample_depth_maps

    def compute_depth_net(self, batch, generator=None):
        rgb, input_depth = batch['rgb'], batch.get('input_depth')
        flip = (self.training and self.flip_lr_prob > 0.0
                and generator is not None
                and float(torch.rand((), generator=generator))
                < self.flip_lr_prob)
        # a depth net with dropout (the PackNet family) draws its masks
        # from the step's generator too, after the flip's draw
        kw = ({'generator': generator}
              if getattr(self.depth_net, 'needs_generator', False) else {})
        if flip:
            output = _flip_output(self.depth_net(
                flip_lr(rgb),
                None if input_depth is None else flip_lr(input_depth), **kw))
        else:
            output = self.depth_net(rgb, input_depth=input_depth, **kw)
        if self.training and self.upsample_depth_maps:
            output = self._upsample_output(output)
        return output

    @staticmethod
    def _upsample_output(output):
        out = dict(output)
        for key in ('inv_depths', 'inv_depths_rgbd'):
            if key in out:
                shape = out[key][0].shape[1:3]
                out[key] = [interpolate(d, shape, mode='nearest')
                            for d in out[key]]
        return out

    def compute_pose_net(self, image, contexts):
        pose_vec = self.pose_net(image, contexts)
        return [Pose.from_vec(pose_vec[:, i], self.rotation_mode)
                for i in range(pose_vec.shape[1])]

    def forward_base(self, batch, generator=None):
        output = self.compute_depth_net(batch, generator)
        poses = None
        if batch.get('rgb_context') and self.pose_net is not None:
            poses = self.compute_pose_net(batch['rgb'], batch['rgb_context'])
        return {**output, 'poses': poses}

    def forward(self, batch, progress=0.0, epoch=0, generator=None):
        return self.forward_base(batch, generator)


class SelfSupModel(SfmModel):
    """+ the multi-view photometric loss on the un-jittered originals."""

    def __init__(self, depth_net, photometric_loss=None, **kwargs):
        super().__init__(depth_net, **kwargs)
        self.photometric_loss = photometric_loss or MultiViewPhotometricLoss()

    def self_supervised_loss(self, batch, output, progress=0.0):
        """The photometric loss: through the fisheye camera when the batch
        carries 'distortion_coeffs' (K is then not passed), else the
        pinhole one."""
        distortion = batch.get('distortion_coeffs')
        return self.photometric_loss(
            batch.get('rgb_original', batch['rgb']),
            batch.get('rgb_context_original', batch.get('rgb_context')),
            output['inv_depths'], output['poses'],
            K=batch.get('intrinsics') if distortion is None else None,
            distortion=distortion, mask=batch.get('mask'),
            progress=progress)

    def forward(self, batch, progress=0.0, epoch=0, generator=None):
        output = self.forward_base(batch, generator)
        if not self.training:
            return output
        if output.get('poses') is None:
            # no context frames: the self-supervised term is undefined
            return {'loss': batch['rgb'].new_zeros(()), 'metrics': {},
                    **output}
        self_sup = self.self_supervised_loss(batch, output, progress)
        return {'loss': self_sup['loss'], 'metrics': self_sup['metrics'],
                **output}

    def _self_sup_part(self, batch, progress, generator, weight):
        """(output, (1 - weight) * self-supervised loss, its metrics); the
        photometric loss is skipped at supervised weight 1."""
        if weight == 1.0:
            output = self.forward_base(batch, generator)
            return output, batch['rgb'].new_zeros(()), {}
        output = SelfSupModel.forward(self, batch, progress=progress,
                                      generator=generator)
        return output, (1.0 - weight) * output['loss'], dict(
            output['metrics'])


class SemiSupModel(SelfSupModel):
    """+ the supervised loss on the raw outputs, weighted against the
    self-supervised one."""

    def __init__(self, depth_net, supervised_loss=None,
                 supervised_loss_weight=0.9, **kwargs):
        super().__init__(depth_net, **kwargs)
        self.supervised_loss = supervised_loss or SupervisedLoss()
        self.supervised_loss_weight = supervised_loss_weight

    def forward(self, batch, progress=0.0, epoch=0, generator=None):
        if not self.training:
            return self.forward_base(batch)
        output, loss, metrics = self._self_sup_part(
            batch, progress, generator, self.supervised_loss_weight)
        sup = self.supervised_loss(output['inv_depths'],
                                   depth2inv(batch['depth']),
                                   progress=progress, epoch=epoch)
        loss = loss + self.supervised_loss_weight * sup['loss']
        metrics.update(sup['metrics'])
        return {**output, 'loss': loss, 'metrics': metrics}


class SemiSupCompletionModel(SelfSupModel):
    """Depth-completion model (the fork's flagship). Eval is the base
    forward; training adds the GT clamp, the sigmoid -> bounded inverse
    depth conversion, the supervised loss on the RGB and RGB+D pyramids,
    the feature-consistency `depth_loss`, and the RGB <-> RGB+D prediction
    consistency against a detached target. A dual-head depth net's
    ('integer', i) / ('fractional', i) maps take `dual_head_loss` instead
    of the supervised loss. `qat_outputs` (model.params.qat 'outputs')
    puts the straight-through uint8 fake quantizer on every head sigmoid
    before its conversion, where the eval protocol's int8_outputs puts
    fake_quant_u8."""

    def __init__(self, depth_net, supervised_loss=None,
                 supervised_loss_weight=0.9, weight_rgbd=1.0,
                 consistency_loss_weight=0.0, min_depth=0.5, max_depth=80.0,
                 use_log_space=False, qat_outputs=False, dual_head_loss=None,
                 **kwargs):
        super().__init__(depth_net, **kwargs)
        self.supervised_loss = supervised_loss or SupervisedLoss()
        self.supervised_loss_weight = supervised_loss_weight
        self.weight_rgbd = weight_rgbd
        self.consistency_loss_weight = consistency_loss_weight
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.use_log_space = use_log_space
        self.qat_outputs = qat_outputs
        self.dual_head_loss = dual_head_loss or DualHeadDepthLoss(
            max_depth=max_depth, min_depth=min_depth)

    def _clamp_gt(self, depth):
        """Clamp valid GT into [min_depth, max_depth]."""
        valid = (depth > 0) & torch.isfinite(depth)
        return torch.where(valid, depth.clamp(self.min_depth, self.max_depth),
                           depth)

    def _bounded(self, sigmoids):
        if self.qat_outputs:
            sigmoids = [ste_quant_u8(s) for s in sigmoids]
        return [sigmoid_to_inv_depth(s, self.min_depth, self.max_depth,
                                     self.use_log_space) for s in sigmoids]

    def forward(self, batch, progress=0.0, epoch=0, generator=None):
        if not self.training:
            return self.forward_base(batch)
        output, loss, metrics = self._self_sup_part(
            batch, progress, generator, self.supervised_loss_weight)
        gt = self._clamp_gt(batch['depth'])
        gt_inv = depth2inv(gt)
        if 'inv_depths' in output:
            sup = self.supervised_loss(self._bounded(output['inv_depths']),
                                       gt_inv, progress=progress,
                                       epoch=epoch)
        else:
            # the dual-head maps, ('integer', i) / ('fractional', i)
            heads = {k: v for k, v in output.items() if isinstance(k, tuple)}
            if self.qat_outputs:
                heads = {k: ste_quant_u8(v) for k, v in heads.items()}
            sup = self.dual_head_loss(heads, gt, progress=progress)
        loss = loss + self.supervised_loss_weight * sup['loss']
        metrics.update(sup['metrics'])

        if 'inv_depths_rgbd' in output:
            sup2 = self.supervised_loss(
                self._bounded(output['inv_depths_rgbd']), gt_inv,
                progress=progress, epoch=epoch)
            loss = loss + (self.weight_rgbd * self.supervised_loss_weight
                           * sup2['loss'])
            metrics['supervised_loss_rgbd'] = sup2['loss']
            if 'depth_loss' in output:
                loss = loss + output['depth_loss']
                metrics['feature_consistency_loss'] = output['depth_loss']
            if self.consistency_loss_weight > 0:
                cons = sum((pr - prd.detach()).abs().mean() for pr, prd in
                           zip(output['inv_depths'],
                               output['inv_depths_rgbd']))
                cons = cons / len(output['inv_depths'])
                loss = loss + self.consistency_loss_weight * cons
                metrics['consistency_loss'] = cons
        return {**output, 'loss': loss, 'metrics': metrics}


class VelSupModel(SelfSupModel):
    """+ the velocity loss between the predicted context poses and the
    batch's 'pose_context', weighted by `velocity_loss_weight`."""

    def __init__(self, depth_net, photometric_loss=None,
                 velocity_loss_weight=0.1, **kwargs):
        super().__init__(depth_net, photometric_loss, **kwargs)
        self.velocity_loss_weight = velocity_loss_weight

    def forward(self, batch, progress=0.0, epoch=0, generator=None):
        output = SelfSupModel.forward(self, batch, progress=progress,
                                      generator=generator)
        if self.training:
            vel = velocity_loss(output['poses'], batch['pose_context'])
            output['loss'] = output['loss'] + \
                self.velocity_loss_weight * vel['loss']
            output['metrics'] = {**output['metrics'], **vel['metrics']}
        return output
