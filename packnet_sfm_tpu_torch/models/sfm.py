"""
SfM model family (the JAX package's models/sfm.py:61-118 and :173-261;
reference models/SfmModel.py, SemiSupCompletionModel.py).

Batches are dicts of NHWC tensors: rgb [B,H,W,3], optional input_depth
[B,H,W,1], depth (GT) [B,H,W,1]. The module's `training` flag picks the
branch, as the JAX `train` argument does. Pose networks, the photometric
loss (supervised_loss_weight < 1), the dual-head loss and QAT belong to
later slices of the port and raise NotImplementedError.
"""

import torch
import torch.nn as nn

from packnet_sfm_tpu_torch.losses.supervised import SupervisedLoss
from packnet_sfm_tpu_torch.ops.depth import sigmoid_to_inv_depth, depth2inv
from packnet_sfm_tpu_torch.ops.image import flip_lr, interpolate


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
    """Depth-net wrapper with the training-time random lr-flip (drawn from
    the `generator` a caller passes; none, no flip, as the JAX model without
    a 'flip' rng) and the optional upsampling of every scale to full size."""

    def __init__(self, depth_net, flip_lr_prob=0.0, upsample_depth_maps=False):
        super().__init__()
        self.depth_net = depth_net
        self.flip_lr_prob = flip_lr_prob
        self.upsample_depth_maps = upsample_depth_maps

    def compute_depth_net(self, batch, generator=None):
        rgb, input_depth = batch['rgb'], batch.get('input_depth')
        flip = (self.training and self.flip_lr_prob > 0.0
                and generator is not None
                and float(torch.rand((), generator=generator))
                < self.flip_lr_prob)
        if flip:
            output = _flip_output(self.depth_net(
                flip_lr(rgb),
                None if input_depth is None else flip_lr(input_depth)))
        else:
            output = self.depth_net(rgb, input_depth=input_depth)
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

    def forward_base(self, batch, generator=None):
        return {**self.compute_depth_net(batch, generator), 'poses': None}

    def forward(self, batch, progress=0.0, epoch=0, generator=None):
        return self.forward_base(batch, generator)


class SemiSupCompletionModel(SfmModel):
    """Depth-completion model (the fork's flagship). Eval is the base
    forward; training adds the GT clamp, the sigmoid -> bounded inverse
    depth conversion, the supervised loss on the RGB and RGB+D pyramids,
    the feature-consistency `depth_loss`, and the RGB <-> RGB+D prediction
    consistency against a detached target."""

    def __init__(self, depth_net, supervised_loss=None,
                 supervised_loss_weight=0.9, weight_rgbd=1.0,
                 consistency_loss_weight=0.0, min_depth=0.5, max_depth=80.0,
                 use_log_space=False, qat_outputs=False, **kwargs):
        super().__init__(depth_net, **kwargs)
        self.supervised_loss = supervised_loss or SupervisedLoss()
        self.supervised_loss_weight = supervised_loss_weight
        self.weight_rgbd = weight_rgbd
        self.consistency_loss_weight = consistency_loss_weight
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.use_log_space = use_log_space
        self.qat_outputs = qat_outputs

    def _clamp_gt(self, depth):
        """Clamp valid GT into [min_depth, max_depth]."""
        valid = (depth > 0) & torch.isfinite(depth)
        return torch.where(valid, depth.clamp(self.min_depth, self.max_depth),
                           depth)

    def _bounded(self, sigmoids):
        return [sigmoid_to_inv_depth(s, self.min_depth, self.max_depth,
                                     self.use_log_space) for s in sigmoids]

    def forward(self, batch, progress=0.0, epoch=0, generator=None):
        if not self.training:
            return self.forward_base(batch)
        if self.supervised_loss_weight != 1.0:
            raise NotImplementedError(
                'supervised_loss_weight < 1 needs the photometric loss, '
                'which comes with the self-supervised slice (slice 3)')
        if self.qat_outputs:
            raise NotImplementedError('QAT is not ported yet (slice 5)')
        output = self.forward_base(batch, generator)
        if 'inv_depths' not in output:
            raise NotImplementedError(
                'the dual-head loss is not ported yet (slice 5)')
        gt_inv = depth2inv(self._clamp_gt(batch['depth']))
        sup = self.supervised_loss(self._bounded(output['inv_depths']),
                                   gt_inv, progress=progress, epoch=epoch)
        loss = self.supervised_loss_weight * sup['loss']
        metrics = dict(sup['metrics'])

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
