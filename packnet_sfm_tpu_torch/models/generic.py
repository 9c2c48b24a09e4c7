"""
The generic (ray-surface camera) model family (the JAX package's
models/generic.py; reference models/GenericSfmModel.py:10-95,
GenericSelfSupModel.py:9-120). The depth net (RaySurfaceResNet) returns
inverse depths and a learned per-pixel ray surface; the photometric loss
projects with the softmax GenericCamera.
"""

from packnet_sfm_tpu_torch.losses.generic_photometric import (
    GenericMultiViewPhotometricLoss)
from packnet_sfm_tpu_torch.models.sfm import SfmModel


class GenericSfmModel(SfmModel):
    """Depth and pose composition whose depth output carries a ray surface;
    its forward is the base forward in training and eval."""


class GenericSelfSupModel(GenericSfmModel):
    """+ the generic photometric loss in training, at the step's
    `progress` (the softmax temperature and the ray-surface ramp)."""

    def __init__(self, depth_net, generic_photometric_loss=None, **kwargs):
        super().__init__(depth_net, **kwargs)
        self.generic_photometric_loss = (generic_photometric_loss or
                                         GenericMultiViewPhotometricLoss())

    def forward(self, batch, progress=0.0, epoch=0, generator=None):
        output = self.forward_base(batch, generator)
        if not self.training:
            return output
        loss_out = self.generic_photometric_loss(
            batch.get('rgb_original', batch['rgb']),
            batch.get('rgb_context_original', batch.get('rgb_context')),
            output['inv_depths'], output['poses'],
            ray_surface=output.get('ray_surface'),
            K=batch.get('intrinsics'), progress=progress)
        return {'loss': loss_out['loss'], 'metrics': loss_out['metrics'],
                **output}
