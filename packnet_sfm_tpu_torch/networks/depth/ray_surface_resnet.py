"""
RaySurfaceResNet: a ResNet depth network with a second, learned ray-surface
decoder (the JAX package's networks/depth/ray_surface_resnet.py; reference
networks/depth/RaySurfaceResNet.py:34-61,
layers/resnet/raysurface_decoder.py:16-64).

- ResNet encoder (18/34/50 layers: `version` '18pt' means 18), NCHW
  inside; a 'pt' version gets its ImageNet weights when train.build builds
  it (utils/pretrained.py), or raises without them unless
  model.depth_net.allow_random_init is set;
- the monodepth2 depth decoder, its sigmoids turned into inverse depths by
  `disp_to_depth(disp, 0.1, 100.0)[0]`: 4 scales in training, 1 in eval;
- `RaySurfaceDecoder`: the same trunk with its own weights and a 3-channel
  head `raysurf_conv_0`, tanh taken in float32: {('raysurf', 0): [B,H,W,3]}.

Public layout is NHWC. `input_depth` (the batch's LiDAR, passed on by
SfmModel.compute_depth_net) is taken and ignored.
"""

import torch
import torch.nn as nn

from packnet_sfm_tpu_torch.networks.depth.resnet_san import _nchw, _nhwc
from packnet_sfm_tpu_torch.networks.layers.resnet import (
    DepthDecoder, ResnetEncoder, _ConvWrap, _DecoderTrunk, resnet_num_ch_enc)
from packnet_sfm_tpu_torch.ops.depth import disp_to_depth


class RaySurfaceDecoder(_DecoderTrunk):
    """Returns {('raysurf', s): tanh [B,3,H,W] float32} per scale."""

    def __init__(self, num_ch_enc, scales=(0,), dtype=torch.float32):
        super().__init__(num_ch_enc, dtype)
        self.scales = tuple(scales)
        for i in self.scales:
            setattr(self, 'raysurf_conv_{}'.format(i),
                    _ConvWrap(self.num_ch_dec[i], 3, dtype))

    def forward(self, input_features):
        def head(i, x):
            r = getattr(self, 'raysurf_conv_{}'.format(i))(x)
            return {('raysurf', i): torch.tanh(r.float())}
        return self.trunk(input_features, head)


class RaySurfaceResNet(nn.Module):
    def __init__(self, version='18pt', dtype=torch.float32):
        super().__init__()
        num_layers = int(version[:2])
        ch = resnet_num_ch_enc(num_layers)
        self.encoder = ResnetEncoder(num_layers, dtype=dtype)
        self.decoder = DepthDecoder(ch, dtype=dtype)
        self.ray_surf = RaySurfaceDecoder(ch, dtype=dtype)

    def forward(self, rgb, input_depth=None):
        """{'inv_depths': [B,H,W,1] per scale, 'ray_surface':
        {('raysurf', 0): [B,H,W,3]}}."""
        feats = self.encoder(_nchw(rgb))
        rays = self.ray_surf(feats)
        disps = self.decoder(feats)
        scales = range(4) if self.training else range(1)
        return {'inv_depths': [
            disp_to_depth(_nhwc(disps[('disp', i)]), 0.1, 100.0)[0]
            for i in scales],
            'ray_surface': {k: _nhwc(v) for k, v in rays.items()}}
