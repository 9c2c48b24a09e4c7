"""
DepthResNet: the plain monodepth2 depth network (the JAX package's
networks/depth/depth_resnet.py; reference networks/depth/DepthResNet.py):
a ResNet encoder (18/34/50 layers; `version` '18pt' means 18, and a 'pt'
version gets its ImageNet weights when train.build builds it,
utils/pretrained.py) and the monodepth2 depth decoder, its sigmoids turned
into scaled disparities by `disp_to_depth(disp, 0.1, 100.0)[0]`, in
[0.01, 10]: 4 scales in training, 1 in eval.

Unlike the SAN nets it returns disparities, not sigmoids, yet the
photometric loss and the eval read its output as a sigmoid (the loss's
`inputs_are_sigmoids`, the eval's `sigmoid_to_inv_depth`), as in the JAX
package, which the port follows.

Public layout is NHWC. `input_depth` is taken and ignored. The JAX
module's `dropout` field is unused there, and the port has none.
"""

import torch
import torch.nn as nn

from packnet_sfm_tpu_torch.networks.depth.resnet_san import _nchw, _nhwc
from packnet_sfm_tpu_torch.networks.layers.resnet import (
    DepthDecoder, ResnetEncoder, resnet_num_ch_enc)
from packnet_sfm_tpu_torch.ops.depth import disp_to_depth


class DepthResNet(nn.Module):
    def __init__(self, version='18pt', dtype=torch.float32):
        super().__init__()
        num_layers = int(version[:2])
        self.encoder = ResnetEncoder(num_layers, dtype=dtype)
        self.decoder = DepthDecoder(resnet_num_ch_enc(num_layers),
                                    dtype=dtype)

    def forward(self, rgb, input_depth=None):
        """{'inv_depths': [B,H,W,1] float32 per scale}."""
        disps = self.decoder(self.encoder(_nchw(rgb)))
        scales = range(4) if self.training else range(1)
        return {'inv_depths': [
            disp_to_depth(_nhwc(disps[('disp', i)]), 0.1, 100.0)[0]
            for i in scales]}
