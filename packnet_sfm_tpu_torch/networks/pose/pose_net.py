"""
The pose networks (the JAX package's networks/pose/pose_net.py).

PoseNet (reference networks/pose/PoseNet.py): an SfmLearner-style net over
the target image concatenated with its contexts, seven stride-2 convs each
followed by GroupNorm(16) and ReLU, then a 1x1 `pose_pred` conv and 0.01
times its spatial mean, [B, N, 6] as [tx, ty, tz, rx, ry, rz] per context.

As in flax: the seven convs compute in the model's compute dtype, the
GroupNorms in float32 with flax's epsilon 1e-6 (torch's default is 1e-5)
and uncentered statistics, and `pose_pred`, whose flax Conv has no dtype,
in float32 because its input is the GroupNorm's float32 output. NCHW
inside; submodules are named after the flax paths (`conv1/Conv_0`,
`conv1/GroupNorm_0`, ..., `pose_pred`).

PoseResNet (reference networks/pose/PoseResNet.py): one ResNet encoder over
two stacked frames and monodepth2's pose decoder, called once per context
on cat(target, context). Its one encoder runs twice a step with two
contexts, so its BatchNorm statistics move twice, in context order, as the
flax module's do. Per context the output is [translation, axisangle],
which Pose.from_vec then reads with the model's rotation mode ('euler').
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from packnet_sfm_tpu_torch.networks.layers.resnet import (
    Conv, GroupNorm, PoseDecoder, ResnetEncoder, resnet_num_ch_enc)


class _ConvGN(nn.Module):
    def __init__(self, cin, cout, k, dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, k, 2, (k - 1) // 2, True, 'xavier',
                           dtype)
        self.GroupNorm_0 = GroupNorm(16, cout, eps=1e-6)

    def forward(self, x):
        return F.relu(self.GroupNorm_0(self.Conv_0(x)))


class PoseNet(nn.Module):
    CHANNELS = (16, 32, 64, 128, 256, 256, 256)
    KERNELS = (7, 5, 3, 3, 3, 3, 3)

    def __init__(self, nb_ref_imgs=2, dtype=torch.float32):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        cin = 3 * (1 + nb_ref_imgs)
        for i, (ch, k) in enumerate(zip(self.CHANNELS, self.KERNELS)):
            setattr(self, 'conv{}'.format(i + 1), _ConvGN(cin, ch, k, dtype))
            cin = ch
        self.pose_pred = Conv(cin, 6 * nb_ref_imgs, 1, init='xavier')

    def forward(self, image, context):
        """image [B,H,W,3] and `nb_ref_imgs` contexts -> [B, N, 6]."""
        if len(context) != self.nb_ref_imgs:
            raise ValueError('PoseNet expects {} contexts, got {}'.format(
                self.nb_ref_imgs, len(context)))
        x = torch.cat([image] + list(context), dim=-1).permute(0, 3, 1, 2)
        for i in range(len(self.CHANNELS)):
            x = getattr(self, 'conv{}'.format(i + 1))(x)
        pose = self.pose_pred(x).mean(dim=(2, 3))
        return 0.01 * pose.reshape(pose.shape[0], self.nb_ref_imgs, 6)


class PoseResNet(nn.Module):
    def __init__(self, version='18pt', dtype=torch.float32):
        super().__init__()
        num_layers = int(version[:2])
        self.encoder = ResnetEncoder(num_layers, dtype=dtype,
                                     num_input_images=2)
        self.decoder = PoseDecoder(resnet_num_ch_enc(num_layers),
                                   num_input_features=1,
                                   num_frames_to_predict_for=2)

    def forward(self, image, context):
        """image [B,H,W,3] and its contexts -> [B, N, 6] float32."""
        out = []
        for ref in context:
            feats = self.encoder(torch.cat([image, ref], -1).permute(
                0, 3, 1, 2))
            axisangle, translation = self.decoder([feats])
            out.append(torch.cat([translation[:, 0], axisangle[:, 0]], 2))
        return torch.cat(out, 1)
