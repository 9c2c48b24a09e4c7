"""
PoseNet (the JAX package's networks/pose/pose_net.py; reference
networks/pose/PoseNet.py): an SfmLearner-style net over the target image
concatenated with its contexts, seven stride-2 convs each followed by
GroupNorm(16) and ReLU, then a 1x1 `pose_pred` conv and 0.01 times its
spatial mean, [B, N, 6] as [tx, ty, tz, rx, ry, rz] per context.

As in flax: the seven convs compute in the model's compute dtype, the
GroupNorms in float32 with flax's epsilon 1e-6 (torch's default is 1e-5)
and uncentered statistics, and `pose_pred`, whose flax Conv has no dtype,
in float32 because its input is the GroupNorm's float32 output. NCHW
inside; submodules are named after the flax paths (`conv1/Conv_0`,
`conv1/GroupNorm_0`, ..., `pose_pred`). PoseResNet is not ported yet.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from packnet_sfm_tpu_torch.networks.layers.resnet import Conv


class GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm(num_groups, dtype=float32): statistics in float32,
    var = max(E[x^2] - E[x]^2, 0), epsilon 1e-6, affine."""

    def __init__(self, num_groups, channels):
        super().__init__(num_groups, channels, eps=1e-6)

    def forward(self, x):
        xf = x.float()
        B, C = xf.shape[:2]
        g = xf.reshape(B, self.num_groups, -1)
        mean = g.mean(dim=2, keepdim=True)
        var = ((g * g).mean(dim=2, keepdim=True) - mean * mean).clamp(min=0)
        y = (g - mean) * torch.rsqrt(var + self.eps)
        return y.reshape(xf.shape) * self.weight[:, None, None] + \
            self.bias[:, None, None]


class _ConvGN(nn.Module):
    def __init__(self, cin, cout, k, dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, k, 2, (k - 1) // 2, True, 'xavier',
                           dtype)
        self.GroupNorm_0 = GroupNorm(16, cout)

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
