"""
PackNet's packing and unpacking layers (the JAX package's
networks/layers/packnet.py; reference networks/layers/packnet/layers01.py),
NCHW inside.

- `packing` / `unpacking`: space-to-depth and its inverse, [B,H,W,C] <->
  [B,H/r,W/r,C*r^2] with channel c*r^2 + ry*r + rx, the JAX package's
  reshapes; the layers run the same map on NCHW as F.pixel_unshuffle /
  F.pixel_shuffle;
- Conv2D: conv + GroupNorm(16, eps 1e-5) + ELU, the GroupNorm and the ELU
  in float32 on the conv's output whatever the compute dtype;
- ResidualConv / ResidualBlock, with dropout on the 1x1 shortcut in
  training only, drawn from the torch.Generator the caller passes;
- InvDepth: 3x3 conv, then a float32 sigmoid / min_depth (in [0, 2] at
  min_depth 0.5);
- Conv3DStack: a 3x3x3 conv of one input channel over (C as depth, H, W)
  with d output channels, flattened d-major (channel j*C + c) as the
  reference's view(b, d*C, h, w), in the JAX package's 'depthwin2d'
  parameter layout (win2d_kernel [kh, kw, dz, d], win2d_bias [d]); one
  F.conv3d computes it;
- PackLayerConv3d: packing -> Conv3DStack -> Conv2D back to C channels;
  UnpackLayerConv3d: Conv2D -> Conv3DStack -> unpacking (the JAX package's
  two-stage path; its PACK_FUSED composed conv is not ported).

Submodules are named after the flax paths (`Conv2D_0/Conv_0`,
`GroupNorm_0`, `_Conv3DStack_0/win2d_kernel`, ...) for
utils/flax_weights.py.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from packnet_sfm_tpu_torch.networks.layers.resnet import Conv, GroupNorm

GN_EPS = 1e-5                      # PackNet's GroupNorm (PoseNet's is 1e-6)


def packing(x, r=2):
    """Space-to-depth [B,H,W,C] -> [B,H/r,W/r,C*r^2]."""
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def unpacking(x, r=2):
    """Depth-to-space [B,H,W,C*r^2] -> [B,rH,rW,C]."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def dropout(x, rate, generator):
    """flax nn.Dropout in training: keep each value with probability
    1 - rate (one uniform draw from `generator` a value) and scale the
    kept ones by 1 / (1 - rate)."""
    if generator is None:
        raise ValueError('dropout in training needs a torch.Generator')
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < \
        keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Conv2D(nn.Module):
    """conv(k, stride), zero 'same' padding, + GroupNorm(16) + ELU."""

    def __init__(self, cin, features, kernel_size=3, stride=1,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel_size, stride,
                           kernel_size // 2, True, 'xavier', dtype)
        self.GroupNorm_0 = GroupNorm(16, features, GN_EPS)

    def forward(self, x):
        return F.elu(self.GroupNorm_0(self.Conv_0(x)))


class ResidualConv(nn.Module):
    """Conv2D(3, s) -> Conv2D(3, 1), plus a 1x1 shortcut (dropout on it in
    training), then GroupNorm + ELU."""

    def __init__(self, cin, features, stride=1, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.Conv2D_0 = Conv2D(cin, features, 3, stride, dtype)
        self.Conv2D_1 = Conv2D(features, features, 3, 1, dtype)
        self.Conv_0 = Conv(cin, features, 1, stride, 0, True, 'xavier',
                           dtype)
        self.GroupNorm_0 = GroupNorm(16, features, GN_EPS)

    def forward(self, x, generator=None):
        y = self.Conv2D_1(self.Conv2D_0(x))
        shortcut = self.Conv_0(x)
        if self.dropout and self.training:
            shortcut = dropout(shortcut, self.dropout, generator)
        return F.elu(self.GroupNorm_0(y + shortcut))


class ResidualBlock(nn.Module):
    def __init__(self, cin, features, num_blocks, stride=1, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            setattr(self, 'ResidualConv_{}'.format(i), ResidualConv(
                cin if i == 0 else features, features,
                stride if i == 0 else 1, dropout, dtype))

    def forward(self, x, generator=None):
        for i in range(self.num_blocks):
            x = getattr(self, 'ResidualConv_{}'.format(i))(x, generator)
        return x


class InvDepth(nn.Module):
    """3x3 conv, then a float32 sigmoid / min_depth: [B,1,H,W]."""

    def __init__(self, cin, min_depth=0.5, dtype=torch.float32):
        super().__init__()
        self.min_depth = min_depth
        self.Conv_0 = Conv(cin, 1, 3, 1, 1, True, 'xavier', dtype)

    def forward(self, x):
        return torch.sigmoid(self.Conv_0(x).float()) / self.min_depth


class Conv3DStack(nn.Module):
    """[B,C,H,W] -> [B,d*C,H,W]: out[:, j*C + c] = sum over (dz, kh, kw) of
    x[:, c+dz-1, h+kh-1, w+kw-1] * win2d_kernel[kh, kw, dz, j] +
    win2d_bias[j], zero outside the channel and spatial ranges."""

    def __init__(self, d=8, dtype=torch.float32):
        super().__init__()
        self.d = d
        self.dtype = dtype
        self.win2d_kernel = nn.Parameter(torch.zeros(3, 3, 3, d))
        self.win2d_bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        B, C, H, W = x.shape
        w = self.win2d_kernel.permute(3, 2, 0, 1)[:, None]   # [d,1,dz,kh,kw]
        v, b = x[:, None], self.win2d_bias
        if x.device.type == 'cpu' and self.dtype == torch.bfloat16:
            # as layers/resnet.py Conv: the CPU's bf16 kernels in float32,
            # one rounding of the result
            y = F.conv3d(v.to(self.dtype).float(), w.to(self.dtype).float(),
                         b.to(self.dtype).float(), padding=1).to(self.dtype)
        else:
            y = F.conv3d(v.to(self.dtype), w.to(self.dtype),
                         b.to(self.dtype), padding=1)       # [B,d,C,H,W]
        return y.reshape(B, self.d * C, H, W)


class PackLayerConv3d(nn.Module):
    """packing(r) -> Conv3DStack -> Conv2D back to `features` (= the input
    channels)."""

    def __init__(self, features, kernel_size=3, r=2, d=8,
                 dtype=torch.float32):
        super().__init__()
        self.r = r
        self._Conv3DStack_0 = Conv3DStack(d, dtype)
        self.Conv2D_0 = Conv2D(features * r * r * d, features, kernel_size,
                               1, dtype)

    def forward(self, x):
        return self.Conv2D_0(self._Conv3DStack_0(F.pixel_unshuffle(x,
                                                                   self.r)))


class UnpackLayerConv3d(nn.Module):
    """Conv2D to features * r^2 / d -> Conv3DStack -> unpacking(r) to
    `features`."""

    def __init__(self, cin, features, kernel_size=3, r=2, d=8,
                 dtype=torch.float32):
        super().__init__()
        self.r = r
        self.Conv2D_0 = Conv2D(cin, features * r * r // d, kernel_size, 1,
                               dtype)
        self._Conv3DStack_0 = Conv3DStack(d, dtype)

    def forward(self, x):
        return F.pixel_shuffle(self._Conv3DStack_0(self.Conv2D_0(x)), self.r)
