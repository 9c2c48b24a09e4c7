"""
ResNet encoder, monodepth2-style decoders and the pose decoder, NCHW
inside. BatchNorm uses
batch statistics in training and its running statistics in eval, picked by
the module's `training` flag as flax's `use_running_average`.

Counterpart of the JAX package's networks/layers/resnet.py. Submodules are
named after the flax module paths (`Conv_0`, `BatchNorm_0`, `BasicBlock_3`,
`upconv_4_0/Conv_0`, ...) so utils/flax_weights.py maps a flax variable
tree onto them by name. A conv computes in the model's compute dtype
(float32 or bfloat16) with float32 parameters, and BatchNorm in float32, as
the flax modules do with `dtype=` set. The pose decoder's flax convs have
no dtype: they compute in float32, the encoder's output dtype.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Conv2d):
    """nn.Conv2d that casts its input and parameters to `dtype` and records
    how flax initialises it (`init`: 'kaiming' fan-out normal, 'xavier'
    uniform or 'lecun' fan-in truncated normal, flax's default), for
    models/factory.py init_weights."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True,
                 init='xavier', dtype=torch.float32):
        super().__init__(cin, cout, k, stride, padding, bias=bias)
        self.init = init
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if x.device.type == 'cpu' and self.dtype == torch.bfloat16:
            # PyTorch's CPU bf16 convolution backward reads uninitialised
            # memory into the filter gradient where the input is one pixel
            # under a 3x3 stride-2 kernel (PoseNet's conv7 at 32x64): the
            # same products of bf16 values summed in float32, rounded once
            return F.conv2d(x.float(), w.float(),
                            None if b is None else b.float(), self.stride,
                            self.padding).to(self.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm computed in float32 with flax's semantics (dtype=float32,
    momentum 0.9, use_fast_variance): in training the batch statistics are
    uncentered fp32 means, var = max(E[x^2] - E[x]^2, 0), and the running
    averages move as 0.9 * old + 0.1 * batch with the biased variance.
    (F.batch_norm's own update would use the unbiased variance.)"""

    flax_momentum = 0.9

    def __init__(self, c):
        super().__init__(c, eps=1e-5)

    def forward(self, x):
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp(min=0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class BasicBlock(nn.Module):
    def __init__(self, cin, features, stride=1, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride, 1, False, 'kaiming', dtype)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, 1, 1, False, 'kaiming', dtype)
        self.BatchNorm_1 = BatchNorm(features)
        self.down = stride != 1 or cin != features
        if self.down:
            self.Conv_2 = Conv(cin, features, 1, stride, 0, False, 'kaiming',
                               dtype)
            self.BatchNorm_2 = BatchNorm(features)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        r = self.BatchNorm_2(self.Conv_2(x)) if self.down else x
        return F.relu(y + r)


class Bottleneck(nn.Module):
    """ResNet-V1.5 bottleneck (stride on the 3x3); output is 4 * features."""

    def __init__(self, cin, features, stride=1, dtype=torch.float32):
        super().__init__()
        cout = features * 4
        self.Conv_0 = Conv(cin, features, 1, 1, 0, False, 'kaiming', dtype)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, stride, 1, False, 'kaiming',
                           dtype)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = Conv(features, cout, 1, 1, 0, False, 'kaiming', dtype)
        self.BatchNorm_2 = BatchNorm(cout)
        self.down = stride != 1 or cin != cout
        if self.down:
            self.Conv_3 = Conv(cin, cout, 1, stride, 0, False, 'kaiming', dtype)
            self.BatchNorm_3 = BatchNorm(cout)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        r = self.BatchNorm_3(self.Conv_3(x)) if self.down else x
        return F.relu(y + r)


RESNET_SPECS = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (Bottleneck, [3, 4, 6, 3]),
}


def resnet_num_ch_enc(num_layers):
    """Encoder channel counts per scale (reference: resnet_encoder.py:70,87)."""
    ch = [64, 64, 128, 256, 512]
    if num_layers > 34:
        ch = [ch[0]] + [c * 4 for c in ch[1:]]
    return ch


def max_pool_3x3_s2(x):
    """torch MaxPool2d(3, stride=2, padding=1) on NCHW."""
    return F.max_pool2d(x, 3, 2, 1)


class ResnetEncoder(nn.Module):
    """5-scale NCHW feature pyramid with the reference's fixed input
    normalization (x - 0.45) / 0.225; `num_input_images` frames stacked on
    the channels (the pose encoder's first conv takes 3 x n)."""

    def __init__(self, num_layers=18, dtype=torch.float32,
                 num_input_images=1):
        super().__init__()
        block, layers = RESNET_SPECS[num_layers]
        self.Conv_0 = Conv(3 * num_input_images, 64, 7, 2, 3, False,
                           'kaiming', dtype)
        self.BatchNorm_0 = BatchNorm(64)
        self.stage_ends = []
        cin, n = 64, 0
        expansion = 4 if block is Bottleneck else 1
        for stage, (width, n_blocks) in enumerate(zip([64, 128, 256, 512],
                                                      layers)):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                setattr(self, '{}_{}'.format(block.__name__, n),
                        block(cin, width, stride, dtype))
                cin = width * expansion
                n += 1
            self.stage_ends.append(n)
        self.blocks = [getattr(self, '{}_{}'.format(block.__name__, i))
                       for i in range(n)]

    def forward(self, x):
        x = (x - 0.45) / 0.225
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        feats = [x]
        x = max_pool_3x3_s2(x)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i + 1 in self.stage_ends:
                feats.append(x)
        return feats


class _ConvWrap(nn.Module):
    """A flax submodule holding one conv as `Conv_0` (ConvBlock, Conv3x3)."""

    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, 3, 1, 1, True, 'xavier', dtype)

    def forward(self, x):
        return self.Conv_0(x)


class _DecoderTrunk(nn.Module):
    """monodepth2 trunk: 5x {upconv -> nearest x2 -> skip concat -> upconv};
    calls `head(i, x)` at each scale in `scales`."""

    def __init__(self, num_ch_enc, dtype):
        super().__init__()
        num_ch_dec = [16, 32, 64, 128, 256]
        self.num_ch_dec = num_ch_dec
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else num_ch_dec[i + 1]
            setattr(self, 'upconv_{}_0'.format(i),
                    _ConvWrap(cin, num_ch_dec[i], dtype))
            cin = num_ch_dec[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            setattr(self, 'upconv_{}_1'.format(i),
                    _ConvWrap(cin, num_ch_dec[i], dtype))

    def trunk(self, input_features, head):
        outputs = {}
        x = input_features[-1]
        for i in range(4, -1, -1):
            x = F.relu(getattr(self, 'upconv_{}_0'.format(i))(x))
            x = F.interpolate(x, scale_factor=2, mode='nearest')
            if i > 0:
                skip = input_features[i - 1]
                dt = torch.promote_types(x.dtype, skip.dtype)
                x = torch.cat([x.to(dt), skip.to(dt)], 1)
            x = F.relu(getattr(self, 'upconv_{}_1'.format(i))(x))
            if i in self.scales:
                outputs.update(head(i, x))
        return outputs


class DepthDecoder(_DecoderTrunk):
    """Returns {('disp', s): sigmoid [B,1,H,W] float32}."""

    def __init__(self, num_ch_enc, scales=(0, 1, 2, 3), dtype=torch.float32):
        super().__init__(num_ch_enc, dtype)
        self.scales = tuple(scales)
        for i in self.scales:
            setattr(self, 'dispconv_{}'.format(i),
                    _ConvWrap(self.num_ch_dec[i], 1, dtype))

    def forward(self, input_features):
        def head(i, x):
            d = getattr(self, 'dispconv_{}'.format(i))(x)
            return {('disp', i): torch.sigmoid(d.float())}
        return self.trunk(input_features, head)


class DualHeadDepthDecoder(_DecoderTrunk):
    """Shared trunk with integer and fractional sigmoid heads per scale."""

    def __init__(self, num_ch_enc, scales=(0, 1, 2, 3), dtype=torch.float32):
        super().__init__(num_ch_enc, dtype)
        self.scales = tuple(scales)
        for i in self.scales:
            setattr(self, 'integer_conv_{}'.format(i),
                    _ConvWrap(self.num_ch_dec[i], 1, dtype))
            setattr(self, 'fractional_conv_{}'.format(i),
                    _ConvWrap(self.num_ch_dec[i], 1, dtype))

    def forward(self, input_features):
        def head(i, x):
            i_raw = getattr(self, 'integer_conv_{}'.format(i))(x)
            f_raw = getattr(self, 'fractional_conv_{}'.format(i))(x)
            return {('integer', i): torch.sigmoid(i_raw.float()),
                    ('fractional', i): torch.sigmoid(f_raw.float())}
        return self.trunk(input_features, head)


class PoseDecoder(nn.Module):
    """monodepth2's pose decoder: a 1x1 `squeeze_i` per input pyramid, two
    3x3 convs (`pose_0`, `pose_1`) and a 1x1 `pose_2`, each ReLU'd but the
    last, all in float32; 0.01 x the spatial mean. Returns (axisangle,
    translation), each [B, num_frames_to_predict_for, 1, 3]."""

    def __init__(self, num_ch_enc, num_input_features=1,
                 num_frames_to_predict_for=2, stride=1):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        for i in range(num_input_features):
            setattr(self, 'squeeze_{}'.format(i),
                    Conv(num_ch_enc[-1], 256, 1, init='lecun'))
        self.squeezes = [getattr(self, 'squeeze_{}'.format(i))
                         for i in range(num_input_features)]
        self.pose_0 = Conv(256 * num_input_features, 256, 3, stride, 1,
                           init='lecun')
        self.pose_1 = Conv(256, 256, 3, stride, 1, init='lecun')
        self.pose_2 = Conv(256, 6 * num_frames_to_predict_for, 1,
                           init='lecun')

    def forward(self, input_features):
        """`input_features`: one feature pyramid per input."""
        out = torch.cat([F.relu(sq(f[-1])) for sq, f in
                         zip(self.squeezes, input_features)], 1)
        out = F.relu(self.pose_0(out))
        out = F.relu(self.pose_1(out))
        out = 0.01 * self.pose_2(out).mean(dim=(2, 3)).reshape(
            -1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]
