"""
The PackNet depth networks (the JAX package's networks/depth/packnet.py;
reference networks/depth/PackNet01.py, PackNetSlim01.py, PackNetSAN01.py,
PackNetSlimSAN01.py), NCHW inside, NHWC in and out.

`_PackNetCore`: pre_calc Conv2D(5x5) -> conv1 + 5 x (PackLayerConv3d,
ResidualBlock) encoder; 5 x (UnpackLayerConv3d, skip merge, iconv)
decoder, version 'A' concatenating the skips and 'B' adding them; four
InvDepth heads (sigmoid / 0.5, in [0, 2]), each coarser one upsampled 2x
nearest into the next iconv. Training gives 4 scales, eval 1.

- PackNet01: ni 64, channels (64, 64, 128, 256, 512), d = 8;
- PackNetSlim01: ni 32, channels (32, 64, 128, 256, 512), d = 4;
- PackNetSAN01 / PackNetSlimSAN01 (`_PackNetSANBase`, by default the slim
  widths): a sparse LiDAR branch (layers/san.py MinkowskiEncoder, the
  masked-conv kernels) fused into the skips. Plain fusion: 5 gates at 1.0,
  `feat * w_i + san_i + b_i` over skips[1:] + [x5p]. FiLM fusion: 6 gates
  at 0.5 over all 6 maps; the sparse stages run only through
  `film_scales` (a contiguous prefix), each output upsampled 2x nearest
  and cut to its skip, `w_i * (gamma * feat + beta) + (1 - w_i) * san_i
  + b_i`. The row-window crop of layers/san.py applies to both. In
  training the RGB pass runs, then the RGB+D pass, and `depth_loss` is the
  mean over the fused maps of mean((rgbd.detach() - rgb)^2): its gradient
  reaches the RGB features only. PackNetSlimSAN01 has FiLM on by default.

Dropout (ResidualConv's shortcut, training only) draws from one
generator on the input's device, seeded by one draw from the generator
the caller passes (SfmModel passes its step generator; `needs_generator`
says whether the net takes one). The JAX module's `san_dropped` count of
LiDAR sites outside the row window is not ported.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from packnet_sfm_tpu_torch.networks.depth.resnet_san import _nchw, _nhwc
from packnet_sfm_tpu_torch.networks.layers.packnet import (
    Conv2D, InvDepth, PackLayerConv3d, ResidualBlock, UnpackLayerConv3d)
from packnet_sfm_tpu_torch.networks.layers.san import (
    MinkowskiEncoder, active_row_window, crop_rows, paste_rows,
    sparsify_depth)


def _upsample2x(x):
    """2x nearest upsample of NCHW."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


class _PackNetCore(nn.Module):
    def __init__(self, version='A', ni=64, channels=(64, 64, 128, 256, 512),
                 num_blocks=(2, 2, 3, 3), num_3d_feat=8, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        no = 1
        n1, n2, n3, n4, n5 = channels
        if version == 'A':
            n5o, n5i = n5, n5 + n4
            n4o, n4i = n4, n4 + n3
            n3o, n3i = n3, n3 + n2 + no
            n2o, n2i = n2, n2 + n1 + no
            n1o, n1i = n1, n1 + ni + no
        elif version == 'B':
            n5o, n5i = n5 // 2, n5 // 2
            n4o, n4i = n4 // 2, n4 // 2
            n3o, n3i = n3 // 2, n3 // 2 + no
            n2o, n2i = n2, n2 + no
            n1o, n1i = n1, n1 + no
        else:
            raise ValueError('Unknown PackNet version {}'.format(version))
        self.version = version
        self.dropout = dropout
        d = num_3d_feat
        self.pre_calc = Conv2D(3, ni, 5, 1, dtype)
        self.conv1 = Conv2D(ni, n1, 7, 1, dtype)
        self.conv2 = ResidualBlock(n1, n2, num_blocks[0], 1, dropout, dtype)
        self.conv3 = ResidualBlock(n2, n3, num_blocks[1], 1, dropout, dtype)
        self.conv4 = ResidualBlock(n3, n4, num_blocks[2], 1, dropout, dtype)
        self.conv5 = ResidualBlock(n4, n5, num_blocks[3], 1, dropout, dtype)
        for i, (c, k) in enumerate(zip(channels, (5, 3, 3, 3, 3))):
            setattr(self, 'pack{}'.format(i + 1),
                    PackLayerConv3d(c, k, d=d, dtype=dtype))
        self.unpack5 = UnpackLayerConv3d(n5, n5o, 3, d=d, dtype=dtype)
        self.unpack4 = UnpackLayerConv3d(n5, n4o, 3, d=d, dtype=dtype)
        self.unpack3 = UnpackLayerConv3d(n4, n3o, 3, d=d, dtype=dtype)
        self.unpack2 = UnpackLayerConv3d(n3, n2o, 3, d=d, dtype=dtype)
        self.unpack1 = UnpackLayerConv3d(n2, n1o, 3, d=d, dtype=dtype)
        self.iconv5 = Conv2D(n5i, n5, 3, 1, dtype)
        self.iconv4 = Conv2D(n4i, n4, 3, 1, dtype)
        self.iconv3 = Conv2D(n3i, n3, 3, 1, dtype)
        self.iconv2 = Conv2D(n2i, n2, 3, 1, dtype)
        self.iconv1 = Conv2D(n1i, n1, 3, 1, dtype)
        self.disp4_layer = InvDepth(n4, dtype=dtype)
        self.disp3_layer = InvDepth(n3, dtype=dtype)
        self.disp2_layer = InvDepth(n2, dtype=dtype)
        self.disp1_layer = InvDepth(n1, dtype=dtype)

    def encode(self, rgb, generator=None):
        """NCHW rgb -> (x5p, skips [x, x1p, x2p, x3p, x4p]), float32."""
        x = self.pre_calc(rgb)
        x1p = self.pack1(self.conv1(x))
        x2p = self.pack2(self.conv2(x1p, generator))
        x3p = self.pack3(self.conv3(x2p, generator))
        x4p = self.pack4(self.conv4(x3p, generator))
        x5p = self.pack5(self.conv5(x4p, generator))
        return x5p, [x, x1p, x2p, x3p, x4p]

    def _merge(self, unpacked, skip):
        if self.version == 'A':
            return torch.cat([unpacked.float(), skip.float()], 1)
        return unpacked.float() + skip.float()

    def decode(self, x5p, skips):
        """The inverse-depth heads, NHWC float32: 4 scales in training, 1
        in eval."""
        skip1, skip2, skip3, skip4, skip5 = skips
        iconv5 = self.iconv5(self._merge(self.unpack5(x5p), skip5))
        iconv4 = self.iconv4(self._merge(self.unpack4(iconv5), skip4))
        disp4 = self.disp4_layer(iconv4)
        iconv3 = self.iconv3(torch.cat([self._merge(
            self.unpack3(iconv4), skip3), _upsample2x(disp4)], 1))
        disp3 = self.disp3_layer(iconv3)
        iconv2 = self.iconv2(torch.cat([self._merge(
            self.unpack2(iconv3), skip2), _upsample2x(disp3)], 1))
        disp2 = self.disp2_layer(iconv2)
        iconv1 = self.iconv1(torch.cat([self._merge(
            self.unpack1(iconv2), skip1), _upsample2x(disp2)], 1))
        disp1 = self.disp1_layer(iconv1)
        disps = [disp1, disp2, disp3, disp4] if self.training else [disp1]
        return [_nhwc(d) for d in disps]


def _dropout_generator(net, rgb, generator):
    """The generator the net's dropout draws from in this forward: one on
    rgb's device, seeded by one draw from `generator`; None where no
    dropout acts. Raises without a generator where one does."""
    if not (net.training and net.core.dropout):
        return None
    if generator is None:
        raise ValueError('{} with dropout {} needs a torch.Generator in '
                         'training'.format(type(net).__name__,
                                           net.core.dropout))
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    return torch.Generator(device=rgb.device).manual_seed(seed)


class _PackNet(nn.Module):
    """A PackNet over RGB only; `input_depth` is taken and ignored."""

    NI, CHANNELS, NUM_3D_FEAT = 64, (64, 64, 128, 256, 512), 8

    def __init__(self, version='1A', dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.core = _PackNetCore(version[1:], self.NI, self.CHANNELS,
                                 num_3d_feat=self.NUM_3D_FEAT,
                                 dropout=dropout, dtype=dtype)

    @property
    def needs_generator(self):
        return bool(self.core.dropout)

    def forward(self, rgb, input_depth=None, generator=None):
        """{'inv_depths': [B,H,W,1] float32 per scale}."""
        gen = _dropout_generator(self, rgb, generator)
        x5p, skips = self.core.encode(_nchw(rgb), gen)
        return {'inv_depths': self.core.decode(x5p, skips)}


class PackNet01(_PackNet):
    pass


class PackNetSlim01(_PackNet):
    NI, CHANNELS, NUM_3D_FEAT = 32, (32, 64, 128, 256, 512), 4


class _PackNetSANBase(nn.Module):
    def __init__(self, version='1A', dropout=0.0, ni=32,
                 channels=(32, 64, 128, 256, 512), num_3d_feat=4,
                 use_film=False, film_scales=(0, 1), san_row_window=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.core = _PackNetCore(version[1:], ni, tuple(channels),
                                 num_3d_feat=num_3d_feat, dropout=dropout,
                                 dtype=dtype)
        self.use_film = use_film
        self.film_scales = tuple(film_scales)
        self.san_row_window = san_row_window
        if use_film:
            # the sparse stages chain, so the modulated scales must be a
            # contiguous prefix; only those stages exist (flax creates the
            # parameters of the stages it runs)
            if self.film_scales != tuple(range(len(self.film_scales))):
                raise ValueError('film_scales must be a contiguous prefix '
                                 '0..k, got {}'.format(film_scales))
            feat_ch = (ni,) + tuple(channels)
            run = feat_ch[:len(self.film_scales)]
            self.mconvs = MinkowskiEncoder(run, run, dtype)
            n_gates, gate_init = len(feat_ch), 0.5
        else:
            self.mconvs = MinkowskiEncoder(tuple(channels), dtype=dtype)
            n_gates, gate_init = 5, 1.0
        self.gate_init = gate_init
        self.weight = nn.Parameter(torch.full((n_gates,), gate_init))
        self.bias = nn.Parameter(torch.zeros(n_gates))

    @property
    def needs_generator(self):
        return bool(self.core.dropout)

    def _sparse_input(self, input_depth):
        """(depth, mask, crop start or None) of the LiDAR, row-cropped to
        the active window where `san_row_window` sets one."""
        d, mask = sparsify_depth(input_depth)
        H = mask.shape[1]
        Hw = (int(H * self.san_row_window) // 32 * 32
              if self.san_row_window > 0 else 0)
        if not (0 < Hw < H and H % 32 == 0):
            return d, mask, None
        s = active_row_window(mask, Hw)
        return crop_rows(d, s, Hw), crop_rows(mask, s, Hw), s

    def _fuse_plain(self, skips, x5p, input_depth):
        d, mask, s = self._sparse_input(input_depth)
        fused = [skips[0]]
        for i, feat in enumerate(skips[1:] + [x5p]):
            d, mask = self.mconvs(i, d, mask)[:2]
            sp = d if s is None else paste_rows(d, s // 2 ** (i + 1),
                                                feat.shape[2])
            fused.append(feat * self.weight[i] + _nchw(sp) + self.bias[i])
        return fused[:5], fused[5]

    def _fuse_film(self, skips, x5p, input_depth):
        d, mask, s = self._sparse_input(input_depth)
        fused = []
        for i, feat in enumerate(skips + [x5p]):
            if i not in self.film_scales:
                fused.append(feat)
                continue
            lvl_h = max(feat.shape[2] // 2, 1)      # the sparse level
            denom = (None if s is None else
                     float(lvl_h * max(feat.shape[3] // 2, 1)))
            d, mask, gamma, beta = self.mconvs(i, d, mask, pool_denom=denom)
            sp = d if s is None else paste_rows(d, s // 2 ** (i + 1), lvl_h)
            sp = _upsample2x(_nchw(sp))[:, :, :feat.shape[2], :feat.shape[3]]
            modulated = _nchw(gamma) * feat + _nchw(beta)
            w = self.weight[i]
            fused.append(w * modulated + (1.0 - w) * sp + self.bias[i])
        return fused[:5], fused[5]

    def run_network(self, rgb, input_depth=None, generator=None):
        """(NHWC inverse depths, the maps of the consistency loss)."""
        x5p, skips = self.core.encode(_nchw(rgb), generator)
        if input_depth is not None:
            fuse = self._fuse_film if self.use_film else self._fuse_plain
            skips, x5p = fuse(skips, x5p, input_depth)
        feats = (skips if self.use_film else skips[1:]) + [x5p]
        return self.core.decode(x5p, skips), feats

    def forward(self, rgb, input_depth=None, generator=None):
        """Eval: {'inv_depths': [[B,H,W,1]]} (with the LiDAR fused where
        given). Training: the RGB pass's 4 scales as 'inv_depths' and, with
        input_depth, the RGB+D pass's as 'inv_depths_rgbd' and the scalar
        'depth_loss'."""
        gen = _dropout_generator(self, rgb, generator)
        if not self.training:
            return {'inv_depths': self.run_network(rgb, input_depth)[0]}
        out_rgb, feat_rgb = self.run_network(rgb, None, gen)
        output = {'inv_depths': out_rgb}
        if input_depth is None:
            return output
        out_rgbd, feat_rgbd = self.run_network(rgb, input_depth, gen)
        output['inv_depths_rgbd'] = out_rgbd
        output['depth_loss'] = sum(
            ((fd.detach().float() - f.float()) ** 2).mean()
            for fd, f in zip(feat_rgbd, feat_rgb)) / len(feat_rgbd)
        return output


class PackNetSAN01(_PackNetSANBase):
    pass


class PackNetSlimSAN01(_PackNetSANBase):
    def __init__(self, use_film=True, **kwargs):
        super().__init__(use_film=use_film, **kwargs)
