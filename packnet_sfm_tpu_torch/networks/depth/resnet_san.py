"""
ResNetSAN01: the depth-completion network of the JAX package's
networks/depth/resnet_san.py (reference ResNetSAN01.py:13-355).

- ResNet encoder (18/34/50) feature pyramid, NCHW inside;
- standard or dual-head decoder;
- optional SAN LiDAR branch (NHWC, layers/san.py) with depth-aware FiLM and
  the sigmoid-gated per-scale fusion
      fused = sigmoid(w_i) * (gamma*f + beta) + (1-sigmoid(w_i)) * sparse + b_i
  (reference ResNetSAN01.py:222-259).

- training forward (the module's `training` flag) runs the RGB pass, then
  the RGB+D pass, so the encoder's BN statistics move twice per step as in
  flax, and returns a softmax(|w|)-weighted MSE feature-consistency loss
  between the two skip pyramids (reference ResNetSAN01.py:321-354).

Public layout is NHWC: forward takes rgb [B,H,W,3] and input_depth
[B,H,W,1] and returns NHWC maps.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from packnet_sfm_tpu_torch.networks.layers.resnet import (
    ResnetEncoder, DepthDecoder, DualHeadDepthDecoder, resnet_num_ch_enc)
from packnet_sfm_tpu_torch.networks.layers.san import (
    MinkowskiEncoder, sparsify_depth, active_row_window, crop_rows,
    paste_rows)


def parse_version(version, default_layers=18):
    """'18A' -> (18, 'A'); '50pt' -> (50, 'pt')."""
    if not version:
        return default_layers, 'A'
    return int(version[:2]), (version[2:] if len(version) > 2 else 'A')


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class ResNetSAN01(nn.Module):
    def __init__(self, version='18A', use_film=False, film_scales=(0,),
                 use_dual_head=False, san_row_window=0.0,
                 dtype=torch.float32):
        super().__init__()
        # the variant ('A', 'pt') builds the same encoder; a 'pt' one gets
        # its ImageNet weights at build (utils/pretrained.py)
        num_layers, _ = parse_version(version)
        self.use_film = use_film
        self.use_dual_head = use_dual_head
        self.san_row_window = san_row_window
        self.encoder = ResnetEncoder(num_layers, dtype=dtype)
        num_ch_enc = resnet_num_ch_enc(num_layers)
        if use_dual_head:
            self.decoder = DualHeadDepthDecoder(num_ch_enc, dtype=dtype)
        else:
            self.decoder = DepthDecoder(num_ch_enc, dtype=dtype)
        if use_film:
            rgb_channels = [c if i in tuple(film_scales) else 0
                            for i, c in enumerate(num_ch_enc)]
            self.mconvs = MinkowskiEncoder(num_ch_enc, rgb_channels, dtype)
        # learnable per-scale fusion gates (reference ResNetSAN01.py:129-135)
        self.weight = nn.Parameter(torch.full((5,), 0.5))
        self.bias = nn.Parameter(torch.zeros(5))

    def run_network(self, rgb, input_depth=None):
        """(decoder outputs, NCHW skip features after any LiDAR fusion)."""
        skip_features = self.encoder(_nchw(rgb))
        if input_depth is not None and self.use_film:
            skip_features = self._fuse_lidar(skip_features, input_depth)
        return self.decoder(skip_features), skip_features

    def _fuse_lidar(self, skip_features, input_depth):
        d, mask = sparsify_depth(input_depth)
        # Row-structured-LiDAR crop: run the SAN stack on an active-row
        # window and paste each stage's output back (layers/san.py).
        H = d.shape[1]
        Hw = (int(H * self.san_row_window) // 32 * 32
              if self.san_row_window > 0 else 0)
        crop = 0 < Hw < H and H % 32 == 0
        if crop:
            s = active_row_window(mask, Hw)
            d, mask = crop_rows(d, s, Hw), crop_rows(mask, s, Hw)
        fused = []
        for i, feat in enumerate(skip_features):
            lvl_h, lvl_w = feat.shape[2], feat.shape[3]
            denom = float(lvl_h * lvl_w) if crop else None
            result = self.mconvs(i, d, mask, pool_denom=denom)
            sparse_feat, mask = result[:2]
            d = sparse_feat
            if crop:
                sparse_feat = paste_rows(sparse_feat, s // 2 ** (i + 1), lvl_h)
            sparse_feat = _nchw(sparse_feat).float()
            w = torch.sigmoid(self.weight[i])
            if len(result) == 4:
                gamma, beta = _nchw(result[2]), _nchw(result[3])
                feat = gamma * feat + beta
            fused.append(w * feat + (1 - w) * sparse_feat + self.bias[i])
        return fused

    def forward(self, rgb, input_depth=None):
        """Eval: {'inv_depths': [sigmoid [B,H,W,1]]}, or the dual-head
        {('integer', i), ('fractional', i): [B,H,W,1]} maps. Training: the
        four RGB disp scales as 'inv_depths' and, with input_depth, the
        RGB+D scales as 'inv_depths_rgbd' and the scalar 'depth_loss'."""
        if not self.training:
            outputs, _ = self.run_network(rgb, input_depth)
            outputs = {k: _nhwc(v) for k, v in outputs.items()}
            if self.use_dual_head:
                return outputs
            return {'inv_depths': [outputs[('disp', 0)]]}

        out_rgb, skip_rgb = self.run_network(rgb, None)
        if self.use_dual_head:
            output = {k: _nhwc(v) for k, v in out_rgb.items()}
        else:
            output = {'inv_depths': [_nhwc(out_rgb[('disp', i)])
                                     for i in range(4)]}
        if input_depth is None:
            return output
        out_rgbd, skip_rgbd = self.run_network(rgb, input_depth)
        if self.use_dual_head:
            # dual-head mixes RGB and RGB+D at the loss level (reference)
            return output
        output['inv_depths_rgbd'] = [_nhwc(out_rgbd[('disp', i)])
                                     for i in range(4)]
        fw = torch.softmax(self.weight.abs(), dim=0)
        output['depth_loss'] = sum(
            fw[i] * F.mse_loss(fr.float(), fr_d.detach().float())
            for i, (fr_d, fr) in enumerate(zip(skip_rgbd, skip_rgb))
        ) / len(skip_rgbd)
        return output
