"""
Sparse Auxiliary Network (SAN) LiDAR branch, NHWC, train and eval.

Counterpart of the JAX package's networks/layers/san.py. A sparse conv of
projected LiDAR is computed as a masked dense conv,

    sparse_conv(x) == mask_out * dense_conv(mask_in * x),

and every tensor here keeps "inactive sites hold exactly 0". Each masked
conv goes through ops/kernels/san_conv.py `masked_conv2d_fn`: on the card
its forward and its input gradient are the hand-written kernels, which skip
tiles with no active site. The branch stays NHWC (the kernels' layout);
HWIO kernels stay HWIO. `MaskedBatchNorm` picks batch or running
statistics from the module's `training` flag, as flax's `train` argument.

Structure (reference minkowski_encoder.py:12-172): MinkConv2D = optional
masked max-pool (3, s2) -> 3 parallel masked-conv stacks of 1/2/3 convs ->
sum -> masked BN + ReLU; MinkowskiEncoder = 5 stages with kernel sizes
[5, 5, 3, 3, 3] plus optional per-scale FiLM generators.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from packnet_sfm_tpu_torch.networks.layers.resnet import Conv
from packnet_sfm_tpu_torch.ops.kernels import san_conv


class _MaskedConv(nn.Module):
    """out = (conv_same(x, kernel) + bias) * mask with `kernel` HWIO, the
    flax parameter layout the kernel reads."""

    def __init__(self, cin, features, kernel_size=3, dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.kernel = nn.Parameter(torch.zeros(k, k, cin, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x, mask):
        return san_conv.masked_conv2d_fn(
            x.to(self.dtype).contiguous(), mask,
            self.kernel.to(self.dtype), self.bias.to(self.dtype))


def sparsify_depth(depth):
    """[B,H,W,1] depth -> (features, mask) with mask = depth > 0."""
    mask = (depth > 0.0).to(depth.dtype)
    return depth * mask, mask


def active_row_window(mask, Hw, align=32, bottom_margin=63):
    """Choose an `align`-aligned row start s so [s, s+Hw) covers the active
    band of `mask` [B,H,W,1] (see the JAX package's san.py for why the crop
    is exact when the band fits; active sites outside the window are
    dropped). Returns s as a Python int: reading it on the host costs one
    device sync per forward, and the crop then slices with it."""
    H = mask.shape[1]
    rows = mask.sum(dim=(0, 2, 3))
    act = torch.nonzero(rows > 0).flatten().tolist()
    r0 = act[0] if act else H
    r1 = act[-1] if act else -1
    s = min(max((r0 // align) * align, 0), H - Hw)
    need_bottom = min(r1 + bottom_margin, H)
    if s + Hw < need_bottom:
        s = min(max(-(-(need_bottom - Hw) // align) * align, 0), H - Hw)
    return s


def calibrate_san_row_window(dataset, k=16, align=32, bottom_margin=63,
                             safety_rows=32):
    """A `san_row_window` fraction measured from the data, for
    `san_row_window: -1`: over up to `k` samples of `dataset` spread over
    its length, the band of rows that hold projected LiDAR, widened by the
    bottom margin `active_row_window` needs for exactness and one
    `safety_rows` band, rounded up to `align` rows. 0.0 (no crop) when a
    sample has no 'input_depth' or the window would not be smaller than
    the image. The window's start stays per batch (`active_row_window`);
    only its size comes from here."""
    n = len(dataset)
    if n == 0:
        return 0.0
    take = np.linspace(0, n - 1, min(k, n)).astype(int)
    r0, r1, H = None, None, None
    for i in take:
        d = dataset[int(i)].get('input_depth')
        if d is None:
            return 0.0
        d = np.asarray(d)
        if d.ndim == 3:                       # [H,W,1] or [1,H,W]
            d = d[..., 0] if d.shape[-1] == 1 else d[0]
        H = d.shape[0]
        rows = np.flatnonzero((d > 0).any(axis=1))
        if rows.size == 0:
            continue
        r0 = rows[0] if r0 is None else min(r0, rows[0])
        r1 = rows[-1] if r1 is None else max(r1, rows[-1])
    if r0 is None:
        return 0.0
    top = (r0 // align) * align
    bottom = min(H, r1 + 1 + bottom_margin + safety_rows)
    Hw = -(-(bottom - top) // align) * align
    if Hw >= H or Hw <= 0:
        return 0.0
    # the model takes int(H * frac) // 32 * 32 rows: half a row more keeps
    # float truncation from losing the last aligned block
    return float((Hw + 0.5) / H)


def crop_rows(x, s, Hw):
    """Row crop [B,H,W,C] -> [B,Hw,W,C] starting at row s."""
    return x[:, s:s + Hw]


def paste_rows(x, s, H):
    """Paste [B,Hw,W,C] into a zero canvas of height H at row s (a zero
    pad, so the gradient is the row crop)."""
    return F.pad(x, (0, 0, 0, 0, s, H - s - x.shape[1]))


def masked_max_pool(x, mask, window=3, stride=2):
    """Max-pool active features; the mask pools by OR (any active site in
    the window). Inactive sites enter the max as -inf, padding too, and
    windows with no active site come out as 0. NHWC in and out. The
    gradient goes to the first maximum of a window in row-major order, as
    reduce_window's select-and-scatter sends it (ties are common: ReLU
    leaves many active sites at exactly 0); a window with no active site
    passes none."""
    pad = window // 2
    neg = torch.where(mask > 0, x, torch.full_like(x, float('-inf')))

    def pool(t):
        return F.max_pool2d(t.permute(0, 3, 1, 2), window, stride,
                            pad).permute(0, 2, 3, 1).contiguous()

    pooled, pooled_mask = pool(neg), pool(mask)
    return torch.where(pooled_mask > 0, pooled,
                       torch.zeros_like(pooled)), pooled_mask


class MaskedBatchNorm(nn.Module):
    """BatchNorm over active sites (MinkowskiBatchNorm semantics):
    (x - mean) * rsqrt(var + eps) * scale + bias, then * mask, in float32.

    In training the statistics come from one fp32 pass of uncentered sums
    over the pre-masked x (zero at inactive sites) divided by the active
    count max(sum(mask), 1), var = max(E[x^2] - E[x]^2, 0), and the running
    averages move as 0.9 * old + 0.1 * batch with the biased variance
    (the JAX package's san.py:259-269)."""

    epsilon = 1e-5
    momentum = 0.9

    def __init__(self, c):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('mean', torch.zeros(c))
        self.register_buffer('var', torch.ones(c))

    def forward(self, x, mask):
        xf = x.float()
        if self.training:
            cnt = mask.float().sum().clamp(min=1.0)
            mean = xf.sum((0, 1, 2)) / cnt
            var = ((xf * xf).sum((0, 1, 2)) / cnt - mean * mean).clamp(min=0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias) * mask


class _MaskedConvSeq(nn.Module):
    """Masked convs with masked BN + ReLU between them (one MinkConv2D
    stack). Input pre-masked; output masked."""

    def __init__(self, cin, widths, kernel_size=3, dtype=torch.float32):
        super().__init__()
        self.n = len(widths)
        for i, w in enumerate(widths):
            setattr(self, 'Conv_{}'.format(i),
                    _MaskedConv(cin, w, kernel_size, dtype))
            if i < self.n - 1:
                setattr(self, 'MaskedBatchNorm_{}'.format(i),
                        MaskedBatchNorm(w))
            cin = w

    def forward(self, x, mask):
        for i in range(self.n):
            x = getattr(self, 'Conv_{}'.format(i))(x, mask)
            if i < self.n - 1:
                x = F.relu(getattr(self, 'MaskedBatchNorm_{}'.format(i))(
                    x, mask))
        return x


class MinkConv2D(nn.Module):
    """Masked-dense equivalent of the reference MinkConv2D block."""

    def __init__(self, cin, features, kernel_size=3, stride=2,
                 dtype=torch.float32):
        super().__init__()
        f, k = features, kernel_size
        self.stride = stride
        self._MaskedConvSeq_0 = _MaskedConvSeq(cin, [f], k, dtype)
        self._MaskedConvSeq_1 = _MaskedConvSeq(cin, [2 * f, f], k, dtype)
        self._MaskedConvSeq_2 = _MaskedConvSeq(cin, [2 * f, 2 * f, f], k,
                                               dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(f)

    def forward(self, x, mask):
        if self.stride != 1:
            x, mask = masked_max_pool(x, mask, 3, self.stride)
        y = (self._MaskedConvSeq_0(x, mask) + self._MaskedConvSeq_1(x, mask)
             + self._MaskedConvSeq_2(x, mask))
        return F.relu(self.MaskedBatchNorm_0(y, mask)), mask


class MinkowskiEncoder(nn.Module):
    """Multi-scale sparse depth encoder with optional depth-aware FiLM.
    `forward(scale, feats, mask, pool_denom)` runs one stage and returns
    (dense, mask) or, where FiLM is on, (dense, mask, gamma, beta) with
    gamma/beta [B,1,1,C]."""

    def __init__(self, channels, rgb_channels=None, dtype=torch.float32):
        super().__init__()
        ks = [5, 5] + [3] * (len(channels) - 1)
        cin = 1
        for i, c in enumerate(channels):
            setattr(self, 'mconv_{}'.format(i),
                    MinkConv2D(cin, c, ks[i], 2, dtype))
            cin = c
        self.film_scales = []
        for i, rgb_ch in enumerate(rgb_channels or []):
            if rgb_ch and rgb_ch > 0:
                # FiLM generator: AdaptiveAvgPool -> 1x1 conv, float32
                setattr(self, 'film_{}'.format(i),
                        Conv(channels[i], rgb_ch * 2, 1, init='xavier'))
                self.film_scales.append(i)

    def forward(self, scale, feats, mask, pool_denom=None):
        """pool_denom: the FULL-map element count H*W of this level when the
        caller row-crops the stage, so the FiLM mean matches the uncropped
        computation (rows outside the window are zero)."""
        dense, mask = getattr(self, 'mconv_{}'.format(scale))(feats, mask)
        if scale not in self.film_scales:
            return dense, mask
        if pool_denom is None:
            pooled = dense.mean(dim=(1, 2))
        else:
            pooled = dense.sum(dim=(1, 2)) / pool_denom
        film = getattr(self, 'film_{}'.format(scale))
        params = film(pooled[:, :, None, None])[:, :, 0, 0]
        gamma, beta = params.chunk(2, dim=1)
        return dense, mask, gamma[:, None, None, :], beta[:, None, None, :]
