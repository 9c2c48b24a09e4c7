"""
Supervised depth losses on NHWC tensors, as in the JAX package's
losses/supervised.py (reference packnet_sfm/losses/supervised_loss.py:
84-237, ssi_loss.py, ssi_loss_enhanced.py, ssi_trim_loss.py,
ssi_silog_loss.py).

Statistics are mask-weighted sums rather than boolean indexing, exactly as
in the JAX package. Methods by suffix: l1, mse, berhu, silog, abs_rel, ssi,
enhanced-ssi, progressive-ssi, ssi-trim, ssi-silog. The 'sparse-' prefix
masks gt > 0 and fills the invalid entries of BOTH tensors with EPS before
the loss, so plain-mean losses (l1, mse, berhu, silog) average over every
pixel with zeros at the invalid ones (reference supervised_loss.py:
292-341). The SSI_SILOG_LOG per-step debug print of the JAX package is not
ported.
"""

import torch
import torch.nn.functional as F

from packnet_sfm_tpu_torch.losses.photometric import ProgressiveScaling
from packnet_sfm_tpu_torch.ops.depth import inv2depth
from packnet_sfm_tpu_torch.ops.image import interpolate, match_scales

EPS = 1e-6


def _masked_mean(x, mask):
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def l1_loss(pred, gt, mask):
    return (pred - gt).abs().mean()


def mse_loss(pred, gt, mask):
    return ((pred - gt) ** 2).mean()


def berhu_loss(pred, gt, mask, threshold=0.2):
    """BerHu: the mean over cat(|diff|, |diff|^2 where |diff| > c),
    c = threshold * max(pred - gt)."""
    huber_c = threshold * (pred - gt).max()
    diff = (pred - gt).abs()
    over = diff > huber_c
    total = diff.sum() + torch.where(over, diff ** 2, 0.0).sum()
    return total / (diff.numel() + over.sum())


def silog_loss(pred, gt, mask, ratio2=0.85):
    """Scale-invariant log loss over ALL pixels (no mask: on the sparse
    path the filled pixels give log_diff = 0 but count in the means)."""
    log_diff = torch.log(pred.clamp(min=EPS)) - torch.log(gt.clamp(min=EPS))
    silog1 = (log_diff ** 2).mean()
    silog2 = ratio2 * log_diff.mean() ** 2
    return torch.sqrt((silog1 - silog2).abs() + 1e-8)


def abs_rel_loss(pred, gt, mask):
    return ((pred - gt).abs() / pred.clamp(min=EPS)).mean()


def ssi_loss(pred, gt, mask, alpha=0.85):
    """Scale-shift-invariant: var(diff) + alpha * mean(diff)^2 over mask."""
    m = mask.to(pred.dtype)
    diff = pred - gt
    mean = _masked_mean(diff, m)
    var = _masked_mean(diff ** 2, m) - mean ** 2
    return var + alpha * mean ** 2


def _ssi_l1_mix(pred, gt, mask, alpha, ssi_w, l1_w):
    m = mask.to(pred.dtype)
    s = ssi_loss(pred, gt, mask, alpha)
    l1 = _masked_mean((1.0 / (pred + 1e-6) - 1.0 / (gt + 1e-6)).abs(), m)
    return ssi_w * s + l1_w * l1


def enhanced_ssi_loss(pred, gt, mask, alpha=0.85, l1_weight=0.2,
                      ssi_weight=0.8, progress=None):
    """SSI + L1-in-depth mix, weights moving with `progress`."""
    if progress is not None:
        p = min(max(float(progress), 0.0), 1.0)
        sw = ssi_weight + (1.0 - p) * 0.1
        lw = l1_weight + p * 0.1
        sw, lw = sw / (sw + lw), lw / (sw + lw)
    else:
        sw, lw = ssi_weight, l1_weight
    return _ssi_l1_mix(pred, gt, mask, alpha, sw, lw)


def progressive_ssi_loss(pred, gt, mask, alpha=0.85, max_l1_weight=0.3,
                         transition_epochs=15, epoch=0):
    """Epoch-scheduled SSI / L1-in-depth mix."""
    lw = min(float(epoch) / transition_epochs, 1.0) * max_l1_weight
    return _ssi_l1_mix(pred, gt, mask, alpha, 1.0 - lw, lw)


def ssi_trim_loss(pred, gt, mask, trim=0.2, eps=1e-6):
    """MiDaS-style trimmed L1: per image, least-squares align
    alpha * pred + beta to gt over the mask, then average the smallest
    (1 - trim) fraction of masked residuals; 0 below 100 valid pixels."""
    losses = []
    for p, g, m in zip(pred, gt, mask):
        m = m.to(p.dtype)
        n = m.sum()
        mean_d, mean_z = _masked_mean(p, m), _masked_mean(g, m)
        var_d = _masked_mean((p - mean_d) ** 2, m) + eps
        cov = _masked_mean((p - mean_d) * (g - mean_z), m)
        alpha = (cov / var_d).clamp(0.1, 10.0)
        beta = mean_z - alpha * mean_d
        res = (alpha * p + beta - g).abs().reshape(-1)
        order = torch.where(m.reshape(-1) > 0, res, float('inf')).sort()[0]
        k = torch.floor((1.0 - trim) * n)
        keep = (torch.arange(order.numel(), device=p.device) < k).to(p.dtype)
        trimmed = (torch.where(torch.isfinite(order), order, 0.0)
                   * keep).sum() / k.clamp(min=1.0)
        losses.append(torch.where(n >= 100, trimmed, 0.0))
    return torch.stack(losses).mean()


def ssi_silog_loss(pred_inv, gt_inv, mask, alpha=0.85, ssi_weight=0.7,
                   silog_weight=0.3, silog_ratio2=0.85, min_depth=None,
                   max_depth=None, gradient_weight=0.0, gradient_scales=4):
    """SSI in the inverse-depth domain + corrected Silog in the clamped
    depth domain (+ the optional multi-scale Sobel gradient loss); 0 when
    fewer than 100 pixels are valid."""
    m = mask.to(pred_inv.dtype)
    ssi = ssi_loss(pred_inv, gt_inv, mask, alpha)
    pred_d, gt_d = inv2depth(pred_inv), inv2depth(gt_inv)
    cmin = 1e-3 if min_depth is None else float(min_depth)
    cmax = 100.0 if max_depth is None else float(max_depth)
    if cmax <= cmin:
        cmax = cmin + 1.0
    log_diff = (torch.log(pred_d.clamp(cmin, cmax))
                - torch.log(gt_d.clamp(cmin, cmax)))
    silog1 = _masked_mean(log_diff ** 2, m)
    silog2 = silog_ratio2 * _masked_mean(log_diff, m) ** 2
    silog = torch.sqrt((silog1 - silog2).abs() + 1e-8)
    total = ssi_weight * ssi + silog_weight * silog
    if gradient_weight > 0.0:
        total = total + gradient_weight * _sobel_gradient_loss(
            pred_d, gt_d, m, gradient_scales)
    return torch.where(m.sum() < 100, 0.0, total)


def _sobel_gradient_loss(pred_d, gt_d, mask, num_scales):
    """Multi-scale Sobel gradient L1 (ssi_silog_loss.py:12-50,115-175)."""
    kx = torch.tensor([[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]],
                      dtype=pred_d.dtype, device=pred_d.device)

    def sobel(x, k):
        return F.conv2d(x.permute(0, 3, 1, 2), k[None, None]).permute(
            0, 2, 3, 1)

    total, valid_scales = 0.0, 0
    for s in range(num_scales):
        if s == 0:
            p, g, m = pred_d, gt_d, mask
        else:
            H, W = pred_d.shape[1] // 2 ** s, pred_d.shape[2] // 2 ** s
            if H < 3 or W < 3:
                break
            p = interpolate(pred_d, (H, W), 'bilinear', False)
            g = interpolate(gt_d, (H, W), 'bilinear', False)
            m = (interpolate(mask, (H, W), 'nearest') > 0.5).to(mask.dtype)
        mg = m[:, 1:-1, 1:-1, :]
        for k in (kx, kx.T):
            total = total + _masked_mean((sobel(p, k) - sobel(g, k)).abs(), mg)
        valid_scales += 1
    return total / max(valid_scales, 1)


def get_loss_func(method, **kw):
    """The per-scale loss callable (pred, gt, mask, progress, epoch) for
    the method's suffix."""
    if method.endswith('ssi-silog'):
        return lambda p, g, m, progress=0.0, epoch=0: ssi_silog_loss(
            p, g, m, alpha=kw.get('alpha', 0.85),
            ssi_weight=kw.get('ssi_weight', 0.7),
            silog_weight=kw.get('silog_weight', 0.3),
            silog_ratio2=kw.get('silog_ratio2', 0.85),
            min_depth=kw.get('min_depth'), max_depth=kw.get('max_depth'),
            gradient_weight=kw.get('gradient_weight', 0.0),
            gradient_scales=kw.get('gradient_scales', 4))
    if method.endswith('enhanced-ssi'):
        return lambda p, g, m, progress=0.0, epoch=0: enhanced_ssi_loss(
            p, g, m, progress=progress)
    if method.endswith('progressive-ssi'):
        return lambda p, g, m, progress=0.0, epoch=0: progressive_ssi_loss(
            p, g, m, epoch=epoch)
    plain = (('ssi-trim', ssi_trim_loss), ('ssi', ssi_loss),
             ('l1', l1_loss), ('mse', mse_loss), ('berhu', berhu_loss),
             ('silog', silog_loss), ('abs_rel', abs_rel_loss))
    for suffix, fn in plain:
        if method.endswith(suffix):
            return lambda p, g, m, progress=0.0, epoch=0, fn=fn: fn(p, g, m)
    raise ValueError('Unknown supervised loss {}'.format(method))


class SupervisedLoss:
    """Multi-scale supervised loss (reference supervised_loss.py:243-478).
    Returns {'loss', 'metrics'} with the per-scale 's{i}/loss' and
    's{i}/valid_ratio' on the sparse path, and 'supervised_loss'."""

    def __init__(self, supervised_method='sparse-l1', supervised_num_scales=4,
                 progressive_scaling=0.0, loss_kwargs=()):
        self.supervised_method = supervised_method
        self.supervised_num_scales = supervised_num_scales
        self.progressive_scaling = progressive_scaling
        self.loss_fn = get_loss_func(supervised_method, **dict(loss_kwargs))

    def __call__(self, inv_depths, gt_inv_depth, masks=None, progress=0.0,
                 epoch=0):
        n = ProgressiveScaling(self.progressive_scaling,
                               self.supervised_num_scales)(progress)
        n = min(n, len(inv_depths))
        gt_scales = match_scales(gt_inv_depth, list(inv_depths[:n]), n,
                                 mode='nearest')
        metrics = {}
        if self.supervised_method.startswith('sparse'):
            total = 0.0
            for i in range(n):
                valid = (gt_scales[i] > 0.0).to(inv_depths[i].dtype)
                if masks is not None and i < len(masks) and \
                        masks[i] is not None:
                    valid = valid * (masks[i] > 0).to(valid.dtype)
                pred_f = torch.where(valid > 0, inv_depths[i], EPS)
                gt_f = torch.where(valid > 0, gt_scales[i], EPS)
                loss_i = self.loss_fn(pred_f, gt_f, valid, progress=progress,
                                      epoch=epoch)
                metrics['s{}/loss'.format(i)] = loss_i
                metrics['s{}/valid_ratio'.format(i)] = valid.mean()
                total = total + loss_i
            loss = total / float(n)
        else:
            loss = sum(self.loss_fn(inv_depths[i], gt_scales[i],
                                    torch.ones_like(gt_scales[i]),
                                    progress=progress, epoch=epoch)
                       for i in range(n)) / float(n)
        metrics['supervised_loss'] = loss
        return {'loss': loss, 'metrics': metrics}
