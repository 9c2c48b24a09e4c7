"""
Dual-head (integer + fractional) depth loss, the ST2 INT8 training
objective (the JAX package's losses/dual_head.py; reference
packnet_sfm/losses/dual_head_depth_loss.py:23-201):

  L = w_int * L1(integer) + w_frac * L1(fractional) + w_cons * L1(recomposed)

over the pixels whose GT lies in (min_depth, max_depth), with the GT split
into its whole metres (over max_depth) and the rest.
"""

import dataclasses

import torch

from packnet_sfm_tpu_torch.ops.depth import decompose_depth, dual_head_to_depth
from packnet_sfm_tpu_torch.ops.image import interpolate


def _masked_l1(a, b, m):
    return ((a - b).abs() * m).sum() / m.sum().clamp(min=1.0)


@dataclasses.dataclass(frozen=True)
class DualHeadDepthLoss:
    max_depth: float = 15.0
    min_depth: float = 0.5
    integer_weight: float = 1.0
    fractional_weight: float = 10.0
    consistency_weight: float = 0.5

    def __post_init__(self):
        assert self.max_depth > self.min_depth > -1e-9
        assert self.integer_weight >= 0 and self.consistency_weight >= 0
        assert self.fractional_weight > 0

    def __call__(self, outputs, depth_gt, progress=0.0):
        """outputs: {('integer', 0), ('fractional', 0): [B,H,W,1] sigmoids};
        depth_gt [B,H',W',1], resized (nearest) to the heads' size when it
        differs. Returns {'loss', 'metrics'}; the loss is 0 when no pixel
        is valid."""
        integer_pred = outputs[('integer', 0)]
        fractional_pred = outputs[('fractional', 0)]
        if depth_gt.shape[1:3] != integer_pred.shape[1:3]:
            depth_gt = interpolate(depth_gt, integer_pred.shape[1:3],
                                   mode='nearest')
        mask = ((depth_gt > self.min_depth) &
                (depth_gt < self.max_depth)).to(integer_pred.dtype)

        integer_gt, fractional_gt = decompose_depth(depth_gt, self.max_depth)
        integer_loss = _masked_l1(integer_pred, integer_gt, mask)
        fractional_loss = _masked_l1(fractional_pred, fractional_gt, mask)
        depth_pred = dual_head_to_depth(integer_pred, fractional_pred,
                                        self.max_depth)
        consistency_loss = _masked_l1(depth_pred, depth_gt, mask)

        total = (self.integer_weight * integer_loss +
                 self.fractional_weight * fractional_loss +
                 self.consistency_weight * consistency_loss)
        n_valid = mask.sum()
        total = torch.where(n_valid > 0, total, torch.zeros_like(total))

        # the metrics the ST2 INT8 validation report keys on (reference
        # dual_head_depth_loss.py:178-195), all masked
        cnt = n_valid.clamp(min=1.0)
        depth_err = (depth_pred - depth_gt).abs()
        mean_depth_error = (depth_err * mask).sum() / cnt
        # the LOWER median (torch .median() semantics, as JAX computes it:
        # invalid pixels to +inf, a global sort, element (n_valid - 1) // 2)
        # where ops/depth.py masked_median averages the two middle values
        flat = torch.where(mask > 0, depth_err,
                           torch.full_like(depth_err, float('inf'))
                           ).reshape(-1).sort().values
        med_idx = ((n_valid.to(torch.int64) - 1) // 2).clamp(min=0)
        median_depth_error = flat.index_select(0, med_idx.reshape(1))[0]
        integer_err_m = (integer_pred - integer_gt).abs() * self.max_depth
        integer_accuracy = ((integer_err_m < 1.0).to(mask.dtype) *
                            mask).sum() / cnt
        fractional_rmse = torch.sqrt(
            (((fractional_pred - fractional_gt) ** 2) * mask).sum() / cnt)
        return {
            'loss': total,
            'metrics': {
                'integer_loss': integer_loss,
                'fractional_loss': fractional_loss,
                'consistency_loss': consistency_loss,
                'total_loss': total,
                'mean_depth_error': mean_depth_error,
                'median_depth_error': median_depth_error,
                'integer_accuracy': integer_accuracy,
                'fractional_rmse': fractional_rmse,
            },
        }
