"""The port's losses; `DualHeadDepthLoss` is exported here."""

from packnet_sfm_tpu_torch.losses.dual_head import DualHeadDepthLoss

__all__ = ['DualHeadDepthLoss']
