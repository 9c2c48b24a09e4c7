"""
Photometric-loss helpers. The multi-view photometric loss itself belongs
to the self-supervised slice of the port; for now this holds the
scale-decay schedule the supervised loss shares with it (the JAX package's
losses/photometric.py:38-67, reference losses/loss_base.py:10-49).
"""

import numpy as np


class ProgressiveScaling:
    """Decay the number of scales with training progress in [0, 1]."""

    def __init__(self, progressive_scaling, num_scales=4):
        self.num_scales = num_scales
        if progressive_scaling > 0.0:
            self.breaks = np.float32(
                [progressive_scaling * (i + 1) for i in range(num_scales - 1)]
                + [1.0])
        else:
            self.breaks = None

    def __call__(self, progress):
        if self.breaks is None:
            return self.num_scales
        return int(self.num_scales - np.searchsorted(self.breaks,
                                                     float(progress)))
