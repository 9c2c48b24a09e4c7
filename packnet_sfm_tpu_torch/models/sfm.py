"""
SfM model family, eval branch (the JAX package's models/sfm.py:61-118 and
:173-207; reference models/SfmModel.py, SemiSupCompletionModel.py).

Batches are dicts of NHWC tensors: rgb [B,H,W,3], optional input_depth
[B,H,W,1], depth (GT) [B,H,W,1]. Training, pose networks and losses belong
to later slices of the port.
"""

import torch.nn as nn


class SfmModel(nn.Module):
    """Depth-net wrapper; forward(batch) is the eval forward."""

    def __init__(self, depth_net):
        super().__init__()
        self.depth_net = depth_net

    def compute_depth_net(self, batch):
        return self.depth_net(batch['rgb'],
                              input_depth=batch.get('input_depth'))

    def forward_base(self, batch):
        return {**self.compute_depth_net(batch), 'poses': None}

    def forward(self, batch):
        return self.forward_base(batch)


class SemiSupCompletionModel(SfmModel):
    """Depth-completion model (the fork's flagship); its eval forward is
    the base forward (sfm.py:205-207). Its training branch (GT clamp,
    bounded inverse depth, supervised losses) waits for the training
    slice."""
