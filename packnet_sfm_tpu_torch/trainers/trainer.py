"""
Training and evaluation loops over batches the caller hands over:
`Trainer` runs the train step epoch by epoch, tracking `progress` and
`epoch` as the JAX package's Trainer.train_epoch does
(trainers/trainer.py:345-410); `evaluate` is the batch-size-weighted
accumulation and flat `mode-metric` dict of its Trainer.validate
(:506-561). Loaders, checkpoints, mid-epoch resume and validation during
training wait for later slices.

The JAX trainer quantizes `progress` to the progressive-scaling breaks
before the step (`_quantize_progress`, so that few programs compile); that
gives the scale count of the segment before the current one. The port
passes the raw progress, whose scale count is ProgressiveScaling's.
"""

import numpy as np
import torch

from packnet_sfm_tpu_torch.parallel.train_step import (
    make_eval_metrics_step, make_optimizer, make_train_step)
from packnet_sfm_tpu_torch.utils.logging_utils import (
    METRIC_NAMES, print_metrics_table)


def evaluate(config, model, batches):
    """Run the eval protocol over `batches` (dicts of NHWC tensors on the
    model's device) with the model in eval mode, and return
    {'<mode>-<metric>': float, 'abs_rel': ...}. Batches without 'depth' are
    skipped; no batch gives {}."""
    params = config.model.params
    step = make_eval_metrics_step(model, params,
                                  flip_tta=bool(params.get('flip_tta', False)),
                                  int8_outputs=bool(params.get('int8_outputs',
                                                               False)))
    accum, count = {}, 0
    for batch in batches:
        if 'depth' not in batch:
            continue
        modes = step(batch)
        b = batch['rgb'].shape[0]
        for k, v in modes.items():
            accum[k] = accum.get(k, 0.0) + v.double().cpu().numpy() * b
        count += b
    if not count:
        return {}
    table = {k: v / count for k, v in accum.items()}
    print_metrics_table('Evaluation', table)
    flat = {}
    for mode, vals in table.items():
        for name, val in zip(METRIC_NAMES, np.asarray(vals)):
            flat['{}-{}'.format(mode, name)] = float(val)
    flat['abs_rel'] = flat.get('depth-abs_rel', 0.0)
    return flat


class Trainer:
    """Adam (from cfg.model.optimizer / scheduler, cfg.arch.clip_grad) and
    the train step over `model`, with `steps_per_epoch` batches an epoch
    for the lr schedule. `generator` feeds the model's random lr-flip."""

    def __init__(self, config, model, steps_per_epoch, generator=None):
        self.max_epochs = int(config.arch.max_epochs)
        self.optimizer = make_optimizer(
            model, config.model.optimizer, config.model.scheduler,
            steps_per_epoch, clip_grad=config.arch.clip_grad)
        self.train_step = make_train_step(model, self.optimizer, generator)
        self.current_epoch = 0

    def train_epoch(self, batches, epoch, max_steps=None):
        """One pass over `batches` (a sized iterable), or its first
        `max_steps`; returns the per-step losses as detached tensors."""
        n = len(batches)
        losses = []
        for b, batch in enumerate(batches):
            if max_steps is not None and b >= max_steps:
                break
            progress = (epoch + b / n) / max(self.max_epochs, 1)
            losses.append(self.train_step(batch, progress, epoch)['loss'])
        return losses

    def fit(self, batches, n_steps):
        """Train `n_steps` steps, epoch after epoch over `batches` (the last
        epoch may stop early); returns the per-step losses as floats."""
        losses = []
        while len(losses) < n_steps:
            losses += self.train_epoch(batches, self.current_epoch,
                                       n_steps - len(losses))
            self.current_epoch += 1
        return torch.stack(losses).tolist()
