"""
Evaluation loop: the batch-size-weighted accumulation and flat
`mode-metric` dict of the JAX package's Trainer.validate
(trainers/trainer.py:506-561). Loaders, checkpoints and training wait for
later slices; here the caller hands over an iterable of batches.
"""

import numpy as np

from packnet_sfm_tpu_torch.parallel.train_step import make_eval_metrics_step
from packnet_sfm_tpu_torch.utils.logging_utils import (
    METRIC_NAMES, print_metrics_table)


def evaluate(config, model, batches):
    """Run the eval protocol over `batches` (dicts of NHWC tensors on the
    model's device) and return {'<mode>-<metric>': float, 'abs_rel': ...}.
    Batches without 'depth' are skipped; no batch gives {}."""
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
