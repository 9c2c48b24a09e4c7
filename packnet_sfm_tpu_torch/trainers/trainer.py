"""
Training and evaluation loops: `Trainer` runs the train step epoch by
epoch over batches the caller hands over, tracking `progress` and `epoch`
as the JAX package's Trainer.train_epoch does (trainers/trainer.py:345-410);
`evaluate` is the batch-size-weighted accumulation and flat `mode-metric`
dict of its Trainer.validate (:506-561), with its per-batch warn-and-skip;
`make_loader`, `validate`, `validate_multi`, `test` and
`save_eval_outputs` are its loader-driven evaluation (:117-171, :506-648).
Checkpoint resume, the loader-driven training loop and validation during
training wait for the trainer slice.

The JAX trainer quantizes `progress` to the progressive-scaling breaks
before the step (`_quantize_progress`, so that few programs compile); that
gives the scale count of the segment before the current one. The port
passes the raw progress, whose scale count is ProgressiveScaling's.
"""

import os

import numpy as np
import torch

from packnet_sfm_tpu_torch.datasets import setup_dataset
from packnet_sfm_tpu_torch.datasets.concat import ConcatDataset
from packnet_sfm_tpu_torch.datasets.loader import DataLoader, to_device_batch
from packnet_sfm_tpu_torch.parallel.train_step import (
    make_eval_metrics_step, make_eval_step, make_optimizer, make_train_step)
from packnet_sfm_tpu_torch.utils.logging_utils import (
    METRIC_NAMES, pcolor, print_metrics_table)
from packnet_sfm_tpu_torch.utils.save import (
    prepare_dataset_prefix, save_depth)


class Metrics(dict):
    """The flat {'<mode>-<metric>': float, 'abs_rel': float} dict of an
    evaluation; `skipped` counts the batches that failed and were left
    out."""

    def __init__(self, values=(), skipped=0):
        super().__init__(values)
        self.skipped = skipped


def evaluate(config, model, batches, title='Evaluation'):
    """Run the eval protocol over `batches` (dicts of NHWC arrays or
    tensors; each moves to the model's device through `to_device_batch`)
    with the model in eval mode, and return its Metrics. Batches without
    'depth' are left out. A batch that fails, in the loader or in the step,
    is reported and skipped (`Metrics.skipped`); when every batch failed it
    raises, so a broken pipeline cannot pass for an empty evaluation. No
    batch gives an empty Metrics."""
    params = config.model.params
    step = make_eval_metrics_step(model, params,
                                  flip_tta=bool(params.get('flip_tta', False)),
                                  int8_outputs=bool(params.get('int8_outputs',
                                                               False)))
    device = next(model.parameters()).device
    accum, count, seen, skipped, error = {}, 0, 0, 0, None
    batches = iter(batches)
    while True:
        seen += 1
        try:
            batch = next(batches)
        except StopIteration:
            break
        except Exception as e:  # noqa: BLE001 — a sample failed to load
            skipped, error = skipped + 1, e
            print(pcolor('  warning: evaluation batch {} failed in the '
                         'loader: {}'.format(seen, e), 'red'))
            continue
        try:
            batch = to_device_batch(batch, device)
            if 'depth' not in batch:
                continue
            b = batch['rgb'].shape[0]
            values = {k: v.double().cpu().numpy() * b
                      for k, v in step(batch).items()}
        except Exception as e:  # noqa: BLE001 — reported, then skipped
            skipped, error = skipped + 1, e
            print(pcolor('  warning: evaluation batch {} failed: {}'.format(
                seen, e), 'red'))
            continue
        for k, v in values.items():
            accum[k] = accum.get(k, 0.0) + v
        count += b
    if skipped and not count:
        raise RuntimeError('all {} evaluation batches failed'.format(
            skipped)) from error
    if not count:
        return Metrics(skipped=skipped)
    table = {k: v / count for k, v in accum.items()}
    print_metrics_table(title, table)
    flat = Metrics(skipped=skipped)
    for mode, vals in table.items():
        for name, val in zip(METRIC_NAMES, np.asarray(vals)):
            flat['{}-{}'.format(mode, name)] = float(val)
    flat['abs_rel'] = flat.get('depth-abs_rel', 0.0)
    return flat


def make_loader(config, split, dataset_idx=None):
    """The DataLoader of a config split ('validation' or 'test'; 'train'
    raises until the trainer slice), over all its datasets concatenated or
    only dataset `dataset_idx`; None when the split names no dataset."""
    cfg = config.datasets[split]
    datasets = setup_dataset(cfg, config.datasets.augmentation, split)
    if not datasets:
        return None
    if dataset_idx is not None:
        datasets = [datasets[dataset_idx]]
    if cfg.get('cache', ''):
        raise NotImplementedError('datasets.{}.cache is not ported yet '
                                  '(ROADMAP.md section 1: the sample cache)'
                                  .format(split))
    repeats = cfg.get('repeat', [1] * len(datasets))
    ds = ConcatDataset(datasets, repeats) if len(datasets) > 1 or \
        (repeats and repeats[0] > 1) else datasets[0]
    # train keeps static shapes; eval sees every sample (the reference
    # asserts all samples seen, utils/reduce.py:67-68)
    return DataLoader(ds, batch_size=cfg.batch_size,
                      shuffle=(split == 'train'), seed=config.arch.seed,
                      num_workers=cfg.num_workers,
                      drop_last=(split == 'train'))


def make_val_loaders(config, split='validation'):
    """[(prefix, loader)]: one loader per dataset of an eval split, each
    prefixed '<i>-<path basename>-<split stem>', or [('', loader)] for a
    single dataset."""
    cfg = config.datasets[split]
    names = list(cfg.get('dataset', []))
    if len(names) <= 1:
        loader = make_loader(config, split)
        return [] if loader is None else [('', loader)]
    return [('{}-{}'.format(i, prepare_dataset_prefix(cfg, i)),
             make_loader(config, split, i)) for i in range(len(names))]


def validate(config, model, loader, title=''):
    """The eval protocol over one loader: `evaluate` with the JAX
    Trainer.validate's table title."""
    return evaluate(config, model, loader,
                    'Validation' + (' — ' + title if title else ''))


def validate_multi(config, model, loaders):
    """Validate each (prefix, loader) separately: the metrics come back
    prefixed '<prefix>/', and those of dataset checkpoint.monitor_index
    also unprefixed. A single unprefixed loader gives its metrics as they
    are."""
    if len(loaders) == 1 and not loaders[0][0]:
        return validate(config, model, loaders[0][1])
    mon = int(config.checkpoint.get('monitor_index', 0))
    combined = Metrics()
    for i, (prefix, loader) in enumerate(loaders):
        flat = validate(config, model, loader, title=prefix)
        combined.skipped += flat.skipped
        combined.update({'{}/{}'.format(prefix, k): v
                         for k, v in flat.items()})
        if i == min(mon, len(loaders) - 1):
            combined.update(flat)
    return combined


def test(config, model, loader=None):
    """Evaluate the test split (`loader`, else one loader per dataset of
    datasets.test) and, when save.folder is set, write each sample's
    outputs there (`save_eval_outputs`)."""
    loaders = [('', loader)] if loader is not None else \
        make_val_loaders(config, 'test')
    if not loaders:
        return Metrics()
    metrics = validate_multi(config, model, loaders)
    if config.save.folder:
        for i, (_, ld) in enumerate(loaders):
            save_eval_outputs(config, model, ld, dataset_idx=i)
    return metrics


def save_eval_outputs(config, model, loader, dataset_idx=0):
    """A second pass over `loader` writing <save.folder>/depth/<dataset>/
    <ckpt>/<name>_{depth.npz, depth.png, rgb.png, viz.png} per the
    save.depth flags (reference utils/save.py). As in the JAX package, the
    saved depth is 1 / the network's sigmoid output. Returns the number of
    samples written."""
    if config.model.depth_net.get('use_dual_head', False):
        raise NotImplementedError('dual-head outputs are not saved yet '
                                  '(ROADMAP.md section 1: the dual head in '
                                  'the eval and inference CLIs)')
    ckpt_name = os.path.basename(
        config.save.get('pretrained', '') or config.checkpoint.filepath
        or '').replace('{', '').replace('}', '').replace(':', '') or 'model'
    ds_cfg = config.datasets.test if config.datasets.test.get('dataset') \
        else config.datasets.validation
    forward = make_eval_step(model)
    device = next(model.parameters()).device
    total = 0
    for batch in loader:
        out = forward(to_device_batch(batch, device))
        inv = out['inv_depths'][0].float().cpu().numpy()
        total += save_depth(batch, inv, config.save, ds_cfg,
                            ckpt_name=ckpt_name, dataset_idx=dataset_idx)
    print(pcolor('saved {} eval outputs -> {}'.format(
        total, config.save.folder), 'cyan'))
    return total


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
