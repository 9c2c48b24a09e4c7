"""
Training and evaluation loops (the JAX package's trainers/trainer.py).

`Trainer.fit` is its loader-driven loop (:285-412): the train loader and one
validation loader per dataset, then epoch by epoch `train_epoch` over
batches kept on the card ahead of the step (`prefetch_to_device`),
validation, the per-epoch eval JSON, the logger's metrics and images, the
top-k checkpoints, and the removal of the stale `mid_epoch.ckpt`. Inside an
epoch: the rolling loss at the 10% marks, a `mid_epoch.ckpt` with the
loader position every `checkpoint.save_every_n_steps`, a `quick_eval` every
`arch.eval_progress_interval`, the StepTimer breakdown (data wait against
step time; unlike the JAX loop, which books the saves and evals between
steps as data wait, it books them to neither). The loss is read on
the host only by the step's non-finite guard, at the 10% marks and for the
epoch mean. Each step's random draws (the lr-flip, `tpu.device_augment`'s
jitter factors) come from a generator seeded by (arch.seed, epoch, batch
index), so a mid-epoch resume replays them.

Resume restores the weights, the batch statistics, Adam's state (the
port's own or a JAX checkpoint's optax state; without either it warns and
starts a fresh optimizer, as JAX does), the step and the epoch. A
mid-epoch checkpoint resumes at its loader position. An epoch-end
checkpoint holds the epoch it finished: the port resumes at the next one,
where the JAX Trainer.setup trains that epoch again.

The JAX trainer quantizes `progress` to the progressive-scaling breaks
before the step (`_quantize_progress`, so that few programs compile); that
gives the scale count of the segment before the current one. The port
passes the raw progress, whose scale count is ProgressiveScaling's.

Under model.params.qat 'weights' the train step runs over int8
fake-quantized depth-net kernels, and validation, the quick evals and the
logged images use those int8 weights, as JAX `_build_steps` /
`_get_metrics_step` (:226-270) do; model.params.int8_outputs and
int8_weights set the eval protocol's quantizers. The save pass writes what
the float weights predict, without int8_outputs, as JAX
`_save_eval_outputs` does.

`evaluate` is the batch-size-weighted accumulation and flat `mode-metric`
dict of its Trainer.validate (:506-561), with its per-batch warn-and-skip;
`make_loader`, `validate`, `validate_multi`, `test` and
`save_eval_outputs` are its loader-driven evaluation (:117-171, :506-648).
"""

import json
import os
import time

import numpy as np
import torch

from packnet_sfm_tpu_torch.datasets import setup_dataset
from packnet_sfm_tpu_torch.datasets.augmentations_advanced import (
    make_batch_augment)
from packnet_sfm_tpu_torch.datasets.cache import SampleCache
from packnet_sfm_tpu_torch.datasets.concat import ConcatDataset
from packnet_sfm_tpu_torch.datasets.loader import (
    DataLoader, prefetch_to_device, to_device_batch)
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.models.factory import (
    init_weights, setup_model, setup_photometric_loss)
from packnet_sfm_tpu_torch.networks.layers.san import (
    calibrate_san_row_window)
from packnet_sfm_tpu_torch.ops.augment import device_color_jitter
from packnet_sfm_tpu_torch.ops.depth import dual_head_to_depth
from packnet_sfm_tpu_torch.parallel.train_step import (
    make_eval_metrics_step, make_eval_step, make_optimizer, make_train_step)
from packnet_sfm_tpu_torch.utils.checkpoint import (
    ModelCheckpoint, adam_state, load_weights, save_checkpoint)
from packnet_sfm_tpu_torch.utils.logging_utils import (
    METRIC_NAMES, AvgMeter, pcolor, print_metrics_table)
from packnet_sfm_tpu_torch.utils.pretrained import load_pretrained
from packnet_sfm_tpu_torch.utils.profiling import StepTimer
from packnet_sfm_tpu_torch.utils.save import (
    prepare_dataset_prefix, save_depth)
from packnet_sfm_tpu_torch.utils.viz import viz_inv_depth

MID_EPOCH = 'mid_epoch.ckpt'


class Metrics(dict):
    """The flat {'<mode>-<metric>': float, 'abs_rel': float} dict of an
    evaluation; `skipped` counts the batches that failed and were left
    out."""

    def __init__(self, values=(), skipped=0):
        super().__init__(values)
        self.skipped = skipped


def qat_weights(params):
    """model.params.qat asks for QAT on weights."""
    return 'weights' in str(params.get('qat', ''))


def metrics_step(config, model):
    """The eval protocol step of `config` (JAX `_get_metrics_step`): its
    flip-TTA and int8_outputs, and int8 weights under int8_weights or QAT on
    weights."""
    params = config.model.params
    return make_eval_metrics_step(
        model, params, flip_tta=bool(params.get('flip_tta', False)),
        int8_outputs=bool(params.get('int8_outputs', False)),
        int8_weights=bool(params.get('int8_weights', False)) or
        qat_weights(params))


def evaluate(config, model, batches, title='Evaluation'):
    """Run the eval protocol over `batches` (dicts of NHWC arrays or
    tensors; each moves to the model's device through `to_device_batch`)
    with the model in eval mode, and return its Metrics. Batches without
    'depth' are left out. A batch that fails, in the loader or in the step,
    is reported and skipped (`Metrics.skipped`); when every batch failed it
    raises, so a broken pipeline cannot pass for an empty evaluation. No
    batch gives an empty Metrics."""
    step = metrics_step(config, model)
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
    """The DataLoader of a config split ('train', 'validation' or 'test'),
    over all its datasets concatenated or only dataset `dataset_idx`; None
    when the split names no dataset. Under tpu.device_augment the train
    split ships un-jittered images (the step jitters them on the card).
    datasets.<split>.cache ('ram' or 'disk', under cache_dir) wraps the
    split in a SampleCache, which a train split whose transform is random
    on the host refuses with a warning, as JAX does; the train split's
    mixup and cutmix run on its batches (`make_batch_augment`)."""
    cfg = config.datasets[split]
    aug = config.datasets.augmentation
    device_augment = bool(config.tpu.get('device_augment', False))
    if split == 'train' and device_augment:
        aug = aug.clone()
        aug.jittering = ()
    datasets = setup_dataset(cfg, aug, split, seed=int(config.arch.seed))
    if not datasets:
        return None
    if dataset_idx is not None:
        datasets = [datasets[dataset_idx]]
    repeats = cfg.get('repeat', [1] * len(datasets))
    ds = ConcatDataset(datasets, repeats) if len(datasets) > 1 or \
        (repeats and repeats[0] > 1) else datasets[0]
    if cfg.get('cache', ''):
        if split != 'train' or SampleCache.validate_transform(
                config.datasets.augmentation, device_augment):
            ds = SampleCache(ds, mode=cfg.cache,
                             cache_dir=cfg.get('cache_dir', '') or None)
        else:
            print(pcolor(
                '[cache] disabled for train split: host-side random '
                'augmentation would be frozen (enable tpu.device_augment '
                'or drop jittering)', 'red'))
    # train keeps static shapes; eval sees every sample (the reference
    # asserts all samples seen, utils/reduce.py:67-68)
    return DataLoader(ds, batch_size=cfg.batch_size,
                      shuffle=(split == 'train'), seed=config.arch.seed,
                      num_workers=cfg.num_workers,
                      drop_last=(split == 'train'),
                      batch_augment=make_batch_augment(
                          config.datasets.augmentation)
                      if split == 'train' else None)


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
    saved depth is 1 / the network's sigmoid output, or for a dual head
    1 / max(dual_head_to_depth(integer, fractional, max_depth), 1e-6); the
    float weights run, whatever model.params.qat, int8_outputs and
    int8_weights say. Returns the number of samples written."""
    dual = bool(config.model.depth_net.get('use_dual_head', False))
    max_d = config.model.params.max_depth or 80.0
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
        if dual:
            depth = dual_head_to_depth(out[('integer', 0)],
                                       out[('fractional', 0)], max_d)
            inv = (1.0 / depth.clamp(min=1e-6)).float().cpu().numpy()
        else:
            inv = out['inv_depths'][0].float().cpu().numpy()
        total += save_depth(batch, inv, config.save, ds_cfg,
                            ckpt_name=ckpt_name, dataset_idx=dataset_idx)
    print(pcolor('saved {} eval outputs -> {}'.format(
        total, config.save.folder), 'cyan'))
    return total


def seeded_model(config, seed):
    """The config's model with weights drawn from torch seed `seed`, then
    the pretrained weights the config asks for (utils/pretrained.py: a 'pt'
    depth net's ImageNet encoder, which raises PretrainedWeightsNotFound
    without a file unless model.depth_net.allow_random_init is set; each
    net's checkpoint_path), on the CPU."""
    model = init_weights(setup_model(config),
                         torch.Generator().manual_seed(seed))
    load_pretrained(config, model)
    return model


def step_seed(seed, epoch, index):
    """The seed of the generator of batch `index` of `epoch`."""
    return int(np.random.SeedSequence([seed, epoch, index]).generate_state(
        1)[0])


class Trainer:
    """Train `config`'s model (see the module note). The model is built
    from the config with weights from arch.seed, or is the one handed
    over; it lives on `device` (the card unless 'cpu' is asked for).
    `resume_state` is a checkpoint payload; `logger` any object with
    `log_metrics(dict, step)` and `log_images(name, array, step)`. `step`
    counts the train steps run, `optimizer.count` the updates applied (a
    step whose loss is not finite applies none)."""

    def __init__(self, config, resume_state=None, logger=None,
                 device='cuda', model=None):
        self.config = config
        self.resume_state = resume_state
        self.logger = logger
        self.device = resolve_device(device)
        self.seed = int(config.arch.seed)
        self.max_epochs = int(config.arch.max_epochs)
        self.validate_first = bool(config.arch.validate_first)
        self.last_val_metrics = {}
        self.current_epoch = 0
        self.step = 0
        self._maybe_autocalibrate_row_window()
        if model is None:
            model = seeded_model(config, self.seed)
        self.model = model.to(self.device)
        ck = config.checkpoint
        self.checkpoint_cb = ModelCheckpoint(
            ck.filepath, monitor=ck.monitor, save_top_k=ck.save_top_k,
            mode=ck.mode, period=ck.period) if ck.filepath else None
        self.generator = torch.Generator()
        self.optimizer = self.train_step = None
        self._augment = None
        self._precision_switched = False
        self._quick_eval_iter = None

    def _maybe_autocalibrate_row_window(self):
        """model.depth_net.san_row_window -1: size the SAN row window from
        the projected LiDAR of the train split (`calibrate_san_row_window`);
        without readable data, no window."""
        dn = self.config.model.depth_net
        if dn.get('san_row_window', 0.0) != -1.0:
            return
        try:
            datasets = setup_dataset(self.config.datasets.train,
                                     self.config.datasets.augmentation,
                                     'train', seed=self.seed)
        except OSError as e:
            print(pcolor('[san] row-window auto-calibration skipped ({}); '
                         'running full-height'.format(e), 'yellow'))
            dn.san_row_window = 0.0
            return
        frac = calibrate_san_row_window(datasets[0]) if datasets else 0.0
        dn.san_row_window = frac
        print(pcolor('[san] auto row window: {:.3f}{}'.format(
            frac, '' if frac > 0 else ' (disabled: full height)'), 'cyan'))

    def setup(self, steps_per_epoch):
        """Build Adam (its schedules over `steps_per_epoch` steps an epoch)
        and the train step, then put back the resume state."""
        cfg = self.config
        self.optimizer = make_optimizer(
            self.model, cfg.model.optimizer, cfg.model.scheduler,
            max(1, steps_per_epoch), clip_grad=cfg.arch.clip_grad)
        jittering = tuple(cfg.datasets.augmentation.jittering or ()) \
            if cfg.tpu.get('device_augment', False) else ()
        if jittering:
            self._augment = lambda batch, gen: device_color_jitter(
                batch, jittering, gen)
        self._build_step()
        if self.resume_state is not None:
            self._resume(self.resume_state)

    def _build_step(self):
        self.train_step = make_train_step(
            self.model, self.optimizer, self.generator, self._augment,
            qat_weights=qat_weights(self.config.model.params))

    def _resume(self, state):
        load_weights(self.model, state)
        adam = adam_state(state)
        if adam is None:
            print(pcolor('[resume] checkpoint has no optimizer state: '
                         'starting with a fresh optimizer', 'yellow'))
        else:
            self.optimizer.load_state_dict(adam)
        self.step = int(state.get('step', 0))
        loader = state.get('loader')
        self.current_epoch = int(loader['epoch']) if loader else \
            int(state.get('epoch', 0)) + 1

    def _run_step(self, batch, epoch, index, n):
        """Step on batch `index` of the `n` of `epoch`; returns its loss."""
        self.generator.manual_seed(step_seed(self.seed, epoch, index))
        progress = (epoch + index / n) / max(self.max_epochs, 1)
        out = self.train_step(batch, progress, epoch)
        self.step += 1
        return out['loss']

    def train_batches(self, batches, n_steps):
        """Train `n_steps` steps, epoch after epoch over `batches` (batch
        dicts on the device, held in memory; the last epoch may stop
        early); returns the per-step losses as floats. Call `setup`
        first."""
        losses, n = [], len(batches)
        while len(losses) < n_steps:
            for b, batch in enumerate(batches[:n_steps - len(losses)]):
                losses.append(self._run_step(batch, self.current_epoch, b,
                                             n))
            self.current_epoch += 1
        return torch.stack(losses).tolist()

    def fit(self):
        """Train from `current_epoch` to arch.max_epochs over the config's
        datasets (see the module note)."""
        cfg = self.config
        train_loader = make_loader(cfg, 'train')
        if train_loader is None:
            raise ValueError('No training dataset configured '
                             '(datasets.train)')
        val_loaders = make_val_loaders(cfg)
        mon = int(cfg.checkpoint.get('monitor_index', 0))
        val_loader = val_loaders[min(mon, len(val_loaders) - 1)][1] \
            if val_loaders else None
        self.setup(len(train_loader))
        if self.validate_first and val_loaders:
            validate_multi(cfg, self.model, val_loaders)
        resume_loader = (self.resume_state or {}).get('loader')
        for epoch in range(self.current_epoch, self.max_epochs):
            self.current_epoch = epoch
            self._maybe_switch_precision(epoch)
            train_loader.set_epoch(epoch)
            if resume_loader is not None:
                # exact mid-epoch resume: the (seed, epoch)-keyed shuffle
                # replayed, the consumed batches skipped
                train_loader.load_state_dict(resume_loader)
                resume_loader = None
            train_metrics = self.train_epoch(train_loader, val_loader, epoch)
            print(pcolor('Epoch {:d} | loss {:.4f} | {:.1f} img/s'.format(
                epoch, train_metrics['loss'], train_metrics['img_per_s']),
                'green'))
            val_metrics = {}
            if val_loaders:
                val_metrics = validate_multi(cfg, self.model, val_loaders)
                self._dump_eval_json(epoch, val_metrics)
            self.last_val_metrics = val_metrics
            if self.logger is not None:
                self.logger.log_metrics(
                    {'train/' + k: v for k, v in train_metrics.items()} |
                    {'val/' + k: v for k, v in val_metrics.items()},
                    step=epoch)
                self._log_val_images(val_loader, epoch)
            if self.checkpoint_cb is not None:
                self.checkpoint_cb.check_and_save(
                    cfg, self.model, self.optimizer,
                    {**train_metrics, **val_metrics}, epoch, self.step)
                # the rolling mid-epoch checkpoint is stale now: resuming
                # from it would restart inside this finished epoch
                mid = os.path.join(self.checkpoint_cb.dirpath, MID_EPOCH)
                if os.path.exists(mid):
                    os.remove(mid)
        return self

    def train_epoch(self, loader, val_loader, epoch):
        """One pass over `loader` from its position (a loaded mid-epoch
        one skips the consumed batches; progress, saves and evals count
        from the true batch index). Returns the mean loss, the StepTimer
        breakdown and img/s over the pass's wall time, data included."""
        cfg = self.config
        n = len(loader)
        pending = loader.skip
        save_every = int(cfg.checkpoint.get('save_every_n_steps', 0))
        eval_every = max(1, int(n * cfg.arch.eval_progress_interval)) \
            if cfg.arch.eval_during_training else None
        losses, meter = [], AvgMeter(50)
        t0 = time.perf_counter()
        timer = StepTimer()
        batches = prefetch_to_device(iter(loader), self.device,
                                     size=max(1, int(cfg.tpu.get('prefetch',
                                                                 2))))
        for i, batch in enumerate(batches):
            b = pending + i
            timer.data_ready()
            losses.append(self._run_step(batch, epoch, b, n))
            meter(losses[-1])
            timer.step_done()
            if n >= 10 and (b + 1) % max(1, n // 10) == 0:
                print(pcolor('  [{}/{}] loss {:.4f} (avg50)'.format(
                    b + 1, n, meter.get()), 'cyan'))
            if save_every and (b + 1) % save_every == 0 and \
                    self.checkpoint_cb is not None:
                save_checkpoint(
                    os.path.join(self.checkpoint_cb.dirpath, MID_EPOCH), cfg,
                    self.model, epoch, self.step, self.optimizer,
                    extra={'loader': {'epoch': epoch,
                                      'batches_consumed': b + 1}})
            if eval_every and val_loader is not None and b > 0 and \
                    b % eval_every == 0:
                self.quick_eval(val_loader, b, n)
            # the prints, saves and evals are neither data wait nor step
            timer.restart()
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        wall = time.perf_counter() - t0
        prof = timer.summary()
        print(pcolor(
            '  step breakdown: data {:.1f} ms | step {:.1f} ms '
            '({:.0%} input-bound)'.format(prof['data_ms_per_step'],
                                          prof['step_ms_per_step'],
                                          prof['data_fraction']), 'blue'))
        return {'loss': mean_loss, **prof,
                'img_per_s': len(losses) * loader.batch_size / max(wall,
                                                                    1e-9)}

    def quick_eval(self, val_loader, step_i, steps):
        """Mid-epoch eval of arch.eval_subset_size validation samples,
        printing abs_rel from RGB alone and from RGB + LiDAR (reference
        horovod_trainer.py:127-220), the means of the batches' abs_rel; returns
        them as {'rgb', 'rgbd'} (None without such batches). The eval
        protocol is validation's (`metrics_step`). A persistent iterator goes
        round the validation set, so successive calls see different
        samples."""
        subset = int(self.config.arch.eval_subset_size)
        step = metrics_step(self.config, self.model)
        seen, rgb, rgbd = 0, [], []
        it = self._quick_eval_iter
        while seen < subset:
            if it is None:
                it = iter(val_loader)
            try:
                batch = next(it)
            except StopIteration:
                it = iter(val_loader)
                try:
                    batch = next(it)
                except StopIteration:
                    break
            dev = to_device_batch(batch, self.device)
            if 'depth' not in dev:
                it = None
                break
            if 'input_depth' in dev:
                rgbd.append(step(dev)['depth'][0])
                dev = {k: v for k, v in dev.items() if k != 'input_depth'}
            rgb.append(step(dev)['depth'][0])
            seen += dev['rgb'].shape[0]
        self._quick_eval_iter = it
        means = {k: float(torch.stack(v).mean()) if v else None
                 for k, v in (('rgb', rgb), ('rgbd', rgbd))}
        if rgb:
            msg = '  [eval @ {}/{}] abs_rel RGB {:.4f}'.format(
                step_i, steps, means['rgb'])
            if rgbd:
                msg += ' | RGB+LiDAR {:.4f}'.format(means['rgbd'])
            print(pcolor(msg, 'yellow'))
        return means

    def _maybe_switch_precision(self, epoch):
        """Bf16 photometric maps for the bulk of training, fp32 from
        tpu.photometric_fp32_progress on: rebuilds only the loss."""
        tpu = self.config.tpu
        frac = float(tpu.get('photometric_fp32_progress', -1.0))
        if frac < 0 or tpu.get('photometric_dtype') != 'bfloat16' or \
                epoch < frac * self.max_epochs or self._precision_switched:
            return
        self._precision_switched = True
        print(pcolor('Switching photometric loss to fp32 at epoch {} '
                     '(progress {:.0%})'.format(epoch, frac), 'yellow'))
        tpu.photometric_dtype = 'float32'
        if hasattr(self.model, 'photometric_loss'):
            self.model.photometric_loss = setup_photometric_loss(self.config)

    def _log_val_images(self, val_loader, epoch):
        """Up to 4 validation images and their predicted inverse depths,
        coloured, to the logger (on the int8 weights under QAT on weights);
        nothing for a dual-head model, as in JAX."""
        if val_loader is None:
            return
        try:
            batch = next(iter(val_loader))
        except StopIteration:
            return
        step = make_eval_step(self.model,
                              qat_weights(self.config.model.params))
        out = step(to_device_batch(batch, self.device))
        if 'inv_depths' not in out:
            return
        rgb = np.asarray(batch['rgb'])[:4]
        sig = out['inv_depths'][0][:4].float().cpu().numpy()
        self.logger.log_images('val/rgb', rgb, step=epoch)
        self.logger.log_images(
            'val/inv_depth',
            np.stack([viz_inv_depth(s[..., 0]) for s in sig]), step=epoch)

    def _dump_eval_json(self, epoch, metrics):
        """<checkpoint dir>/evaluation_results/epoch_<N>_results.json."""
        if not self.config.checkpoint.filepath:
            return
        out_dir = os.path.join(
            os.path.dirname(self.config.checkpoint.filepath),
            'evaluation_results')
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, 'epoch_{}_results.json'.format(
                epoch)), 'w') as f:
            json.dump(metrics, f, indent=2)
