"""Parts of the port's training loop that the parity tests of
tests/test_torch_trainer_fit.py do not reach, on the CPU on
configs/overfit_synthetic.yaml (ResNetSAN01 + PoseNet, Synthetic 64x96,
B2):

- the progressive precision switch (JAX tests/test_trainer_eval.py
  test_progressive_precision_switch and test_precision_switch_keeps_
  augment_and_static_progress): bf16 photometric maps until
  tpu.photometric_fp32_progress, float32 after; under tpu.device_augment
  with progressive_scaling 0.3 the on-card jitter still runs in every step
  after the switch (the JAX regression the second test pins);
- validate_first and `_log_val_images`, through a recording logger: the
  first validation scores the initial weights before any step; each epoch
  logs the first validation batch's RGB and the coloured inverse depth of
  the eval forward, on the int8 weights under QAT on weights, and nothing
  for a dual-head model (JAX trainers/trainer.py:749-752);
- the indoor dual-head YAML (no input depth: no SAN pass) builds and takes
  a step under QAT on weights and outputs (the outdoor one is stepped
  against JAX in tests/test_torch_dual_head.py).
"""

from pathlib import Path

import numpy as np
import pytest

from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.config import parse_train_config
from packnet_sfm_tpu_torch.datasets.loader import to_device_batch
from packnet_sfm_tpu_torch.parallel.train_step import make_eval_step
from packnet_sfm_tpu_torch.trainers import trainer as trainer_mod
from packnet_sfm_tpu_torch.trainers.trainer import (
    Trainer, evaluate, make_loader, seeded_model)
from packnet_sfm_tpu_torch.utils.viz import viz_inv_depth
from tests.torch_fixtures import OVERFIT, one_torch_thread  # noqa: F401

INDOOR = str(Path(__file__).resolve().parents[1] / 'configs' /
             'train_resnet_san_ncdb_indoor_dual_head_640x384.yaml')

pytestmark = pytest.mark.usefixtures('one_torch_thread')


class Recorder:
    """A logger recording, with the trainer's validations and steps, the
    order of events, and each image set it is handed."""

    def __init__(self):
        self.events, self.images = [], []

    def log_metrics(self, metrics, step=None):
        self.events.append(('metrics', step))

    def log_images(self, name, array, step=None):
        self.events.append(('images', step))
        self.images.append((name, np.asarray(array), step))


@pytest.mark.parametrize('case', ['plain', 'device_augment'])
def test_precision_switch(case, monkeypatch):
    """The photometric maps switch from bf16 to float32 at the configured
    progress (epoch 1 of 2; epoch 2 of 3 at 0.4); under device_augment the
    jitter runs in every step of every epoch, the switch's included."""
    # 4 training samples: 2 steps an epoch
    over = ['tpu.photometric_dtype', 'bfloat16', 'checkpoint.filepath', '',
            'model.loss.supervised_loss_weight', 0.9,
            'datasets.train.split', ['4']]
    if case == 'plain':
        over += ['arch.max_epochs', 2, 'tpu.photometric_fp32_progress', 0.5]
        switch = 1
    else:
        over += ['arch.max_epochs', 3, 'tpu.photometric_fp32_progress', 0.4,
                 'tpu.device_augment', True,
                 'datasets.augmentation.jittering', (0.2, 0.2, 0.2, 0.05),
                 'model.loss.progressive_scaling', 0.3]
        switch = 2
    cfg = parse_train_config(OVERFIT, over)
    cfg.datasets.validation.dataset = []
    jitters = []
    real = trainer_mod.device_color_jitter

    def counted(*args, **kwargs):
        jitters.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(trainer_mod, 'device_color_jitter', counted)
    per_epoch = []

    class Watched(Trainer):
        def train_epoch(self, loader, val_loader, epoch):
            n = len(jitters)
            out = super().train_epoch(loader, val_loader, epoch)
            per_epoch.append((self.model.photometric_loss.photometric_dtype,
                              len(jitters) - n))
            return out

    tr = Watched(cfg, device='cpu').fit()
    assert tr._precision_switched and cfg.tpu.photometric_dtype == 'float32'
    steps = len(make_loader(cfg, 'train'))
    want_jitter = steps if case == 'device_augment' else 0
    assert per_epoch == [('bfloat16', want_jitter)] * switch + [
        ('float32', want_jitter)] * (cfg.arch.max_epochs - switch)


@pytest.mark.parametrize('case', ['float', 'qat_weights', 'dual'])
def test_validate_first_and_logged_images(case, monkeypatch):
    over = ['arch.max_epochs', 1, 'arch.validate_first', True,
            'checkpoint.filepath', '', 'tpu.photometric_dtype', 'float32',
            'datasets.train.split', ['4']]
    if case == 'qat_weights':
        over += ['model.params.qat', 'weights']
    if case == 'dual':
        over += ['model.depth_net.use_dual_head', True,
                 'model.loss.supervised_loss_weight', 1.0]
    cfg = parse_train_config(OVERFIT, over)
    log = Recorder()
    first = {}
    real = trainer_mod.validate_multi

    def validate_multi(config, model, loaders):
        out = real(config, model, loaders)
        log.events.append(('validate', None))
        first.setdefault('metrics', out)
        return out

    monkeypatch.setattr(trainer_mod, 'validate_multi', validate_multi)
    tr = Trainer(cfg, logger=log, device='cpu')
    setup = tr.setup

    def watched_setup(n):
        setup(n)
        step = tr.train_step

        def recorded(*args):
            log.events.append(('step', None))
            return step(*args)
        tr.train_step = recorded

    tr.setup = watched_setup
    tr.fit()
    n = len(make_loader(cfg, 'train'))
    images = [] if case == 'dual' else [('images', 0)] * 2
    assert log.events == [('validate', None)] + [('step', None)] * n + [
        ('validate', None), ('metrics', 0)] + images

    # the first validation scored the initial weights
    init = seeded_model(cfg, int(cfg.arch.seed))
    val = [(p, ld) for p, ld in trainer_mod.make_val_loaders(cfg)]
    want = evaluate(cfg, init, val[0][1])
    assert sorted(first['metrics']) == sorted(want)
    for k in want:
        np.testing.assert_allclose(first['metrics'][k], want[k], rtol=1e-6,
                                   err_msg=k)

    if case == 'dual':
        assert log.images == []
        return
    batch = next(iter(val[0][1]))
    (n_rgb, rgb, s0), (n_inv, inv, s1) = log.images
    assert (n_rgb, n_inv, s0, s1) == ('val/rgb', 'val/inv_depth', 0, 0)
    np.testing.assert_array_equal(rgb, np.asarray(batch['rgb'])[:4])
    dev = to_device_batch(batch, tr.device)
    for int8 in (False, True):
        sig = make_eval_step(tr.model, int8)(dev)['inv_depths'][0][:4]
        viz = np.stack([viz_inv_depth(s[..., 0])
                        for s in sig.float().numpy()])
        if int8 == (case == 'qat_weights'):
            np.testing.assert_array_equal(inv, viz)
        else:
            assert not np.array_equal(inv, viz)


def test_indoor_dual_head_yaml_steps():
    run = port_train.main(INDOOR, device='cpu', n_steps=1, n_batches=1,
                          seed=0, overrides=[
                              'tpu.compute_dtype', 'float32',
                              'datasets.augmentation.image_shape', (32, 64),
                              'datasets.train.batch_size', 2,
                              'model.params.qat', 'weights+outputs'])
    assert run['model'].depth_net.use_dual_head
    assert run['model'].qat_outputs
    assert run['trainer'].optimizer.count == 1
    assert np.all(np.isfinite(run['losses']))
