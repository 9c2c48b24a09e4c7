"""The port's train transforms and on-card colour jitter against the JAX
package's, on the CPU: the train crop, resize_sample (intrinsics,
distortion_coeffs, depth kept sparse), duplicate_sample, the host jitter
with hue given the same np.random.RandomState, the whole train pipeline,
TrainTransform's per-sample generator keyed by (seed, dataset, epoch,
index), ops/augment.py's `_adjust` / `_hue_rotate` on the same factors and
the untouched originals, and the advanced augmentations' configuration.

Tolerances: host transforms are the same numpy arithmetic, held at atol
1e-6 (measured exact); the jitter on tensors at atol 1e-6 (float32 in
another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from packnet_sfm_tpu.datasets import transforms as jtr
from packnet_sfm_tpu.ops import augment as jaug
from packnet_sfm_tpu_torch.config import parse_train_config
from packnet_sfm_tpu_torch.datasets import transforms as ttr
from packnet_sfm_tpu_torch.datasets.loader import (
    DataLoader, prefetch_to_device)
from packnet_sfm_tpu_torch.ops import augment as taug
from packnet_sfm_tpu_torch.trainers.trainer import make_loader
from tests.torch_fixtures import CONFIG

JITTER = (0.2, 0.2, 0.2, 0.05)


def _sample(seed=0, H=40, W=56, contexts=2):
    rng = np.random.RandomState(seed)
    depth = (rng.rand(H, W, 1) * 10 * (rng.rand(H, W, 1) < 0.3))
    s = {'idx': seed,
         'rgb': rng.rand(H, W, 3).astype(np.float32),
         'depth': depth.astype(np.float32),
         'input_depth': (depth * (rng.rand(H, W, 1) < 0.5)).astype(
             np.float32),
         'mask': (rng.rand(H, W, 1) > 0.3).astype(np.float32),
         'intrinsics': np.array([[50., 0, 27.5], [0, 48., 19.5], [0, 0, 1]],
                                np.float32),
         'distortion_coeffs': {'k': np.arange(7, dtype=np.float32),
                               'ux': np.float32(30.), 'uy': np.float32(20.)}}
    if contexts:
        s['rgb_context'] = [rng.rand(H, W, 3).astype(np.float32)
                            for _ in range(contexts)]
    return s


def _copy(sample):
    return {k: (dict(v) if isinstance(v, dict) else
                [x.copy() for x in v] if isinstance(v, list) else
                v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in sample.items()}


def _same(got, want, atol=1e-6):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _same(got[k], want[k], atol)
        elif isinstance(want[k], list):
            for a, b in zip(got[k], want[k], strict=True):
                np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                           err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize('borders', [(), (4, -4, 2, -6), (-8, 6)])
def test_crop_resize_duplicate_match_jax(borders):
    s = _sample()
    if borders:
        box = ttr.parse_crop_borders(borders, s['rgb'].shape[:2])
        assert box == jtr.parse_crop_borders(borders, s['rgb'].shape[:2])
        _same(ttr.crop_sample(_copy(s), box), jtr.crop_sample(_copy(s), box))
    got = ttr.resize_sample(_copy(s), (24, 32))
    want = jtr.resize_sample(_copy(s), (24, 32))
    _same(got, want)
    # the intrinsics and the principal point scale with the image; depth
    # stays sparse and keeps its values
    np.testing.assert_allclose(got['intrinsics'][0], [50 * 32 / 56, 0,
                                                      27.5 * 32 / 56])
    assert got['distortion_coeffs']['uy'] == np.float32(20.) * (24 / 40)
    kept = got['depth'][got['depth'] > 0]
    assert set(kept.tolist()) <= set(s['depth'][s['depth'] > 0].tolist())
    dup = ttr.duplicate_sample(_copy(got))
    _same(dup, jtr.duplicate_sample(_copy(got)))
    assert dup['rgb_original'] is not dup['rgb']


@pytest.mark.parametrize('jitter', [JITTER, (0.4, 0.1, 0.3, 0.0)])
def test_colorjitter_with_hue_matches_jax_on_one_generator(jitter):
    s = _sample(1)
    got = ttr.colorjitter_sample(_copy(s), jitter, np.random.RandomState(7))
    want = jtr.colorjitter_sample(_copy(s), jitter, np.random.RandomState(7))
    _same(got, want)
    assert not np.allclose(got['rgb'], s['rgb'])
    # one set of factors: a context equal to the target jitters equally
    s['rgb_context'][0] = s['rgb'].copy()
    out = ttr.colorjitter_sample(_copy(s), jitter, np.random.RandomState(3))
    np.testing.assert_array_equal(out['rgb_context'][0], out['rgb'])
    with pytest.raises(ValueError, match='RandomState'):
        ttr.train_transforms(_copy(s), jittering=jitter)


def test_train_pipeline_and_keyed_generator_match_jax():
    s = _sample(2)
    args = ((24, 32), JITTER, (2, -2, 4, -4))
    got = ttr.train_transforms(_copy(s), *args, rng=np.random.RandomState(5))
    want = jtr.train_transforms(_copy(s), *args, rng=np.random.RandomState(5))
    _same(got, want)
    # originals un-jittered: the resized images
    resized = jtr.resize_sample(jtr.crop_sample(
        _copy(s), jtr.parse_crop_borders(args[2], (40, 56))), (24, 32))
    np.testing.assert_array_equal(got['rgb_original'], resized['rgb'])
    # TrainTransform: the generator of sample idx in epoch e
    t = ttr.TrainTransform(*args, seed=42, dataset=1)
    t.set_epoch(3)
    _same(t(_copy(s)), jtr.train_transforms(
        _copy(s), *args, rng=np.random.RandomState([42, 1, 3, s['idx']])))
    again = t(_copy(s))
    _same(again, t(_copy(s)))                 # replayed, whatever the order
    t.set_epoch(4)
    assert not np.allclose(t(_copy(s))['rgb'], again['rgb'])


def test_device_jitter_matches_jax_on_the_same_factors():
    rng = np.random.RandomState(0)
    img = rng.rand(3, 8, 10, 3).astype(np.float32)
    fb, fc, fs = (rng.uniform(0.7, 1.3, (3, 1, 1, 1)).astype(np.float32)
                  for _ in range(3))
    fh = rng.uniform(-0.3, 0.3, (3, 1, 1, 1)).astype(np.float32)
    t = torch.from_numpy
    adj = taug._adjust(t(img), t(fb), t(fc), t(fs))
    np.testing.assert_allclose(adj.numpy(), np.asarray(jaug._adjust(
        jnp.asarray(img), fb, fc, fs)), rtol=0, atol=1e-6)
    hue = taug._hue_rotate(adj, t(fh))
    np.testing.assert_allclose(hue.numpy(), np.asarray(jaug._hue_rotate(
        jnp.asarray(adj.numpy()), fh)), rtol=0, atol=1e-6)


def test_device_jitter_keeps_originals_and_replays_its_factors():
    rng = np.random.RandomState(1)
    batch = {'rgb': torch.from_numpy(rng.rand(4, 6, 8, 3).astype(np.float32)),
             'rgb_context': [torch.from_numpy(rng.rand(4, 6, 8, 3).astype(
                 np.float32))]}
    before = {'rgb': batch['rgb'].clone(),
              'ctx': batch['rgb_context'][0].clone()}
    out = taug.device_color_jitter(batch, JITTER,
                                   torch.Generator().manual_seed(3))
    assert torch.equal(out['rgb_original'], before['rgb'])
    assert torch.equal(out['rgb_context_original'][0], before['ctx'])
    assert torch.equal(batch['rgb'], before['rgb'])        # input untouched
    assert not torch.allclose(out['rgb'], before['rgb'])
    again = taug.device_color_jitter(batch, JITTER,
                                     torch.Generator().manual_seed(3))
    assert torch.equal(again['rgb'], out['rgb'])
    # the factors: brightness, contrast, saturation in [0.8, 1.2], hue in
    # [-0.05, 0.05], one per sample
    f = taug.jitter_factors(1000, JITTER, torch.Generator().manual_seed(0))
    for x, (lo, hi) in zip(f, [(0.8, 1.2)] * 3 + [(-0.05, 0.05)]):
        assert x.shape == (1000, 1, 1, 1)
        assert lo <= float(x.min()) and float(x.max()) <= hi
        assert float(x.max()) - float(x.min()) > 0.9 * (hi - lo)
    # an image equal to the target takes the target's factors
    batch['rgb_context'][0] = batch['rgb']
    out = taug.device_color_jitter(batch, JITTER,
                                   torch.Generator().manual_seed(4))
    assert torch.equal(out['rgb_context'][0], out['rgb'])


def test_prefetch_on_the_cpu_moves_batches_in_order():
    class Items:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return {'idx': i, 'rgb': np.full((2, 2, 3), i, np.float32)}

    loader = DataLoader(Items(), batch_size=2, shuffle=False,
                        num_workers=2)
    got = list(prefetch_to_device(iter(loader), 'cpu', size=2))
    assert [b['rgb'][:, 0, 0, 0].tolist() for b in got] == [
        [0, 1], [2, 3], [4, 5]]
    assert all('idx' not in b and isinstance(b['rgb'], torch.Tensor)
               for b in got)


def test_refusals_name_the_roadmap(tmp_path):
    """What this test once found refused is ported: RandAugment and random
    erasing build into the train transform (and the train split:
    tests/test_torch_datasets.py), mixup and
    cutmix into the train loader's batch augmentation (their values against
    JAX: tests/test_torch_advanced_aug.py)."""
    from packnet_sfm_tpu_torch.datasets import augmentations_advanced as adv
    cfg = parse_train_config(CONFIG)
    for name, kind in (('randaugment', adv.RandAugment),
                       ('random_erasing', adv.RandomErasing)):
        aug = cfg.datasets.augmentation.clone()
        aug[name].enabled = True
        t = ttr.get_transforms('train', augmentation=aug)
        assert [type(a) for a in t.advanced] == [kind]
    for name in ('mixup', 'cutmix'):
        c = parse_train_config(CONFIG, [
            'datasets.augmentation.{}.enabled'.format(name), True,
            'datasets.train.dataset', ['Synthetic'],
            'datasets.train.split', ['4']])
        assert make_loader(c, 'train').batch_augment is not None
