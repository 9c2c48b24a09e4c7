"""The port's advanced augmentations and sample cache
(packnet_sfm_tpu_torch/datasets/augmentations_advanced.py, cache.py, the
train transform's hook and the loader's batch augmentation) against the JAX
package's, on the CPU, given the same np.random.RandomState:

- each RandAugment op, RandAugment, RandomErasing, mixup and cutmix;
- the train pipeline with RandAugment and random erasing after the jitter,
  drawn from TrainTransform's key (seed, dataset, epoch, index);
- mixup and cutmix on the train loader's batches, each drawn from the
  RandomState of (seed, epoch, batch index): a mid-epoch resume replays
  them; mixup on a multi-camera batch permutes over B in both packages, and
  cutmix raises on one (JAX from its shape unpacking);
- SampleCache 'ram' and 'disk' replay the uncached dataset, a disk file
  written by either package is read by the other, a partial write is
  decoded again, and make_loader refuses the cache on a train split whose
  transform is random on the host, as `validate_transform` says in both.

Tolerance: none, bit-equal (the same numpy arithmetic on the same draws).
"""

import copy

import numpy as np
import pytest

from packnet_sfm_tpu.datasets import augmentations_advanced as jadv
from packnet_sfm_tpu.datasets import transforms as jtr
from packnet_sfm_tpu.datasets.cache import SampleCache as JCache
from packnet_sfm_tpu.datasets.synthetic import SyntheticDataset as JSynth
from packnet_sfm_tpu_torch.config import parse_train_config
from packnet_sfm_tpu_torch.datasets import augmentations_advanced as tadv
from packnet_sfm_tpu_torch.datasets import transforms as ttr
from packnet_sfm_tpu_torch.datasets.cache import SampleCache
from packnet_sfm_tpu_torch.datasets.loader import DataLoader
from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticDataset
from packnet_sfm_tpu_torch.trainers.trainer import make_loader
from tests.test_torch_datasets import assert_same
from tests.torch_fixtures import CONFIG

JITTER = (0.2, 0.2, 0.2, 0.05)


def _image(seed, H=24, W=40):
    return np.random.RandomState(seed).rand(H, W, 3).astype(np.float32)


def _batch(seed, B=4, H=16, W=20, cameras=0):
    rng = np.random.RandomState(seed)
    lead = (B, cameras) if cameras else (B,)
    rgb = rng.rand(*lead, H, W, 3).astype(np.float32)
    depth = (rng.rand(*lead, H, W, 1) * 10 *
             (rng.rand(*lead, H, W, 1) < 0.3)).astype(np.float32)
    return {'rgb': rgb, 'rgb_original': rgb.copy(), 'depth': depth,
            'input_depth': depth * 0.5,
            'rgb_context': [rng.rand(*lead, H, W, 3).astype(np.float32)]}


@pytest.mark.parametrize('op', range(len(jadv.RANDAUGMENT_OPS)))
def test_randaugment_ops_match_jax(op):
    name, jfn = jadv.RANDAUGMENT_OPS[op]
    tname, tfn = tadv.RANDAUGMENT_OPS[op]
    assert tname == name
    img = _image(op)
    for m in (0.1, 0.5, 0.9):
        got = tfn(img.copy(), m)
        assert got.dtype == np.float32, name
        np.testing.assert_array_equal(got, jfn(img.copy(), m), err_msg=name)


@pytest.mark.parametrize('seed', range(4))
def test_randaugment_and_random_erasing_match_jax_on_one_generator(seed):
    img = _image(10 + seed)
    for t_aug, j_aug in (
            (tadv.RandAugment(9, 0.5, 0.7), jadv.RandAugment(9, 0.5, 0.7)),
            (tadv.RandAugment(2, 0.3, 1.0), jadv.RandAugment(2, 0.3, 1.0)),
            (tadv.RandomErasing(0.8, 0.02, 0.4, 0.3),
             jadv.RandomErasing(0.8, 0.02, 0.4, 0.3)),
            (tadv.RandomErasing(1.0, 0.5, 0.99, 0.3),   # may find no fit
             jadv.RandomErasing(1.0, 0.5, 0.99, 0.3))):
        rs_t, rs_j = (np.random.RandomState(seed) for _ in range(2))
        for _ in range(3):
            got, want = t_aug(img, rs_t), j_aug(img, rs_j)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        # the same draws consumed
        assert rs_t.rand() == rs_j.rand()


def test_train_pipeline_with_advanced_augmentations_matches_jax():
    """TrainTransform(jitter, RandAugment, random erasing): the draws of
    sample idx in epoch e come from RandomState([seed, dataset, e, idx]),
    the jitter's first; JAX's train_transforms handed that generator
    computes the same. Only 'rgb' is augmented."""
    aug = parse_train_config(CONFIG).datasets.augmentation.clone()
    aug.randaugment.enabled = True
    aug.randaugment.prob = 1.0
    aug.random_erasing.enabled = True
    aug.random_erasing.probability = 1.0
    t = ttr.get_transforms('train', (16, 24), JITTER, augmentation=aug,
                           seed=3, dataset=1)
    rng = np.random.RandomState(0)
    for epoch, idx in ((0, 0), (0, 5), (2, 5)):
        sample = {'idx': idx, 'rgb': rng.rand(20, 30, 3).astype(np.float32),
                  'rgb_context': [rng.rand(20, 30, 3).astype(np.float32)],
                  'intrinsics': np.eye(3, dtype=np.float32) * 30}
        t.set_epoch(epoch)
        got = t(copy.deepcopy(sample))
        want = jtr.train_transforms(
            copy.deepcopy(sample), (16, 24), JITTER,
            rng=np.random.RandomState([3, 1, epoch, idx]),
            advanced=[jadv.RandAugment(9, 0.5, 1.0),
                      jadv.RandomErasing(1.0, 0.02, 0.4, 0.3,
                                         (0.485, 0.456, 0.406))])
        assert_same(got, want, str((epoch, idx)))
        assert not np.array_equal(got['rgb_context'][0], got['rgb'])


def test_train_pipeline_needs_a_generator_for_the_augmentations():
    sample = {'idx': 0, 'rgb': _image(0)}
    with pytest.raises(ValueError, match='RandomState'):
        ttr.train_transforms(sample, advanced=[tadv.RandAugment()])


@pytest.mark.parametrize('seed', range(3))
@pytest.mark.parametrize('cameras', [0, 2], ids=['B4', 'B4xN2'])
def test_mixup_matches_jax_and_permutes_over_b(seed, cameras):
    got = tadv.mixup_batch(_batch(seed, cameras=cameras), 0.4, 1.0,
                           np.random.RandomState(seed))
    want = jadv.mixup_batch(_batch(seed, cameras=cameras), 0.4, 1.0,
                            np.random.RandomState(seed))
    assert_same(got, want)
    assert got['rgb'].shape == _batch(seed, cameras=cameras)['rgb'].shape
    # depth and the contexts are not mixed
    np.testing.assert_array_equal(got['depth'],
                                  _batch(seed, cameras=cameras)['depth'])
    skipped = tadv.mixup_batch(_batch(seed), 0.4, 0.0,
                               np.random.RandomState(seed))
    assert_same(skipped, _batch(seed))


@pytest.mark.parametrize('seed', range(3))
def test_cutmix_matches_jax(seed):
    got = tadv.cutmix_batch(_batch(seed), 1.0, 1.0,
                            np.random.RandomState(seed))
    want = jadv.cutmix_batch(_batch(seed), 1.0, 1.0,
                             np.random.RandomState(seed))
    assert_same(got, want)


def test_cutmix_raises_on_a_multi_camera_batch():
    """JAX unpacks B, H, W, _ from rgb and fails on [B,N,H,W,3] once the
    draw picks the batch; the port raises naming the cause, whatever the
    draw."""
    with pytest.raises(ValueError):
        jadv.cutmix_batch(_batch(0, cameras=2), 1.0, 1.0,
                          np.random.RandomState(0))
    for prob in (1.0, 0.0):
        with pytest.raises(ValueError, match='multi-camera'):
            tadv.cutmix_batch(_batch(0, cameras=2), 1.0, prob,
                              np.random.RandomState(0))


class _Frames:
    """Tiny dataset of distinct frames (sample i filled with i / 10)."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return {'idx': i, 'rgb': np.full((6, 8, 3), i / 10, np.float32),
                'depth': np.full((6, 8, 1), i + 1.0, np.float32)}


def test_batch_augment_is_keyed_and_resumes_exactly():
    aug = {'mixup': {'enabled': True, 'alpha': 0.4, 'prob': 0.7},
           'cutmix': {'enabled': True, 'alpha': 1.0, 'prob': 0.7}}
    loader = DataLoader(_Frames(), 2, shuffle=True, seed=5, num_workers=2,
                        batch_augment=tadv.make_batch_augment(aug))
    loader.set_epoch(1)
    full = list(loader)
    plain = DataLoader(_Frames(), 2, shuffle=True, seed=5, num_workers=2)
    plain.set_epoch(1)
    for b, (batch, raw) in enumerate(zip(full, plain)):
        rs = np.random.RandomState([5, 1, b])
        want = jadv.cutmix_batch(jadv.mixup_batch(raw, 0.4, 0.7, rs), 1.0,
                                 0.7, rs)
        assert_same(batch, want, str(b))
    assert any(not np.array_equal(a['rgb'], b['rgb'])
               for a, b in zip(full, plain))
    loader.load_state_dict({'epoch': 1, 'batches_consumed': 2})
    for batch, want in zip(loader, full[2:]):
        assert_same(batch, want)
    assert tadv.make_batch_augment({'mixup': {'enabled': False}}) is None


def _cache_config(extra=()):
    return parse_train_config(CONFIG, [
        'datasets.train.dataset', ['Synthetic'], 'datasets.train.split',
        ['4'], 'datasets.train.cache', 'ram'] + list(extra))


@pytest.mark.parametrize('mode', ['ram', 'disk'])
def test_sample_cache_replays_the_dataset(tmp_path, mode):
    ds = SyntheticDataset(num_samples=3, height=8, width=12)
    cache = SampleCache(ds, mode, str(tmp_path / 'c'))
    first = [cache[i] for i in range(3)]
    for i in range(3):
        assert_same(first[i], ds[i])
        assert_same(cache[i], ds[i])
    if mode == 'disk':
        # another process's cache over the same files, and JAX's: the files
        # serve every sample
        for other in (SampleCache(None, 'disk', str(tmp_path / 'c')),
                      JCache(JSynth(num_samples=3, height=8, width=12),
                             'disk', str(tmp_path / 'c'))):
            for i in range(3):
                assert_same(other[i], ds[i])
        with open(tmp_path / 'c' / '1.npy', 'wb') as f:
            f.write(b'\x93NUMPY\x01\x00')    # a partial write
        assert_same(cache[1], ds[1])
    else:
        assert cache[0] is first[0]
    with pytest.raises(ValueError):
        SampleCache(ds, 'gpu')


@pytest.mark.parametrize('jitter,device_augment,advanced,safe', [
    (JITTER, False, None, False), (JITTER, True, None, True),
    ((), False, None, True), ((), True, 'randaugment', False),
    ((), False, 'random_erasing', False)])
def test_train_cache_refused_when_the_host_transform_is_random(
        capsys, jitter, device_augment, advanced, safe):
    extra = ['datasets.augmentation.jittering', jitter,
             'tpu.device_augment', device_augment]
    if advanced:
        extra += ['datasets.augmentation.{}.enabled'.format(advanced), True]
    cfg = _cache_config(extra)
    aug = cfg.datasets.augmentation
    assert SampleCache.validate_transform(aug, device_augment) == safe
    assert JCache.validate_transform(aug, device_augment) == safe
    loader = make_loader(cfg, 'train')
    assert isinstance(loader.dataset, SampleCache) == safe
    assert ('[cache] disabled' in capsys.readouterr().out) == (not safe)
