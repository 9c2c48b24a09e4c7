"""The port's datasets and loader (packnet_sfm_tpu_torch/datasets) against
the JAX package's, on the NCDB fixture tree of tests/test_datasets.py and
on the synthetic dataset: the same keys, bit-equal arrays, the same batches
in the same order. Also the NCDB divide-by-256 quirk, the loader's resume
and failure handling, `to_device_batch` with its camera fold, and
`setup_dataset`'s dispatch.

Tolerance: none, bit-equal (the same numpy and Pillow operations).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from packnet_sfm_tpu.datasets import setup_dataset as j_setup_dataset
from packnet_sfm_tpu.datasets.concat import ConcatDataset as JConcat
from packnet_sfm_tpu.datasets.loader import DataLoader as JLoader
from packnet_sfm_tpu.datasets.ncdb import NcdbDataset as JNcdb
from packnet_sfm_tpu.datasets.synthetic import SyntheticDataset as JSynth
from packnet_sfm_tpu_torch.config import parse_train_config
from packnet_sfm_tpu_torch.datasets import setup_dataset
from packnet_sfm_tpu_torch.datasets.concat import ConcatDataset
from packnet_sfm_tpu_torch.datasets.loader import DataLoader, to_device_batch
from packnet_sfm_tpu_torch.datasets.ncdb import NcdbDataset, load_depth_png
from packnet_sfm_tpu_torch.datasets.synthetic import SyntheticDataset
from tests.test_datasets import make_ncdb_tree
from tests.torch_fixtures import CONFIG


def assert_same(got, want, where=''):
    """Nested dicts / lists / arrays equal, keys and dtypes included."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], '{}.{}'.format(where, k))
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, '{}[{}]'.format(where, i))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.fixture(scope='module')
def ncdb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ncdb'))
    make_ncdb_tree(root)
    sd = os.path.join(root, 'synced_data')
    # a global mask at another size than the frames, and LiDAR-like input
    # depth beside the GT folder
    mask = np.zeros((16, 24), np.uint8)
    mask[4:, 2:] = 255
    Image.fromarray(mask).save(os.path.join(root, 'mask.png'))
    os.makedirs(os.path.join(sd, 'newest_depth_maps'))
    rng = np.random.RandomState(5)
    for i in range(3):
        d = (rng.rand(32, 48) * 12 * 256 * (rng.rand(32, 48) < 0.2)
             ).astype(np.uint16)
        Image.fromarray(d).save(os.path.join(
            sd, 'newest_depth_maps', 'frame_{:04d}.png'.format(i)))
    return root


@pytest.mark.parametrize('kw', [
    dict(depth_type='depth_original', min_depth=0.5, max_depth=15.0),
    dict(depth_type='depth_original', input_depth_type='depth',
         mask_file='mask.png', use_mask=True),
    dict(input_depth_type='depth', mask_file='mask.png')],
    ids=['clip', 'mask', 'default'])
def test_ncdb_samples_match_jax(ncdb_root, kw):
    got_ds = NcdbDataset(ncdb_root, 'split.json', **kw)
    want_ds = JNcdb(ncdb_root, 'split.json', **kw)
    assert len(got_ds) == len(want_ds) == 3
    for i in range(3):
        assert_same(got_ds[i], want_ds[i], 'sample {}'.format(i))


def test_ncdb_depth_divides_by_256_only_above_255(tmp_path):
    path = str(tmp_path / 'd.png')
    small = np.array([[0, 7, 255]], np.uint16)
    Image.fromarray(small).save(path)
    np.testing.assert_array_equal(load_depth_png(path), [[0.0, 7.0, 255.0]])
    Image.fromarray(np.array([[0, 256, 512]], np.uint16)).save(path)
    np.testing.assert_array_equal(load_depth_png(path), [[0.0, 1.0, 2.0]])


def test_synthetic_samples_match_jax():
    kw = dict(num_samples=3, height=16, width=24, with_input_depth=True)
    got, want = SyntheticDataset(**kw), JSynth(**kw)
    for i in range(3):
        assert_same(got[i], want[i], 'sample {}'.format(i))


@pytest.mark.parametrize('shuffle', [False, True])
def test_loader_batches_and_order_match_jax(ncdb_root, shuffle):
    ds = [NcdbDataset(ncdb_root, 'split.json', input_depth_type='depth'),
          SyntheticDataset(num_samples=2, height=32, width=48)]
    jds = [JNcdb(ncdb_root, 'split.json', input_depth_type='depth'),
           JSynth(num_samples=2, height=32, width=48)]
    ncdb = (DataLoader(ds[0], 2, shuffle=shuffle, seed=3, drop_last=False),
            JLoader(jds[0], 2, shuffle=shuffle, seed=3, drop_last=False))
    concat = (DataLoader(ConcatDataset(ds[1:], [2]), 2, shuffle=shuffle,
                         seed=3),
              JLoader(JConcat(jds[1:], [2]), 2, shuffle=shuffle, seed=3))
    for got_loader, want_loader in (ncdb, concat):
        for epoch in (0, 1):
            got_loader.set_epoch(epoch)
            want_loader.set_epoch(epoch)
            got, want = list(got_loader), list(want_loader)
            assert len(got) == len(want) == len(got_loader) == \
                len(want_loader)
            assert_same(got, want, 'epoch {}'.format(epoch))


def test_loader_resumes_and_hands_on_failures():
    class Flaky:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 2:
                raise OSError('truncated file')
            return {'x': np.full(2, i, np.float32)}

    loader = DataLoader(Flaky(), 2, num_workers=2)
    it = iter(loader)
    assert next(it)['x'][:, 0].tolist() == [0, 1]
    with pytest.raises(OSError, match='truncated'):
        next(it)
    assert next(it)['x'][:, 0].tolist() == [4, 5]
    assert list(it) == [] and list(it) == []
    shuffled = DataLoader(SyntheticDataset(num_samples=6, height=8, width=8,
                                           back_context=0, forward_context=0),
                          2, shuffle=True, seed=1)
    shuffled.set_epoch(2)
    full = [b['idx'].tolist() for b in shuffled]
    state = {'epoch': 2, 'batches_consumed': 1}
    shuffled.load_state_dict(state)
    rest = iter(shuffled)
    assert [b['idx'].tolist() for b in rest] == full[1:]
    assert shuffled.state_dict() == {'epoch': 2, 'batches_consumed': 3}


def test_to_device_batch_drops_host_keys_and_refuses_multicam():
    batch = {'idx': np.arange(2), 'filename': ['a', 'b'],
             'rgb': np.zeros((2, 4, 4, 3), np.float32),
             'rgb_context': [np.ones((2, 4, 4, 3), np.float32)],
             'distortion_coeffs': {'k': np.zeros((2, 7), np.float32)},
             'tag': 'x'}
    dev = to_device_batch(batch, torch.device('cpu'))
    assert sorted(dev) == ['distortion_coeffs', 'rgb', 'rgb_context', 'tag']
    assert isinstance(dev['rgb_context'][0], torch.Tensor)
    assert isinstance(dev['distortion_coeffs']['k'], torch.Tensor)
    assert dev['tag'] == 'x'
    # a multi-camera batch has its cameras folded into the batch axis
    # (against JAX's fold: tests/test_torch_image_dgp.py)
    multi = to_device_batch({'rgb': np.zeros((2, 3, 4, 4, 3)),
                             'pose': np.zeros((2, 3, 4, 4)),
                             'rgb_context': [np.zeros((2, 3, 4, 4, 3))],
                             'sensor_name': 'cam', 'scale': np.ones(2)},
                            'cpu')
    assert sorted(multi) == ['pose', 'rgb', 'rgb_context', 'scale']
    assert multi['rgb'].shape == (6, 4, 4, 3)
    assert multi['pose'].shape == (6, 4, 4)
    assert multi['rgb_context'][0].shape == (6, 4, 4, 3)
    assert multi['scale'].shape == (2,)


def test_setup_dataset_matches_jax_and_refuses_unported(ncdb_root):
    cfg = parse_train_config(CONFIG, [
        'datasets.test.path', [ncdb_root], 'datasets.test.split',
        ['split.json'], 'datasets.test.input_depth_type', ['depth'],
        'datasets.augmentation.image_shape', (16, 24)])
    got = setup_dataset(cfg.datasets.test, cfg.datasets.augmentation, 'test')
    want = j_setup_dataset(cfg.datasets.test, cfg.datasets.augmentation,
                           'test')
    assert len(got) == len(want) == 1
    assert_same(got[0][1], want[0][1])
    assert got[0][1]['rgb'].shape == (16, 24, 3)
    assert got[0][1]['depth'].shape == (32, 48, 1)   # GT stays full-size
    # KITTI, DGP and Image are ported (tests/test_torch_kitti_data.py,
    # test_torch_image_dgp.py): on this NCDB tree they find no scene and
    # the root's one image, as JAX's readers do
    for name, n in (('DGP', 0), ('Image', 1)):
        node = cfg.datasets.test.clone()
        node.dataset, node.split = [name], ['']
        (got,) = setup_dataset(node, cfg.datasets.augmentation, 'test')
        (want,) = j_setup_dataset(node, cfg.datasets.augmentation, 'test')
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want) == n
        for i in range(n):
            assert_same(got[i], want[i])
    # train mode builds the train transform; with the jitter off a train
    # sample equals the JAX package's
    aug = cfg.datasets.augmentation.clone()
    aug.jittering = ()
    got = setup_dataset(cfg.datasets.test, aug, 'train')
    want = j_setup_dataset(cfg.datasets.test, aug, 'train')
    assert_same(got[0][1], want[0][1])
    assert got[0][1]['depth'].shape == (16, 24, 1)   # train resizes GT too
    aug.random_erasing.enabled = True
    (ds,) = setup_dataset(cfg.datasets.test, aug, 'train')
    assert [type(a).__name__ for a in ds.transform.advanced] == [
        'RandomErasing']
