"""The port's KITTI reader (packnet_sfm_tpu_torch/datasets/kitti.py) against
the JAX package's KITTIDataset, on KITTI_raw trees written by the port's
`write_kitti_tree` and by tests/test_datasets.py `make_kitti_tree`:
images, intrinsics, groundtruth PNG and velodyne .npz depth, input depth,
contexts at stride 1 and 2, poses, the dropped samples, the eval
transforms at KITTI's 352x1216 crop, `setup_dataset`'s dispatch, the
split-list cache under KITTI_CACHE_DIR; the NCDB reader's environment
overrides; and one epoch of configs/overfit_kitti.yaml through the port's
Trainer.fit, as tests/test_kitti_e2e.py runs it for JAX.

Tolerance: none, bit-equal (the same numpy and Pillow operations), but
the poses: atol 1e-6 (float64 chains cast to float32).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from packnet_sfm_tpu.datasets import setup_dataset as j_setup_dataset
from packnet_sfm_tpu.datasets.kitti import KITTIDataset as JKITTI
from packnet_sfm_tpu.datasets.ncdb import NcdbDataset as JNcdb
from packnet_sfm_tpu.datasets.transforms import get_transforms as j_transforms
from packnet_sfm_tpu_torch.config import parse_train_config
from packnet_sfm_tpu_torch.datasets import setup_dataset
from packnet_sfm_tpu_torch.datasets.kitti import KITTIDataset, write_kitti_tree
from packnet_sfm_tpu_torch.datasets.ncdb import (
    NcdbDataset, resolve_depth_folder, write_ncdb_tree)
from packnet_sfm_tpu_torch.datasets.transforms import get_transforms
from packnet_sfm_tpu_torch.models.factory import setup_model
from packnet_sfm_tpu_torch.trainers.trainer import Trainer
from tests.test_datasets import make_kitti_tree
from tests.test_torch_datasets import assert_same
from tests.torch_fixtures import one_torch_thread  # noqa: F401

N_FRAMES = 8
CROP = (-352, 0, 0.5, 1216)


@pytest.fixture(scope='module')
def kitti_root(tmp_path_factory):
    """8 frames at 48x160, no depth files for the first and last frame."""
    root = str(tmp_path_factory.mktemp('kitti'))
    write_kitti_tree(root, (48, 160), N_FRAMES, depth_margin=1)
    return root


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    """Each test its own split-list cache: xdist workers share no files."""
    path = str(tmp_path / 'kitti_cache')
    monkeypatch.setenv('KITTI_CACHE_DIR', path)
    return path


def same_samples(got, want, pose_keys=('pose', 'pose_context')):
    assert len(got) == len(want) and got.paths == want.paths
    for i in range(len(want)):
        g, w = got[i], want[i]
        for key in pose_keys:
            if key in w:
                np.testing.assert_allclose(np.asarray(g.pop(key)),
                                           np.asarray(w.pop(key)),
                                           atol=1e-6, err_msg=key)
        assert_same(g, w, str(i))


@pytest.mark.parametrize('kw', [
    dict(depth_type='groundtruth', input_depth_type='velodyne',
         back_context=1, forward_context=1, with_pose=True),
    dict(depth_type='velodyne', back_context=2, forward_context=1,
         strides=(2,), with_pose=True),
    dict(depth_type='groundtruth'),
    dict(input_depth_type='velodyne', back_context=1)],
    ids=['gt-lidar-ctx-pose', 'lidar-stride2-pose', 'gt', 'lidar-input'])
def test_reader_matches_jax(kitti_root, kw):
    got = KITTIDataset(kitti_root, 'split.txt', **kw)
    want = JKITTI(kitti_root, 'split.txt', **kw)
    same_samples(got, want)
    s = got[0]
    assert s['rgb'].shape == (48, 160, 3) and s['intrinsics'].shape == (3, 3)
    assert s['intrinsics'][0, 0] == np.float32(721.5377)
    n_ctx = kw.get('back_context', 0) + kw.get('forward_context', 0)
    assert len(s.get('rgb_context', [])) == n_ctx


def test_reader_drops_samples_and_reads_both_depth_files(kitti_root):
    """Frames 0 and 7 have no depth files; with stride 2 and one context
    each way frames 1 and 6 lose a context too."""
    def frames(ds):
        return [int(os.path.basename(p)[:-4]) for p in ds.paths]
    assert frames(KITTIDataset(kitti_root, 'split.txt')) == list(range(8))
    assert frames(KITTIDataset(kitti_root, 'split.txt',
                               depth_type='groundtruth')) == list(range(1, 7))
    assert frames(KITTIDataset(kitti_root, 'split.txt', back_context=1,
                               forward_context=1, strides=(2,))) == \
        list(range(2, 6))
    s = KITTIDataset(kitti_root, 'split.txt', depth_type='groundtruth',
                     input_depth_type='velodyne')[0]
    gt, lidar = s['depth'][..., 0], s['input_depth'][..., 0]
    assert gt.dtype == lidar.dtype == np.float32
    # the 16-bit PNG / 256 and the .npz under 'velodyne_depth'
    assert np.all(gt * 256 == np.round(gt * 256))
    assert 0 < (lidar > 0).mean() < (gt > 0).mean()
    assert not (gt[:int(48 * 0.35)] > 0).any()


def test_reader_matches_jax_on_make_kitti_tree(tmp_path):
    """The JAX package's own fixture tree (first-column split, identity
    calibration, tiny motion)."""
    root = make_kitti_tree(str(tmp_path))
    kw = dict(depth_type='groundtruth', back_context=1, forward_context=1,
              with_pose=True)
    same_samples(KITTIDataset(root, 'split.txt', **kw),
                 JKITTI(root, 'split.txt', **kw))


def test_eval_transforms_at_the_352x1216_crop(tmp_path):
    """Both packages' validation and test transforms with the KITTI YAMLs'
    crop_eval_borders on KITTI's raw 375x1242: the inputs cropped to
    352x1216 (rows from the bottom, columns centred), the GT kept whole,
    the principal point moved."""
    root = str(tmp_path / 'big')
    write_kitti_tree(root, (375, 1242), 3)
    kw = dict(depth_type='groundtruth', input_depth_type='velodyne')
    for mode in ('validation', 'test'):
        got = KITTIDataset(root, 'split.txt', transform=get_transforms(
            mode, crop_eval_borders=CROP), **kw)
        want = JKITTI(root, 'split.txt', transform=j_transforms(
            mode, crop_eval_borders=CROP), **kw)
        same_samples(got, want)
        s = got[1]
        assert s['rgb'].shape == (352, 1216, 3)
        assert s['input_depth'].shape == (352, 1216, 1)
        assert s['depth'].shape == (375, 1242, 1)
        raw = KITTIDataset(root, 'split.txt')[1]['intrinsics']
        np.testing.assert_array_equal(
            s['intrinsics'][:2, 2], raw[:2, 2] - np.float32([13, 23]))


def test_setup_dataset_dispatch_matches_jax(kitti_root):
    """train_kitti.yaml's train split through both packages' setup_dataset
    (the split's default back and forward context of 1), jitter off."""
    cfg = parse_train_config('configs/train_kitti.yaml', [
        'datasets.train.path', [kitti_root],
        'datasets.train.split', ['split.txt'],
        'datasets.augmentation.image_shape', (32, 64),
        'datasets.augmentation.jittering', ()])
    (got,) = setup_dataset(cfg.datasets.train, cfg.datasets.augmentation,
                           'train')
    (want,) = j_setup_dataset(cfg.datasets.train, cfg.datasets.augmentation,
                              'train')
    assert isinstance(got, KITTIDataset)
    assert (got.back_context, got.forward_context) == (1, 1)
    same_samples(got, want)
    s = got[0]
    assert s['rgb'].shape == (32, 64, 3) and len(s['rgb_context']) == 2
    assert 'depth' not in s and 'rgb_context_original' in s


def test_split_cache_under_kitti_cache_dir(kitti_root, cache_dir,
                                           monkeypatch, tmp_path):
    """The validated list is written under KITTI_CACHE_DIR and read back
    from there; '' turns the cache off. The key holds the stride, which the
    JAX reader's leaves out: with one cache, JAX at stride 2 returns the
    list it validated at stride 1."""
    ds = KITTIDataset(kitti_root, 'split.txt', back_context=1,
                      forward_context=1)
    (name,) = os.listdir(cache_dir)
    with open(os.path.join(cache_dir, name)) as f:
        assert json.load(f) == ds.paths
    with open(os.path.join(cache_dir, name), 'w') as f:
        json.dump(ds.paths[:2], f)
    assert KITTIDataset(kitti_root, 'split.txt', back_context=1,
                        forward_context=1).paths == ds.paths[:2]
    assert len(KITTIDataset(kitti_root, 'split.txt', back_context=1,
                            forward_context=1, strides=(2,))) == 4
    assert len(os.listdir(cache_dir)) == 2
    shared = str(tmp_path / 'jax_cache')
    monkeypatch.setenv('KITTI_CACHE_DIR', shared)
    JKITTI(kitti_root, 'split.txt', back_context=1, forward_context=1)
    assert len(JKITTI(kitti_root, 'split.txt', back_context=1,
                      forward_context=1, strides=(2,))) == 6
    monkeypatch.setenv('KITTI_CACHE_DIR', '')
    assert len(KITTIDataset(kitti_root, 'split.txt', back_context=1,
                            forward_context=1)) == 6
    assert len(os.listdir(cache_dir)) == 2 and len(os.listdir(shared)) == 1


@pytest.mark.parametrize('env', [
    {'NCDB_DEPTH_FOLDER': 'my_gt_maps'},
    {'NCDB_DEPTH_TYPE': 'depth'},
    {'NCDB_DEPTH_TYPE': 'depth', 'NCDB_DEPTH_FOLDER': 'my_gt_maps'}])
def test_ncdb_depth_overrides(tmp_path, monkeypatch, env):
    """NCDB_DEPTH_FOLDER names the GT folder over any type, NCDB_DEPTH_TYPE
    the type when the config gives none: as the JAX reader."""
    root = str(tmp_path / 'ncdb')
    write_ncdb_tree(root, (16, 24), 2)
    seq = os.path.join(root, 'seq')
    for folder, scale in (('my_gt_maps', 2.0),
                          (resolve_depth_folder('depth'), 3.0)):
        os.makedirs(os.path.join(seq, folder))
        for f in os.listdir(os.path.join(seq, 'newest_original_depth_maps')):
            src = np.asarray(Image.open(
                os.path.join(seq, 'newest_original_depth_maps', f)))
            Image.fromarray(
                (src * scale).clip(0, 65535).astype(np.uint16)).save(
                    os.path.join(seq, folder, f))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for depth_type in ('', 'depth_original'):
        got = NcdbDataset(root, 'split.json', depth_type=depth_type)
        want = JNcdb(root, 'split.json', depth_type=depth_type)
        assert got.depth_folder == want.depth_folder
        assert_same(got[1]['depth'], want[1]['depth'])
    folder = NcdbDataset(root, 'split.json').depth_folder
    assert folder == env.get('NCDB_DEPTH_FOLDER', 'newest_depth_maps')


@pytest.mark.parametrize('yaml', [
    'train_kitti', 'overfit_kitti', 'eval_resnet_san_kitti',
    'train_resnet_san_kitti', 'train_resnet_san_kitti_tiny'])
def test_kitti_yamls_build(kitti_root, yaml):
    """Each KITTI YAML's model and the datasets of each of its splits,
    pointed at the tree, build through the port's factory and
    setup_dataset."""
    cfg = parse_train_config('configs/{}.yaml'.format(yaml))
    assert setup_model(cfg) is not None
    built = 0
    for split in ('train', 'validation', 'test'):
        node = cfg.datasets[split]
        if not node.get('dataset'):
            continue
        node.path = [kitti_root] * len(node.path)
        node.split = ['split.txt'] * len(node.split)
        for ds in setup_dataset(node, cfg.datasets.augmentation, split):
            assert isinstance(ds, KITTIDataset) and len(ds) > 0
            built += 1
    assert built >= 1


@pytest.mark.usefixtures('one_torch_thread')
def test_overfit_kitti_fit_one_epoch(kitti_root):
    """configs/overfit_kitti.yaml (DepthResNet + PoseResNet '18pt' on
    random weights, velodyne GT) for one epoch over the tree through the
    port's Trainer.fit, then its validation."""
    cfg = parse_train_config('configs/overfit_kitti.yaml')
    for split in ('train', 'validation', 'test'):
        node = cfg.datasets[split]
        node.path = [kitti_root]
        node.split = ['split.txt']
        node.batch_size = 2
        node.num_workers = 1
    cfg.datasets.train.repeat = [1]     # the YAML's 1000
    cfg.datasets.augmentation.image_shape = (32, 64)
    cfg.tpu.compute_dtype = 'float32'
    cfg.checkpoint.filepath = ''
    cfg.arch.eval_during_training = False
    trainer = Trainer(cfg, device='cpu').fit()
    # 6 frames with depth and both contexts, B2
    assert trainer.step == trainer.optimizer.count == 3
    assert set(trainer.last_val_metrics) >= {'depth-abs_rel',
                                             'depth_gt-abs_rel'}
    assert np.isfinite(trainer.last_val_metrics['depth_gt-abs_rel'])
