"""The port's Image and DGP readers (packnet_sfm_tpu_torch/datasets/
image_dataset.py, dgp.py) and the multi-camera fold against the JAX
package's, on trees written by the port's `write_image_tree` and
`write_dgp_tree` (2 scenes x 4 samples, 2 cameras, 64x96):

- Image samples, their contexts clamped at both ends of the folder, from a
  glob and from a split file, and the factory's dispatch (no depth);
- DGP samples of one and of two cameras: rgb, K and depth bit-equal, the
  poses and 'pose_context' within atol 1e-6; the depth-map cache written by
  either package and read by the other; `project_lidar_to_depth`'s
  truncation toward zero and nearest-wins rule; the quaternion reader;
- `stack_sample` and the fold of a collated two-camera batch equal JAX's
  stack and its trainer's _host_prepare (fold_multicam_batch);
- one float32 step of configs/overfit_ddad.yaml's SelfSupModel (DepthResNet
  + PoseResNet '18pt') on that folded batch (B2 x 2 cameras) against the
  loss JAX's make_train_step differentiates, on variables drawn with numpy
  and carried by load_flax_variables: loss and metrics rtol 1e-5, each
  gradient leaf |g - g_jax| <= 2e-2 |g_jax| + 1e-8 in the Frobenius norm
  and the BatchNorm statistics per leaf atol 1e-5 x max|leaf|, the limits
  of tests/test_torch_depth_resnet.py;
- overfit_ddad.yaml through train.fit and eval.py --checkpoint on the tree.

Tolerance otherwise: none, bit-equal (the same numpy and Pillow
operations).
"""

import os
import shutil

import jax
import numpy as np
import pytest

from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.datasets import setup_dataset as j_setup_dataset
from packnet_sfm_tpu.datasets import dgp as jdgp
from packnet_sfm_tpu.datasets.image_dataset import ImageDataset as JImage
from packnet_sfm_tpu.datasets.loader import default_collate as j_collate
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.trainers.trainer import _host_prepare
from packnet_sfm_tpu_torch import eval as port_eval
from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.datasets import dgp as tdgp
from packnet_sfm_tpu_torch.datasets import setup_dataset
from packnet_sfm_tpu_torch.datasets.image_dataset import (
    ImageDataset, dummy_intrinsics, write_image_tree)
from packnet_sfm_tpu_torch.datasets.loader import (
    default_collate, to_device_batch)
from packnet_sfm_tpu_torch.models.factory import setup_model as t_setup_model
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_state_dict, flax_variables, load_flax_variables)
from tests.test_torch_datasets import assert_same
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import randomize_variables

OVERFIT_DDAD = 'configs/overfit_ddad.yaml'
H, W = 64, 96
CAMS = ['camera_01', 'camera_05']
N_SCENES, N_SAMPLES = 2, 4
RANDOM_INIT = ['model.depth_net.allow_random_init', True,
               'model.pose_net.allow_random_init', True]


@pytest.fixture(scope='module')
def dgp_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('dgp'))
    return tdgp.write_dgp_tree(root, N_SCENES, N_SAMPLES, CAMS, H, W,
                               n_points=3000, seed=0)


@pytest.fixture
def fresh_root(dgp_root, tmp_path):
    """A copy of the tree without any depth-map cache."""
    root = str(tmp_path / 'dgp')
    shutil.copytree(dgp_root, root,
                    ignore=shutil.ignore_patterns('depth'))
    return root


def same_samples(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        for key in ('pose', 'pose_context', 'extrinsics'):
            if key in w:
                np.testing.assert_allclose(np.asarray(g.pop(key)),
                                           np.asarray(w.pop(key)),
                                           atol=1e-6, err_msg=key)
        assert_same(g, w, str(i))


# ------------------------------------------------------------------ Image

@pytest.mark.parametrize('listing', ['glob', 'split'])
def test_image_samples_and_clamped_contexts_match_jax(tmp_path, listing):
    root = write_image_tree(str(tmp_path / 'frames'), 5, H, W, seed=1)
    split = ''
    if listing == 'split':
        split = 'list.txt'
        with open(os.path.join(root, split), 'w') as f:
            f.write('000003.png\n000001.png\n\n000004.png\n')
    kw = dict(split=split, back_context=1, forward_context=2)
    got, want = ImageDataset(root, **kw), JImage(root, **kw)
    assert got.files == want.files
    assert len(got) == (3 if split else 5)
    for i in range(len(want)):
        assert_same(got[i], want[i], str(i))
    # at the ends a context repeats the nearest frame
    last = got[len(got) - 1]
    np.testing.assert_array_equal(last['rgb_context'][1], last['rgb'])
    np.testing.assert_array_equal(got[0]['rgb_context'][0], got[0]['rgb'])
    np.testing.assert_array_equal(got[0]['intrinsics'],
                                  dummy_intrinsics(W, H))


def test_image_split_through_setup_dataset_matches_jax(tmp_path):
    """'Image' drops the split's depth types, as JAX's factory does; the
    train transform (jitter off) and the eval transform match."""
    root = write_image_tree(str(tmp_path / 'frames'), 3, H, W, seed=2)
    cfg = t_parse('configs/train_omnicam.yaml', [
        'datasets.train.path', [root], 'datasets.train.depth_type',
        ['lidar'], 'datasets.augmentation.image_shape', (32, 48),
        'datasets.augmentation.jittering', ()])
    for mode in ('train', 'test'):
        (got,) = setup_dataset(cfg.datasets.train, cfg.datasets.augmentation,
                               mode)
        (want,) = j_setup_dataset(cfg.datasets.train,
                                  cfg.datasets.augmentation, mode)
        assert isinstance(got, ImageDataset)
        for i in range(3):
            assert_same(got[i], want[i], '{} {}'.format(mode, i))
        assert got[0]['rgb'].shape == (32, 48, 3)


# -------------------------------------------------------------------- DGP

@pytest.mark.parametrize('kw', [
    dict(cameras=['camera_01'], depth_type='lidar', input_depth_type='lidar',
         back_context=1, forward_context=1),
    dict(cameras=CAMS, depth_type='lidar', back_context=1, forward_context=1),
    dict(cameras=CAMS[::-1], with_pose=False)],
    ids=['one-camera-ctx', 'two-cameras-ctx', 'two-cameras-no-pose'])
def test_dgp_samples_match_jax(fresh_root, kw):
    got = tdgp.DGPDataset(fresh_root, **kw)
    want = jdgp.DGPDataset(fresh_root, **kw)
    assert got.samples == want.samples
    assert len(got) == N_SCENES * (N_SAMPLES - kw.get('back_context', 0) -
                                   kw.get('forward_context', 0))
    same_samples(got, want)
    s = got[0]
    n = len(kw['cameras'])
    if n > 1:
        assert s['rgb'].shape == (n, H, W, 3)
        assert isinstance(s['sensor_name'], str)
    if 'depth_type' in kw:
        assert float((s['depth'] > 0).mean()) > 0.01


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_depth_cache_written_by_one_package_is_read_by_the_other(
        fresh_root, writer):
    kw = dict(cameras=CAMS, depth_type='lidar')
    first, second = (tdgp, jdgp) if writer == 'port' else (jdgp, tdgp)
    rendered = [first.DGPDataset(fresh_root, **kw)[i]['depth']
                for i in range(2)]
    cache = os.path.join(fresh_root, 'scene_000', 'depth', 'lidar', CAMS[1],
                         '000001.npz')
    assert os.path.exists(cache)
    # without the sweeps the depth can come only from the cache
    for scene in os.listdir(fresh_root):
        shutil.rmtree(os.path.join(fresh_root, scene, 'point_cloud'))
    ds = second.DGPDataset(fresh_root, **kw)
    for i in range(2):
        np.testing.assert_array_equal(ds[i]['depth'], rendered[i])


def test_lidar_projection_truncates_and_the_nearest_point_wins():
    """Pixel coordinates go through astype(int): u = -0.5 and -0.9 truncate
    to column 0 (kept), u = -1.2 to -1 (dropped). Three points share one
    pixel in every order: the nearest wins. Points within 0.1 m of the
    camera are dropped."""
    K = np.array([[10., 0, 0], [0, 10, 0], [0, 0, 1]], np.float32)
    pts = np.array([[-0.05, 0.2, 1.0],     # u = -0.5, v = 2
                    [-0.18, 0.6, 2.0],     # u = -0.9, v = 3
                    [-0.12, 0.5, 1.0],     # u = -1.2: dropped
                    [0.35, 0.35, 0.05]])   # too near
    same_px = [[0.3, 0.3, 1.0], [0.6, 0.6, 2.0], [0.9, 0.9, 3.0]]
    for order in ([0, 1, 2], [2, 0, 1], [1, 2, 0]):
        world = np.concatenate([pts, np.asarray(same_px)[order]])
        got = tdgp.project_lidar_to_depth(world, np.eye(4), K, 6, 5)
        np.testing.assert_array_equal(
            got, jdgp.project_lidar_to_depth(world, np.eye(4), K, 6, 5))
        assert got.shape == (6, 5, 1) and got.dtype == np.float32
        assert got[3, 3, 0] == 1.0             # the nearest of the three
        assert got[2, 0, 0] == 1.0 and got[3, 0, 0] == 2.0
        assert (got > 0).sum() == 3


def test_quaternion_poses_match_jax():
    rng = np.random.RandomState(5)
    for _ in range(5):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        d = {'translation': dict(zip('xyz', rng.randn(3))),
             'rotation': dict(zip(('qw', 'qx', 'qy', 'qz'), q))}
        np.testing.assert_array_equal(tdgp.quat_to_rot(q),
                                      jdgp.quat_to_rot(q))
        got = tdgp.pose_from_dict(d)
        np.testing.assert_array_equal(got, jdgp.pose_from_dict(d))
        np.testing.assert_allclose(got[:3, :3] @ got[:3, :3].T, np.eye(3),
                                   atol=1e-6)
    np.testing.assert_array_equal(tdgp.pose_from_dict({}), np.eye(4))


# ------------------------------------------------- multi-camera batch, step

def ddad_config(parse, root, extra=()):
    return parse(OVERFIT_DDAD, [
        'tpu.compute_dtype', 'float32', 'tpu.photometric_dtype', 'float32',
        'datasets.augmentation.image_shape', (H, W),
        'datasets.augmentation.jittering', (),
        'datasets.train.path', [root], 'datasets.train.split', [''],
        'datasets.train.cameras', [CAMS], 'datasets.train.batch_size', 2,
        'datasets.train.repeat', [1]] + list(extra))


@pytest.fixture(scope='module')
def folded(dgp_root):
    """The first two train samples of the two-camera tree, collated and
    folded by each package: (port batch of tensors, JAX numpy batch)."""
    tcfg, jcfg = ddad_config(t_parse, dgp_root), ddad_config(j_parse,
                                                             dgp_root)
    (tds,) = setup_dataset(tcfg.datasets.train, tcfg.datasets.augmentation,
                           'train')
    (jds,) = j_setup_dataset(jcfg.datasets.train, jcfg.datasets.augmentation,
                             'train')
    got = [tds[i] for i in range(2)]
    want = [jds[i] for i in range(2)]
    for g, w in zip(got, want):
        assert_same(g, w)
    return (to_device_batch(default_collate(got), 'cpu'),
            _host_prepare(j_collate(want)))


def test_stack_sample_and_fold_match_jax(folded, dgp_root):
    got, want = folded
    assert_same({k: ([c.numpy() for c in v] if isinstance(v, list) else
                     v.numpy()) for k, v in got.items()},
                jax.tree_util.tree_map(np.asarray, want))
    assert got['rgb'].shape == (4, H, W, 3)        # B2 x 2 cameras
    assert got['rgb_context'][0].shape == (4, H, W, 3)
    assert got['pose_context'][1].shape == (4, 4, 4)
    assert got['intrinsics'].shape == (4, 3, 3)
    ds = tdgp.DGPDataset(dgp_root, cameras=CAMS)
    per_cam = [tdgp.DGPDataset(dgp_root, cameras=[c])[0] for c in CAMS]
    assert_same(tdgp.stack_sample(per_cam), jdgp.stack_sample(per_cam))
    assert_same(ds[0], tdgp.stack_sample(per_cam))


def test_folded_two_camera_step_matches_jax(folded, dgp_root,
                                            one_torch_thread):  # noqa: F811
    batch, nb = folded
    jcfg = ddad_config(j_parse, dgp_root)
    tcfg = ddad_config(t_parse, dgp_root)
    jm = j_setup_model(jcfg)
    v = randomize_variables(jax.eval_shape(
        lambda b: jm.init(jax.random.PRNGKey(0), b, train=False), nb), 21)

    def loss_fn(params, stats, b):
        out, mut = jm.apply({'params': params, 'batch_stats': stats}, b,
                            train=True, mutable=['batch_stats'])
        return out['loss'], (out['metrics'], mut['batch_stats'])

    (jloss, (jmetrics, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v['params'], v['batch_stats'], nb)
    tm = load_flax_variables(t_setup_model(tcfg), v).train()
    out = tm(batch)
    out['loss'].backward()
    np.testing.assert_allclose(float(out['loss'].detach()), float(jloss),
                               rtol=1e-5)
    assert sorted(out['metrics']) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(out['metrics'][k].detach()),
                                   float(jmetrics[k]), rtol=1e-5, err_msg=k)
    want = flax_state_dict(tm, {'params': jgrads,
                                'batch_stats': v['batch_stats']})
    params = dict(tm.named_parameters())
    assert len(params) == len(jax.tree_util.tree_leaves(jgrads))
    for name, p in params.items():
        g, w = p.grad.numpy(), want[name]
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) + 1e-8, name
    got = flax_variables(tm)['batch_stats']
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jstats)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_overfit_ddad_fits_and_evaluates_from_disk(dgp_root, tmp_path,
                                                   one_torch_thread):  # noqa
    """overfit_ddad.yaml as written but for the tree, the size and one
    epoch: train.fit (its 'camera_01', B4, validation on the LiDAR depth,
    a checkpoint), then eval.test over that checkpoint on the test split."""
    data = []
    for split in ('train', 'validation', 'test'):
        data += ['datasets.{}.path'.format(split), [dgp_root],
                 'datasets.{}.split'.format(split), ['']]
    ck = str(tmp_path / 'ckpt')
    trainer = port_train.fit(OVERFIT_DDAD, 'cpu', data + RANDOM_INIT + [
        'tpu.compute_dtype', 'float32',
        'datasets.augmentation.image_shape', (H, W),
        'datasets.train.repeat', [1], 'datasets.train.num_workers', 2,
        'checkpoint.filepath', ck, 'arch.eval_during_training', False])
    n_train = N_SCENES * (N_SAMPLES - 2)
    assert trainer.step == trainer.optimizer.count == n_train // 4
    assert np.isfinite(trainer.last_val_metrics['depth-abs_rel'])
    (ckpt,) = [f for f in os.listdir(os.path.join(ck, 'model'))
               if f.endswith('.ckpt')]
    metrics = port_eval.test(os.path.join(ck, 'model', ckpt), device='cpu',
                             overrides=data[-4:])
    # the same frames and weights as the last validation; min_depth 0.0
    # makes the log modes' rmse_log infinite, in JAX too
    assert len(metrics) == 6 * 7 + 1 and not metrics.skipped
    assert np.isfinite(metrics['depth-abs_rel'])
    keys = sorted(metrics)
    assert keys == sorted(trainer.last_val_metrics)
    np.testing.assert_allclose([metrics[k] for k in keys],
                               [trainer.last_val_metrics[k] for k in keys],
                               rtol=1e-5)
