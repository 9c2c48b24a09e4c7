"""The KITTI paths of the port against the JAX package's, on the CPU in
float32 with variables drawn with numpy and carried by
load_flax_variables:

- K1, configs/train_kitti.yaml's SelfSupModel (DepthResNet + PoseResNet,
  'min' with automask, smoothness 1e-3) at B2 32x64 with two contexts: the
  loss the JAX make_train_step differentiates (model.apply in training),
  its value and metrics rtol 1e-5, each gradient leaf |g - g_jax| <= 2e-2
  |g_jax| + 1e-8 in the Frobenius norm, the BatchNorm statistics after the
  step per leaf atol 1e-5 x max|leaf|;
- VelSupModel on the same networks over the Synthetic dataset's batch with
  its 'pose_context': the same limits, and velocity_loss itself rtol 1e-6;
- K2, configs/train_resnet_san_kitti.yaml: its SAN branch as written
  (use_film false) reads no LiDAR in either package; the row window
  calibrated on a KITTI tree at the 352x1216 crop equals JAX's; one epoch
  through train.fit with FiLM on and the YAML's two validation datasets;
  and configs/eval_resnet_san_kitti.yaml's 6 x 7 metrics over a KITTI tree
  (garg crop, top-center, crop_eval_borders) against the JAX eval step's
  on the same batches, atol 1e-4;
- the entry points refuse to run without CUDA unless asked for the CPU.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.datasets import setup_dataset as j_setup_dataset
from packnet_sfm_tpu.datasets.synthetic import SyntheticDataset
from packnet_sfm_tpu.geometry.pose import Pose as JPose
from packnet_sfm_tpu.losses.velocity import velocity_loss as j_velocity
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.networks.layers.san import (
    calibrate_san_row_window as j_calibrate)
from packnet_sfm_tpu.parallel.train_step import (
    make_eval_metrics_step as j_metrics_step)
from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.datasets import setup_dataset
from packnet_sfm_tpu_torch.datasets.kitti import write_kitti_tree
from packnet_sfm_tpu_torch.datasets.loader import default_collate
from packnet_sfm_tpu_torch.eval import make_batches
from packnet_sfm_tpu_torch.geometry.pose import Pose as TPose
from packnet_sfm_tpu_torch.losses.velocity import velocity_loss
from packnet_sfm_tpu_torch.models.factory import setup_model as t_setup_model
from packnet_sfm_tpu_torch.models.sfm import VelSupModel
from packnet_sfm_tpu_torch.networks.layers.san import (
    calibrate_san_row_window)
from packnet_sfm_tpu_torch.parallel.train_step import (
    make_eval_metrics_step as t_metrics_step)
from packnet_sfm_tpu_torch.trainers.trainer import make_loader
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_state_dict, flax_variables, load_flax_variables)
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import randomize_variables

TRAIN_KITTI = 'configs/train_kitti.yaml'
SAN_KITTI = 'configs/train_resnet_san_kitti.yaml'
EVAL_KITTI = 'configs/eval_resnet_san_kitti.yaml'
SHAPE = (32, 64)
FP32 = ['tpu.compute_dtype', 'float32', 'tpu.photometric_dtype', 'float32',
        'datasets.augmentation.image_shape', SHAPE]
SMALL_CROP = (-32, 0, 0.5, 96)
EvalState = collections.namedtuple('EvalState', 'params batch_stats')


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv('KITTI_CACHE_DIR', str(tmp_path / 'kitti_cache'))


@pytest.fixture(scope='module')
def kitti_root(tmp_path_factory):
    """10 frames at 48x160 (depth on frames 1-8), a train split of 3 frames
    (2 samples with both contexts) and a validation split of 2."""
    root = str(tmp_path_factory.mktemp('kitti'))
    write_kitti_tree(root, (48, 160), 10, depth_margin=1,
                     splits={'train.txt': (4, 5, 6), 'val.txt': (3, 6)})
    return root


def np_tree(batch):
    return {k: ([np.asarray(c) for c in v] if isinstance(v, list) else
                np.asarray(v)) for k, v in batch.items()}


def step_matches_jax(overrides, batch, seed):
    """One training forward and backward of the config's model in both
    packages on `batch` (tensors), the JAX side as make_train_step
    differentiates it; returns the port's output."""
    jcfg = j_parse(TRAIN_KITTI, list(overrides))
    tcfg = t_parse(TRAIN_KITTI, list(overrides))
    jm = j_setup_model(jcfg)
    nb = np_tree(batch)
    v = randomize_variables(jax.eval_shape(
        lambda b: jm.init(jax.random.PRNGKey(0), b, train=False), nb), seed)

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
    return out


def test_k1_step_matches_jax():
    batch = make_batches(SHAPE, 2, 1, seed=3, device='cpu', contexts=2)[0]
    out = step_matches_jax(FP32, batch, 8)
    assert sorted(out['metrics']) == ['photometric_loss', 'smoothness_loss']
    assert len(out['poses']) == 2 and len(out['inv_depths']) == 4


def test_velsup_step_matches_jax():
    """VelSupModel, no YAML's, on train_kitti.yaml's networks: K1's batch
    with the 'pose_context' of a collated Synthetic batch."""
    ds = SyntheticDataset(num_samples=2, height=SHAPE[0], width=SHAPE[1])
    poses = default_collate([ds[i] for i in range(2)])['pose_context']
    batch = make_batches(SHAPE, 2, 1, seed=5, device='cpu', contexts=2)[0]
    batch['pose_context'] = [torch.from_numpy(p) for p in poses]
    out = step_matches_jax(FP32 + ['model.name', 'VelSupModel',
                                   'model.loss.velocity_loss_weight', 0.5],
                           batch, 9)
    assert 'velocity_loss' in out['metrics']


def test_velocity_loss_matches_jax():
    rng = np.random.RandomState(4)
    vecs = [(rng.randn(3, 6) * 0.3).astype(np.float32) for _ in range(2)]
    gt = [np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)) for _ in range(2)]
    for g in gt:
        g[:, :3, 3] = rng.randn(3, 3)
    want = j_velocity([JPose.from_vec(v) for v in vecs], gt)
    got = velocity_loss([TPose.from_vec(torch.from_numpy(v)) for v in vecs],
                        [torch.from_numpy(g) for g in gt])
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=1e-6)
    assert float(got['metrics']['velocity_loss']) == float(got['loss'])
    model = t_setup_model(t_parse(TRAIN_KITTI, ['model.name',
                                                'VelSupModel']))
    assert isinstance(model, VelSupModel)
    assert model.velocity_loss_weight == 0.1


def test_san_kitti_as_written_reads_no_lidar():
    """train_resnet_san_kitti.yaml leaves use_film off, and in both
    packages the SAN branch (the masked convs) is built and run only with
    FiLM: the YAML's LiDAR input reaches no layer, so the RGB+D pyramid is
    the RGB one."""
    cfg = t_parse(SAN_KITTI, ['tpu.compute_dtype', 'float32'])
    model = t_setup_model(cfg).train()
    assert not hasattr(model.depth_net, 'mconvs')
    jm = j_setup_model(j_parse(SAN_KITTI))
    batch = make_batches(SHAPE, 1, 1, seed=1, device='cpu')[0]
    shapes = jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False), np_tree(batch))
    assert 'mconvs' not in shapes['params']['depth_net']
    with torch.no_grad():
        out = model.depth_net(batch['rgb'], batch['input_depth'])
    for a, b in zip(out['inv_depths'], out['inv_depths_rgbd']):
        assert torch.equal(a, b)


def test_san_row_window_calibrates_on_kitti_as_jax(tmp_path):
    """san_row_window -1 on a KITTI tree at the YAML's 352x1216 train crop:
    the LiDAR below the horizon gives a window of 256 of the 352 rows, in
    both packages."""
    root = str(tmp_path / 'big')
    write_kitti_tree(root, (375, 1242), 4)
    over = ['datasets.train.path', [root], 'datasets.train.split',
            ['split.txt'], 'datasets.augmentation.jittering', ()]
    cfg = t_parse(SAN_KITTI, list(over))
    (ds,) = setup_dataset(cfg.datasets.train, cfg.datasets.augmentation,
                          'train')
    jcfg = j_parse(SAN_KITTI, list(over))
    (jds,) = j_setup_dataset(jcfg.datasets.train, jcfg.datasets.augmentation,
                             'train')
    assert ds[0]['input_depth'].shape == (352, 1216, 1)
    frac = calibrate_san_row_window(ds)
    assert frac == j_calibrate(jds)
    assert int(352 * frac) // 32 * 32 == 256


@pytest.mark.usefixtures('one_torch_thread')
def test_san_kitti_fit_validates_both_datasets(kitti_root):
    """train_resnet_san_kitti.yaml, FiLM on, one epoch through train.fit at
    a small crop: both validation datasets (with and without LiDAR input)
    each validated, prefixed, the first also unprefixed."""
    trainer = port_train.fit(SAN_KITTI, 'cpu', [
        'tpu.compute_dtype', 'float32', 'model.depth_net.use_film', True,
        'datasets.augmentation.crop_train_borders', SMALL_CROP,
        'datasets.augmentation.crop_eval_borders', SMALL_CROP,
        'datasets.train.path', [kitti_root], 'datasets.train.split',
        ['train.txt'], 'datasets.train.batch_size', 2,
        'datasets.train.num_workers', 1,
        'datasets.validation.path', [kitti_root] * 2,
        'datasets.validation.split', ['val.txt'] * 2,
        'datasets.validation.num_workers', 1,
        'arch.max_epochs', 1, 'arch.eval_subset_size', 2,
        'checkpoint.filepath', ''])
    assert trainer.step == trainer.optimizer.count == 1
    m = trainer.last_val_metrics
    first, second = sorted({k.split('/')[0] for k in m if '/' in k})
    assert first.startswith('0-') and second.startswith('1-')
    for p in (first, second):
        assert len([k for k in m if k.startswith(p + '/')]) == 6 * 7 + 1
    # with FiLM on, the LiDAR moves the predictions
    key = '/depth_gt-abs_rel'
    assert m[first + key] != m[second + key]
    assert m['depth_gt-abs_rel'] == m[first + key]


@pytest.mark.usefixtures('one_torch_thread')
def test_eval_kitti_metrics_match_jax(kitti_root):
    """eval_resnet_san_kitti.yaml (garg crop, scale_output top-center,
    crop_eval_borders at a small size) over the tree's test split: the
    port's eval step against JAX's on the same batches and weights."""
    over = ['datasets.test.path', [kitti_root], 'datasets.test.split',
            ['val.txt'], 'datasets.test.batch_size', 2,
            'datasets.augmentation.crop_eval_borders', SMALL_CROP]
    tcfg = t_parse(EVAL_KITTI, list(over))
    jcfg = j_parse(EVAL_KITTI, list(over))
    assert tcfg.model.params.scale_output == 'top-center'
    batches = list(make_loader(tcfg, 'test'))
    assert batches[0]['rgb'].shape == (2, 32, 96, 3)
    assert batches[0]['depth'].shape == (2, 48, 160, 1)
    jm = j_setup_model(jcfg)
    nb = {k: batches[0][k] for k in ('rgb', 'input_depth')}
    v = randomize_variables(jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False), nb), 10)
    tm = load_flax_variables(t_setup_model(tcfg), v).eval()
    jstep = j_metrics_step(jm, jcfg.model.params)
    tstep = t_metrics_step(tm, tcfg.model.params)
    state = EvalState(v['params'], v['batch_stats'])
    for b in batches:
        b = {k: b[k] for k in ('rgb', 'input_depth', 'depth')}
        want = jstep(state, b)
        got = tstep({k: torch.from_numpy(x) for k, x in b.items()})
        assert sorted(got) == sorted(want) and len(want) == 6
        for mode in want:
            np.testing.assert_allclose(got[mode].numpy(),
                                       np.asarray(want[mode]), atol=1e-4,
                                       err_msg=mode)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the refusal needs none')
    for path in (TRAIN_KITTI, SAN_KITTI):
        with pytest.raises(RuntimeError, match='CUDA'):
            port_train.fit(path)
