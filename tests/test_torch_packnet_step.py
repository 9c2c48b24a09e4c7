"""The PackNet YAMLs in the port against the JAX package, on the CPU in
float32, with variables drawn with numpy and carried by
load_flax_variables:

- configs/train_ddad.yaml (SelfSupModel, PackNet01 '1A' at its own widths
  and PoseNet) on a DGP tree written with write_dgp_tree (camera_01, read
  at 32x64, B2, repeat 1): one step's loss and metrics rtol 1e-5 against
  the loss the JAX make_train_step differentiates, its 4 inverse-depth
  maps at 1e-5 x max|ref|, each gradient leaf
  |g - g_jax| <= 2e-2 |g_jax| + 1e-8 in the Frobenius norm (a leaf the
  reference has at below 1e-6 of the largest, analytically zero, within
  1e-6 of the largest);
- configs/train_packnet_san_kitti.yaml (SemiSupCompletionModel,
  PackNetSAN01 '1A') on a KITTI tree at a 32x96 crop with its velodyne
  input, at narrow widths through model.depth_net.ni / channels /
  num_3d_feat (both factories forward them): the same limits on the RGB
  and the RGB+D maps, and the MaskedBatchNorm statistics after the step
  per leaf atol 1e-5 x max;
- configs/eval_packnet_san_kitti.yaml (dropout 0.5, in eval) over a
  checkpoint the port writes: eval.py's 6 x 7 metrics against the JAX
  eval step's on the same batches and weights, averaged as the port
  averages them, atol 1e-4; the merged test split keeps the velodyne
  entry, so the masked convs run;
- configs/train_packnet_san_ddad.yaml: it builds, its 4 train and 8
  validation datasets expand as the JAX package's do, and its dropout
  acts in training only (PackNet's dropout draws cannot match across
  frameworks: tests/test_torch_packnet.py holds the kept share and the
  scale).
"""

import collections

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.datasets import setup_dataset as j_setup_dataset
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.parallel.train_step import (
    make_eval_metrics_step as j_metrics_step)
from packnet_sfm_tpu.utils.checkpoint import load_checkpoint as j_load
from packnet_sfm_tpu_torch import eval as port_eval
from packnet_sfm_tpu_torch.config import parse_test_file
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.datasets import setup_dataset
from packnet_sfm_tpu_torch.datasets.dgp import write_dgp_tree
from packnet_sfm_tpu_torch.datasets.kitti import write_kitti_tree
from packnet_sfm_tpu_torch.datasets.loader import (
    default_collate, to_device_batch)
from packnet_sfm_tpu_torch.models.factory import (
    init_weights, setup_model as t_setup_model)
from packnet_sfm_tpu_torch.ops.kernels import san_conv
from packnet_sfm_tpu_torch.trainers.trainer import make_loader
from packnet_sfm_tpu_torch.utils.checkpoint import save_checkpoint
from packnet_sfm_tpu_torch.utils.flax_weights import load_flax_variables
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import (
    assert_grads_match, assert_stats_match, jax_run_once,
    pooled_random_variables)

TRAIN_DDAD = 'configs/train_ddad.yaml'
SAN_KITTI = 'configs/train_packnet_san_kitti.yaml'
EVAL_KITTI = 'configs/eval_packnet_san_kitti.yaml'
SAN_DDAD = 'configs/train_packnet_san_ddad.yaml'
FP32 = ['tpu.compute_dtype', 'float32', 'tpu.photometric_dtype', 'float32']
SMALL_CROP = (-32, 0, 0.5, 96)
NARROW = ['model.depth_net.ni', 16,
          'model.depth_net.channels', [16, 16, 32, 64, 128],
          'model.depth_net.num_3d_feat', 4]


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv('KITTI_CACHE_DIR', str(tmp_path / 'kitti_cache'))


@pytest.fixture(scope='module')
def kitti_root(tmp_path_factory):
    """10 frames at 48x160 (depth on frames 1-8): train frames 4-6, the
    validation and test frames 3 and 6."""
    root = str(tmp_path_factory.mktemp('kitti'))
    write_kitti_tree(root, (48, 160), 10, depth_margin=1,
                     splits={'train.txt': (4, 5, 6), 'val.txt': (3, 6)})
    return root


@pytest.fixture(scope='module')
def dgp_root(tmp_path_factory):
    """2 scenes x 3 samples, four cameras at 48x80."""
    root = str(tmp_path_factory.mktemp('dgp'))
    return write_dgp_tree(root, 2, 3, ['camera_01', 'camera_05',
                                       'camera_06', 'camera_09'], 48, 80,
                          n_points=2000, seed=0)


def first_batch(config, n):
    """The first `n` samples of the config's train split (the port's
    reader and transforms), collated: (tensors, the same as numpy)."""
    (ds,) = setup_dataset(config.datasets.train,
                          config.datasets.augmentation, 'train')
    batch = to_device_batch(default_collate([ds[i] for i in range(n)]),
                            'cpu')
    batch = {k: v for k, v in batch.items()
             if torch.is_tensor(v) or (isinstance(v, list) and v and
                                       torch.is_tensor(v[0]))}
    nb = {k: ([c.numpy() for c in v] if isinstance(v, list) else v.numpy())
          for k, v in batch.items()}
    return batch, nb


def step_matches_jax(path, overrides, batch, nb, seed, opt_level=0):
    """One training forward and backward of the YAML's model in both
    packages, the JAX side as make_train_step differentiates it: the loss
    and metrics rtol 1e-5, the inverse-depth outputs at 1e-5 x max, the
    gradients and the statistics (see the module note). Returns the port's
    model and output."""
    jm = j_setup_model(j_parse(path, list(overrides)))
    v = pooled_random_variables(jax.eval_shape(
        lambda b: jm.init(jax.random.PRNGKey(0), b, train=False), nb), seed)
    keys = ('inv_depths', 'inv_depths_rgbd')

    def loss_fn(params, stats, b):
        out, mut = jm.apply({'params': params, 'batch_stats': stats}, b,
                            train=True, mutable=['batch_stats'])
        maps = {k: out[k] for k in keys if k in out}
        return out['loss'], (out['metrics'], mut['batch_stats'], maps)

    (jloss, (jmetrics, jstats, jmaps)), jgrads = jax_run_once(
        jax.value_and_grad(loss_fn, has_aux=True), v['params'],
        v.get('batch_stats', {}), nb, opt_level=opt_level)
    with torch.device('meta'):
        tm = t_setup_model(t_parse(path, list(overrides)))
    tm = load_flax_variables(tm.to_empty(device='cpu'), v).train()
    out = tm(batch)
    out['loss'].backward()
    np.testing.assert_allclose(float(out['loss'].detach()), float(jloss),
                               rtol=1e-5)
    assert sorted(out['metrics']) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(out['metrics'][k].detach()),
                                   float(jmetrics[k]), rtol=1e-5, err_msg=k)
    assert sorted(k for k in keys if k in out) == sorted(jmaps)
    for k, maps in jmaps.items():
        assert len(out[k]) == len(maps) == 4
        for i, (a, b) in enumerate(zip(out[k], maps)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                       atol=1e-5 * float(np.abs(b).max()),
                                       err_msg='{} {}'.format(k, i))
    assert_grads_match(tm, jgrads, v.get('batch_stats', {}))
    assert_stats_match(tm, jstats)
    return tm, out


@pytest.mark.usefixtures('one_torch_thread')
def test_train_ddad_step_matches_jax(dgp_root):
    over = FP32 + ['datasets.augmentation.image_shape', (32, 64),
                   'datasets.train.path', [dgp_root],
                   'datasets.train.split', [''],
                   'datasets.train.batch_size', 2,
                   'datasets.train.repeat', [1]]
    cfg = t_parse(TRAIN_DDAD, list(over))
    assert list(cfg.datasets.train.cameras) == [['camera_01']]
    batch, nb = first_batch(cfg, 2)
    assert batch['rgb'].shape == (2, 32, 64, 3)
    assert len(batch['rgb_context']) == 2
    tm, out = step_matches_jax(TRAIN_DDAD, over, batch, nb, 20,
                               opt_level=None)
    assert type(tm.depth_net).__name__ == 'PackNet01'
    assert sorted(out['metrics']) == ['photometric_loss', 'smoothness_loss']
    # upsample_depth_maps (the default): every scale at full size
    assert [d.shape[1:3] for d in out['inv_depths']] == [(32, 64)] * 4
    assert len(out['poses']) == 2


def kitti_overrides(root):
    return ['tpu.compute_dtype', 'float32',
            'datasets.augmentation.crop_train_borders', SMALL_CROP,
            'datasets.augmentation.crop_eval_borders', SMALL_CROP,
            'datasets.train.path', [root], 'datasets.train.split',
            ['train.txt'], 'datasets.train.batch_size', 2]


@pytest.mark.usefixtures('one_torch_thread')
def test_packnet_san_kitti_step_matches_jax(kitti_root):
    over = kitti_overrides(kitti_root) + NARROW
    cfg = t_parse(SAN_KITTI, list(over))
    batch, nb = first_batch(cfg, 2)
    assert batch['rgb'].shape == (2, 32, 96, 3)
    assert float((batch['input_depth'] > 0).float().mean()) > 0.01
    tm, out = step_matches_jax(SAN_KITTI, over, batch, nb, 21)
    assert type(tm.depth_net).__name__ == 'PackNetSAN01'
    assert tm.depth_net.core.pre_calc.Conv_0.out_channels == 16
    assert {'supervised_loss', 'supervised_loss_rgbd',
            'feature_consistency_loss'} <= set(out['metrics'])
    assert len(out['inv_depths_rgbd']) == 4


@pytest.mark.usefixtures('one_torch_thread')
def test_eval_packnet_san_kitti_over_a_port_checkpoint_matches_jax(
        kitti_root, tmp_path):
    """A checkpoint the port writes (train_packnet_san_kitti.yaml's model,
    seeded weights) evaluated by eval.py with eval_packnet_san_kitti.yaml;
    the JAX eval step on the same batches with the checkpoint's weights
    read by the JAX package's reader."""
    tcfg = t_parse(SAN_KITTI, kitti_overrides(kitti_root) + NARROW)
    model = init_weights(t_setup_model(tcfg), torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in model.parameters():       # off the identity init
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.05)
    ckpt = str(tmp_path / 'packnet_san.ckpt')
    save_checkpoint(ckpt, tcfg, model)
    test = ['datasets.test.path', [kitti_root] * 2, 'datasets.test.split',
            ['val.txt'] * 2,
            'datasets.augmentation.crop_eval_borders', SMALL_CROP,
            'save.folder', '']
    calls = []
    masked_conv = san_conv.masked_conv2d_fn

    def counted(*args):
        calls.append(args[0].shape)
        return masked_conv(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(san_conv, 'masked_conv2d_fn', counted)
        metrics = port_eval.test(ckpt, EVAL_KITTI, device='cpu',
                                 overrides=test)
    # 30 masked convs a frame with LiDAR: the 2 frames of the first entry
    assert len(calls) == 30 * 2
    config, _ = parse_test_file(ckpt, EVAL_KITTI, test)
    assert config.model.depth_net.dropout == 0.5
    assert list(config.datasets.test.input_depth_type) == ['velodyne', '']
    assert len(metrics) == 6 * 7 + 1 and not metrics.skipped

    jcfg = j_parse(EVAL_KITTI, ['tpu.compute_dtype', 'float32'] + NARROW +
                   ['datasets.augmentation.crop_eval_borders', SMALL_CROP])
    jm = j_setup_model(jcfg)
    assert jm.depth_net.dropout == 0.5
    state = j_load(ckpt)
    jstep = j_metrics_step(jm, jcfg.model.params)

    jstate = collections.namedtuple('State', 'params batch_stats')(
        state['params'], state['batch_stats'])

    accum, count, with_lidar = {}, 0, 0
    for b in make_loader(config, 'test'):
        nb = {k: np.asarray(b[k]) for k in ('rgb', 'input_depth', 'depth')
              if k in b}
        with_lidar += 'input_depth' in nb
        n = nb['rgb'].shape[0]
        for mode, vals in jstep(jstate, nb).items():
            accum[mode] = accum.get(mode, 0.0) + np.asarray(
                vals, np.float64) * n
        count += n
    assert with_lidar == 2 and count == 4
    from packnet_sfm_tpu_torch.utils.logging_utils import METRIC_NAMES
    want = {'{}-{}'.format(mode, name): v / count
            for mode, vals in accum.items()
            for name, v in zip(METRIC_NAMES, vals)}
    assert sorted(want) == sorted(k for k in metrics if k != 'abs_rel')
    for k, v in want.items():
        # the YAML's min_depth 0 bounds the inverse depth at 1e6: the
        # log-space map exp(log(1/80) + 18.2 s) multiplies the heads'
        # float32 noise (1e-7 relative) by ~18, and its median-scaled
        # metrics reach 1e17; atol 1e-4, and rtol 1e-4 for those
        np.testing.assert_allclose(metrics[k], v, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_packnet_san_ddad_builds_and_expands_as_jax(dgp_root):
    """train_packnet_san_ddad.yaml: PackNetSAN01 with dropout 0.5; its four
    single-camera train entries and eight validation entries (the second
    four with LiDAR input) become datasets as in the JAX package; the
    dropout acts in training only."""
    over = ['tpu.compute_dtype', 'float32',
            'datasets.augmentation.image_shape', (32, 64)]
    for split in ('train', 'validation'):
        over += ['datasets.{}.path'.format(split), [dgp_root],
                 'datasets.{}.split'.format(split), ['']]
    tcfg, jcfg = t_parse(SAN_DDAD, list(over)), j_parse(SAN_DDAD, list(over))
    assert tcfg.arch.validate_first
    for split in ('train', 'validation'):
        for key in ('dataset', 'path', 'split', 'depth_type',
                    'input_depth_type', 'cameras', 'repeat'):
            assert list(tcfg.datasets[split].get(key, [])) == list(
                jcfg.datasets[split].get(key, [])), (split, key)
    assert list(tcfg.datasets.train.repeat) == [5] * 4
    for split, n in (('train', 4), ('validation', 8)):
        tds = setup_dataset(tcfg.datasets[split],
                            tcfg.datasets.augmentation, split)
        jds = j_setup_dataset(jcfg.datasets[split],
                              jcfg.datasets.augmentation, split)
        assert len(tds) == len(jds) == n
        for a, b in zip(tds, jds):
            assert len(a) == len(b)
            sa, sb = a[0], b[0]
            assert sorted(sa) == sorted(sb)
            assert ('input_depth' in sa) == ('input_depth' in sb)
            if split == 'validation':       # train jitters, per package
                np.testing.assert_array_equal(sa['rgb'], sb['rgb'])
        lidar = ['input_depth' in ds[0] for ds in tds]
        assert lidar == ([False] * 4 if split == 'train'
                         else [False] * 4 + [True] * 4)
    cams = [list(c) for c in tcfg.datasets.validation.cameras]
    assert cams == [list(c) for c in jcfg.datasets.validation.cameras]
    with torch.device('meta'):
        tm = t_setup_model(tcfg)
    assert type(tm.depth_net).__name__ == 'PackNetSAN01'
    assert tm.depth_net.core.dropout == 0.5 and tm.depth_net.needs_generator
    assert tm.depth_net.core.conv2.ResidualConv_0.dropout == 0.5
    # dropout in training only: a small net of the same class
    tcfg.model.depth_net.ni = 16
    tcfg.model.depth_net.channels = [16, 16, 32, 64, 128]
    tcfg.model.depth_net.num_3d_feat = 4
    small = init_weights(t_setup_model(tcfg), torch.Generator().manual_seed(6))
    b = {'rgb': torch.rand(1, 32, 64, 3, generator=torch.Generator()
                           .manual_seed(7))}
    with torch.no_grad():
        small.eval()
        e1, e2 = (small.compute_depth_net(b)['inv_depths'][0]
                  for _ in range(2))
        small.train()
        t1, t2 = (small.compute_depth_net(b, torch.Generator().manual_seed(
            s))['inv_depths'][0] for s in (1, 2))
    assert torch.equal(e1, e2) and not torch.equal(t1, t2)
