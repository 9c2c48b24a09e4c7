"""The PyTorch port's eval protocol against the JAX package's, on the CPU
in float32: depth metrics (with the even-count median), flip-TTA fusion,
the whole make_eval_metrics_step on the same weights and batch, the
evaluate() accumulation, the flax weight loader's refusals, and the YAML
config through the port's own config package.

Tolerance: atol 1e-4 on every metric (float32 sums in another order).
"""

import collections
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.ops import depth as jdepth
from packnet_sfm_tpu.parallel.train_step import (
    make_eval_metrics_step as j_metrics_step)
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.eval import make_batches, main
from packnet_sfm_tpu_torch.models.factory import setup_model as t_setup_model
from packnet_sfm_tpu_torch.ops import depth as tdepth
from packnet_sfm_tpu_torch.parallel.train_step import (
    make_eval_metrics_step as t_metrics_step)
from packnet_sfm_tpu_torch.trainers.trainer import evaluate
from packnet_sfm_tpu_torch.utils.flax_weights import load_flax_variables
from packnet_sfm_tpu_torch.utils.logging_utils import METRIC_NAMES
from tests.torch_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

CONFIG = str(Path(__file__).resolve().parents[1] / 'configs' /
             'train_resnet_san_ncdb_640x384.yaml')
SMALL = ['tpu.compute_dtype', 'float32']
SHAPE = (64, 96)
# the JAX eval step takes a pytree with .params and .batch_stats
EvalState = collections.namedtuple('EvalState', 'params batch_stats')


def test_masked_median_even_count_averages_middle_values():
    x = torch.tensor([[4.0, 1.0], [3.0, 2.0]])
    mask = torch.tensor([[True, True], [True, True]])
    assert float(tdepth.masked_median(x, mask)) == 2.5   # nanmedian: 2.5
    assert float(torch.nanmedian(x[mask])) == 2.0        # torch: lower one
    np.testing.assert_allclose(
        float(jdepth._masked_median(x.numpy(), mask.numpy())), 2.5)
    odd = torch.tensor([[True, True], [True, False]])
    assert float(tdepth.masked_median(x, odd)) == 3.0


@pytest.mark.parametrize('crop', ['', 'garg'])
@pytest.mark.parametrize('use_gt_scale', [False, True])
def test_compute_depth_metrics(crop, use_gt_scale):
    rng = np.random.RandomState(0)
    gt = ((rng.rand(3, 37, 53, 1) * 20) * (rng.rand(3, 37, 53, 1) < 0.3)
          ).astype(np.float32)
    gt[2] = 0.0                   # an image with no valid pixel scores zeros
    gt[1, 20, 10:12] = 7.0        # keep one count even somewhere
    pred = (rng.rand(3, 20, 30, 1) * 15 + 0.5).astype(np.float32)
    want = jdepth.compute_depth_metrics(gt, pred, 0.5, 15.0, crop=crop,
                                        use_gt_scale=use_gt_scale)
    got = tdepth.compute_depth_metrics(torch.from_numpy(gt),
                                       torch.from_numpy(pred), 0.5, 15.0,
                                       crop=crop, use_gt_scale=use_gt_scale)
    assert got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize('mode,align,shape', [
    ('bilinear', True, (37, 53)), ('bilinear', False, (9, 14)),
    ('nearest', False, (40, 60)), ('nearest', False, (7, 11))])
def test_image_ops(mode, align, shape):
    from packnet_sfm_tpu.ops import image as jimage
    from packnet_sfm_tpu_torch.ops import image as timage
    x = np.random.RandomState(2).rand(2, 20, 30, 3).astype(np.float32)
    want = jimage.interpolate(x, shape, mode=mode, align_corners=align)
    got = timage.interpolate(torch.from_numpy(x), shape, mode=mode,
                             align_corners=align)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(timage.flip_lr(torch.from_numpy(x)).numpy(),
                                  np.asarray(jimage.flip_lr(x)))
    np.testing.assert_array_equal(
        timage.upsample2x_nearest(torch.from_numpy(x)).numpy(),
        np.asarray(jimage.upsample2x_nearest(x)))


def test_post_process_inv_depth():
    rng = np.random.RandomState(1)
    a, b = (rng.rand(2, 8, 40, 1).astype(np.float32) for _ in range(2))
    want = jdepth.post_process_inv_depth(a, b)
    got = tdepth.post_process_inv_depth(torch.from_numpy(a),
                                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_yaml_config_through_port_config():
    cfg = t_parse(CONFIG)
    jcfg = j_parse(CONFIG)
    assert cfg.model.name == 'SemiSupCompletionModel'
    assert cfg.model.depth_net.version == '18A'
    assert cfg.model.depth_net.use_film is True
    assert list(cfg.model.depth_net.film_scales) == [0]
    assert tuple(cfg.datasets.augmentation.image_shape) == (384, 640)
    assert (cfg.model.params.min_depth, cfg.model.params.max_depth) == \
        (0.5, 15.0)
    assert cfg.tpu.compute_dtype == 'bfloat16'
    assert cfg.to_dict() == jcfg.to_dict()
    assert t_parse(CONFIG, SMALL).tpu.compute_dtype == 'float32'


@pytest.fixture(scope='module')
def models():
    """The JAX model with randomised variables and the port's model
    carrying the same variables, both from the slice's YAML in float32."""
    jcfg = j_parse(CONFIG, list(SMALL))
    jm = j_setup_model(jcfg)
    batch = make_batches(SHAPE, 2, 1, seed=3, device='cpu')[0]
    np_batch = {k: v.numpy() for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), np_batch,
                                            train=False))
    rng = np.random.RandomState(4)

    def leaf(path, x):
        name = path[-1].key
        if name == 'kernel':
            return (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))
                    ).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    tcfg = t_parse(CONFIG, list(SMALL))
    tm = load_flax_variables(t_setup_model(tcfg), variables).eval()
    return jcfg, jm, variables, tcfg, tm, batch, np_batch


def test_eval_metrics_step_flip_tta_matches_jax(models):
    jcfg, jm, variables, tcfg, tm, batch, np_batch = models
    state = EvalState(variables['params'], variables['batch_stats'])
    want = j_metrics_step(jm, jcfg.model.params, flip_tta=True)(
        state, np_batch)
    got = t_metrics_step(tm, tcfg.model.params, flip_tta=True)(batch)
    assert sorted(got) == sorted(want) == sorted(
        ['depth', 'depth_gt', 'depth_lin', 'depth_lin_gt', 'depth_log',
         'depth_log_gt'])
    for mode in want:
        assert got[mode].shape == (7,)
        np.testing.assert_allclose(got[mode].numpy(), np.asarray(want[mode]),
                                   atol=1e-4, err_msg=mode)


def test_evaluate_weights_by_batch_size(models):
    _, _, _, tcfg, tm, batch, _ = models
    step = t_metrics_step(tm, tcfg.model.params)
    halves = [{k: v[:1] for k, v in batch.items()},
              {k: v[1:] for k, v in batch.items()}]
    flat = evaluate(tcfg, tm, [halves[0], halves[1], {'rgb': batch['rgb']}])
    assert len(flat) == 6 * 7 + 1
    per_half = [step(h) for h in halves]
    for mode in ('depth', 'depth_log_gt'):
        mean = (per_half[0][mode] + per_half[1][mode]) / 2
        for i, name in enumerate(METRIC_NAMES):
            np.testing.assert_allclose(flat['{}-{}'.format(mode, name)],
                                       float(mean[i]), atol=1e-6)
    assert flat['abs_rel'] == flat['depth-abs_rel']
    assert evaluate(tcfg, tm, []) == {}


def test_loader_raises_on_missing_and_extra_keys(models):
    _, _, variables, tcfg, _, _, _ = models
    params = variables['params']['depth_net']
    missing = jax.tree_util.tree_map(lambda x: x, variables)
    del missing['params']['depth_net']['mconvs']['film_0']['bias']
    with pytest.raises(KeyError, match='film_0.bias'):
        load_flax_variables(t_setup_model(tcfg), missing)
    extra = jax.tree_util.tree_map(lambda x: x, variables)
    extra['params']['depth_net']['decoder']['dispconv_9'] = {
        'Conv_0': {'bias': params['decoder']['dispconv_0']['Conv_0']['bias']}}
    with pytest.raises(KeyError, match='dispconv_9'):
        load_flax_variables(t_setup_model(tcfg), extra)
    bad = jax.tree_util.tree_map(lambda x: x, variables)
    bad['params']['depth_net']['weight'] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match='shape'):
        load_flax_variables(t_setup_model(tcfg), bad)


def test_eval_main_on_cpu_and_refuses_missing_cuda():
    flat = main(CONFIG, device='cpu', batch_size=1, n_batches=1, seed=0,
                overrides=['model.params.flip_tta', True])
    assert len(flat) == 6 * 7 + 1
    assert all(np.isfinite(v) for v in flat.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            main(CONFIG)
