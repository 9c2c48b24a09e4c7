"""The port's INT8 quantization (ops/quantization.py) and int8 evaluation
against the JAX package's, on the CPU in float32 at B2 32x64 (JAX
tests/test_qat.py's size): the quantizers and the quantized depth net bit
for bit, the straight-through gradients exactly the identity; the eval
protocol with int8 outputs and int8 weights on a single-head (flip-TTA)
and a dual-head ResNet18-SAN; the trainer's quick eval, which under QAT on
weights scores the int8 weights; the save pass of a dual-head model under
QAT, which writes what the float weights predict, as JAX's does; and the
CLIs on a dual-head checkpoint: infer.py against JAX scripts/infer.py,
and eval.test --int8 --int8-weights against evaluate with those flags.

The JAX package runs its quantizers inside jitted steps, where XLA turns
the division by 255 and by 127 into a product with the reciprocal; the
port does the same, so its codes and weights equal JAX's jitted ones bit
for bit (ops/quantization.py). The JAX side here is therefore jitted.

Tolerances: metrics atol 1e-4 (tests/test_torch_eval.py: float32 sums in
another order). A u8 output code of the two frameworks' sigmoids may
differ by one step where x * 255 sits within rounding of a .5 tie; that
moves one pixel's depth by one code, which the metrics' atol takes (one
code of the dual head's integer map, 15/255 m, at one of ~1600 valid
pixels moves abs_rel by < 4e-5). Depth maps rtol 1e-5, visualisations
within one step of 255 (tests/test_torch_eval_cli.py).
"""

import collections
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.ops import depth as jdepth
from packnet_sfm_tpu.ops import quantization as jq
from packnet_sfm_tpu.parallel.train_step import (
    make_eval_metrics_step as j_metrics_step)
from packnet_sfm_tpu.utils.save import save_depth as j_save_depth
from packnet_sfm_tpu_torch import eval as port_eval
from packnet_sfm_tpu_torch import infer as port_infer
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.models.factory import setup_model as t_setup_model
from packnet_sfm_tpu_torch.ops import quantization as tq
from packnet_sfm_tpu_torch.parallel.train_step import (
    make_eval_metrics_step as t_metrics_step)
from packnet_sfm_tpu_torch.trainers import trainer
from packnet_sfm_tpu_torch.utils.checkpoint import save_checkpoint
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_tree, load_flax_variables)
from tests.test_datasets import make_ncdb_tree
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import randomize_variables

pytestmark = pytest.mark.usefixtures('one_torch_thread')

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {'single': str(ROOT / 'configs' /
                         'train_resnet_san_ncdb_640x384.yaml'),
           'dual': str(ROOT / 'configs' /
                       'train_resnet_san_ncdb_dual_head_640x384.yaml')}
SHAPE = (32, 64)
SMALL = ['tpu.compute_dtype', 'float32',
         'datasets.augmentation.image_shape', SHAPE]
EvalState = collections.namedtuple('EvalState', 'params batch_stats')


def t(x):
    return torch.from_numpy(np.asarray(x))


def _batch(seed=6, B=2):
    rng = np.random.RandomState(seed)
    H, W = SHAPE
    return {'rgb': rng.rand(B, H, W, 3).astype(np.float32),
            'depth': ((rng.rand(B, H, W, 1) * 10 + 1) *
                      (rng.rand(B, H, W, 1) < 0.4)).astype(np.float32),
            'input_depth': ((rng.rand(B, H, W, 1) * 10 + 1) *
                            (rng.rand(B, H, W, 1) < 0.1)).astype(np.float32)}


# ------------------------------------------------------------ quantizers

def test_u8_quantizers_bit_equal_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.rand(20000) * 1.4 - 0.2,
                        (np.arange(256) + 0.5) / 255.0,      # near the ties
                        np.arange(256) / 255.0]).astype(np.float32)
    np.testing.assert_array_equal(
        tq.fake_quant_u8(t(x)).numpy(),
        np.asarray(jax.jit(jq.fake_quant_u8)(x)))
    xt = t(x).requires_grad_(True)
    r = rng.randn(x.size).astype(np.float32)
    y = tq.ste_quant_u8(xt)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jax.jit(jq.ste_quant_u8)(x)))
    (y * t(r)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), r)     # the identity


@pytest.mark.parametrize('bits', [8, 3])
def test_weight_quantizer_bit_equal_jax(bits):
    """HWIO kernels on their last axis and OIHW weights on axis 0, a zero
    channel and a 1e3 channel among them; the gradient is the identity."""
    rng = np.random.RandomState(bits)
    w = rng.randn(3, 3, 8, 16).astype(np.float32)
    w[..., 0] = 0.0
    w[..., 1] *= 1e3
    want = np.asarray(jax.jit(
        lambda v: jq.fake_quant_weight_per_channel(v, bits))(w))
    wt = t(w).requires_grad_(True)
    got = tq.fake_quant_weight_per_channel(wt, bits)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert not np.any(want[..., 0])
    r = rng.randn(*w.shape).astype(np.float32)
    (got * t(r)).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), r)
    oihw = t(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    np.testing.assert_array_equal(
        tq.fake_quant_weight_per_channel(oihw, bits, axis=0).numpy(),
        np.transpose(want, (3, 2, 0, 1)))


def test_quantized_depth_net_bit_equal_jax():
    """The dual-head YAML's model with a PoseNet added: the port's quantized
    parameters, read back as the flax tree, equal JAX's
    quantize_depth_net_params bit for bit; the quantized leaves are exactly
    JAX's (every depth-net `kernel` of ndim >= 2: the convs (OIHW in the
    port), the FiLM generators' 1x1 convs, the masked convs (HWIO)), and
    nothing else changes: biases, BN, MaskedBatchNorm, the fusion gates,
    the pose net, the module's own weights."""
    over = SMALL + ['model.pose_net.name', 'PoseNet']
    jm = j_setup_model(j_parse(CONFIGS['dual'], list(over)))
    batch = _batch()
    batch['rgb_context'] = [batch['rgb']] * 2       # the pose net's input
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch,
                                            train=False))
    variables = randomize_variables(shapes, 7)
    want = jax.jit(jq.quantize_depth_net_params)(variables['params'])
    model = load_flax_variables(t_setup_model(t_parse(CONFIGS['dual'],
                                                      list(over))), variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = flax_tree(model, tq.quantize_depth_net_params(model))

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    quantized = {p for p, v in leaves(variables['params'])
                 if p[0] == 'depth_net' and p[-1] == 'kernel' and v.ndim >= 2}
    assert {p for p, _ in leaves(got)} == quantized
    assert any('mconvs' in p for p in quantized)
    assert any('film' in '/'.join(p) for p in quantized)
    assert any(p[0] == 'pose_net' for p, _ in leaves(variables['params']))
    want_leaves = dict(leaves(want))
    for p, v in leaves(got):
        np.testing.assert_array_equal(v, np.asarray(want_leaves[p]),
                                      err_msg='/'.join(p))
        assert not np.array_equal(v, dict(leaves(variables['params']))[p])
    for p, v in leaves(variables['params']):
        if p not in quantized:
            assert np.array_equal(np.asarray(want_leaves[p]), v)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------- int8 eval

@pytest.fixture(scope='module')
def models():
    """Per kind ('single', 'dual'): the JAX model and config, randomised
    variables, the port's model carrying them, and the jitted JAX eval
    protocol with int8 outputs and int8 weights (flip-TTA for the single
    head), shared by the eval and quick-eval tests."""
    out = {}
    batch = _batch()
    for kind, path in CONFIGS.items():
        jcfg = j_parse(path, list(SMALL))
        jm = j_setup_model(jcfg)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch,
                                                train=False))
        variables = randomize_variables(shapes, 4)
        tcfg = t_parse(path, list(SMALL))
        tm = load_flax_variables(t_setup_model(tcfg), variables).eval()
        out[kind] = {'jcfg': jcfg, 'jm': jm, 'variables': variables,
                     'tcfg': tcfg, 'tm': tm, 'state': EvalState(
                         variables['params'], variables['batch_stats']),
                     'int8_step': j_metrics_step(
                         jm, jcfg.model.params, flip_tta=kind == 'single',
                         int8_outputs=True, int8_weights=True)}
    return out


@pytest.mark.parametrize('kind', ['single', 'dual'])
def test_int8_eval_metrics_step_matches_jax(models, kind):
    m = models[kind]
    batch = _batch()
    want = m['int8_step'](m['state'], batch)
    got = t_metrics_step(m['tm'], m['tcfg'].model.params,
                         flip_tta=kind == 'single', int8_outputs=True,
                         int8_weights=True)({k: t(v) for k, v in
                                             batch.items()})
    modes = ['depth', 'depth_gt'] + (
        ['depth_lin', 'depth_lin_gt', 'depth_log', 'depth_log_gt']
        if kind == 'single' else [])
    assert sorted(got) == sorted(want) == sorted(modes)
    for mode in want:
        np.testing.assert_allclose(got[mode].numpy(), np.asarray(want[mode]),
                                   atol=1e-4, err_msg=mode)
    # the int8 protocol is not the float one
    fp = t_metrics_step(m['tm'], m['tcfg'].model.params,
                        flip_tta=kind == 'single')({k: t(v) for k, v in
                                                    batch.items()})
    assert not np.allclose(fp['depth'].numpy(), got['depth'].numpy())


def test_quick_eval_matches_jax_on_int8_weights(models, capsys):
    """Under model.params.qat 'weights' (and int8_outputs, flip-TTA) the
    trainer's quick eval scores the int8 weights: its RGB and RGB+LiDAR
    abs_rel equal the JAX metrics step's with int8 weights on the same
    weights and batch (the RGB one on the batch without LiDAR), as JAX
    Trainer.quick_eval through `_get_metrics_step` computes them."""
    m = models['single']
    cfg = t_parse(CONFIGS['single'], SMALL + [
        'model.params.qat', 'weights', 'model.params.int8_outputs', True,
        'model.params.flip_tta', True, 'arch.eval_subset_size', 2])
    tr = trainer.Trainer(cfg, device='cpu', model=m['tm'])
    batch = _batch()
    got = tr.quick_eval([batch], 1, 4)
    assert 'abs_rel RGB' in capsys.readouterr().out
    rgb = {k: v for k, v in batch.items() if k != 'input_depth'}
    want_rgbd = float(m['int8_step'](m['state'], batch)['depth'][0])
    want_rgb = float(m['int8_step'](m['state'], rgb)['depth'][0])
    np.testing.assert_allclose(got['rgbd'], want_rgbd, atol=1e-4)
    np.testing.assert_allclose(got['rgb'], want_rgb, atol=1e-4)
    cfg.model.params.qat = ''
    float_eval = trainer.Trainer(cfg, device='cpu', model=m['tm']).quick_eval(
        [batch], 1, 4)
    assert abs(float_eval['rgbd'] - got['rgbd']) > 1e-4


# ------------------------------------------------- save pass and the CLIs

@pytest.fixture(scope='module')
def dual_ckpt(models, tmp_path_factory):
    """An NCDB tree (3 frames at 32x48, read at 32x64) and a checkpoint of
    the dual-head model, written by the port, its test split on the tree."""
    d = tmp_path_factory.mktemp('dual')
    root = str(d / 'ncdb')
    os.makedirs(root)
    make_ncdb_tree(root)
    over = ['datasets.test.path', [root], 'datasets.test.split',
            ['split.json'], 'datasets.test.batch_size', 1,
            'datasets.test.num_workers', 1, 'checkpoint.filepath', '']
    cfg = t_parse(CONFIGS['dual'], SMALL + over)
    path = save_checkpoint(str(d / 'dual.ckpt'), cfg, models['dual']['tm'])
    return {'dir': d, 'root': root, 'ckpt': path, 'over': over}


def _files(folder):
    return sorted(str(p.relative_to(folder)) for p in Path(folder).rglob('*')
                  if p.is_file())


def test_dual_save_pass_under_qat_writes_what_jax_writes(models, dual_ckpt):
    """The save pass of a dual-head model under QAT on weights and outputs
    and with int8_outputs / int8_weights set: 1 / max(dual_head_to_depth,
    1e-6) of the FLOAT weights, as JAX `_save_eval_outputs` writes it
    (its eval state's params, no quantizer)."""
    m, d = models['dual'], dual_ckpt['dir']
    flags = ['model.params.qat', 'weights+outputs',
             'model.params.int8_outputs', True, 'model.params.int8_weights',
             True]
    folders = {k: str(d / k) for k in ('port_save', 'jax_save')}
    cfg = t_parse(CONFIGS['dual'], SMALL + dual_ckpt['over'] + flags + [
        'save.folder', folders['port_save']])
    loader = trainer.make_loader(cfg, 'test')
    assert trainer.save_eval_outputs(cfg, m['tm'], loader) == 3

    jcfg = j_parse(CONFIGS['dual'], SMALL + dual_ckpt['over'] + flags + [
        'save.folder', folders['jax_save']])
    jm = m['jm']

    @jax.jit
    def inv(b):
        out = jm.apply({'params': m['variables']['params'],
                        'batch_stats': m['variables']['batch_stats']}, b,
                       train=False)
        depth = jdepth.dual_head_to_depth(out[('integer', 0)],
                                          out[('fractional', 0)], 15.0)
        return 1.0 / jnp.maximum(depth, 1e-6)

    for batch in loader:
        dev = {k: np.asarray(v) for k, v in batch.items()
               if k in ('rgb', 'input_depth')}
        j_save_depth(batch, np.asarray(inv(dev)), jcfg.save,
                     jcfg.datasets.test, ckpt_name='model')
    files = _files(folders['jax_save'])
    assert len(files) == 3 * 4 and files == _files(folders['port_save'])
    for f in files:
        got, want = (Path(folders[k]) / f for k in ('port_save', 'jax_save'))
        if f.endswith('.npz'):
            np.testing.assert_allclose(np.load(got)['depth'],
                                       np.load(want)['depth'], rtol=1e-5)
        elif f.endswith('_rgb.png'):
            assert got.read_bytes() == want.read_bytes(), f


def test_dual_head_clis(models, dual_ckpt, tmp_path):
    """infer.py on a dual-head checkpoint against JAX scripts/infer.py on
    one frame; eval.test --int8 --int8-weights equals `evaluate` with
    those flags on the checkpoint's model."""
    import sys
    sys.path.insert(0, str(ROOT / 'scripts'))
    try:
        import infer as jax_infer
    finally:
        sys.path.remove(str(ROOT / 'scripts'))
    frame = os.path.join(dual_ckpt['root'], 'synced_data', 'image_a6',
                         'frame_0001.png')
    save = ('npz', 'png', 'viz')
    jax_infer.infer_and_save_depth(dual_ckpt['ckpt'], frame,
                                   str(tmp_path / 'jax'), image_shape=SHAPE,
                                   save=save)
    port_infer.infer_and_save_depth(dual_ckpt['ckpt'], frame,
                                    str(tmp_path / 'port'), image_shape=SHAPE,
                                    save=save, device='cpu')
    files = _files(tmp_path / 'jax')
    assert files == _files(tmp_path / 'port') == [
        'frame_0001.npz', 'frame_0001.png', 'frame_0001_viz.png']
    for f in files:
        got, want = tmp_path / 'port' / f, tmp_path / 'jax' / f
        if f.endswith('.npz'):
            np.testing.assert_allclose(np.load(got)['depth'],
                                       np.load(want)['depth'], rtol=1e-5)
        else:
            with Image.open(got) as a, Image.open(want) as b:
                diff = np.abs(np.asarray(a, np.int64) -
                              np.asarray(b, np.int64))
            assert diff.max() <= (1 if f.endswith('_viz.png') else 0), f

    got = port_eval.test(dual_ckpt['ckpt'], int8=True, int8_weights=True,
                         device='cpu')
    cfg = t_parse(CONFIGS['dual'], SMALL + dual_ckpt['over'] + [
        'model.params.int8_outputs', True, 'model.params.int8_weights',
        True])
    want = trainer.evaluate(cfg, models['dual']['tm'],
                            trainer.make_loader(cfg, 'test'))
    assert len(want) == 2 * 7 + 1 and got.skipped == 0
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    fp = port_eval.test(dual_ckpt['ckpt'], device='cpu')
    assert fp['abs_rel'] != got['abs_rel']
