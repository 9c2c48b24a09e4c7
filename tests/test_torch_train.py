"""The PyTorch port's training path against the JAX package's, on the CPU
in float32, with the same (randomised) variables carried across by
packnet_sfm_tpu_torch.utils.flax_weights and inputs drawn with numpy:
train-mode BatchNorm and MaskedBatchNorm, the masked max-pool's gradient
with tied zeros, the supervised losses, the lr schedules, the optimizer
against optax on the same gradients, the whole SemiSupCompletionModel
train step (ResNetSAN01 18A, FiLM, sparse-ssi-silog; with and without
san_row_window) against JAX make_train_step (one compile a window serves
both: the first step's gradients are recorded before the clip), the
non-finite guard, train.main, and evaluate on a training-mode model.

Tolerances, each with its reason:
- module outputs, statistics and gradients: atol 1e-5 x max|value|
  (float32 sums in another order);
- losses and metrics of the whole step: rtol 1e-5 (measured <= 1.4e-6);
- gradient leaves of the whole step: |g - g_jax| <= 2e-2 |g_jax| + 1e-8 in
  the Frobenius norm of each leaf (measured <= 6.1e-3). The gradients are
  ill-conditioned at this size, not the port: flipping the batch order in
  the port alone moves single entries by 0.7% of their leaf's max (ReLU and
  max-pool decisions near ties, BN over 12 samples at the 1/32 level). The
  30 masked-conv biases that feed a BN have a zero gradient analytically;
  both frameworks give < 1.4e-9 there, which the 1e-8 floor takes;
- BN running statistics after one step: atol 1e-4 x max|value| (measured
  8.9e-6 relative);
- after three Adam steps: losses rtol 2e-4 (measured 2.5e-5). Adam divides
  each gradient entry by its own magnitude, so entries whose gradient is
  within rounding of zero move by +-lr in either framework: the parameter
  updates agree in sign on >= 97% of the entries that move (measured
  98.8%, 99.1% with the row window) and to a relative norm <= 0.15 over
  all parameters (measured 0.073, 0.061); statistics to 5e-2 of their
  leaf's max (measured 1.6e-2). The optimizer itself is held to optax
  tightly on identical gradients.
"""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.losses import supervised as jsup
from packnet_sfm_tpu.losses.photometric import ProgressiveScaling as JPS
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.networks.layers import san as jsan
from packnet_sfm_tpu.ops import image as jimage
from packnet_sfm_tpu.parallel.train_step import (
    TrainState, make_lr_schedule as j_lr, make_optimizer as j_make_opt,
    make_train_step as j_make_step)
from packnet_sfm_tpu.trainers.trainer import Trainer as JTrainer
from packnet_sfm_tpu_torch import eval as port_eval
from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.eval import make_batches
from packnet_sfm_tpu_torch.losses import supervised as tsup
from packnet_sfm_tpu_torch.losses.photometric import ProgressiveScaling
from packnet_sfm_tpu_torch.models.factory import setup_model as t_setup_model
from packnet_sfm_tpu_torch.models.sfm import SfmModel
from packnet_sfm_tpu_torch.networks.layers import resnet as tresnet
from packnet_sfm_tpu_torch.networks.layers import san as tsan
from packnet_sfm_tpu_torch.ops import image as timage
from packnet_sfm_tpu_torch.parallel.train_step import (
    make_lr_schedule as t_lr, make_optimizer as t_make_opt,
    make_train_step as t_make_step)
from packnet_sfm_tpu_torch.trainers.trainer import evaluate
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_state_dict, load_flax_variables)
from tests.torch_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

CONFIG = str(Path(__file__).resolve().parents[1] / 'configs' /
             'train_resnet_san_ncdb_640x384.yaml')
SMALL = ['tpu.compute_dtype', 'float32']
SHAPE = (64, 96)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, rel=1e-5, name=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=name)


def randomize(shapes, seed):
    """Every leaf drawn with numpy: kernels at 1/sqrt(fan-in), BN scales
    and variances in [0.5, 1.5], everything else at 0.1 N(0, 1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == 'kernel':
            return (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))
                    ).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# ------------------------------------------------------------------ layers

def test_masked_batch_norm_train_matches_flax():
    rng = np.random.RandomState(0)
    mask = (rng.rand(2, 8, 12, 1) < 0.4).astype(np.float32)
    x = ((rng.randn(2, 8, 12, 16) + 2.0) * mask).astype(np.float32)
    r = rng.randn(2, 8, 12, 16).astype(np.float32)
    jm = jsan.MaskedBatchNorm()
    v = randomize(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), x, mask, train=False)), 1)

    def f(x_, params):
        y, mut = jm.apply({'params': params, 'batch_stats': v['batch_stats']},
                          x_, mask, train=True, mutable=['batch_stats'])
        return (y * r).sum(), (y, mut['batch_stats'])

    (_, (want_y, want_bs)), (want_dx, want_dp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(x, v['params'])
    tm = load_flax_variables(tsan.MaskedBatchNorm(16), v).train()
    xt = t(x).requires_grad_(True)
    y = tm(xt, t(mask))
    (y * t(r)).sum().backward()
    close(y.detach(), want_y)
    close(xt.grad, want_dx)
    close(tm.scale.grad, want_dp['scale'])
    close(tm.bias.grad, want_dp['bias'])
    close(tm.mean, want_bs['mean'])
    close(tm.var, want_bs['var'])


def test_batch_norm_train_matches_flax():
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 5, 7, 8) * 2 + 3).astype(np.float32)    # NHWC
    r = rng.randn(3, 5, 7, 8).astype(np.float32)
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.float32)
    v = randomize(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x)),
                  3)

    def f(x_, params):
        y, mut = jm.apply({'params': params, 'batch_stats': v['batch_stats']},
                          x_, mutable=['batch_stats'])
        return (y * r).sum(), (y, mut['batch_stats'])

    (_, (want_y, want_bs)), (want_dx, want_dp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(x, v['params'])
    tm = load_flax_variables(tresnet.BatchNorm(8), v).train()
    xt = t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = tm(xt)
    (y * t(r).permute(0, 3, 1, 2)).sum().backward()
    close(y.detach().permute(0, 2, 3, 1), want_y)
    close(xt.grad.permute(0, 2, 3, 1), want_dx)
    close(tm.weight.grad, want_dp['scale'])
    close(tm.bias.grad, want_dp['bias'])
    # biased variance, 0.9 on the old value (F.batch_norm's own update
    # would take the unbiased one)
    close(tm.running_mean, want_bs['mean'])
    close(tm.running_var, want_bs['var'])


def test_masked_max_pool_gradient_with_tied_zeros():
    rng = np.random.RandomState(4)
    mask = np.zeros((2, 13, 18, 1), np.float32)
    mask[:, 6:] = rng.rand(2, 7, 18, 1) < 0.6      # top windows all inactive
    x = np.maximum(rng.randn(2, 13, 18, 5), 0.0)   # ReLU: many exact zeros
    x[:, 9:, :9] = 0.0                             # windows of tied zeros
    x = (x * mask).astype(np.float32)
    r = rng.randn(2, 7, 9, 5).astype(np.float32)

    def f(x_):
        return (jsan.masked_max_pool(x_, jnp.asarray(mask))[0] * r).sum()

    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(x)))
    xt = t(x).requires_grad_(True)
    (tsan.masked_max_pool(xt, t(mask))[0] * t(r)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert np.all(want[np.broadcast_to(mask == 0, want.shape)] == 0)


def test_paste_rows_is_differentiable():
    x = torch.randn(2, 4, 5, 3, requires_grad=True)
    out = tsan.paste_rows(x, 2, 9)
    y = out.detach()
    assert out.shape == (2, 9, 5, 3)
    assert torch.equal(y[:, 2:6], x.detach()) and not y[:, :2].any()
    (out * torch.arange(9.0)[None, :, None, None]).sum().backward()
    assert torch.equal(x.grad[0, :, 0, 0], torch.arange(2.0, 6.0))


# ------------------------------------------------------------------ losses

def _loss_inputs(seed, valid_frac=0.3, B=2, H=24, W=32):
    rng = np.random.RandomState(seed)
    gt = ((rng.rand(B, H, W, 1) * 2 + 0.07) *
          (rng.rand(B, H, W, 1) < valid_frac)).astype(np.float32)
    preds = [(rng.rand(B, H // 2 ** i, W // 2 ** i, 1) * 2 + 0.07
              ).astype(np.float32) for i in range(4)]
    return preds, gt


LOSS_KW = (('min_depth', 0.5), ('max_depth', 15.0), ('ssi_weight', 0.7),
           ('silog_weight', 0.3), ('alpha', 0.85), ('silog_ratio2', 0.85),
           ('gradient_weight', 0.0), ('gradient_scales', 4))


@pytest.mark.parametrize('method', [
    'sparse-ssi-silog', 'sparse-l1', 'sparse-mse', 'sparse-berhu',
    'sparse-silog', 'sparse-abs_rel', 'sparse-ssi', 'sparse-enhanced-ssi',
    'sparse-progressive-ssi', 'sparse-ssi-trim', 'l1', 'ssi-silog'])
def test_supervised_loss_matches_jax(method):
    preds, gt = _loss_inputs(5)
    jl = jsup.SupervisedLoss(method, 4, 0.0, LOSS_KW)
    tl = tsup.SupervisedLoss(method, 4, 0.0, LOSS_KW)

    def f(ps):
        out = jl(ps, jnp.asarray(gt), progress=0.3, epoch=4)
        return out['loss'], out['metrics']

    (want, want_m), want_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        [jnp.asarray(p) for p in preds])
    pt = [t(p).requires_grad_(True) for p in preds]
    got = tl(pt, t(gt), progress=0.3, epoch=4)
    got['loss'].backward()
    assert sorted(got['metrics']) == sorted(want_m)
    for k in want_m:
        close(got['metrics'][k].detach(), want_m[k], name=k)
    for p, g in zip(pt, want_g):
        close(p.grad, g, rel=1e-4)


def test_ssi_silog_below_100_valid_pixels_is_zero():
    preds, gt = _loss_inputs(6)
    flat = gt.reshape(-1)
    flat[np.flatnonzero(flat > 0)[99:]] = 0.0        # exactly 99 valid
    for fn in (jsup.ssi_silog_loss, tsup.ssi_silog_loss):
        pred, g_ = (preds[0], gt) if fn is jsup.ssi_silog_loss else (
            t(preds[0]), t(gt))
        m = g_ > 0
        assert float(fn(pred, g_, m)) == 0.0
    # one more valid pixel gives the loss back
    gt2 = gt.copy()
    gt2[gt2 == 0] = 1.0
    assert float(tsup.ssi_silog_loss(t(preds[0]), t(gt2), t(gt2) > 0)) > 0


def test_ssi_silog_gradient_term_matches_jax():
    preds, gt = _loss_inputs(7, valid_frac=0.6)
    m = (gt > 0).astype(np.float32)
    want = jax.jit(lambda p, g, m_: jsup.ssi_silog_loss(
        p, g, m_, min_depth=0.5, max_depth=15.0, gradient_weight=0.5,
        gradient_scales=3))(preds[0], gt, m)
    got = tsup.ssi_silog_loss(t(preds[0]), t(gt), t(m), min_depth=0.5,
                              max_depth=15.0, gradient_weight=0.5,
                              gradient_scales=3)
    close(got, want)


@pytest.mark.parametrize('ps,progress', [(0.0, 0.5), (0.2, 0.1), (0.2, 0.3),
                                         (0.2, 0.4), (0.3, 0.95)])
def test_progressive_scaling_and_match_scales(ps, progress):
    assert ProgressiveScaling(ps, 4)(progress) == JPS(ps, 4)(progress)
    x = np.random.RandomState(8).rand(2, 16, 24, 1).astype(np.float32)
    shapes = [(16, 24), (8, 12), (4, 6), (32, 48)]
    for a, b in zip(timage.match_scales(t(x), shapes, 4, mode='nearest'),
                    jimage.match_scales(x, shapes, 4, mode='nearest')):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_jax_trainer_quantizes_progress_one_segment_back():
    """A fault of the JAX trainer recorded in ROADMAP.md: with
    progressive_scaling > 0 it quantizes progress to the last break
    crossed, whose scale count is that of the segment before; the port
    passes the raw progress."""
    fake = types.SimpleNamespace(_progressive=0.2)
    quantized = JTrainer._quantize_progress(fake, 0.3)
    assert JPS(0.2, 4)(0.3) == ProgressiveScaling(0.2, 4)(0.3) == 3
    assert JPS(0.2, 4)(quantized) == 4


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize('cfg', [
    {'name': 'StepLR', 'step_size': 2, 'gamma': 0.5},
    {'name': 'CosineAnnealingLR', 'T_max': 3},
    {'name': 'StepLR', 'step_size': 1, 'gamma': 0.1, 'warmup_epochs': 1.5},
    {'name': 'Constant'}])
def test_lr_schedule_matches_jax(cfg):
    ts, js = t_lr(cfg, 2e-4, 3), j_lr(cfg, 2e-4, 3)
    for count in range(20):
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-6)


class _TwoGroups(torch.nn.Module):
    def __init__(self, shapes):
        super().__init__()
        for net, leaves in shapes.items():
            mod = torch.nn.Module()
            for name, shape in leaves.items():
                setattr(mod, name, torch.nn.Parameter(torch.zeros(shape)))
            setattr(self, net, mod)


def test_optimizer_matches_optax_on_the_same_gradients():
    """Depth and pose groups with their own lr and weight decay, the global
    clip on and off across steps, a StepLR boundary: params after every
    step at rtol 1e-5 (float32 arithmetic in another order)."""
    rng = np.random.RandomState(9)
    shapes = {'depth_net': {'a': (4, 3), 'b': (5,)},
              'pose_net': {'c': (2, 2)}}
    params = {n: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
              for n, d in shapes.items()}
    opt_cfg = {'name': 'Adam', 'depth': {'lr': 2e-3, 'weight_decay': 0.01},
               'pose': {'lr': 1e-3, 'weight_decay': 0.0}}
    sched = {'name': 'StepLR', 'step_size': 1, 'gamma': 0.5}
    jtx = j_make_opt(opt_cfg, sched, 2, clip_grad=10.0)
    jstate = jtx.init(params)
    update = jax.jit(jtx.update)
    model = _TwoGroups(shapes)
    with torch.no_grad():
        for n, d in params.items():
            for k, v in d.items():
                getattr(getattr(model, n), k).copy_(t(v))
    opt = t_make_opt(model, opt_cfg, sched, 2, clip_grad=10.0)
    jp = params
    for step in range(5):
        scale = 20.0 if step % 2 else 0.5        # clip on odd steps only
        grads = {n: {k: (rng.randn(*s) * scale).astype(np.float32)
                     for k, s in d.items()} for n, d in shapes.items()}
        updates, jstate = update(grads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for n, d in grads.items():
            for k, g in d.items():
                getattr(getattr(model, n), k).grad = t(g).clone()
        opt.step()
        for n, d in jp.items():
            for k, v in d.items():
                np.testing.assert_allclose(
                    getattr(getattr(model, n), k).detach().numpy(),
                    np.asarray(v), rtol=1e-5, atol=1e-7,
                    err_msg='{} {}.{}'.format(step, n, k))
    assert opt.count == 5


def test_optimizer_refuses_what_is_not_ported():
    model = _TwoGroups({'depth_net': {'a': (2,)}})
    sched = {'name': 'StepLR'}
    for cfg in ({'name': 'SGD'}, {'name': 'Adam', 'grad_accumulation_steps': 2},
                {'name': 'Adam', 'ema_decay': 0.99}):
        with pytest.raises(NotImplementedError):
            t_make_opt(model, cfg, sched, 1)


# -------------------------------------------------------- whole train step

@pytest.fixture(scope='module')
def setup():
    """Randomised variables of the slice's model (float32) and one batch."""
    jm = j_setup_model(j_parse(CONFIG, list(SMALL)))
    batch = make_batches(SHAPE, 2, 1, seed=3, device='cpu')[0]
    np_batch = {k: v.numpy() for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), np_batch,
                                            train=False))
    return randomize(shapes, 4), batch, np_batch


def _configs(window):
    # the JAX masked conv runs its XLA form, the reference of the kernels
    assert jsan.SAN_CONV_IMPL == 'xla'
    over = list(SMALL) + ['model.depth_net.san_row_window', window]
    return j_parse(CONFIG, list(over)), t_parse(CONFIG, list(over))


def _recording(tx):
    """optax's `tx` behind a transformation that keeps the raw gradients
    of the last update as its state, unchanged otherwise."""
    record = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    return optax.chain(record, tx)


@pytest.fixture(scope='module')
def jax_steps(setup):
    """window -> three steps of JAX make_train_step (its value_and_grad of
    the model's loss, the clip, Adam; one compile a window) from the
    randomised variables: step 1's loss, metrics, gradients (recorded
    before the clip) and statistics, and each step's loss and state."""
    variables, _, np_batch = setup
    runs = {}

    def run(window):
        if window not in runs:
            jcfg, _ = _configs(window)
            jm = j_setup_model(jcfg)
            jtx = _recording(j_make_opt(
                jcfg.model.optimizer, jcfg.model.scheduler, 1,
                clip_grad=jcfg.arch.clip_grad))
            state = TrainState(params=variables['params'],
                               batch_stats=variables['batch_stats'],
                               opt_state=jax.jit(jtx.init)(
                                   variables['params']),
                               step=jnp.zeros((), jnp.int32),
                               epoch=jnp.zeros((), jnp.int32))
            jstep = j_make_step(jm, jtx, donate=False)
            out = {'losses': []}
            for i in range(3):
                state, metrics = jstep(state, np_batch,
                                       jax.random.PRNGKey(0), 0.0)
                out['losses'].append(float(metrics['loss']))
                if i == 0:
                    out['first'] = {
                        'metrics': {k: v for k, v in metrics.items()
                                    if k != 'loss'},
                        'grads': state.opt_state[0],
                        'stats': state.batch_stats}
            out['state'] = state
            runs[window] = out
        return runs[window]
    return run


@pytest.mark.parametrize('window', [0.0, 0.67])
def test_train_step_loss_metrics_gradients_match_jax(setup, jax_steps,
                                                     window):
    variables, batch, np_batch = setup
    _, tcfg = _configs(window)
    jrun = jax_steps(window)
    jloss, jmetrics = jrun['losses'][0], jrun['first']['metrics']
    jgrads, jstats = jrun['first']['grads'], jrun['first']['stats']

    tm = load_flax_variables(t_setup_model(tcfg), variables).train()
    out = tm(batch)
    out['loss'].backward()
    np.testing.assert_allclose(float(out['loss'].detach()), float(jloss),
                               rtol=1e-5)
    assert sorted(out['metrics']) == sorted(jmetrics) == sorted(
        ['s0/loss', 's0/valid_ratio', 'supervised_loss',
         'supervised_loss_rgbd', 'feature_consistency_loss',
         'consistency_loss'])
    for k in jmetrics:
        np.testing.assert_allclose(float(out['metrics'][k].detach()),
                                   float(jmetrics[k]), rtol=1e-5, err_msg=k)
    want = flax_state_dict(tm, {'params': jgrads, 'batch_stats': jstats})
    params = dict(tm.named_parameters())
    assert len(params) == len(jax.tree_util.tree_leaves(jgrads)) > 150
    for name, p in params.items():
        g, w = p.grad.numpy(), want[name]
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) + 1e-8, name
    state = tm.state_dict()
    for name in want:
        if name not in params:
            close(state[name], want[name], rel=1e-4, name=name)


@pytest.mark.parametrize('window', [0.0, 0.67])
def test_three_adam_steps_match_jax_make_train_step(setup, jax_steps,
                                                    window):
    variables, batch, np_batch = setup
    _, tcfg = _configs(window)
    jrun = jax_steps(window)
    state = jrun['state']
    tm = load_flax_variables(t_setup_model(tcfg), variables)
    opt = t_make_opt(tm, tcfg.model.optimizer, tcfg.model.scheduler, 1,
                     clip_grad=tcfg.arch.clip_grad)
    tstep = t_make_step(tm, opt)
    for jloss in jrun['losses']:
        tmetrics = tstep(batch)
        np.testing.assert_allclose(float(tmetrics['loss']), jloss,
                                   rtol=2e-4)
    assert opt.count == 3 and int(state.step) == 3

    before = flax_state_dict(tm, variables)
    want = flax_state_dict(tm, {'params': state.params,
                                'batch_stats': state.batch_stats})
    got = tm.state_dict()
    params = dict(tm.named_parameters())
    dt = np.concatenate([(got[k].numpy() - before[k]).ravel()
                         for k in params])
    dj = np.concatenate([(want[k] - before[k]).ravel() for k in params])
    moved = dj != 0
    # under the row window the SAN levels are 1-2 rows tall at this size:
    # a third of the kernel taps see only padding and never move
    assert moved.mean() > 0.5
    assert (np.sign(dt[moved]) == np.sign(dj[moved])).mean() >= 0.97
    assert np.linalg.norm(dt - dj) <= 0.15 * np.linalg.norm(dj)
    for name in want:
        if name not in params:
            close(got[name], want[name], rel=5e-2, name=name)


def test_non_finite_guard_keeps_params_and_adam_state(setup):
    variables, batch, _ = setup
    _, tcfg = _configs(0.0)
    tm = load_flax_variables(t_setup_model(tcfg), variables)
    opt = t_make_opt(tm, tcfg.model.optimizer, tcfg.model.scheduler, 1,
                     clip_grad=tcfg.arch.clip_grad)
    step = t_make_step(tm, opt)
    assert np.isfinite(float(step(batch)['loss'])) and opt.count == 1

    def snapshot():
        adam = [{k: v.clone() for k, v in s.items()}
                for s in opt.adam.state.values()]
        return ({k: v.clone() for k, v in tm.state_dict().items()}, adam)

    (state0, adam0) = snapshot()
    tm.weight_rgbd = float('nan')               # the loss turns NaN
    assert not np.isfinite(float(step(batch)['loss']))
    state1, adam1 = snapshot()
    assert opt.count == 1
    params = dict(tm.named_parameters())
    moved_stats = 0
    for k, v in state1.items():
        if k in params:
            assert torch.equal(v, state0[k]), k
        elif not k.endswith('num_batches_tracked'):
            assert bool(torch.isfinite(v).all()), k
            moved_stats += not torch.equal(v, state0[k])
    assert moved_stats == sum(1 for k in state0 if k.endswith(
        ('mean', 'var'))), 'every BN statistic moves, as in JAX'
    for a, b in zip(adam0, adam1):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert all(p.grad is None for p in tm.parameters())


def test_sfm_model_flips_with_its_generator():
    class Net(torch.nn.Module):
        def forward(self, rgb, input_depth=None):
            # not flip-equivariant: the column index enters the output
            cols = torch.arange(rgb.shape[2], dtype=rgb.dtype)[None, None, :,
                                                               None]
            return {'inv_depths': [rgb[..., :1] * 0 + cols]}

    rgb = torch.rand(1, 4, 6, 3)
    for prob, want in ((1.0, torch.arange(6.0).flip(0)), (0.0, None)):
        m = SfmModel(Net(), flip_lr_prob=prob).train()
        out = m({'rgb': rgb}, generator=torch.Generator().manual_seed(0))
        got = out['inv_depths'][0][0, 0, :, 0]
        if want is None:
            want = torch.arange(6.0)
        assert torch.equal(got, want)


def test_train_main_on_cpu_and_refuses_missing_cuda():
    run = port_train.main(
        CONFIG, device='cpu', n_steps=3, n_batches=2, seed=0,
        overrides=['datasets.train.batch_size', 2,
                   'datasets.augmentation.image_shape', SHAPE])
    assert len(run['losses']) == 3 and np.all(np.isfinite(run['losses']))
    assert run['trainer'].optimizer.count == 3
    assert run['trainer'].current_epoch == 2
    assert run['batches'][0]['rgb'].shape == (2,) + SHAPE + (3,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            port_train.main(CONFIG)


def test_evaluate_runs_a_training_mode_model_in_eval_mode():
    """A model handed over in training mode (as train.build and train.main
    return it) is evaluated with the eval forward: the same metrics as
    eval.main on the same seeded weights, and no BN statistic moves."""
    over = ['datasets.augmentation.image_shape', SHAPE]
    want = port_eval.main(CONFIG, device='cpu', batch_size=1, n_batches=2,
                          seed=0, overrides=list(over))
    config, model = port_train.build(CONFIG, 'cpu', seed=0,
                                     overrides=list(over))
    assert model.training
    batches = make_batches(SHAPE, 1, 2, seed=0, device='cpu')
    got = evaluate(config, model, batches)
    assert not model.training
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)

    run = port_train.main(CONFIG, device='cpu', n_steps=1, n_batches=1,
                          seed=0, overrides=list(over) + [
                              'datasets.train.batch_size', 2])
    stats = {k: v.clone() for k, v in run['model'].state_dict().items()}
    first = evaluate(run['config'], run['model'], batches)
    assert evaluate(run['config'], run['model'], batches) == first
    for k, v in run['model'].state_dict().items():
        assert torch.equal(v, stats[k]), k
