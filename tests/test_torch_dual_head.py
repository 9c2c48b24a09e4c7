"""The port's dual-head path against the JAX package's, on the CPU in
float32: the dual-head helpers of ops/depth.py, DualHeadDepthLoss (an odd
and an even valid count for the lower median, a GT of another shape, an
empty mask), and one training step of the NCDB dual-head YAML's
ResNet18-SAN (FiLM, input depth) at B2 32x64 under model.params.qat '',
'outputs', 'weights' and 'weights+outputs', then three Adam steps under
'weights+outputs'.

The JAX side is JAX's own code, composed as its make_train_step composes
it: the model's forward (`forward_base`, train mode, the batch statistics
mutable) over the parameters or over `quantize_depth_net_params` of them,
the model's own loss on the forward's outputs (SemiSupCompletionModel
with its dual-head branch and, under 'outputs', ste_quant_u8), and the
gradient through both. The straight-through weight quantizer passes the
gradient unchanged, so the gradient of the latent weights is the
network's gradient at the quantized weights. The network's forward and
its VJP compile once and serve all four settings; the loss is a small
program per value of qat_outputs.

Tolerances, with their reasons:
- the loss function: loss and metrics rtol 1e-6, the heads' gradients
  atol 1e-6 x max (the same float32 operations, sums in another order);
- the step: loss and metrics rtol 1e-5; gradients per leaf
  |g - g_jax| <= 2e-2 |g_jax| + 1e-8 in norm; statistics atol 1e-4 x max
  (tests/test_torch_train.py's limits and reasons);
- u8 ties under 'outputs': the two frameworks' sigmoids differ by float32
  rounding (~1e-7), which moves a u8 code by one step where x * 255 sits
  that close to a .5 tie. The rule: at most 4 codes of the loss's heads
  differ, each by exactly one step; the port's loss and metrics are what
  the JAX model's loss gives on the port's own heads (rtol 1e-5: sums
  over the 4096 pixels in another order); and the two losses differ by
  at most rtol 1e-5 plus, per flipped code, the most one step of that
  head can move the loss;
- three Adam steps: losses rtol 2e-4 plus the flip allowance (after the
  first update any number of codes may flip, each by one step), updates in
  sign on >= 97% of the moved entries and to a relative norm <= 0.15,
  statistics 5e-2 of their leaf's max (tests/test_torch_train.py).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.losses.dual_head import DualHeadDepthLoss as JLoss
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.ops import depth as jdepth
from packnet_sfm_tpu.ops import quantization as jq
from packnet_sfm_tpu.parallel.train_step import make_optimizer as j_make_opt
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.losses import DualHeadDepthLoss
from packnet_sfm_tpu_torch.models.factory import setup_model as t_setup_model
from packnet_sfm_tpu_torch.ops import depth as tdepth
from packnet_sfm_tpu_torch.ops import quantization as tq
from packnet_sfm_tpu_torch.parallel.train_step import (
    make_optimizer as t_make_opt, make_train_step as t_make_step)
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_state_dict, load_flax_variables)
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import randomize_variables

pytestmark = pytest.mark.usefixtures('one_torch_thread')

CONFIGS = Path(__file__).resolve().parents[1] / 'configs'
DUAL = str(CONFIGS / 'train_resnet_san_ncdb_dual_head_640x384.yaml')
SHAPE = (32, 64)
SMALL = ['tpu.compute_dtype', 'float32',
         'datasets.augmentation.image_shape', SHAPE]
QAT = ('', 'outputs', 'weights', 'weights+outputs')
# the training heads, in a fixed order (a jitted function cannot return
# tuple keys beside the model's str keys)
KEYS = [(h, i) for i in range(4) for h in ('integer', 'fractional')]
LOSS_HEADS = [('integer', 0), ('fractional', 0)]
METRICS = ['integer_loss', 'fractional_loss', 'consistency_loss',
           'total_loss', 'mean_depth_error', 'median_depth_error',
           'integer_accuracy', 'fractional_rmse']


def t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ the helpers

def test_dual_head_depth_helpers_match_jax():
    rng = np.random.RandomState(0)
    depth = (rng.rand(2, 6, 7, 1) * 20).astype(np.float32)
    integer, frac = (rng.rand(2, 2, 6, 7, 1).astype(np.float32))
    for got, want in zip(tdepth.decompose_depth(t(depth), 15.0),
                         jdepth.decompose_depth(depth, 15.0)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tdepth.dual_head_to_inv_depth(t(integer), t(frac), 15.0, 0.5).numpy(),
        np.asarray(jdepth.dual_head_to_inv_depth(integer, frac, 15.0, 0.5)))
    np.testing.assert_allclose(
        tdepth.sigmoid_to_depth_log(t(integer), 0.5, 15.0).numpy(),
        np.asarray(jdepth.sigmoid_to_depth_log(integer, 0.5, 15.0)),
        rtol=1e-6)


def test_quantization_error_report_matches_jax():
    """JAX's report runs outside jit, where fake_quant_u8 divides by 255;
    the port multiplies by 1/255 as JAX's jitted steps do (ops/
    quantization.py). One ulp of a code near 0.5 (6e-8) times max_depth 15
    moves a decoded dual-head depth by 0.9 um: atol 2e-3 mm."""
    got = tq.quantization_error_report()
    want = jq.quantization_error_report()
    assert sorted(got) == sorted(want)
    for design in want:
        for k in want[design]:
            np.testing.assert_allclose(got[design][k], want[design][k],
                                       rtol=1e-4, atol=2e-3,
                                       err_msg=design + k)
    # the reference's analysis: the dual head is ~15x finer at 0.5-15 m
    assert got['dual_head']['max_mm'] < got['single_linear']['max_mm'] / 10


# --------------------------------------------------------------- the loss

def _loss_case(case):
    """(heads {('integer', 0), ('fractional', 0): [2,16,24,1]}, GT)."""
    rng = np.random.RandomState({'odd': 1, 'even': 2, 'resize': 3,
                                 'empty': 4}[case])
    heads = {k: rng.rand(2, 16, 24, 1).astype(np.float32)
             for k in LOSS_HEADS}
    shape = (2, 32, 48, 1) if case == 'resize' else (2, 16, 24, 1)
    gt = (rng.rand(*shape) * 14.0 + 0.6).astype(np.float32)  # all valid
    keep = np.zeros(gt.size, bool)
    if case != 'empty':
        n = {'odd': 301, 'even': 300}.get(case, gt.size // 3)
        keep[rng.choice(gt.size, n, replace=False)] = True
    gt = np.where(keep.reshape(gt.shape), gt, 0.0).astype(np.float32)
    return heads, gt


@pytest.mark.parametrize('case', ['odd', 'even', 'resize', 'empty'])
def test_dual_head_loss_matches_jax(case):
    heads, gt = _loss_case(case)
    kw = dict(max_depth=15.0, min_depth=0.5, integer_weight=1.0,
              fractional_weight=10.0, consistency_weight=0.5)

    def f(hs):
        out = JLoss(**kw)(hs, jnp.asarray(gt))
        return out['loss'], out['metrics']

    (want, want_m), want_g = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in heads.items()})
    th = {k: t(v).requires_grad_(True) for k, v in heads.items()}
    got = DualHeadDepthLoss(**kw)(th, t(gt))
    got['loss'].backward()
    assert sorted(got['metrics']) == sorted(want_m) == sorted(METRICS)
    np.testing.assert_allclose(float(got['loss'].detach()), float(want),
                               rtol=1e-6)
    for k in METRICS:
        np.testing.assert_allclose(float(got['metrics'][k].detach()),
                                   float(want_m[k]), rtol=1e-6, err_msg=k)
    for k in LOSS_HEADS:
        w = np.asarray(want_g[k])
        np.testing.assert_allclose(th[k].grad.numpy(), w, rtol=0,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30))
    if case == 'empty':
        assert float(got['loss'].detach()) == 0.0
    if case in ('odd', 'even'):
        # the LOWER median of the valid errors, not the mean of the middle
        # two (ops/depth.py masked_median)
        depth = tdepth.dual_head_to_depth(t(heads[LOSS_HEADS[0]]),
                                          t(heads[LOSS_HEADS[1]]), 15.0)
        err = (depth - t(gt)).abs()[t(gt) > 0.5].sort().values
        assert float(got['metrics']['median_depth_error'].detach()) == float(
            err[(err.numel() - 1) // 2])


# ------------------------------------------------------ the training step

def _batch(seed=0, B=2):
    """RGB, GT at 40% of the pixels and LiDAR at 10%, 1-11 m (JAX
    tests/test_qat.py)."""
    rng = np.random.RandomState(seed)
    H, W = SHAPE
    return {'rgb': rng.rand(B, H, W, 3).astype(np.float32),
            'depth': ((rng.rand(B, H, W, 1) * 10 + 1) *
                      (rng.rand(B, H, W, 1) < 0.4)).astype(np.float32),
            'input_depth': ((rng.rand(B, H, W, 1) * 10 + 1) *
                            (rng.rand(B, H, W, 1) < 0.1)).astype(np.float32)}


@pytest.fixture(scope='module')
def jax_dual():
    """Randomised variables of the dual-head model and the JAX pieces of its
    step: `forward(params, stats)` -> (the training heads in KEYS order,
    the new statistics); `vjp(params, stats, cotangents)` -> the
    parameters' gradient; `loss[qat_outputs](heads)` -> ((loss, metrics),
    the heads' cotangents) through the model's own loss."""
    batch = _batch()
    models = {qo: j_setup_model(j_parse(DUAL, SMALL + [
        'model.params.qat', 'outputs' if qo else ''])) for qo in (0, 1)}
    jm = models[0]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch,
                                            train=False))
    variables = randomize_variables(shapes, 4)

    def heads(params, stats):
        out, mut = jm.apply({'params': params, 'batch_stats': stats}, batch,
                            train=True, mutable=['batch_stats'],
                            method=lambda m, b, train: m.forward_base(b, train))
        return [out[k] for k in KEYS], mut['batch_stats']

    @jax.jit
    def vjp(params, stats, cots):
        _, back = jax.vjp(lambda p: heads(p, stats)[0], params)
        return back(cots)[0]

    def loss_of(model):
        def f(hs):
            def given(next_fun, args, kwargs, context):
                if context.method_name == 'forward_base':
                    return {**dict(zip(KEYS, hs)), 'poses': None}
                return next_fun(*args, **kwargs)
            with fnn.intercept_methods(given):
                out, _ = model.apply(variables, batch, train=True,
                                     mutable=['batch_stats'])
            return out['loss'], out['metrics']
        return jax.jit(jax.value_and_grad(f, has_aux=True))

    return {'batch': batch, 'variables': variables, 'cfg': j_parse(
        DUAL, list(SMALL)), 'forward': jax.jit(heads), 'vjp': vjp,
        'loss': {qo: loss_of(m) for qo, m in models.items()},
        'quantize': jax.jit(jq.quantize_depth_net_params),
        'fake_quant_u8': jax.jit(jq.fake_quant_u8)}


def _jax_step(jd, params, stats, qat):
    """Loss, metrics, gradients, new statistics and loss heads of one JAX
    step from latent `params` under `qat`."""
    # numpy leaves throughout: the compiled pieces then serve every call
    point = jax.tree_util.tree_map(np.asarray, jd['quantize'](
        params) if 'weights' in qat else params)
    stats = jax.tree_util.tree_map(np.asarray, stats)
    hs, new_stats = jd['forward'](point, stats)
    (loss, metrics), cots = jd['loss']['outputs' in qat](hs)
    grads = jd['vjp'](point, stats, cots)
    return {'loss': float(loss), 'metrics': metrics, 'grads': grads,
            'stats': new_stats,
            'heads': {k: np.asarray(h) for k, h in zip(KEYS, hs)}}


def _port(qat):
    """The port's model of the dual-head YAML under `qat`, its optimizer
    and train step; the step records the gradients the optimizer is
    handed and the heads of each forward."""
    cfg = t_parse(DUAL, SMALL + ['model.params.qat', qat])
    model = t_setup_model(cfg)
    opt = t_make_opt(model, cfg.model.optimizer, cfg.model.scheduler, 1,
                     clip_grad=cfg.arch.clip_grad)
    rec = {'grads': [], 'heads': []}
    apply = opt.step

    def step():
        rec['grads'].append({n: None if p.grad is None else p.grad.clone()
                             for n, p in model.named_parameters()})
        apply()
    opt.step = step
    model.depth_net.register_forward_hook(
        lambda mod, args, out: rec['heads'].append(
            {k: out[k].detach().clone() for k in LOSS_HEADS}))
    return model, opt, t_make_step(model, opt, qat_weights='weights' in qat), \
        rec


def _codes(jd, heads):
    return {k: np.round(np.asarray(jd['fake_quant_u8'](v)) * 255.0)
            for k, v in heads.items()}


def _valid_count(jd):
    gt = np.clip(jd['batch']['depth'], 0.5, 15.0)
    return max(float(((gt > 0.5) & (gt < 15.0)).sum()), 1.0)


def _metrics_close(jd, got, want, t_heads, quantized, rtol=1e-5):
    """The 8 metrics at `rtol`; integer_accuracy also within the share of
    valid pixels whose integer error sits at the 1 m threshold (within
    1e-4 m), where one rounding decides the comparison: on u8 codes the
    error is a multiple of 1/17 m, so exactly 1 m (code 17 (j + 1)) occurs,
    and under jit XLA computes decompose_depth's floor(gt) / max_depth as
    a product with 1 / max_depth, one ulp off the port's division."""
    head = t_heads[('integer', 0)].numpy()
    if quantized:
        head = np.asarray(jd['fake_quant_u8'](head))
    gt = np.clip(jd['batch']['depth'], 0.5, 15.0)
    valid = (gt > 0.5) & (gt < 15.0)
    err = np.abs(head - np.floor(gt) / 15.0) * 15.0
    ties = float((valid & (np.abs(err - 1.0) < 1e-4)).sum())
    for k in METRICS:
        atol = ties / _valid_count(jd) if k == 'integer_accuracy' else 0.0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _flip_rule(jd, t_heads, j_heads, t_loss, j_loss, t_metrics, rtol=1e-5,
               max_flips=4):
    """The u8 tie rule of the module note under QAT on outputs, the losses
    held to `rtol` plus the flips' allowance, at most `max_flips` codes
    flipped (None: any number, each by one step). Returns the number of
    flipped codes."""
    tc = _codes(jd, {k: t_heads[k].numpy() for k in LOSS_HEADS})
    jc = _codes(jd, {k: j_heads[k] for k in LOSS_HEADS})
    diffs = np.concatenate([(tc[k] - jc[k]).ravel() for k in LOSS_HEADS])
    flips = int((diffs != 0).sum())
    assert max_flips is None or flips <= max_flips, flips
    assert np.all(np.abs(diffs[diffs != 0]) == 1), diffs
    # the port's loss is the JAX model's loss on the port's own heads
    hs = [jnp.asarray(t_heads[k].numpy()) if k in LOSS_HEADS
          else jnp.asarray(j_heads[k]) for k in KEYS]
    (loss_on_t, metrics_on_t), _ = jd['loss'][1](hs)
    np.testing.assert_allclose(t_loss, float(loss_on_t), rtol=1e-5)
    _metrics_close(jd, t_metrics, metrics_on_t, t_heads, True)
    cfg = jd['cfg'].model
    cnt = _valid_count(jd)
    m = float(cfg.params.max_depth)
    per_flip = cfg.loss.supervised_loss_weight * max(
        cfg.loss.integer_weight + cfg.loss.dual_consistency_weight * m,
        cfg.loss.fractional_weight + cfg.loss.dual_consistency_weight
    ) / 255.0 / cnt
    assert abs(t_loss - j_loss) <= rtol * abs(j_loss) + flips * per_flip
    return flips


@pytest.mark.parametrize('qat', QAT)
def test_dual_head_step_matches_jax(jax_dual, qat):
    jd = jax_dual
    v = jd['variables']
    want = _jax_step(jd, v['params'], v['batch_stats'], qat)
    model, opt, step, rec = _port(qat)
    load_flax_variables(model, v)
    out = step({k: t(x) for k, x in jd['batch'].items()})
    assert opt.count == 1
    loss = float(out['loss'])
    metrics = {k: float(out[k]) for k in METRICS}
    assert sorted(k for k in out if k != 'loss') == sorted(METRICS) == \
        sorted(want['metrics'])
    if 'outputs' in qat:
        _flip_rule(jd, rec['heads'][0], want['heads'], loss, want['loss'],
                   metrics)
    else:
        np.testing.assert_allclose(loss, want['loss'], rtol=1e-5)
    if 'outputs' not in qat:
        _metrics_close(jd, metrics, want['metrics'], rec['heads'][0], False)

    expected = flax_state_dict(model, {'params': want['grads'],
                                       'batch_stats': want['stats']})
    grads = rec['grads'][0]
    assert len(grads) == len(jax.tree_util.tree_leaves(want['grads'])) > 150
    san = [n for n in grads if n.startswith('depth_net.mconvs.')]
    assert len(san) > 50
    for name, g in grads.items():
        w = expected[name]
        if name in san or name in ('depth_net.weight', 'depth_net.bias'):
            # the RGB+D pass feeds no loss of a dual-head model: no
            # gradient reaches the SAN (no dgrad launch on the card) nor
            # the fusion gates, as JAX's zeros say
            assert g is None and not np.any(w), name
            continue
        if g is None:
            # the heads of scales 1-3, which the dual-head loss leaves out
            assert not np.any(w), name
            continue
        g = g.numpy()
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) + 1e-8, name
    # the unused RGB+D pass still moves the BN and MaskedBatchNorm
    # statistics, the SAN's among them
    state = model.state_dict()
    start = flax_state_dict(model, v)
    moved = 0
    for name, w in expected.items():
        if name not in grads:
            np.testing.assert_allclose(state[name].numpy(), w, rtol=0,
                                       atol=1e-4 * max(np.abs(w).max(),
                                                       1e-30), err_msg=name)
            moved += name.startswith('depth_net.mconvs.') and \
                not np.array_equal(w, start[name])
    assert moved > 10


def test_three_qat_adam_steps_match_jax(jax_dual):
    """Three steps under 'weights+outputs' against the JAX pieces with
    optax's Adam (JAX make_optimizer): the per-step losses, the updates
    and statistics; the latent weights are off their int8 grid in both
    frameworks afterwards (float master weights, JAX tests/test_qat.py)."""
    jd = jax_dual
    v, cfg = jd['variables'], jd['cfg']
    tx = j_make_opt(cfg.model.optimizer, cfg.model.scheduler, 1,
                    clip_grad=cfg.arch.clip_grad)
    params, stats = v['params'], v['batch_stats']
    opt_state = jax.jit(tx.init)(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    model, opt, step, rec = _port('weights+outputs')
    load_flax_variables(model, v)
    before = flax_state_dict(model, v)
    batch = {k: t(x) for k, x in jd['batch'].items()}
    for i in range(3):
        want = _jax_step(jd, params, stats, 'weights+outputs')
        params, opt_state = update(want['grads'], opt_state, params)
        stats = want['stats']
        out = step(batch)
        loss = float(out['loss'])
        # after an Adam step the weights differ beyond rounding (entries
        # whose gradient is within rounding of zero move by +-lr), so more
        # codes flip: each still by one step, the losses within the flips'
        # allowance
        _flip_rule(jd, rec['heads'][i], want['heads'], loss, want['loss'],
                   {k: float(out[k]) for k in METRICS}, rtol=2e-4,
                   max_flips=4 if i == 0 else None)
    assert opt.count == 3

    want = flax_state_dict(model, {'params': params, 'batch_stats': stats})
    got = model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    # the SAN and the fusion gates get no gradient: neither framework moves
    # them (Adam's moments stay 0)
    still = [n for n in names if n.startswith('depth_net.mconvs.') or
             n in ('depth_net.weight', 'depth_net.bias')]
    for n in still:
        assert torch.equal(got[n], t(before[n])) and np.array_equal(
            want[n], before[n]), n
    names = [n for n in names if n not in still]
    dt = np.concatenate([(got[k].numpy() - before[k]).ravel() for k in names])
    dj = np.concatenate([(want[k] - before[k]).ravel() for k in names])
    moved = dj != 0
    assert moved.mean() > 0.5
    assert (np.sign(dt[moved]) == np.sign(dj[moved])).mean() >= 0.97
    assert np.linalg.norm(dt - dj) <= 0.15 * np.linalg.norm(dj)
    for name in want:
        if name not in names and name not in still:
            w = want[name]
            np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                       atol=5e-2 * max(np.abs(w).max(),
                                                       1e-30), err_msg=name)
    # float master weights: the latent kernels are off their int8 grid
    kernels = tq.depth_net_kernels(model)
    q = tq.quantize_depth_net_params(model, kernels=kernels)
    assert all(not torch.equal(q[n], got[n]) for n in kernels)
    leaf = [x for x in jax.tree_util.tree_leaves(params['depth_net'])
            if x.ndim == 4][0]
    assert not np.array_equal(
        np.asarray(jq.fake_quant_weight_per_channel(leaf)), np.asarray(leaf))
