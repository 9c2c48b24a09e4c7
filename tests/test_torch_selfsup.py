"""The PyTorch port's self-supervised slice against the JAX package's, on
the CPU with inputs and weights drawn with numpy: the multi-view
photometric loss (float32 and bf16 maps, the fused kernels' path, 'min'
with automask and 'mean', clip_loss, 'border' padding, the fused and the
per-scale warps), PoseNet on carried weights, the whole
SemiSupCompletionModel train step at supervised weight 0.9 with PoseNet
(loss, metrics and per-leaf gradients against jax.value_and_grad), the
slice's YAML against bench.py's `_selfsup_cfg()`, the optimizer's pose
group, and train.main on the slice's YAML.

Tolerances, each with its reason:
- the loss in float32: loss and metrics rtol 1e-5; gradients (sigmoids,
  pose vectors) atol 1e-4 x max|value| (float32 sums in another order,
  through the warp's coordinate derivatives);
- bf16 photometric maps: loss rtol 2e-3 and gradients atol 2e-2 x
  max|value| (bf16 products and casts, rounded in another order);
- PoseNet: atol 1e-5 x max|value| in float32, 2e-2 in bf16 (convs
  rounded to bf16 at other places);
- the whole step: loss and metrics rtol 1e-5; each gradient leaf
  |g - g_jax| <= 2e-2 |g_jax| + 1e-8 in the Frobenius norm, the rule of
  tests/test_torch_train.py (ill-conditioned at this size, see its note).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.geometry.pose import Pose as JPose
from packnet_sfm_tpu.losses.photometric import MultiViewPhotometricLoss as JL
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.networks.pose.pose_net import PoseNet as JPoseNet
from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.eval import make_batches
from packnet_sfm_tpu_torch.geometry.pose import Pose as TPose
from packnet_sfm_tpu_torch.losses.photometric import (
    MultiViewPhotometricLoss as TL)
from packnet_sfm_tpu_torch.models.factory import setup_model as t_setup_model
from packnet_sfm_tpu_torch.models.sfm import SfmModel
from packnet_sfm_tpu_torch.networks.pose.pose_net import PoseNet as TPoseNet
from packnet_sfm_tpu_torch.ops.kernels import photometric as tphoto
from packnet_sfm_tpu_torch.ops.kernels import warp as twarp
from packnet_sfm_tpu_torch.parallel.train_step import make_optimizer
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_state_dict, load_flax_variables)
# one_torch_thread is not for the whole-step test: its zero leaves sit at
# the 1e-8 floor, and another summation order crosses it
from tests.torch_fixtures import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / 'packnet_sfm_tpu_torch' / 'configs' /
             'selfsup_kitti_192x640.yaml')


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-30))


def randomize(shapes, seed):
    """Every leaf drawn with numpy: kernels at 1/sqrt(fan-in), norm scales
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


# ------------------------------------------------------------------- loss

LOSS_CASES = {
    # name: (loss kwargs, per-scale warps)
    'fp32-min-automask': (dict(automask_loss=True), False),
    'bf16-min-automask-border': (dict(automask_loss=True,
                                      padding_mode='border',
                                      photometric_dtype='bfloat16'), False),
    'kernels-min-automask': (dict(automask_loss=True, use_pallas=True),
                             False),
    'fp32-mean-clip-border-per-scale': (dict(photometric_reduce_op='mean',
                                             clip_loss=0.5,
                                             padding_mode='border'), True),
}


def _loss_inputs(seed, per_scale, B=2):
    # the per-scale pyramid's last level must be 2 rows tall for the
    # reflect pad
    H, W = (16, 24) if per_scale else (12, 16)
    rng = np.random.RandomState(seed)
    image = rng.rand(B, H, W, 3).astype(np.float32)
    # contexts near the target, so that the warps compare like with like
    ctx = [np.clip(image + rng.randn(B, H, W, 3) * 0.1, 0, 1).astype(
        np.float32) for _ in range(2)]
    shapes = [(H // 2 ** i, W // 2 ** i) if per_scale else (H, W)
              for i in range(4)]
    sig = [rng.uniform(0.05, 0.6, (B, h, w, 1)).astype(np.float32)
           for h, w in shapes]
    vec = (rng.randn(B, 2, 6) * 0.05).astype(np.float32)
    K = np.tile(np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2],
                          [0, 0, 1]], np.float32)[None], (B, 1, 1))
    return image, ctx, sig, vec, K


@pytest.mark.parametrize('case', list(LOSS_CASES))
@pytest.mark.usefixtures('one_torch_thread')
def test_photometric_loss_matches_jax(case):
    kw, per_scale = LOSS_CASES[case]
    kw = dict(kw, smooth_loss_weight=0.1, min_depth=0.5, max_depth=80.0)
    image, ctx, sig, vec, K = _loss_inputs(3, per_scale)
    jl, tl = JL(**kw), TL(**kw)

    def jf(s, v, image, ctx, K):
        poses = [JPose.from_vec(v[:, i]) for i in range(2)]
        out = jl(image, ctx, s, poses, K=K)
        return out['loss'], out['metrics']

    (want, want_m), (want_ds, want_dv) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(sig, vec, image, ctx, K)
    ts = [t(s).requires_grad_(True) for s in sig]
    tv = t(vec).requires_grad_(True)
    out = tl(t(image), [t(c) for c in ctx], ts,
             [TPose.from_vec(tv[:, i]) for i in range(2)], K=t(K))
    out['loss'].backward()
    lowp = 'bf16' in case
    rtol, grad_rel = (2e-3, 2e-2) if lowp else (1e-5, 1e-4)
    assert sorted(out['metrics']) == sorted(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(out['metrics'][k].detach()),
                                   float(want_m[k]), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(float(out['loss'].detach()), float(want),
                               rtol=rtol)
    for a, b in zip(ts, want_ds):
        close(a.grad, b, grad_rel)
    close(tv.grad, want_dv, grad_rel)


@pytest.mark.usefixtures('one_torch_thread')
def test_loss_counts_one_warp_per_context_and_one_automask_map():
    """Under upsample_depth_maps every scale shares one warp launch per
    context, and the automask's unwarped map is computed once per context;
    on CPU tensors the wrappers run their plain versions and count nothing.
    (chip_smoke.py asserts the counts of the kernels on the card.)"""
    image, ctx, sig, vec, K = _loss_inputs(4, False)
    calls = {'warp': 0, 'photo': 0}
    saved = (twarp.warp_bilinear_out, tphoto.photometric_fwd)

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    twarp.warp_bilinear_out = count('warp', saved[0])
    tphoto.photometric_fwd = count('photo', saved[1])
    try:
        TL(automask_loss=True, use_pallas=True)(
            t(image), [t(c) for c in ctx], [t(s) for s in sig],
            [TPose.from_vec(t(vec[:, i])) for i in range(2)], K=t(K))
    finally:
        twarp.warp_bilinear_out, tphoto.photometric_fwd = saved
    assert calls == {'warp': 2, 'photo': 10}


def test_loss_refuses_the_fisheye_camera():
    image, ctx, sig, vec, K = _loss_inputs(5, False)
    with pytest.raises(NotImplementedError, match='fisheye'):
        TL()(t(image), [t(c) for c in ctx], [t(s) for s in sig],
             [TPose.from_vec(t(vec[:, i])) for i in range(2)],
             distortion={'k': t(K)})
    with pytest.raises(ValueError, match='Automasking'):
        TL(automask_loss=True, photometric_reduce_op='mean')


# ---------------------------------------------------------------- PoseNet

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.usefixtures('one_torch_thread')
def test_posenet_matches_jax(dtype):
    rng = np.random.RandomState(6)
    img = rng.rand(2, 32, 64, 3).astype(np.float32)
    ctx = [rng.rand(2, 32, 64, 3).astype(np.float32) for _ in range(2)]
    jm = JPoseNet(dtype=getattr(jnp, dtype))
    v = randomize(jax.eval_shape(lambda a, c: jm.init(
        jax.random.PRNGKey(0), a, c), img, ctx), 7)
    want = jax.jit(jm.apply)(v, img, ctx)
    tm = load_flax_variables(TPoseNet(dtype=getattr(torch, dtype)), v)
    got = tm(t(img), [t(c) for c in ctx])
    assert got.shape == (2, 2, 6) and got.dtype == torch.float32
    # flax's GroupNorm epsilon, and pose_pred in float32 after the norms
    assert tm.conv1.GroupNorm_0.eps == 1e-6
    assert tm.pose_pred.dtype == torch.float32
    close(got.detach(), want, 1e-5 if dtype == 'float32' else 2e-2)


# -------------------------------------------------------- whole train step

SHAPE = (32, 64)
SMALL = ['tpu.compute_dtype', 'float32', 'tpu.photometric_dtype', 'float32',
         'datasets.augmentation.image_shape', SHAPE]


def test_whole_train_step_matches_jax_value_and_grad():
    jcfg, tcfg = j_parse(CONFIG, list(SMALL)), t_parse(CONFIG, list(SMALL))
    jm = j_setup_model(jcfg)
    batch = make_batches(SHAPE, 2, 1, seed=3, device='cpu', contexts=2)[0]
    np_batch = {k: ([c.numpy() for c in v] if isinstance(v, list)
                    else v.numpy()) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False), np_batch)
    variables = randomize(shapes, 8)
    key = jax.random.PRNGKey(0)

    def loss_fn(params, stats, b):
        out, mut = jm.apply({'params': params, 'batch_stats': stats},
                            b, train=True, rngs={'flip': key},
                            mutable=['batch_stats'])
        return out['loss'], out['metrics']

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'], variables['batch_stats'],
                                np_batch)

    tm = load_flax_variables(t_setup_model(tcfg), variables).train()
    out = tm(batch)
    out['loss'].backward()
    np.testing.assert_allclose(float(out['loss'].detach()), float(jloss),
                               rtol=1e-5)
    assert 'photometric_loss' in jmetrics and 'smoothness_loss' in jmetrics
    assert sorted(out['metrics']) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(out['metrics'][k].detach()),
                                   float(jmetrics[k]), rtol=1e-5, err_msg=k)
    want = flax_state_dict(tm, {'params': jgrads,
                                'batch_stats': variables['batch_stats']})
    params = dict(tm.named_parameters())
    assert len(params) == len(jax.tree_util.tree_leaves(jgrads))
    assert any(n.startswith('pose_net.') for n in params)
    for name, p in params.items():
        g, w = p.grad.numpy(), want[name]
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) + 1e-8, name
    assert len(out['poses']) == 2


def test_optimizer_puts_pose_net_in_the_pose_group():
    """The pose group is chosen by the attribute name `pose_net`."""
    model = SfmModel(torch.nn.Linear(3, 2), pose_net=TPoseNet())
    opt = make_optimizer(model, {'name': 'Adam', 'depth': {'lr': 1e-3},
                                 'pose': {'lr': 5e-4}},
                         {'name': 'Constant'}, 1)
    depth_g, pose_g = opt.adam.param_groups
    assert {id(p) for p in pose_g['params']} == {
        id(p) for p in model.pose_net.parameters()}
    assert len(depth_g['params']) == len(list(model.depth_net.parameters()))
    assert (depth_g['lr'], pose_g['lr']) == (1e-3, 5e-4)


# ----------------------------------------------------------- config, entry

def test_yaml_matches_bench_selfsup_cfg():
    """Every field the model and the losses read agrees with bench.py's
    `_selfsup_cfg()`; the batch is bench.py's B8 at 192x640."""
    want, got = bench._selfsup_cfg(), t_parse(CONFIG)
    for section in ('depth_net', 'pose_net', 'loss', 'params'):
        for k, v in want.model[section].items():
            assert got.model[section][k] == v, (section, k)
    assert got.model.name == want.model.name
    for k in ('compute_dtype', 'photometric_dtype', 'use_pallas'):
        assert got.tpu[k] == want.tpu[k], k
    assert got.datasets.train.batch_size == 8
    assert tuple(got.datasets.augmentation.image_shape) == (192, 640)
    assert port_train.n_contexts(got) == 2


@pytest.mark.usefixtures('one_torch_thread')
def test_bf16_conv_filter_gradient_is_deterministic_on_cpu():
    """PoseNet's conv7 at a 32x64 input: a bf16 3x3 stride-2 conv of one
    pixel. PyTorch's CPU bf16 convolution backward reads uninitialised
    memory into its filter gradient there (garbage up to 3e38, or NaN, the
    selfsup step's non-finite steps at this size); the port's Conv sums in
    float32 on the CPU: the same finite gradient every time, that of the
    bf16-rounded operands."""
    from packnet_sfm_tpu_torch.networks.layers.resnet import Conv
    rng = np.random.RandomState(0)
    conv = Conv(256, 256, 3, 2, 1, True, 'xavier', torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            rng.randn(256, 256, 3, 3).astype(np.float32) * 0.05))
    x = torch.from_numpy(rng.randn(2, 256, 1, 1).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 256, 1, 1).astype(np.float32))
    grads = []
    for _ in range(4):
        junk = [torch.full((1024, 1024), float('nan')) for _ in range(8)]
        del junk  # freed memory full of NaN for the backward to find
        conv.zero_grad(set_to_none=True)
        conv(x).float().backward(g)
        grads.append(conv.weight.grad.clone())
    want = torch.nn.grad.conv2d_weight(
        x.bfloat16().float(), conv.weight.shape, g.bfloat16().float(), 2, 1)
    for got in grads:
        assert torch.equal(got, grads[0]) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-2,
                                   atol=1e-2 * float(want.abs().max()))


@pytest.mark.usefixtures('one_torch_thread')
def test_train_main_selfsup_on_cpu():
    """Both chip paths at a tiny size: bf16 maps, and float32 maps through
    the kernels' Function; the wrappers count no launch on the CPU."""
    before = (twarp.warp_bilinear_out.launches,
              twarp.warp_bilinear_dgrid.launches,
              tphoto.photometric_fwd.launches,
              tphoto.photometric_bwd.launches)
    for extra in ([], ['tpu.photometric_dtype', 'float32',
                       'tpu.use_pallas', True]):
        run = port_train.main(
            CONFIG, device='cpu', n_steps=2, n_batches=1, seed=0,
            overrides=['datasets.train.batch_size', 2,
                       'datasets.augmentation.image_shape', (32, 64)] + extra)
        assert np.all(np.isfinite(run['losses']))
        assert run['trainer'].optimizer.count == 2
        b = run['batches'][0]
        assert len(b['rgb_context']) == 2 and b['intrinsics'].shape == (
            2, 3, 3)
        assert float(b['intrinsics'][0, 0, 2]) == 32.0
    assert before == (twarp.warp_bilinear_out.launches,
                      twarp.warp_bilinear_dgrid.launches,
                      tphoto.photometric_fwd.launches,
                      tphoto.photometric_bwd.launches)
