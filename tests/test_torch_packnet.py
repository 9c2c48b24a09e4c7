"""The port's PackNet layers and networks against the JAX package's flax
modules, on the CPU in float32, with variables drawn with numpy and carried
by load_flax_variables:

- packing / unpacking, and the Conv3DStack's d-major flatten on
  integer-valued inputs and weights (every sum exact), bit-equal;
- forward outputs at 1e-5 x max|ref|: PackNetSlim01 at its own widths in
  eval; PackNet01 1A (its own widths) and PackNetSAN01 on RGB and RGB+D (in
  training, and through the eval YAML in eval) are held by
  tests/test_torch_packnet_step.py through the YAMLs' steps;
- PackNetSlimSAN01 1B (FiLM on scales 0 and 1) at narrow widths (ni 16,
  channels (16, 16, 32, 64, 128), d 4) in training on RGB+D: its outputs at
  1e-5 x max, `depth_loss` rtol 1e-5, every gradient of one scalar of all
  outputs per leaf in the Frobenius norm |g - g_jax| <= 2e-2 |g_jax| + 1e-8
  (the FiLM generators' among them; a leaf the reference has at below 1e-6
  of the largest, analytically zero, within 1e-6 of the largest), and the
  MaskedBatchNorm statistics after the forward per leaf atol 1e-5 x max;
  zero gradient from `depth_loss` to the RGB+D-only leaves, plain and FiLM;
- the row-window crop against the uncropped run (as the JAX suite's
  tests/test_networks.py holds it), plain and FiLM;
- dropout: its kept share and 1/(1-p) scale on a seeded generator, in
  training only;
- the weights: flax's names, init_weights' distributions and gates, the
  keys QAT quantizes;
- what both packages compute from PackNet's heads, which reach 2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.networks.depth import packnet as jp
from packnet_sfm_tpu.networks.layers import packnet as jl
from packnet_sfm_tpu.ops import depth as jdepth
from packnet_sfm_tpu.ops import quantization as jq
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.models.factory import (
    init_weights, setup_model as t_setup_model)
from packnet_sfm_tpu_torch.networks.depth import packnet as tp
from packnet_sfm_tpu_torch.networks.layers import packnet as tl
from packnet_sfm_tpu_torch.ops import depth as tdepth
from packnet_sfm_tpu_torch.ops.quantization import depth_net_kernels
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_state_dict, flax_variables, load_flax_variables)
from packnet_sfm_tpu_torch.networks.layers.san import MaskedBatchNorm
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import (
    assert_grads_match, assert_stats_match, jax_run_once,
    pooled_random_variables)

B, H, W = 2, 64, 96
NARROW = dict(ni=16, channels=(16, 16, 32, 64, 128), num_3d_feat=4)


def lidar(seed, b=B, h=H, w=W):
    """Sparse depth on beam rows below 40% of the height."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((b, h, w, 1), np.float32)
    rows = np.linspace(int(h * 0.4), h - 1, 16).astype(int)
    mask[:, rows] = rng.rand(b, len(rows), w, 1) < 0.3
    return ((rng.rand(b, h, w, 1) * 70 + 1) * mask).astype(np.float32)


def rgb(seed, b=B, h=H, w=W):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close_rel(got, want, rel=1e-5, msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=msg)


def build_pair(name, kwargs, x, d, seed):
    """(flax module, its variables drawn from `seed`, the port's module
    with them; built on the meta device and filled by
    load_flax_variables, which raises on a leaf it does not fill)."""
    jm = getattr(jp, name)(**kwargs)
    args = (x,) if d is None else (x, d)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            train=True))
    v = pooled_random_variables(shapes, seed)
    with torch.device('meta'):
        tm = getattr(tp, name)(**kwargs)
    return jm, v, load_flax_variables(tm.to_empty(device='cpu'), v)


# ------------------------------------------------------------ the layers

def test_packing_unpacking_bit_equal_jax():
    x = np.random.RandomState(0).randn(2, 8, 12, 6).astype(np.float32)
    packed = tl.packing(t(x))
    assert packed.shape == (2, 4, 6, 24)
    assert np.array_equal(packed.numpy(), np.asarray(jl.packing(x)))
    y = np.random.RandomState(1).randn(2, 4, 6, 20).astype(np.float32)
    assert np.array_equal(tl.unpacking(t(y)).numpy(),
                          np.asarray(jl.unpacking(y)))
    assert torch.equal(tl.unpacking(packed), t(x))
    # the channel order: c * r^2 + ry * r + rx
    assert packed[0, 1, 2, 5 * 4 + 1 * 2 + 0] == x[0, 3, 4, 5]


def test_conv3d_stack_bit_equal_jax():
    """Integer inputs and weights, so every sum is exact whatever its
    order: the port's F.conv3d and JAX's depth-window conv agree bit for
    bit, and channel j*C + c holds depth feature j of input channel c."""
    rng = np.random.RandomState(2)
    C, d = 6, 4
    x = rng.randint(-3, 4, (2, 5, 7, C)).astype(np.float32)
    kern = rng.randint(-2, 3, (3, 3, 3, d)).astype(np.float32)
    bias = rng.randint(-2, 3, (d,)).astype(np.float32)
    jm = jl._Conv3DStack(d=d)
    want = np.asarray(jm.apply({'params': {'win2d_kernel': kern,
                                           'win2d_bias': bias}}, x))
    tm = tl.Conv3DStack(d=d)
    with torch.no_grad():
        tm.win2d_kernel.copy_(t(kern))
        tm.win2d_bias.copy_(t(bias))
        got = tm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 5, 7, d * C)
    assert np.array_equal(got, want)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (1, 1)))
    j, c, h, w = 2, 3, 1, 4
    direct = bias[j] + sum(
        xp[0, h + kh, w + kw, c + dz] * kern[kh, kw, dz, j]
        for kh in range(3) for kw in range(3) for dz in range(3))
    assert got[0, h, w, j * C + c] == direct


def test_conv2d_groupnorm_eps_and_elu_in_float32():
    """PackNet's GroupNorm takes epsilon 1e-5 (PoseNet's 1e-6), and norms
    and activates in float32 on a bfloat16 conv."""
    from packnet_sfm_tpu_torch.networks.pose.pose_net import PoseNet
    m = tl.Conv2D(16, 32, 3, dtype=torch.bfloat16)
    assert m.GroupNorm_0.eps == 1e-5
    assert PoseNet().conv1.GroupNorm_0.eps == 1e-6
    out = m(torch.randn(1, 16, 8, 8))
    assert out.dtype == torch.float32
    head = tl.InvDepth(32, dtype=torch.bfloat16)(out)
    assert head.dtype == torch.float32 and float(head.max()) <= 2.0


# ------------------------------------------------ forwards at full width

@pytest.mark.usefixtures('one_torch_thread')
def test_packnet_slim_forward_matches_jax():
    """PackNetSlim01 at its own widths, B1 32x64, in eval."""
    x = rgb(3, b=1, h=32, w=64)
    jm, v, tm = build_pair('PackNetSlim01', {}, x, None, 5)
    want = jax_run_once(lambda v: jm.apply(v, x, train=False)[
        'inv_depths'], v, opt_level=None)
    with torch.no_grad():
        got = tm.eval()(t(x))
    assert sorted(got) == ['inv_depths'] and len(got['inv_depths']) == 1
    assert got['inv_depths'][0].shape == (1, 32, 64, 1)
    close_rel(got['inv_depths'][0], want[0])


# -------------------------------------------- narrow widths, with grads

FUSIONS = {'plain-1A': ('PackNetSAN01', dict(version='1A', **NARROW)),
           'film-1B': ('PackNetSlimSAN01', dict(version='1B',
                                                film_scales=(0, 1),
                                                **NARROW))}


@pytest.fixture(scope='module')
def narrow():
    """{fusion: (flax module, variables, the port's module with them)} at
    narrow widths, built once."""
    x, d = rgb(6), lidar(7)
    return {k: build_pair(name, kwargs, x, d, 8)
            for k, (name, kwargs) in FUSIONS.items()}


def objective(out, maps):
    """One scalar of every output: the heads against fixed maps, and the
    feature-consistency loss."""
    total = out['depth_loss']
    for key in ('inv_depths', 'inv_depths_rgbd'):
        for m, r in zip(out[key], maps):
            total = total + (m * r).mean()
    return total


@pytest.mark.usefixtures('one_torch_thread')
def test_film_training_forward_and_grads_match_jax(narrow):
    jm, v, tm = narrow['film-1B']
    x, d = rgb(6), lidar(7)
    maps = [np.random.RandomState(9 + i).rand(B, H // 2 ** i, W // 2 ** i,
                                              1).astype(np.float32)
            for i in range(4)]

    def loss_fn(params, stats):
        out, mut = jm.apply({'params': params, 'batch_stats': stats}, x, d,
                            train=True, mutable=['batch_stats'])
        return objective(out, maps), (out, mut['batch_stats'])

    (jloss, (jout, jstats)), jgrads = jax_run_once(jax.value_and_grad(
        loss_fn, has_aux=True), v['params'], v['batch_stats'])
    tm = load_flax_variables(tm, v).train()
    tm.zero_grad()
    out = tm(t(x), t(d))
    loss = objective(out, [t(m) for m in maps])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(out['depth_loss'].detach()),
                               float(jout['depth_loss']), rtol=1e-5)
    for key in ('inv_depths', 'inv_depths_rgbd'):
        assert len(out[key]) == 4
        for i, (a, b) in enumerate(zip(out[key], jout[key])):
            close_rel(a.detach(), b, msg='{} {}'.format(key, i))
    assert_grads_match(tm, jgrads, v['batch_stats'])
    for i in (0, 1):
        g = tm.mconvs.get_submodule('film_{}'.format(i)).weight.grad
        assert float(g.norm()) > 1e-4, i
    assert tm.weight.shape == (6,)
    assert sum(isinstance(m, MaskedBatchNorm) for m in tm.modules()) == 8
    assert_stats_match(tm, jstats)


@pytest.mark.parametrize('fusion', sorted(FUSIONS))
def test_depth_loss_reaches_the_rgb_features_only(fusion):
    """The RGB+D side of depth_loss is detached: its gradient to the
    leaves only the RGB+D pass reads (the sparse branch, the gates) is
    exactly zero, and it does reach the shared encoder."""
    name, kwargs = FUSIONS[fusion]
    tm = getattr(tp, name)(**kwargs)
    init_weights(tm, torch.Generator().manual_seed(4))
    tm.train()
    out = tm(t(rgb(6)), t(lidar(7)))
    out['depth_loss'].backward()
    assert float(out['depth_loss']) > 0
    for pname, p in tm.named_parameters():
        if pname.startswith('mconvs.') or pname in ('weight', 'bias'):
            assert p.grad is None or not bool(p.grad.any()), (fusion, pname)
    assert float(tm.core.pre_calc.Conv_0.weight.grad.norm()) > 0


@pytest.mark.parametrize('use_film', [False, True])
def test_row_window_crop_matches_uncropped(use_film):
    """A LiDAR band in the bottom rows that fits a half-height window: the
    cropped SAN branch gives the uncropped outputs (reduction-order noise:
    MaskedBatchNorm sums over the cropped tensor), in training."""
    rng = np.random.RandomState(10)
    mask = np.zeros((B, H, W, 1), np.float32)
    mask[:, 40:] = rng.rand(B, H - 40, W, 1) < 0.2
    d = (rng.rand(B, H, W, 1) * 10 * mask).astype(np.float32)
    kwargs = dict(NARROW, use_film=use_film)
    full = tp._PackNetSANBase(**kwargs)
    init_weights(full, torch.Generator().manual_seed(3))
    crop = tp._PackNetSANBase(san_row_window=0.5, **kwargs)
    crop.load_state_dict(full.state_dict())
    x = t(rgb(11))
    with torch.no_grad():
        out_f = full.train()(x, t(d))
        out_c = crop.train()(x, t(d))
    for a, b in zip(out_f['inv_depths_rgbd'], out_c['inv_depths_rgbd']):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(out_f['depth_loss']),
                               float(out_c['depth_loss']), atol=1e-6)


# ------------------------------------------------------------- dropout

def test_dropout_keep_share_and_scale():
    """flax's Dropout semantics on a seeded generator: each value kept
    with probability 1 - p, the kept ones scaled by 1 / (1 - p); the same
    seed, the same mask."""
    x = torch.rand(64, 64, 64) + 0.5
    for p in (0.5, 0.25):
        y = tl.dropout(x, p, torch.Generator().manual_seed(0))
        kept = y != 0
        share = float(kept.float().mean())
        assert abs(share - (1 - p)) < 5 * math.sqrt(p * (1 - p) / x.numel())
        assert torch.equal(y[kept], x[kept] / (1 - p))
        assert torch.equal(y, tl.dropout(x, p,
                                         torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match='Generator'):
        tl.dropout(x, 0.5, None)


def test_dropout_acts_in_training_only():
    net = tp.PackNetSAN01(dropout=0.5, **NARROW)
    init_weights(net, torch.Generator().manual_seed(1))
    ref = tp.PackNetSAN01(**NARROW)
    ref.load_state_dict(net.state_dict())
    assert net.needs_generator and not ref.needs_generator
    x, d = t(rgb(12, b=1)), t(lidar(13, b=1))
    with torch.no_grad():
        net.eval(), ref.eval()
        a, b = net(x, d)['inv_depths'][0], ref(x, d)['inv_depths'][0]
        assert torch.equal(a, b)
        net.train(), ref.train()
        runs = [net(x, generator=torch.Generator().manual_seed(s))[
            'inv_depths'][0] for s in (0, 0, 1)]
        plain = ref(x)['inv_depths'][0]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], plain)
    with pytest.raises(ValueError, match='Generator'):
        net(x)


# ------------------------------------------------------------- weights

def test_flax_names_and_init_weights(narrow):
    """The port's parameters and buffers are exactly the flax tree's
    (compact names, raw win2d leaves, GroupNorm scale -> weight); a
    missing or an extra leaf raises; init_weights draws the 3D conv with
    glorot's limit for fan-in 27 and fan-out 9d and sets the gates."""
    for fusion, gate in (('plain-1A', 1.0), ('film-1B', 0.5)):
        name, kwargs = FUSIONS[fusion]
        _, v, tm = narrow[fusion]
        back = flax_variables(load_flax_variables(tm, v))
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_leaves_with_path(back),
                jax.tree_util.tree_leaves_with_path(v)):
            assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
            assert np.array_equal(a, np.asarray(b))
        gn = v['params']['core']['pre_calc']['GroupNorm_0']['scale']
        assert np.array_equal(tm.core.pre_calc.GroupNorm_0.weight.detach(),
                              gn)
        broken = jax.tree_util.tree_map(lambda a: a, v)
        del broken['params']['core']['pack1']['_Conv3DStack_0'][
            'win2d_kernel']
        with pytest.raises(KeyError, match='win2d_kernel'):
            load_flax_variables(getattr(tp, name)(**kwargs), broken)
        broken = jax.tree_util.tree_map(lambda a: a, v)
        broken['params']['core']['extra'] = {'kernel': np.zeros(1)}
        with pytest.raises(KeyError, match='extra'):
            load_flax_variables(getattr(tp, name)(**kwargs), broken)
        fresh = init_weights(getattr(tp, name)(**kwargs),
                             torch.Generator().manual_seed(0))
        assert torch.equal(fresh.weight, torch.full_like(fresh.weight, gate))
        assert not bool(fresh.bias.any())
        assert fresh.weight.shape == (6 if gate == 0.5 else 5,)
        k = fresh.core.pack1._Conv3DStack_0.win2d_kernel
        limit = math.sqrt(6.0 / (27 + 9 * 4))
        assert float(k.abs().max()) <= limit
        assert float(k.abs().max()) > 0.9 * limit
        assert not bool(fresh.core.pack1._Conv3DStack_0.win2d_bias.any())
        assert torch.equal(fresh.core.pre_calc.GroupNorm_0.weight,
                           torch.ones(kwargs['ni']))


def test_qat_quantizes_the_kernels_jax_quantizes(narrow):
    """model.params.qat 'weights': the port fake-quantizes exactly the
    depth-net leaves the JAX package's quantize_depth_net_params changes
    (each 'kernel', so not win2d_kernel, the gates, biases or norms)."""
    for fusion in sorted(FUSIONS):
        _, v, net = narrow[fusion]
        tm = torch.nn.Module()
        tm.depth_net = net
        params = {'depth_net': v['params']}
        stats = {'depth_net': v['batch_stats']}
        q = jax.jit(jq.quantize_depth_net_params)(params)
        # 1 where the JAX quantizer changed the leaf, in torch names
        marks = jax.tree_util.tree_map(
            lambda a, b: np.full(np.shape(a), float(not np.array_equal(
                np.asarray(a), np.asarray(b))), np.float32), q, params)
        changed = {k for k, a in flax_state_dict(
            tm, {'params': marks, 'batch_stats': stats}).items()
            if k in dict(tm.named_parameters()) and a.any()}
        kernels = depth_net_kernels(tm)
        assert len(changed) > 50 and set(kernels) == changed, fusion
        assert not any('win2d' in k for k in kernels)


# ----------------------------------------------------- the heads above 1

def test_heads_above_one_read_as_sigmoids_in_both_packages():
    """InvDepth is sigmoid / 0.5, in [0, 2]; both packages' losses and
    SemiSupCompletionModel._bounded read it as a sigmoid in [0, 1], so a
    head above 1 maps past 1 / min_depth (depth below min_depth). The port
    computes what the JAX package does there."""
    s = np.linspace(0.0, 2.0, 41, dtype=np.float32).reshape(1, 41, 1, 1)
    for lo, hi in ((0.05, 80.0), (0.5, 80.0), (0.5, 200.0)):
        for log in (False, True):
            got = tdepth.sigmoid_to_inv_depth(t(s), lo, hi, log).numpy()
            want = np.asarray(jdepth.sigmoid_to_inv_depth(
                jnp.asarray(s), lo, hi, log))
            np.testing.assert_allclose(got, want, rtol=1e-6)
            assert got.max() > 1.0 / lo
        np.testing.assert_allclose(
            tdepth.sigmoid_to_depth_linear(t(s), lo, hi).numpy(),
            np.asarray(jdepth.sigmoid_to_depth_linear(jnp.asarray(s), lo,
                                                      hi)), rtol=1e-6)
    with torch.device('meta'):
        model = t_setup_model(t_parse('configs/train_packnet_san_kitti.yaml'))
    jmodel = j_setup_model(j_parse('configs/train_packnet_san_kitti.yaml'))
    assert (model.min_depth, model.max_depth) == (
        jmodel.min_depth, jmodel.max_depth) == (0.5, 80.0)
    bounded = model._bounded([t(s)])[0].numpy()
    assert bounded.max() > 1 / 0.5
    np.testing.assert_allclose(bounded, np.asarray(jdepth.sigmoid_to_inv_depth(
        jnp.asarray(s), 0.5, 80.0, False)), rtol=1e-6)


# ------------------------------------------------------------ factory

YAMLS = ('train_ddad', 'train_packnet_san_kitti', 'eval_packnet_san_kitti',
         'train_packnet_san_ddad')


@pytest.mark.parametrize('yaml', YAMLS)
def test_setup_model_builds_the_yaml_as_jax(yaml):
    """setup_model builds each PackNet YAML, with the depth-net fields the
    JAX factory forwards."""
    path = 'configs/{}.yaml'.format(yaml)
    with torch.device('meta'):
        tm = t_setup_model(t_parse(path, ['tpu.compute_dtype', 'float32']))
    jm = j_setup_model(j_parse(path, ['tpu.compute_dtype', 'float32']))
    assert type(tm).__name__ == type(jm).__name__
    tn, jn = tm.depth_net, jm.depth_net
    assert type(tn).__name__ == type(jn).__name__
    assert tn.core.dropout == jn.dropout
    assert tn.core.version == jn.version[1:]
    if hasattr(jn, 'use_film'):
        assert (tn.use_film, tn.film_scales, tn.san_row_window) == (
            jn.use_film, tuple(jn.film_scales), jn.san_row_window)
        assert tn.core.pack1.Conv2D_0.Conv_0.out_channels == jn.channels[0]
        assert tn.core.pre_calc.Conv_0.out_channels == jn.ni
        assert tn.core.pack1._Conv3DStack_0.d == jn.num_3d_feat
    assert (tm.pose_net is None) == (jm.pose_net is None)
