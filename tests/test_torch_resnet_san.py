"""The PyTorch port's ResNet-SAN modules against the JAX package's flax
modules, on the CPU in float32, with the same (randomised) variables carried
across by packnet_sfm_tpu_torch.utils.flax_weights.load_flax_variables.

Inputs and variables are drawn with numpy from a seed. Tolerance: atol 1e-4
on sigmoid maps and on BN-scaled features (float32 sums in another order);
masked max-pool is exact. Each flax model is built once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.networks.layers import resnet as jresnet
from packnet_sfm_tpu.networks.layers import san as jsan
from packnet_sfm_tpu.networks.depth.resnet_san import ResNetSAN01 as JSAN01
from packnet_sfm_tpu_torch.networks.layers import resnet as tresnet
from packnet_sfm_tpu_torch.networks.layers import san as tsan
from packnet_sfm_tpu_torch.networks.depth.resnet_san import (
    ResNetSAN01 as TSAN01)
from packnet_sfm_tpu_torch.utils.flax_weights import load_flax_variables

H, W = 64, 96


def init(module, *args, **kwargs):
    """Variable shapes only (tracing flax init is cheap, running it is not);
    randomize() draws every value."""
    return jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))


def apply(module, variables, *args, **kwargs):
    """Jitted flax apply (eager dispatch is several times slower here)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(
        variables, *args)


def randomize(variables, seed):
    """Same tree, every leaf drawn with numpy so that BN statistics and
    biases are not at their identity init."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = x.shape
        if name == 'kernel':
            return rng.randn(*shape).astype(np.float32) / np.sqrt(
                np.prod(shape[:-1]))
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == 'weight':
            return rng.randn(*shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def lidar(seed, B, h, w):
    """KITTI-structured sparse depth: beam rows below 40% of the height."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((B, h, w, 1), np.float32)
    rows = np.linspace(int(h * 0.4), h - 1, 16).astype(int)
    mask[:, rows] = rng.rand(B, len(rows), w, 1) < 0.3
    return ((rng.rand(B, h, w, 1) * 70 + 1) * mask).astype(np.float32)


def to_torch(x):
    return torch.from_numpy(np.asarray(x))


def nchw(x):
    return to_torch(x).permute(0, 3, 1, 2)


def close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.fixture(scope='module')
def feats():
    rng = np.random.RandomState(1)
    return [rng.rand(2, H // 2 ** (i + 1), W // 2 ** (i + 1), c)
            .astype(np.float32) for i, c in enumerate([64, 64, 128, 256, 512])]


@pytest.mark.parametrize('num_layers', [18, 50])
def test_resnet_encoder(num_layers):
    rgb = np.random.RandomState(0).rand(2, H, W, 3).astype(np.float32)
    jm = jresnet.ResnetEncoder(num_layers=num_layers)
    v = randomize(init(jm, rgb, train=False), 2)
    want = apply(jm, v, rgb, train=False)
    tm = load_flax_variables(tresnet.ResnetEncoder(num_layers), v).eval()
    with torch.no_grad():
        got = tm(nchw(rgb))
    assert len(got) == 5
    for g, w_ in zip(got, want):
        close(g.permute(0, 2, 3, 1), w_, atol=1e-3 * float(np.abs(w_).max()))


@pytest.mark.parametrize('dual', [False, True])
def test_depth_decoders(feats, dual):
    ch = [64, 64, 128, 256, 512]
    if dual:
        jm = jresnet.DualHeadDepthDecoder(num_ch_enc=ch, max_depth=15.0)
        tm = tresnet.DualHeadDepthDecoder(ch)
    else:
        jm, tm = jresnet.DepthDecoder(num_ch_enc=ch), tresnet.DepthDecoder(ch)
    v = randomize(init(jm, feats), 3)
    want = apply(jm, v, feats)
    load_flax_variables(tm, v).eval()
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    assert sorted(got) == sorted(want)
    for key in want:
        close(got[key].permute(0, 2, 3, 1), want[key])


def test_masked_max_pool_and_fully_inactive_windows():
    rng = np.random.RandomState(4)
    mask = np.zeros((2, 13, 18, 1), np.float32)
    mask[:, 6:] = rng.rand(2, 7, 18, 1) < 0.3      # top windows all inactive
    x = (rng.randn(2, 13, 18, 5) * mask).astype(np.float32)
    want_x, want_m = jsan.masked_max_pool(jnp.asarray(x), jnp.asarray(mask))
    got_x, got_m = tsan.masked_max_pool(to_torch(x), to_torch(mask))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert np.all(got_x.numpy()[got_m.numpy()[..., 0] == 0] == 0)


def test_masked_batch_norm_eval():
    rng = np.random.RandomState(5)
    mask = (rng.rand(2, 8, 12, 1) < 0.4).astype(np.float32)
    x = (rng.randn(2, 8, 12, 16) * mask).astype(np.float32)
    jm = jsan.MaskedBatchNorm()
    v = randomize(init(jm, x, mask, train=False), 6)
    want = apply(jm, v, x, mask, train=False)
    tm = load_flax_variables(tsan.MaskedBatchNorm(16), v).eval()
    close(tm(to_torch(x), to_torch(mask)).detach(), want)


def test_minkowski_stage_with_film():
    d = lidar(7, 2, 32, 48)
    mask = (d > 0).astype(np.float32)
    jm = jsan.MinkowskiEncoder(channels=[8], rgb_channels=[8])
    v = randomize(init(jm, 0, d, mask, False), 8)
    dense, m2, gamma, beta = jm.apply(v, 0, d, mask, False)
    tm = load_flax_variables(tsan.MinkowskiEncoder([8], [8]), v).eval()
    with torch.no_grad():
        t_dense, t_m2, t_gamma, t_beta = tm(0, to_torch(d), to_torch(mask))
    scale = float(np.abs(dense).max())
    close(t_dense, dense, atol=1e-5 * scale)
    np.testing.assert_array_equal(t_m2.numpy(), np.asarray(m2))
    close(t_gamma, gamma, atol=1e-5 * scale)
    close(t_beta, beta, atol=1e-5 * scale)


@pytest.fixture(scope='module')
def san_model():
    """One flax ResNetSAN01 with FiLM and its randomised variables."""
    rng = np.random.RandomState(9)
    rgb = rng.rand(2, H, W, 3).astype(np.float32)
    d = lidar(10, 2, H, W)
    jm = JSAN01(use_film=True, film_scales=(0,), max_depth=15.0)
    v = randomize(init(jm, rgb, d, train=False), 11)
    return rgb, d, v


@pytest.mark.parametrize('case', ['rgb', 'rgbd', 'rgbd_row_window'])
def test_resnet_san01_eval(san_model, case):
    rgb, d, v = san_model
    window = 0.67 if case == 'rgbd_row_window' else 0.0
    depth = None if case == 'rgb' else d
    jm = JSAN01(use_film=True, film_scales=(0,), max_depth=15.0,
                san_row_window=window)
    want = apply(jm, v, rgb, depth, train=False)['inv_depths'][0]
    tm = TSAN01(use_film=True, film_scales=(0,),
                san_row_window=window)
    load_flax_variables(tm, v).eval()
    with torch.no_grad():
        got = tm(to_torch(rgb), None if depth is None else to_torch(depth))
    assert list(got) == ['inv_depths']
    assert got['inv_depths'][0].shape == (2, H, W, 1)
    close(got['inv_depths'][0], want)


def test_resnet_san01_dual_head_eval():
    rng = np.random.RandomState(12)
    rgb = rng.rand(1, H, W, 3).astype(np.float32)
    d = lidar(13, 1, H, W)
    jm = JSAN01(use_film=True, use_dual_head=True, max_depth=15.0)
    v = randomize(init(jm, rgb, d, train=False), 14)
    want = apply(jm, v, rgb, d, train=False)
    tm = TSAN01(use_film=True, use_dual_head=True)
    load_flax_variables(tm, v).eval()
    with torch.no_grad():
        got = tm(to_torch(rgb), to_torch(d))
    assert sorted(got) == sorted(want)
    for key in want:
        close(got[key], want[key])
