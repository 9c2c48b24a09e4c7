"""The PyTorch port's generic-camera slice against the JAX package's, on the
CPU in float32, with inputs drawn with numpy and weights carried by
utils/flax_weights.py: window starts and patch coordinates; the plain
projection forward (rows, cols, m, s) and its gradient against the Pallas
kernel in interpret mode and its analytic VJP, and at p = 20 against the
XLA twin; the explicit plain backward and the autograd Function against
autograd of the plain forward; GenericCamera.project and the pinhole ray
template against JAX (which runs its dense softmax at these sizes);
RaySurfaceResNet in training and eval; the generic photometric loss; the
whole GenericSelfSupModel loss and per-leaf gradients against
jax.value_and_grad; the factory on both omnicam YAMLs; train.main on the
CPU; the raises where the window does not fit the plane or the kernels'
shared memory; and a numpy emulation of the CUDA kernels' tiles, lanes
and chunks (its own note, near the end of the file).

Tolerances, each with its reason:
- the projection against the Pallas kernel and the XLA twin (the same
  pre-divided formulation): values atol 1e-5 x max|value|, gradients atol
  2e-5 x max|value| (float32 sums of the softmax in another order, and dd
  summed against the window's centre ray; measured <= 6.1e-7 and 9.9e-6);
- the explicit plain backward and the Function against autograd of the
  plain forward: atol 2e-5 x max|value| at temperature 1 (measured <=
  2.3e-6); at the training temperature (~1e-4, a near-argmax softmax over
  logits of ~1e4, whose float32 ulp is ~1e-3) atol 2e-3 x max|value|:
  both are 2.5e-4 to 3.2e-4 of max from the same formula in float64, and
  1.4e-4 from each other;
- GenericCamera.project and everything downstream of it against JAX's
  dense softmax (logits divided by the temperature after the match, not
  before): coordinates rtol 1e-3, atol 2e-4, gradients rtol 5e-3 and atol
  2e-3 x max|value|, JAX's own cross-formulation limits
  (tests/test_generic_camera.py). The temperature is ~1e-4, so a one-ulp
  change of a logit moves the softmax weights by ~1e-4 relative;
- RaySurfaceResNet: atol 1e-5 x max|value| (float32 convs summed in another
  order);
- the loss: rtol 1e-4 on the loss and its metrics (the projection's
  cross-formulation noise, averaged over the image);
- the whole step: loss rtol 1e-4; each gradient leaf |g - g_jax| <= 2e-2
  |g_jax| in the Frobenius norm, the rule of tests/test_torch_train.py,
  plus a floor of 1e-6 x the largest gradient for the leaves that are
  zero analytically (see the test's note on conditioning).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.geometry import camera_generic as jcg
from packnet_sfm_tpu.geometry.pose import Pose as JPose
from packnet_sfm_tpu.losses.generic_photometric import (
    GenericMultiViewPhotometricLoss as JGL)
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu.networks.depth.ray_surface_resnet import (
    RaySurfaceResNet as JRSR)
from packnet_sfm_tpu.ops.pallas import generic_projection as jgp
from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.config import parse_train_config as t_parse
from packnet_sfm_tpu_torch.eval import make_batches, shifted_context_batch
from packnet_sfm_tpu_torch.geometry import camera_generic as tcg
from packnet_sfm_tpu_torch.geometry.pose import Pose as TPose
from packnet_sfm_tpu_torch.losses.generic_photometric import (
    GenericMultiViewPhotometricLoss as TGL)
from packnet_sfm_tpu_torch.models.factory import (
    init_weights, setup_model as t_setup_model)
from packnet_sfm_tpu_torch.models.generic import GenericSelfSupModel
from packnet_sfm_tpu_torch.networks.depth.ray_surface_resnet import (
    RaySurfaceResNet as TRSR)
from packnet_sfm_tpu_torch.ops.kernels import build
from packnet_sfm_tpu_torch.ops.kernels import generic_projection as tgp
from packnet_sfm_tpu_torch.ops.kernels import warp as twarp
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_state_dict, load_flax_variables)
from tests.torch_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {'half': str(ROOT / 'configs' / 'train_omnicam.yaml'),
           'full': str(ROOT / 'configs' / 'train_omnicam_fullres.yaml')}
# RaySurfaceResNet '18pt' wants ImageNet weights the repository does not
# hold: train.main starts it from seeded random weights only when told to
RANDOM_INIT = ['model.depth_net.allow_random_init', True]


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rel, name=''):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def cross(got, want, rtol=1e-3, atol=2e-4):
    """JAX's dense softmax against the pre-divided formulation."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def cross_grad(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=5e-3,
                               atol=2e-3 * float(np.abs(want).max()))


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


def _K(B, H, W):
    return np.tile(np.array([[W, 0, W / 2 - 0.5], [0, W, H / 2 - 0.5],
                             [0, 0, 1]], np.float32)[None], (B, 1, 1))


def _rays(seed, B, H, W):
    """Pinhole rays of _K with a small random residual, unit length."""
    rng = np.random.RandomState(seed)
    rays = np.asarray(jcg.pinhole_ray_surface(jnp.asarray(_K(B, H, W)), H, W))
    rays = rays + rng.randn(B, H, W, 3).astype(np.float32) * 0.02
    return (rays / np.linalg.norm(rays, axis=-1, keepdims=True)).astype(
        np.float32)


# ------------------------------------------------------------ the windows

def test_window_starts_and_patch_coords_match_jax():
    for n, p in ((10, 4), (9, 4), (48, 2), (41, 20), (97, 20), (5, 4)):
        np.testing.assert_array_equal(tgp.window_starts(n, p),
                                      jcg._window_starts(n, p))
    for H, W, p in ((10, 16, 4), (21, 48, 2), (9, 11, 4)):
        coords = tcg._patch_coords(H, W, p)
        np.testing.assert_array_equal(coords, jcg._patch_coords(H, W, p))
        # the window's first coordinate is the pixel's window start
        sy = np.repeat(tgp.window_starts(H, p), W)
        sx = np.tile(tgp.window_starts(W, p), H)
        np.testing.assert_array_equal(coords[:, 0], np.stack([sy, sx], 1))


# ---------------------------------------------------- the projection kernel

def _proj_inputs(seed, b, h, w):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in
            ((b, 3, h, w), (b, 3, h, w), (b, h, w), (b, h, w))]


@pytest.mark.parametrize('shape', [(1, 10, 16, 4),   # border-dominated
                                   (2, 9, 11, 4),    # k1 == H
                                   (1, 21, 48, 2)])  # odd rows, H != W
def test_plain_projection_matches_pallas_kernel_and_vjp(shape):
    b, h, w, p = shape
    ray, d, gy, gx = _proj_inputs(3, b, h, w)
    (jrows, jcols), res = jgp._fwd(ray, d, p, True)
    jdray, jdd = jgp._bwd(p, True, res, (gy, gx))
    rows, cols, m, s = tgp.generic_projection_fwd(t(ray), t(d), p)
    for a, want in zip((rows, cols, m, s), (jrows, jcols) + res[4:]):
        close(a, want, 1e-5)
    rt, dt = t(ray).requires_grad_(True), t(d).requires_grad_(True)
    r_, c_ = tgp.expected_patch_coords_fn(rt, dt, p)
    ((r_ * t(gy)).sum() + (c_ * t(gx)).sum()).backward()
    close(rt.grad, jdray, 2e-5)
    close(dt.grad, jdd, 2e-5)


def test_plain_projection_p20_matches_xla_twin():
    """p = 20 on a 41x45 plane (k1 == H2), against `_expected_xla`'s
    streaming recurrence and its autodiff."""
    ray, d, gy, gx = _proj_inputs(4, 1, 41, 45)

    def lx(r, dd):
        rows, cols = jgp._expected_xla(r, dd, 20)
        return jnp.sum(rows * gy) + jnp.sum(cols * gx), (rows, cols)

    (_, (jrows, jcols)), (jdray, jdd) = jax.value_and_grad(
        lx, argnums=(0, 1), has_aux=True)(ray, d)
    rt, dt = t(ray).requires_grad_(True), t(d).requires_grad_(True)
    rows, cols = tgp.expected_patch_coords_fn(rt, dt, 20)
    close(rows.detach(), jrows, 1e-5)
    close(cols.detach(), jcols, 1e-5)
    ((rows * t(gy)).sum() + (cols * t(gx)).sum()).backward()
    close(rt.grad, jdray, 2e-5)
    close(dt.grad, jdd, 2e-5)


@pytest.mark.parametrize('case', ['flat', 'peaked'])
def test_explicit_backward_and_function_match_autograd(case):
    """The plain backward (the kernels' formula) and the autograd Function
    (on CPU tensors, through the wrappers' plain versions) against autograd
    of the plain forward: random unnormalised rays at temperature 1, and
    pinhole rays with directions divided by the temperature at progress 0.5
    (a near-argmax softmax), p = 20, H2 != W2."""
    if case == 'flat':
        ray, d, gy, gx = _proj_inputs(5, 2, 13, 17)
        p = 4
    else:
        rays = _rays(6, 1, 41, 53)
        d = _rays(7, 1, 41, 53) / tcg.softmax_temperature(0.5)
        ray = np.ascontiguousarray(rays.transpose(0, 3, 1, 2))
        d = np.ascontiguousarray(d.transpose(0, 3, 1, 2))
        gy, gx = _proj_inputs(8, 1, 41, 53)[2:]
        p = 20
    rt, dt = t(ray).requires_grad_(True), t(d).requires_grad_(True)
    rows, cols = tgp.expected_patch_coords_reference(rt, dt, p)
    ((rows * t(gy)).sum() + (cols * t(gx)).sum()).backward()
    want = (rt.grad, dt.grad)
    res = tgp.generic_projection_fwd(t(ray), t(d), p)
    got = tgp.generic_projection_bwd(t(ray), t(d), *res, t(gy), t(gx), p)
    rf, df = t(ray).requires_grad_(True), t(d).requires_grad_(True)
    rows_f, cols_f = tgp.ExpectedPatchCoordsFunction.apply(rf, df, p)
    ((rows_f * t(gy)).sum() + (cols_f * t(gx)).sum()).backward()
    close(rows_f.detach(), rows.detach(), 0.0)
    rel = 2e-5 if case == 'flat' else 2e-3
    for a, b_ in zip(got + (rf.grad, df.grad), want + want):
        close(a, b_, rel)
    # a cotangent that never arrives is zero
    rf.grad = None
    tgp.ExpectedPatchCoordsFunction.apply(rf, df, p)[0].sum().backward()
    want_rows_only = tgp.generic_projection_bwd(
        t(ray), t(d), *res, torch.ones_like(res[0]), torch.zeros_like(res[0]),
        p)[0]
    close(rf.grad, want_rows_only, 0.0)


def test_kernel_source_builds_into_build_kernels():
    path = build.library_path('generic_projection')
    assert path.parent == ROOT / 'build' / 'kernels'
    assert re.fullmatch(r'generic_projection-[0-9a-f]{16}\.so', path.name)
    src = (build.CSRC / 'generic_projection.cu').read_text()
    for symbol in ('generic_projection_fwd', 'generic_projection_bwd'):
        assert 'extern "C" int {}('.format(symbol) in src


def test_wrappers_refuse_what_the_kernels_do_not_take():
    ray, d, gy, gx = (t(a) for a in _proj_inputs(9, 1, 9, 12))
    before = (tgp.generic_projection_fwd.launches,
              tgp.generic_projection_bwd.launches)
    with pytest.raises(ValueError, match='2p\\+1 = 11 must fit the 9x12'):
        tgp.generic_projection_fwd(ray, d, 5)
    with pytest.raises(ValueError, match='must fit'):
        tgp.expected_patch_coords_fn(ray, d, 5)
    with pytest.raises(TypeError, match='float32'):
        tgp.generic_projection_fwd(ray.double(), d.double(), 2)
    with pytest.raises(ValueError, match='contiguous'):
        tgp.generic_projection_fwd(ray.transpose(2, 3).contiguous()
                                   .transpose(2, 3), d, 2)
    with pytest.raises(ValueError, match='one shape'):
        tgp.generic_projection_fwd(ray, d[:, :, :8], 2)
    with pytest.raises(ValueError, match='residuals'):
        tgp.generic_projection_bwd(ray, d, gy, gx, gy, gx, gy, gx[:, :8], 2)
    # the kernels stage a pixel tile's window rays in shared memory, which
    # holds the window up to p = 66 (staged_bytes)
    big = torch.zeros(1, 3, 150, 150)
    assert max(tgp.staged_bytes(150, 150, 66)) <= tgp.MAX_SMEM
    with pytest.raises(ValueError, match='shared memory'):
        tgp.generic_projection_fwd(big, big, 67)
    with pytest.raises(ValueError, match='shared memory'):
        tgp.generic_projection_bwd(big, big, *big[:, 0].repeat(6, 1, 1)
                                   .split(1), 67)
    res = tgp.generic_projection_fwd(ray, d, 4)
    tgp.generic_projection_bwd(ray, d, *res, gy, gx, 4)
    assert before == (tgp.generic_projection_fwd.launches,
                      tgp.generic_projection_bwd.launches)
    # the camera raises where the half-resolution plane is below 2p+1
    rays = t(_rays(10, 1, 32, 48))
    cam = tcg.GenericCamera(rays, patch_side=8)
    with pytest.raises(ValueError, match='2p\\+1 = 17 must fit the 16x24'):
        cam.project(cam.reconstruct(torch.ones(1, 32, 48, 1), 'c'))


# ---------------------------------------------------------------- camera

@pytest.mark.parametrize('downsample', [False, True])
def test_generic_camera_project_matches_jax(downsample):
    """Non-square 24x40 (12x20 at half resolution), p = 3, a random pose,
    frame 'w', progress 0.3: coordinates and gradients in the ray surface
    and the points."""
    B, H, W, p = 2, 24, 40, 3
    rays = _rays(11, B, H, W)
    rng = np.random.RandomState(12)
    depth = (rng.rand(B, H, W, 1) * 4 + 1).astype(np.float32)
    vec = (rng.randn(B, 6) * 0.05).astype(np.float32)

    def jf(r, pts):
        cam = jcg.GenericCamera.create(r, Tcw=JPose.from_vec(vec),
                                       patch_side=p)
        return cam.project(pts, progress=0.3, downsample=downsample,
                           frame='w')

    jpts = np.asarray(jcg.GenericCamera.create(rays, patch_side=p)
                      .reconstruct(depth, frame='w'))
    want, (jgr, jgp_) = jax.jit(jax.value_and_grad(
        lambda r, x: (jnp.sum(jf(r, x) ** 2), jf(r, x)), argnums=(0, 1),
        has_aux=True))(rays, jpts)
    want = np.asarray(want[1])

    rt = t(rays).requires_grad_(True)
    pts = tcg.GenericCamera(t(rays), patch_side=p).reconstruct(t(depth), 'w')
    close(pts, jpts, 1e-5)
    pt = pts.detach().requires_grad_(True)
    cam = tcg.GenericCamera(rt, TPose.from_vec(t(vec)), patch_side=p)
    got = cam.project(pt, progress=0.3, downsample=downsample, frame='w')
    assert got.shape == (B, H, W, 2)
    cross(got.detach(), want)
    (got ** 2).sum().backward()
    cross_grad(rt.grad, jgr)
    cross_grad(pt.grad, jgp_)
    # the identity grid back from a pinhole camera's own reconstruction
    if not downsample:
        xs = np.linspace(-1, 1, W, dtype=np.float32)
        assert abs(float(got[0, 12, 20, 0].detach()) - xs[20]) < 0.1


def test_pinhole_ray_surface_and_temperature_match_jax():
    K = _K(2, 12, 20)
    close(tcg.pinhole_ray_surface(t(K), 12, 20),
          jcg.pinhole_ray_surface(jnp.asarray(K), 12, 20), 1e-6)
    for progress in (0.0, 0.5, 1.0):
        want = jnp.maximum(1e-8, 1e-4 / jnp.exp(0.1 * jnp.float32(progress)))
        assert tcg.softmax_temperature(progress) == pytest.approx(
            float(want), rel=1e-6)


# -------------------------------------------------------- RaySurfaceResNet

@pytest.mark.parametrize('train', [True, False])
def test_ray_surface_resnet_matches_jax(train):
    rng = np.random.RandomState(13)
    rgb = rng.rand(2, 32, 64, 3).astype(np.float32)
    jm = JRSR(version='18pt')
    v = randomize(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                                   train=False), rgb), 14)
    if train:
        want, mut = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=['batch_stats']))(v, rgb)
    else:
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, rgb)
    tm = load_flax_variables(TRSR('18pt'), v).train(train)
    got = tm(t(rgb), input_depth=torch.zeros(2, 32, 64, 1))
    assert len(got['inv_depths']) == (4 if train else 1)
    for a, b_ in zip(got['inv_depths'], want['inv_depths']):
        assert a.shape == b_.shape
        close(a.detach(), b_, 1e-5)
    r = got['ray_surface'][('raysurf', 0)]
    assert r.shape == (2, 32, 64, 3) and r.dtype == torch.float32
    close(r.detach(), want['ray_surface'][('raysurf', 0)], 1e-5)
    if train:   # the running statistics moved as flax's did
        stats = flax_state_dict(tm, {'params': v['params'],
                                     'batch_stats': mut['batch_stats']})
        state = tm.state_dict()
        for k in stats:
            if k.endswith(('running_mean', 'running_var')):
                close(state[k], stats[k], 1e-4, k)
    # the weight carrier raises on a missing or an unexpected leaf
    params = jax.tree_util.tree_map(np.asarray, v['params'])
    head = params['ray_surf'].pop('raysurf_conv_0')
    with pytest.raises(KeyError, match='missing'):
        flax_state_dict(tm, {'params': params,
                             'batch_stats': v['batch_stats']})
    params['ray_surf']['raysurf_conv_1'] = head
    with pytest.raises(KeyError, match='unexpected'):
        flax_state_dict(tm, {'params': params,
                             'batch_stats': v['batch_stats']})


# ------------------------------------------------------------------- loss

def _loss_inputs(seed, B=1, H=16, W=24):
    rng = np.random.RandomState(seed)
    image = rng.rand(B, H, W, 3).astype(np.float32)
    ctx = [np.clip(image + rng.randn(B, H, W, 3) * 0.1, 0, 1).astype(
        np.float32) for _ in range(2)]
    inv = rng.uniform(0.2, 1.0, (B, H, W, 1)).astype(np.float32)
    residual = np.tanh(rng.randn(B, H, W, 3) * 0.5).astype(np.float32)
    vec = (rng.randn(B, 2, 6) * 0.02).astype(np.float32)
    return image, ctx, inv, residual, vec, _K(B, H, W)


@pytest.mark.parametrize('progress,full_res', [(0.0, False), (0.5, False),
                                               (0.5, True)])
def test_generic_loss_matches_jax(progress, full_res):
    """The omnicam YAML's loss fields, p = 3 on 16x24 (8x12 at half
    resolution): loss, metrics and gradients in the inverse depth, the
    ray-surface residual and the pose vectors. At progress 0 the residual
    gets no gradient in either."""
    kw = dict(ssim_loss_weight=0.85, smooth_loss_weight=0.01,
              photometric_reduce_op='mean', clip_loss=0.5, patch_side=3,
              full_res_projection=full_res)
    image, ctx, inv, residual, vec, K = _loss_inputs(15)
    jl = JGL(**kw)

    def jf(i, r, v):
        poses = [JPose.from_vec(v[:, c]) for c in range(2)]
        out = jl(image, ctx, [i], poses, ray_surface={('raysurf', 0): r},
                 K=K, progress=progress)
        return out['loss'], out['metrics']

    (want, want_m), grads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(inv, residual, vec)
    leaves = [t(a).requires_grad_(True) for a in (inv, residual, vec)]
    out = TGL(**kw)(t(image), [t(c) for c in ctx], [leaves[0]],
                    [TPose.from_vec(leaves[2][:, c]) for c in range(2)],
                    ray_surface={('raysurf', 0): leaves[1]}, K=t(K),
                    progress=progress)
    out['loss'].backward()
    assert sorted(out['metrics']) == sorted(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(out['metrics'][k].detach()),
                                   float(want_m[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(out['loss'].detach()), float(want),
                               rtol=1e-4)
    for a, b_ in zip(leaves, grads):
        cross_grad(a.grad, b_)
    if progress == 0.0:
        assert float(leaves[1].grad.abs().max()) == 0.0
        assert float(np.abs(grads[1]).max()) == 0.0
    else:
        assert float(leaves[1].grad.abs().max()) > 0.0


# ----------------------------------------------------------- whole step

SMALL = ['tpu.compute_dtype', 'float32',
         'datasets.augmentation.image_shape', (32, 64)]


def test_whole_generic_step_matches_jax_value_and_grad(monkeypatch):
    """GenericSelfSupModel (RaySurfaceResNet 18 + PoseNet, the omnicam
    YAML's loss) at B2 32x64 and progress 0.5, the window cut to p = 3 in
    both: loss, metrics and every gradient leaf, the ray head's included.

    B2, not the YAML's B1: at B1 the encoder's BN normalises its 1x2 lowest
    level over two values. The comparison is ill-conditioned at this size:
    the projections of the two formulations differ by ~1e-4 px, and a
    sample that close to an integer coordinate takes the other bilinear
    cell. In the port alone, a 3e-7 relative change of the temperature
    moves single leaves by 1e-3 on this batch (seed 16) and by up to 18% on
    others (seeds 18, 19), so the test holds this batch to the rule and
    reports that reading beside each leaf's error. The PoseNet conv biases
    before a GroupNorm have a zero gradient analytically (~2e-8 in both):
    leaves below 1e-6 x the largest leaf's gradient are held to that
    floor."""
    jcfg = j_parse(CONFIGS['half'], list(SMALL))
    tcfg = t_parse(CONFIGS['half'], list(SMALL))
    jm = j_setup_model(jcfg)
    jm = jm.clone(generic_photometric_loss=dataclasses.replace(
        jm.generic_photometric_loss, patch_side=3))
    batch = make_batches((32, 64), 2, 1, seed=16, device='cpu',
                         contexts=2)[0]
    np_batch = {k: ([c.numpy() for c in v] if isinstance(v, list)
                    else v.numpy()) for k, v in batch.items()}
    variables = randomize(jax.eval_shape(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False), np_batch), 17)

    def loss_fn(params, b):
        out, _ = jm.apply({'params': params,
                           'batch_stats': variables['batch_stats']}, b,
                          train=True, progress=0.5, mutable=['batch_stats'])
        return out['loss'], out['metrics']

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'], np_batch)

    tm = load_flax_variables(t_setup_model(tcfg), variables).train()
    tm.generic_photometric_loss.patch_side = 3
    out = tm(batch, progress=0.5)
    out['loss'].backward()
    np.testing.assert_allclose(float(out['loss'].detach()), float(jloss),
                               rtol=1e-4)
    assert sorted(out['metrics']) == sorted(jmetrics) == [
        'photometric_loss', 'smoothness_loss']
    for k in jmetrics:
        np.testing.assert_allclose(float(out['metrics'][k].detach()),
                                   float(jmetrics[k]), rtol=1e-4, err_msg=k)
    want = flax_state_dict(tm, {'params': jgrads,
                                'batch_stats': variables['batch_stats']})
    params = dict(tm.named_parameters())
    assert len(params) == len(jax.tree_util.tree_leaves(jgrads))
    assert float(params['depth_net.ray_surf.raysurf_conv_0.Conv_0.weight']
                 .grad.abs().max()) > 0.0
    # the disp heads of scales 1-3 feed no loss: None here, 0 in JAX
    got = {n: np.zeros_like(want[n]) if p.grad is None else
           p.grad.numpy().copy() for n, p in params.items()}

    # the batch's conditioning: the port's gradients again, with the
    # softmax temperature moved by 3e-7 relative
    temperature = tcg.softmax_temperature
    monkeypatch.setattr(tcg, 'softmax_temperature',
                        lambda progress: temperature(progress) * (1 + 3e-7))
    tm.zero_grad(set_to_none=True)
    tm(batch, progress=0.5)['loss'].backward()
    monkeypatch.undo()

    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for name, p in params.items():
        g, w = got[name], want[name]
        moved = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) + floor, (
            '{}: |g - g_jax| = {:.2e} |g_jax|; a 3e-7 change of the '
            'temperature moves the port\'s g by {:.2e} |g|'.format(
                name, np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30),
                np.linalg.norm(moved - g) / max(np.linalg.norm(g), 1e-30)))
    assert len(out['poses']) == 2 and len(out['inv_depths']) == 4


# ------------------------------------------------------- factory, entry

@pytest.mark.parametrize('which', ['half', 'full'])
def test_factory_builds_the_omnicam_yamls_as_jax(which):
    jm, tcfg = j_setup_model(j_parse(CONFIGS[which])), t_parse(CONFIGS[which])
    tm = t_setup_model(tcfg)
    assert isinstance(tm, GenericSelfSupModel)
    assert isinstance(tm.depth_net, TRSR)
    assert tm.depth_net.encoder.Conv_0.dtype == torch.bfloat16
    jl, tl = jm.generic_photometric_loss, tm.generic_photometric_loss
    assert tl.full_res_projection is (which == 'full')
    for f in ('num_scales', 'patch_side', 'full_res_projection',
              'ssim_loss_weight', 'smooth_loss_weight', 'C1', 'C2',
              'photometric_reduce_op', 'clip_loss', 'progressive_scaling',
              'padding_mode', 'automask_loss', 'inputs_are_sigmoids',
              'use_pallas', 'photometric_dtype'):
        assert getattr(tl, f) == getattr(jl, f), f
    assert (tl.patch_side, tl.num_scales, tl.photometric_dtype) == (
        20, 1, 'float32')
    assert tm.upsample_depth_maps is jm.upsample_depth_maps is True
    assert tuple(tcfg.datasets.augmentation.image_shape) == (384, 384)
    assert int(tcfg.datasets.train.batch_size) == 1
    assert port_train.n_contexts(tcfg) == 2


def test_init_weights_covers_the_ray_surface_head():
    model = t_setup_model(t_parse(CONFIGS['half']))
    heads = model.depth_net.ray_surf.raysurf_conv_0.Conv_0
    assert heads.init == 'xavier'
    with torch.no_grad():
        heads.weight.fill_(7.0)
        heads.bias.fill_(7.0)
    init_weights(model, torch.Generator().manual_seed(0))
    w = heads.weight.detach()
    limit = (6.0 / (16 * 9 + 3 * 9)) ** 0.5
    assert float(w.abs().max()) <= limit and float(w.std()) > limit / 4
    assert float(heads.bias.abs().max()) == 0.0
    again = init_weights(t_setup_model(t_parse(CONFIGS['half'])),
                         torch.Generator().manual_seed(0))
    assert torch.equal(again.depth_net.ray_surf.raysurf_conv_0.Conv_0.weight,
                       w)


def test_train_main_generic_on_cpu():
    """configs/train_omnicam.yaml at 96x96 (48x48 at half resolution, so
    p stays 20): two steps, the projection through the plain versions and
    no kernel launch counted."""
    counters = (tgp.generic_projection_fwd, tgp.generic_projection_bwd,
                twarp.warp_bilinear_out, twarp.warp_bilinear_dgrid)
    before = [f.launches for f in counters]
    run = port_train.main(CONFIGS['half'], device='cpu', n_steps=2,
                          n_batches=1, seed=0, overrides=[
                              'datasets.augmentation.image_shape', (96, 96)]
                          + RANDOM_INIT)
    assert np.all(np.isfinite(run['losses']))
    assert run['trainer'].optimizer.count == 2
    assert run['model'].generic_photometric_loss.patch_side == 20
    b = run['batches'][0]
    assert b['rgb'].shape == (1, 96, 96, 3) and len(b['rgb_context']) == 2
    assert [f.launches for f in counters] == before


def test_train_main_generic_loss_falls_on_a_shifted_context_batch():
    """configs/train_omnicam.yaml at 96x96 through train.main on caller
    batches: a smooth target whose context frames are it shifted by 4 px,
    ten steps in one epoch (progress below 0.02, as in the first steps of a
    run). The loss falls; the seeded batches' uniform-noise context frames
    give it nothing to learn."""
    b = make_batches((96, 96), 1, 1, seed=0, device='cpu', contexts=2)[0]
    sb = shifted_context_batch(b)
    assert torch.equal(sb['rgb_context'][0][:, :, 4:], sb['rgb'][:, :, :-4])
    assert torch.equal(sb['rgb_context'][1][:, :, :-4], sb['rgb'][:, :, 4:])
    assert sb['intrinsics'] is b['intrinsics'] and sb['rgb_original'] is \
        sb['rgb']
    run = port_train.main(CONFIGS['half'], device='cpu', n_steps=10, seed=0,
                          batches=[sb] * 10, overrides=[
                              'datasets.augmentation.image_shape', (96, 96)]
                          + RANDOM_INIT)
    losses = run['losses']
    assert run['trainer'].optimizer.count == 10
    assert all(b_ is sb for b_ in run['batches'])
    assert losses[-1] < 0.95 * losses[0], losses


# ------------------------------------- the kernels' lane split, emulated
#
# csrc/generic_projection.cu splits the work otherwise than the plain
# versions' loops. Forward: 4x8 pixel tiles whose windows' rays are staged
# in shared memory, 4 lanes a pixel taking the window columns j = tc + 4u
# (chunks of 11 slots, out-of-window slots clamped and masked), the window
# rows in order, each row's max and sums combined over the 4 lanes by warp
# shuffles (lane bits 0, 1) before the plain version's row recurrence. dd:
# 4x4 pixel tiles, 8 lanes a pixel (window-row halves x the 4 column
# phases), combined over lane bits 0, 1, 4. dray: 8x8 ray tiles, a warp's
# two ray rows sharing each staged pixel row, the pixels staged 8 rows at
# a time, 4 column lanes a ray combined over lane bits 3, 4. The emulation
# below walks the same tiles, bands, lanes and chunks in numpy (float32),
# checks that they visit each (pixel, window position) and each (ray,
# pixel) exactly once and read the ray the window names from the staged
# tile, and holds its fixed-order combination to the chip checks' limits
# against the plain versions: m rtol 1e-6, s rtol 1e-5, rows and cols atol
# 1e-5 of the plane's extent, dray and dd atol 2e-4 x max|ref|.

KERNEL_CONSTANTS = {'FTX': 8, 'PTX': 4, 'PTY': 4, 'CW': 11, 'RTX': 8,
                    'RTY': 8, 'BAND': 8}
FTX, PTX, PTY, CW, RTX, RTY, BAND = KERNEL_CONSTANTS.values()


def _plo(c, p):
    return np.where(c <= 2 * p, 0, c - p)


def _phi(c, p, n):
    return np.where(c >= n - (2 * p + 1), n - 1, c + p)


def _dd_row_stride(ncols, k1):
    """dd's staged row stride: padded so that its two window-row halves
    (h rows apart) load from distinct banks."""
    h = (k1 + 1) // 2
    return next((w for w in range(ncols, ncols + 32)
                 if 7 <= (h * w) % 32 <= 25), ncols)


def _pixel_lanes(H, W, p, txw):
    """Every pixel's tile and staged rays, as the pixel-major kernels place
    them on PTY x txw tiles: (the image position y * W + x of every staged
    element [tiles, RH*RW], -1 in the padding; tile index [H, W]; window
    offset in the staged tile [H, W]; RW)."""
    k1 = 2 * p + 1
    sy, sx = tgp.window_starts(H, p), tgp.window_starts(W, p)
    RH, ncols = min(PTY - 1 + k1, H), min(txw - 1 + k1, W)
    RW = ncols if txw == FTX else _dd_row_stride(ncols, k1)
    ty, tx = -(-H // PTY), -(-W // txw)
    staged = np.full((ty * tx, RH, RW), -1, np.int64)
    ry0, rx0 = sy[::PTY], sx[::txw]
    pos = np.arange(H * W).reshape(H, W)
    for a in range(ty):
        nrows = sy[min((a + 1) * PTY, H) - 1] + k1 - ry0[a]
        for b in range(tx):
            ncols = sx[min((b + 1) * txw, W) - 1] + k1 - rx0[b]
            assert nrows <= RH and ncols <= RW
            staged[a * tx + b, :nrows, :ncols] = pos[
                ry0[a]:ry0[a] + nrows, rx0[b]:rx0[b] + ncols]
    ys, xs = np.arange(H)[:, None], np.arange(W)[None]
    tile_of = (ys // PTY) * tx + xs // txw
    off = (sy[:, None] - ry0[ys // PTY]) * RW + (sx[None] - rx0[xs // txw])
    return staged.reshape(ty * tx, -1), tile_of, off, RW


def _chunk_slots(tc, k1):
    """The slots of a lane's window columns tc + 4u, chunk by chunk:
    [[(column j, column read jj, in window)] * CW]. A chunk whose first
    CW - 1 slots the kernel takes as in the window without a test must
    have them so."""
    chunks = []
    for jc in range(tc, k1, 4 * CW):
        fast = jc + 4 * (CW - 2) < k1
        chunk = []
        for u in range(CW):
            j = jc + 4 * u
            assert j < k1 or not (fast and u < CW - 1)
            chunk.append((j, min(j, k1 - 1), j < k1))
        chunks.append(chunk)
    return chunks


def _checked_window_rays(ray, lanes, p, jj, rows):
    """The rays the lanes read at window column jj of the window rows
    `rows` of every pixel, [B, 3, R, H, W], after checking that the staged
    tile's element they address holds the ray the window names."""
    staged, tile_of, off, RW = lanes
    H, W = ray.shape[2:]
    sy, sx = tgp.window_starts(H, p), tgp.window_starts(W, p)
    read = staged[tile_of[None], off[None] + rows[:, None, None] * RW + jj]
    want = (sy[None, :, None] + rows[:, None, None]) * W + sx[None, None] + jj
    assert np.array_equal(read, np.broadcast_to(want, read.shape))
    return ray.reshape(*ray.shape[:2], -1)[:, :, want]


def _butterfly(parts, masks):
    """Sum lane partials in the kernels' shuffle order: for each mask the
    lane adds its partner's value; every lane ends with the same sum."""
    parts = dict(parts)
    for mask in masks:
        parts = {k: parts[k] + parts[k ^ mask] for k in parts}
    return parts[0]


def _lane_logits(ray, d, p, lanes, tc, rows):
    """A lane's slots over the window rows `rows`: [(column j, in window,
    logits [R, B, H, W], rays [B, 3, R, H, W])]."""
    out = []
    for chunk in _chunk_slots(tc, 2 * p + 1):
        for j, jj, ok in chunk:
            g = _checked_window_rays(ray, lanes, p, jj, rows)
            logit = (d[:, 0, None] * g[:, 0] + d[:, 1, None] * g[:, 1]
                     + d[:, 2, None] * g[:, 2]).transpose(1, 0, 2, 3)
            out.append((j, ok, logit, g))
    return out


def emulate_forward(ray, d, p):
    """(rows, cols, m, s) by the forward kernel's lanes and order, and the
    visit count of every window position (every pixel's lanes walk the
    same slots; the staged rays they read are checked pixel by pixel)."""
    B, _, H, W = ray.shape
    k1 = 2 * p + 1
    f32 = np.float32
    sy, sx = tgp.window_starts(H, p), tgp.window_starts(W, p)
    tiles = _pixel_lanes(H, W, p, FTX)
    lanes = {}
    visits = np.zeros((k1, k1), np.int64)
    for tc in range(4):
        lanes[tc] = _lane_logits(ray, d, p, tiles, tc, np.arange(k1))
        for j, ok, _, _ in lanes[tc]:
            visits[:, j % k1] += ok
    m = np.full((B, H, W), -1e30, f32)
    s, ey, ex = (np.zeros((B, H, W), f32) for _ in range(3))
    for i in range(k1):
        lane_max = {tc: np.max([lg[i] if ok else np.full_like(lg[i], -1e30)
                                for _, ok, lg, _ in v], axis=0)
                    for tc, v in lanes.items()}
        m_new = np.maximum(m, np.maximum(
            np.maximum(lane_max[0], lane_max[1]),
            np.maximum(lane_max[2], lane_max[3])))
        alpha = np.exp(m - m_new)
        cs, cx = {}, {}
        for tc, lane in lanes.items():
            cs[tc], cx[tc] = np.zeros_like(m), np.zeros_like(m)
            for j, ok, lg, _ in lane:
                pe = np.exp(lg[i] - m_new) if ok else np.zeros_like(m)
                cs[tc] = cs[tc] + pe
                cx[tc] = cx[tc] + pe * (sx[None, None] + j).astype(f32)
        psum, pcx = _butterfly(cs, (1, 2)), _butterfly(cx, (1, 2))
        s = s * alpha + psum
        ey = ey * alpha + (sy[None, :, None] + i).astype(f32) * psum
        ex = ex * alpha + pcx
        m = m_new
    return ey / s, ex / s, m, s, visits


def emulate_dd(ray, d, rows, cols, m, s, gy, gx, p):
    """dd by the dd kernel's lanes and order: 8 lanes a pixel, th * 16 +
    tc, window rows [0, h) and [h, k1), each lane's slots row by row."""
    B, _, H, W = ray.shape
    k1 = 2 * p + 1
    h = (k1 + 1) // 2
    f32 = np.float32
    inv_s = f32(1) / s
    sy, sx = tgp.window_starts(H, p), tgp.window_starts(W, p)
    tiles = _pixel_lanes(H, W, p, PTX)
    centre = _checked_window_rays(ray, tiles, p, p, np.array([p]))[:, :, 0]
    parts = {}
    for th in (0, 1):
        wrows = np.arange(h, k1) if th else np.arange(h)
        for tc in range(4):
            lane = _lane_logits(ray, d, p, tiles, tc, wrows)
            gy_row = gy[None] * ((sy[None, None, :, None]
                                  + wrows[:, None, None, None]).astype(f32)
                                 - rows[None])                 # [R,B,H,W]
            acc = np.zeros((B, 3, H, W), f32)
            for j, ok, logit, g in lane:
                if not ok:
                    continue            # masked: glogit 0
                pk = np.exp(logit - m[None]) * inv_s[None]
                gl = pk * (gy_row + gx[None] * ((sx[None, None] + j)
                                                .astype(f32) - cols[None]))
                acc += np.einsum('rbhw,bkrhw->bkhw', gl,
                                 g - centre[:, :, None])
            parts[th * 16 + tc] = acc
    return _butterfly(parts, (1, 2, 16))


def emulate_dray(ray, d, rows, cols, m, s, gy, gx, p):
    """dray by the kernel's tiles, bands, warps and lanes, and every (ray,
    pixel) pair it visits, as ray index * H*W + pixel index, sorted. The
    bands' row ranges are walked as the kernel walks them and each row of
    a warp's range must come once; the sums then run over a tile's rows at
    once, each lane's apart, and over the lanes in the kernel's shuffle
    order."""
    B, _, H, W = ray.shape
    f32 = np.float32
    inv_s = f32(1) / s
    parts = np.zeros((4, B, 3, H, W), f32)        # by column lane tc
    pairs = []
    tc = np.arange(4)[:, None, None]
    for r0 in range(0, H, RTY):
        Y0, Y1 = int(_plo(r0, p)), int(_phi(min(r0 + RTY, H) - 1, p, H))
        ys = np.arange(Y0, Y1 + 1)
        # the tile's 8 ray rows, two a warp; a warp walks, band by band,
        # [max(yb, ylo of its first row), min(yb + nb - 1, yhi of its
        # second)], and a row feeds its first ray if y <= that ray's yhi,
        # its second if y >= that ray's ylo
        ra = r0 + np.arange(RTY)
        rr = np.minimum(ra, H - 1)
        ylo, yhi = _plo(rr, p), _phi(rr, p, H)
        walked = np.zeros((RTY // 2, len(ys)), np.int64)
        for w in range(RTY // 2):
            for yb in range(Y0, Y1 + 1, BAND):
                nb = min(BAND, Y1 - yb + 1)
                walked[w, max(yb, ylo[2 * w]) - Y0:
                       min(yb + nb - 1, yhi[2 * w + 1]) + 1 - Y0] += 1
        assert walked.max() == 1
        walked = np.repeat(walked, 2, axis=0).astype(bool)   # by ray row
        fed = walked & np.where((ra % 2 == 0)[:, None],
                                ys[None] <= yhi[:, None],
                                ys[None] >= ylo[:, None])
        fed &= (ra < H)[:, None]           # a row past H: not written
        for c0 in range(0, W, RTX):
            cw = c0 + np.arange(RTX)
            keep = cw < W
            c = np.minimum(cw, W - 1)
            xlo, xhi = _plo(c, p)[None, :, None], _phi(c, p, W)[None, :, None]
            # a lane's columns xlo + tc + 4u (its chunks of CW slots cut to
            # the slots any lane of the tile has)
            x = xlo + tc + 4 * np.arange(-(-int(np.max(xhi - xlo + 1))
                                           // 4))[None, None]
            ok = (fed[:, :, None, None, None]
                  & ((x <= xhi) & keep[None, :, None])[None, None])
            xx = np.minimum(x, xhi)
            q = (ys[:, None, None, None], xx[None])
            dq = d[:, :, q[0], q[1]]                     # [B,3,Y,4,8,U]
            mq, sq, gyq, gxq, eyq, exq = (
                a[:, None, q[0], q[1]] for a in (m, inv_s, gy, gx, rows,
                                                 cols))
            g = ray[:, :, rr[:, None], c[None]][:, :, :, None, None, :, None]
            logit = (dq[:, 0, None] * g[:, 0] + dq[:, 1, None] * g[:, 1]
                     + dq[:, 2, None] * g[:, 2])         # [B,8r,Y,4,8c,U]
            pk = np.exp(logit - mq) * sq
            gl = pk * (gyq * (rr.astype(f32)[:, None, None, None, None]
                              - eyq)
                       + gxq * (c.astype(f32)[:, None] - exq))
            gl = np.where(ok[None], gl, f32(0))
            contrib = np.einsum('brytcu,bkytcu->tbkrc', gl, dq)
            rk = ra < H
            parts[:, :, :, rr[rk][:, None], c[keep][None]] += \
                contrib[:, :, :, rk][..., keep]
            ri, yi, ti, ci, ui = np.nonzero(ok)
            pairs.append((rr[ri] * W + c[ci]) * (H * W) + ys[yi] * W
                         + x[ti, ci, ui])
    dray = _butterfly({k: parts[k] for k in range(4)}, (1, 2))
    return dray, np.sort(np.concatenate(pairs))


def _expected_pairs(H, W, p):
    """Every (ray, pixel) pair whose window holds the ray, sorted."""
    k1 = 2 * p + 1
    sy, sx = tgp.window_starts(H, p), tgp.window_starts(W, p)
    ry = sy[:, None] + np.arange(k1)[None]                      # [H, k1]
    rx = sx[:, None] + np.arange(k1)[None]                      # [W, k1]
    ray_idx = ry[:, None, :, None] * W + rx[None, :, None, :]   # [H,W,k1,k1]
    pix = (np.arange(H)[:, None] * W + np.arange(W)[None])[..., None, None]
    return np.sort((ray_idx * (H * W) + pix).ravel())


def _peaked(seed, B, H, W):
    rays = _rays(seed, B, H, W)
    d = _rays(seed + 1, B, H, W) / tcg.softmax_temperature(0.0)
    return (np.ascontiguousarray(rays.transpose(0, 3, 1, 2)),
            np.ascontiguousarray(d.transpose(0, 3, 1, 2)).astype(np.float32))


def test_kernel_constants_match_the_emulation():
    src = (build.CSRC / 'generic_projection.cu').read_text()
    for name, value in KERNEL_CONSTANTS.items():
        assert re.search(r'constexpr int {} = {};'.format(name, value), src), \
            name


@pytest.mark.parametrize('shape', [(1, 48, 48), (2, 41, 41), (1, 41, 97)])
def test_kernel_lane_split_visits_once_and_matches_plain(shape):
    """The kernels' tiles, lanes and chunks at p = 20, emulated: each
    (pixel, window position) once, each (ray, pixel) of a window once and
    nothing else, the staged rays the windows name, and the fixed-order
    sums within the chip checks' limits of the plain versions. Rays near
    the pinhole template with directions at the temperature of progress 0
    (a peaked softmax); at B2 the second image has random rays and
    directions (a flat one)."""
    B, H, W = shape
    p = 20
    ray, d = _peaked(20 + H, 1, H, W)
    if B == 2:
        flat = _proj_inputs(21, 1, H, W)[:2]
        ray, d = (np.concatenate([a, b]) for a, b in zip((ray, d), flat))
    gy, gx = _proj_inputs(22, B, H, W)[2:]
    rows, cols, m, s, visits = emulate_forward(ray, d, p)
    assert np.all(visits == 1)
    want = [a.numpy() for a in tgp.generic_projection_fwd_reference(
        t(ray), t(d), p)]
    for got, ref, ext in ((rows, want[0], H - 1), (cols, want[1], W - 1)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * ext)
    np.testing.assert_allclose(m, want[2], rtol=1e-6, atol=0)
    np.testing.assert_allclose(s, want[3], rtol=1e-5, atol=0)
    res = [np.asarray(a) for a in want]
    dd = emulate_dd(ray, d, *res, gy, gx, p)
    dray, pairs = emulate_dray(ray, d, *res, gy, gx, p)
    np.testing.assert_array_equal(pairs, _expected_pairs(H, W, p))
    wdray, wdd = (a.numpy() for a in tgp.generic_projection_bwd_reference(
        t(ray), t(d), *(t(a) for a in res), t(gy), t(gx), p))
    close(dd, wdd, 2e-4)
    close(dray, wdray, 2e-4)
