"""The generic (ray-surface) camera family's data and evaluation against the
JAX package, on the CPU in float32:

- the generic photometric loss with a `ray_template` (JAX
  losses/generic_photometric.py:45-60) in place of the pinhole template of
  K, p = 3 on 16x24 at progress 0.5: loss and metrics rtol 1e-5, the
  gradients of the inverse depth, the residual and the pose vectors at
  tests/test_torch_generic.py's cross-formulation limits (rtol 5e-3, atol
  2e-3 x max|ref|); the template alone, K absent, gives the same;
- eval.main on configs/train_omnicam.yaml (seeded weights, 64x96): its
  metrics finite, and the forward of its model (inv_depths, ray_surface)
  against the JAX eval step on the same weights, atol 1e-5 x max|ref|;
- configs/train_omnicam_fullres.yaml through train.fit on an Image tree
  written by `write_image_tree` (64x96: the full-resolution projection's
  41x41 window fits), then eval.test over its GenericSelfSupModel
  checkpoint with the save pass, and that checkpoint's forward on the test
  loader's batch against the JAX eval step on the checkpoint as the JAX
  package loads it, atol 1e-5 x max|ref|.
"""

import os

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
from packnet_sfm_tpu.utils.checkpoint import load_checkpoint as j_load
from packnet_sfm_tpu_torch import eval as port_eval
from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.config import parse_test_file
from packnet_sfm_tpu_torch.datasets.image_dataset import write_image_tree
from packnet_sfm_tpu_torch.datasets.loader import to_device_batch
from packnet_sfm_tpu_torch.geometry.pose import Pose as TPose
from packnet_sfm_tpu_torch.losses.generic_photometric import (
    GenericMultiViewPhotometricLoss as TGL)
from packnet_sfm_tpu_torch.models.factory import setup_model
from packnet_sfm_tpu_torch.parallel.train_step import make_eval_step
from packnet_sfm_tpu_torch.trainers.trainer import make_loader
from packnet_sfm_tpu_torch.utils.checkpoint import load_weights
from packnet_sfm_tpu_torch.utils.flax_weights import flax_variables
from tests.test_torch_generic import _K, close, cross_grad
from tests.torch_fixtures import one_torch_thread  # noqa: F401

OMNICAM = 'configs/train_omnicam.yaml'
FULLRES = 'configs/train_omnicam_fullres.yaml'
SHAPE = (64, 96)
SMALL = ['tpu.compute_dtype', 'float32', 'datasets.augmentation.image_shape',
         SHAPE, 'model.depth_net.allow_random_init', True]


def t(x):
    return torch.from_numpy(np.array(x))


def test_loss_with_a_ray_template_matches_jax():
    progress = 0.5
    rng = np.random.RandomState(31)
    B, H, W = 1, 16, 24
    image = rng.rand(B, H, W, 3).astype(np.float32)
    ctx = [np.clip(image + rng.randn(B, H, W, 3) * 0.1, 0, 1).astype(
        np.float32) for _ in range(2)]
    inv = rng.uniform(0.2, 1.0, (B, H, W, 1)).astype(np.float32)
    residual = np.tanh(rng.randn(B, H, W, 3) * 0.5).astype(np.float32)
    vec = (rng.randn(B, 2, 6) * 0.02).astype(np.float32)
    # a template off the pinhole one: its rays turned and renormalised
    tmpl = np.asarray(jcg.pinhole_ray_surface(jnp.asarray(_K(B, H, W)), H,
                                              W))
    tmpl = tmpl + rng.randn(*tmpl.shape).astype(np.float32) * 0.05
    tmpl = (tmpl / np.linalg.norm(tmpl, axis=-1, keepdims=True)).astype(
        np.float32)
    kw = dict(ssim_loss_weight=0.85, smooth_loss_weight=0.01,
              photometric_reduce_op='mean', clip_loss=0.5, patch_side=3)
    jl = JGL(**kw)

    def jf(i, r, v):
        poses = [JPose.from_vec(v[:, c]) for c in range(2)]
        out = jl(image, ctx, [i], poses, ray_surface={('raysurf', 0): r},
                 ray_template=tmpl, progress=progress)
        return out['loss'], out['metrics']

    (want, want_m), grads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(inv, residual, vec)
    outs = []
    for K in (None, t(_K(B, H, W))):
        leaves = [t(a).requires_grad_(True) for a in (inv, residual, vec)]
        out = TGL(**kw)(t(image), [t(c) for c in ctx], [leaves[0]],
                        [TPose.from_vec(leaves[2][:, c]) for c in range(2)],
                        ray_surface={('raysurf', 0): leaves[1]}, K=K,
                        ray_template=t(tmpl), progress=progress)
        out['loss'].backward()
        outs.append((out, leaves))
    (out, leaves), (out_k, leaves_k) = outs
    assert float(out['loss'].detach()) == float(out_k['loss'].detach())
    for a, b_ in zip(leaves, leaves_k):
        assert torch.equal(a.grad, b_.grad)
    np.testing.assert_allclose(float(out['loss'].detach()), float(want),
                               rtol=1e-5)
    assert sorted(out['metrics']) == sorted(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(out['metrics'][k].detach()),
                                   float(want_m[k]), rtol=1e-5, err_msg=k)
    for a, b_ in zip(leaves, grads):
        cross_grad(a.grad, b_)
    # the template, not K, sets the rays: the pinhole loss differs
    pinhole = TGL(**kw)(t(image), [t(c) for c in ctx], [t(inv)],
                        [TPose.from_vec(t(vec)[:, c]) for c in range(2)],
                        ray_surface={('raysurf', 0): t(residual)},
                        K=t(_K(B, H, W)), progress=progress)
    assert float(pinhole['loss']) != float(out['loss'].detach())
    with pytest.raises(ValueError, match='intrinsics'):
        TGL(**kw)(t(image), [t(c) for c in ctx], [t(inv)],
                  [TPose.from_vec(t(vec)[:, c]) for c in range(2)],
                  ray_surface={('raysurf', 0): t(residual)})


@pytest.fixture(scope='module')
def jax_forward():
    """The omnicam model's eval forward in JAX, jitted once for the
    module: (variables, rgb) -> {'inv_depths', 'ray_surface'}."""
    jm = j_setup_model(j_parse(OMNICAM, list(SMALL)))
    return jax.jit(lambda v, rgb: jm.apply(v, {'rgb': rgb}, train=False))


def forward_matches_jax(model, rgb, variables, jax_forward):
    got = make_eval_step(model)({'rgb': rgb})
    want = jax_forward(variables, rgb.numpy())
    assert len(got['inv_depths']) == len(want['inv_depths']) == 1
    close(got['inv_depths'][0], want['inv_depths'][0], 1e-5)
    r = got['ray_surface'][('raysurf', 0)]
    assert r.shape == tuple(rgb.shape)
    close(r, want['ray_surface'][('raysurf', 0)], 1e-5)


def test_eval_main_on_omnicam_matches_the_jax_forward(
        jax_forward, one_torch_thread):  # noqa: F811
    metrics = port_eval.main(OMNICAM, device='cpu', batch_size=1,
                             n_batches=2, seed=3, overrides=list(SMALL))
    assert len(metrics) == 6 * 7 + 1 and not metrics.skipped
    assert np.isfinite(metrics['depth-abs_rel'])
    config, model = port_eval.build(OMNICAM, 'cpu', 3, list(SMALL))
    batch = port_eval.make_batches(SHAPE, 1, 1, seed=3, device='cpu')[0]
    forward_matches_jax(model, batch['rgb'], flax_variables(model),
                        jax_forward)


def test_checkpoint_trained_on_an_image_tree_evaluates_as_jax(
        tmp_path, jax_forward, one_torch_thread):  # noqa: F811
    root = write_image_tree(str(tmp_path / 'frames'), 2, *SHAPE, seed=4)
    ck = str(tmp_path / 'ckpt')
    trainer = port_train.fit(FULLRES, 'cpu', list(SMALL) + [
        'datasets.train.path', [root], 'datasets.train.num_workers', 2,
        'arch.max_epochs', 1, 'checkpoint.filepath', ck])
    assert trainer.step == trainer.optimizer.count == 2
    (name,) = [f for f in os.listdir(os.path.join(ck, 'model'))
               if f.endswith('.ckpt')]
    ckpt = os.path.join(ck, 'model', name)
    test_split = ['datasets.test.dataset', ['Image'], 'datasets.test.path',
                  [root], 'datasets.test.split', ['']]
    out = str(tmp_path / 'out')
    metrics = port_eval.test(ckpt, device='cpu', save_folder=out,
                             overrides=test_split)
    # Image frames carry no depth: no metrics; both frames saved
    assert dict(metrics) == {} and not metrics.skipped
    saved = sorted(f for _, _, files in os.walk(out) for f in files)
    assert saved == ['{:06d}_{}'.format(i, kind) for i in range(2) for kind
                     in ('depth.npz', 'depth.png', 'rgb.png', 'viz.png')]
    config, state = parse_test_file(ckpt, None, test_split)
    model = load_weights(setup_model(config), state)
    batch = to_device_batch(next(iter(make_loader(config, 'test'))), 'cpu')
    assert tuple(batch['rgb'].shape) == (1,) + SHAPE + (3,)
    jstate = j_load(ckpt)
    forward_matches_jax(model, batch['rgb'],
                        {'params': jstate['params'],
                         'batch_stats': jstate['batch_stats']}, jax_forward)
