"""The port's DepthResNet and PoseResNet against the JAX package's flax
modules, on the CPU in float32 at 64x96, on variables drawn with numpy and
carried by load_flax_variables:

- forward in training (4 scales) and eval (1 scale): atol 1e-5 x max|ref|;
- the gradient of a fixed random projection of the outputs, per leaf
  |g - g_jax| <= 2e-2 |g_jax| + 1e-8 in the Frobenius norm (float32 sums
  in another order through ReLU and max-pool ties), the rule of
  tests/test_torch_train.py;
- the BatchNorm statistics after one training call: per leaf atol 1e-5 x
  max|leaf| (float32 means summed in another order). PoseResNet
  calls its one encoder once per context, so they move twice, in order
  (flax momentum 0.9 is PyTorch's 0.1);
- the 'pt' loads of both encoders (PoseResNet's takes two stacked images)
  from one state_dict the test writes, bit-equal to JAX's
  `load_pretrained_encoder`, and a file missing a key raises;
- the pose vector's layout, [translation, axisangle] per context, read as
  Euler angles by Pose.from_vec as in JAX;
- DepthResNet's output, a disparity in [0.01, 10], read as a sigmoid by
  the photometric loss and the eval in both packages: the same depths from
  one output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.export import torch_import as jimport
from packnet_sfm_tpu.geometry.pose import Pose as JPose
from packnet_sfm_tpu.networks.depth.depth_resnet import (
    DepthResNet as JDepthResNet)
from packnet_sfm_tpu.networks.pose.pose_net import PoseResNet as JPoseResNet
from packnet_sfm_tpu.ops import depth as jdepth
from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.config import parse_train_config
from packnet_sfm_tpu_torch.geometry.pose import Pose as TPose
from packnet_sfm_tpu_torch.models.factory import setup_model
from packnet_sfm_tpu_torch.networks.depth.depth_resnet import (
    DepthResNet as TDepthResNet)
from packnet_sfm_tpu_torch.networks.pose.pose_net import (
    PoseResNet as TPoseResNet)
from packnet_sfm_tpu_torch.ops import depth as tdepth
from packnet_sfm_tpu_torch.utils import pretrained
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_state_dict, flax_variables, load_flax_variables)
from tests.test_pretrained import synth_torchvision_resnet18_sd
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import randomize_variables

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SHAPE = (64, 96)
TRAIN_KITTI = 'configs/train_kitti.yaml'


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30))


def grads_close(model, jgrads, stats):
    want = flax_state_dict(model, {'params': jgrads, 'batch_stats': stats})
    params = dict(model.named_parameters())
    assert len(params) == len(jax.tree_util.tree_leaves(jgrads))
    for name, p in params.items():
        g, w = p.grad.numpy(), want[name]
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) + 1e-8, name


def stats_close(model, jstats):
    got = flax_variables(model)['batch_stats']
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(jstats)):
        want = np.asarray(b)
        np.testing.assert_allclose(a, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope='module')
def depth_case():
    """The flax DepthResNet('18pt') on a B2 64x96 image: its variables, one
    jitted train call (outputs, updated statistics, the gradient of
    sum(w_i * out_i)) and the eval output."""
    rng = np.random.RandomState(0)
    rgb = rng.rand(2, *SHAPE, 3).astype(np.float32)
    w = [rng.randn(2, SHAPE[0] >> i, SHAPE[1] >> i, 1).astype(np.float32)
         for i in range(4)]
    jm = JDepthResNet(version='18pt')
    v = randomize_variables(jax.eval_shape(
        lambda x: jm.init(jax.random.PRNGKey(0), x, train=False), rgb), 11)

    def loss(params, stats, x):
        out, mut = jm.apply({'params': params, 'batch_stats': stats}, x,
                            train=True, mutable=['batch_stats'])
        return sum((o * wi).sum() for o, wi in zip(out['inv_depths'], w)), \
            (out['inv_depths'], mut['batch_stats'])

    (_, (outs, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v['params'], v['batch_stats'], rgb)
    evals = jax.jit(lambda var, x: jm.apply(var, x, train=False))(v, rgb)
    return rgb, w, v, outs, stats, grads, evals['inv_depths']


@pytest.fixture(scope='module')
def pose_case():
    """The flax PoseResNet('18pt') on a B2 64x96 target and two contexts,
    as `depth_case`."""
    rng = np.random.RandomState(1)
    img = rng.rand(2, *SHAPE, 3).astype(np.float32)
    ctx = [rng.rand(2, *SHAPE, 3).astype(np.float32) for _ in range(2)]
    w = rng.randn(2, 2, 6).astype(np.float32)
    jm = JPoseResNet(version='18pt')
    v = randomize_variables(jax.eval_shape(
        lambda a, c: jm.init(jax.random.PRNGKey(0), a, c, train=False),
        img, ctx), 12)

    def loss(params, stats, a, c):
        out, mut = jm.apply({'params': params, 'batch_stats': stats}, a, c,
                            train=True, mutable=['batch_stats'])
        return (out * w).sum(), (out, mut['batch_stats'])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v['params'], v['batch_stats'], img, ctx)
    evals = jax.jit(lambda var, a, c: jm.apply(var, a, c, train=False))(
        v, img, ctx)
    return img, ctx, w, v, out, stats, grads, evals


def test_depth_resnet_matches_flax(depth_case):
    rgb, w, v, outs, stats, grads, evals = depth_case
    tm = load_flax_variables(TDepthResNet('18pt'), v).train()
    got = tm(t(rgb))['inv_depths']
    assert [tuple(o.shape) for o in got] == [
        (2, SHAPE[0] >> i, SHAPE[1] >> i, 1) for i in range(4)]
    for a, b in zip(got, outs):
        close(a.detach(), b, 1e-5)
    sum((o * t(wi)).sum() for o, wi in zip(got, w)).backward()
    grads_close(tm, grads, v['batch_stats'])
    stats_close(tm, stats)
    tm = load_flax_variables(TDepthResNet('18pt'), v).eval()
    with torch.no_grad():
        (got,) = tm(t(rgb))['inv_depths']
    close(got, evals[0], 1e-5)
    # a disparity in [0.01, 10], not a sigmoid
    assert 0.01 <= float(got.min()) and float(got.max()) <= 10.0


def test_pose_resnet_matches_flax(pose_case):
    img, ctx, w, v, out, stats, grads, evals = pose_case
    tm = load_flax_variables(TPoseResNet('18pt'), v).train()
    assert tm.encoder.Conv_0.weight.shape == (64, 6, 7, 7)
    got = tm(t(img), [t(c) for c in ctx])
    assert got.shape == (2, 2, 6) and got.dtype == torch.float32
    close(got.detach(), out, 1e-5)
    (got * t(w)).sum().backward()
    grads_close(tm, grads, v['batch_stats'])
    # one encoder, two calls: the statistics moved twice, in order
    stats_close(tm, stats)
    once = load_flax_variables(TPoseResNet('18pt'), v).train()
    once(t(img), [t(ctx[0])])
    moved = flax_variables(once)['batch_stats']['encoder']['BatchNorm_0']
    twice = flax_variables(tm)['batch_stats']['encoder']['BatchNorm_0']
    assert not np.allclose(moved['mean'], twice['mean'])
    assert tm.encoder.BatchNorm_0.flax_momentum == 0.9
    tm = load_flax_variables(TPoseResNet('18pt'), v).eval()
    with torch.no_grad():
        close(tm(t(img), [t(c) for c in ctx]), evals, 1e-5)


def test_pose_vector_is_translation_then_euler_angles(pose_case):
    """Each context's 6-vector is [translation, axisangle] from the pose
    decoder; SfmModel reads it with Pose.from_vec(..., 'euler'), the
    axis-angle half taken as Euler angles, as JAX does."""
    img, ctx, _, v, _, _, _, evals = pose_case
    tm = load_flax_variables(TPoseResNet('18pt'), v).eval()
    x = torch.cat([t(img), t(ctx[1])], -1).permute(0, 3, 1, 2)
    with torch.no_grad():
        axisangle, translation = tm.decoder([tm.encoder(x)])
        vec = tm(t(img), [t(c) for c in ctx])
    assert axisangle.shape == translation.shape == (2, 2, 1, 3)
    np.testing.assert_array_equal(vec[:, 1, :3].numpy(),
                                  translation[:, 0, 0].numpy())
    np.testing.assert_array_equal(vec[:, 1, 3:].numpy(),
                                  axisangle[:, 0, 0].numpy())
    got = TPose.from_vec(vec[:, 1], 'euler').mat.numpy()
    want = JPose.from_vec(np.asarray(evals)[:, 1], 'euler').mat
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_depth_resnet_output_is_read_as_a_sigmoid(depth_case):
    """As in JAX, train_kitti.yaml's loss reads DepthResNet's disparity as
    a sigmoid (`inputs_are_sigmoids`, min_depth 0.0 -> 0.05, max 80), and
    the eval too (min_depth 0.0: max inverse depth 1e6): both packages give
    the same depths from one output, not the 1 / disparity the network
    means."""
    rgb, _, v, _, _, _, evals = depth_case
    disp = np.asarray(evals[0])
    loss = setup_model(parse_train_config(TRAIN_KITTI)).photometric_loss
    assert loss.inputs_are_sigmoids and (loss.min_depth, loss.max_depth) \
        == (0.05, 80.0)
    got = tdepth.sigmoid_to_depth_linear(t(disp), loss.min_depth,
                                         loss.max_depth)
    want = jdepth.sigmoid_to_depth_linear(disp, 0.05, 80.0)
    close(got, want, 1e-6)
    assert not np.allclose(got.numpy(), 1.0 / disp, rtol=1e-2)
    got = tdepth.sigmoid_to_inv_depth(t(disp), 0.0, 80.0)
    want = jdepth.sigmoid_to_inv_depth(jnp.asarray(disp), 0.0, 80.0)
    close(got, want, 1e-6)
    np.testing.assert_allclose(float(tdepth.sigmoid_to_inv_depth(
        torch.ones(()), 0.0, 80.0)), 1e6, rtol=1e-6)


def test_pt_loads_match_jax_and_refuse_a_missing_key(depth_case, pose_case,
                                                     tmp_path):
    """One torchvision-layout state_dict file, loaded by the port into
    DepthResNet's and PoseResNet's encoders (train.build, as the YAML asks)
    and by JAX's load_pretrained_encoder: bit-equal encoders. PoseResNet's
    first conv is conv1 repeated over the two images and halved."""
    path = str(tmp_path / 'resnet18-test.pth')
    torch.save(synth_torchvision_resnet18_sd(seed=5), path)
    _, model = port_train.build(TRAIN_KITTI, 'cpu', seed=0, overrides=[
        'model.depth_net.weights_path', path,
        'model.pose_net.weights_path', path])
    for net, case, n in (('depth_net', depth_case, 1),
                         ('pose_net', pose_case, 2)):
        v = case[2] if net == 'depth_net' else case[3]
        jv = jimport.load_pretrained_encoder(v, 18, num_input_images=n,
                                             weights_path=path,
                                             required=True)
        got = flax_variables(getattr(model, net).encoder)
        for col in ('params', 'batch_stats'):
            for (p, a), (_, b) in zip(
                    jax.tree_util.tree_leaves_with_path(got[col]),
                    jax.tree_util.tree_leaves_with_path(jv[col]['encoder'])):
                np.testing.assert_array_equal(
                    a, np.asarray(b), err_msg=net + jax.tree_util.keystr(p))
    conv1 = synth_torchvision_resnet18_sd(seed=5)['conv1.weight'].numpy()
    np.testing.assert_array_equal(
        model.pose_net.encoder.Conv_0.weight.detach().numpy(),
        np.concatenate([conv1, conv1], 1) / 2)
    sd = synth_torchvision_resnet18_sd(seed=5)
    del sd['layer2.0.downsample.1.running_var']
    bad = str(tmp_path / 'resnet18-missing.pth')
    torch.save(sd, bad)
    with pytest.raises(KeyError):
        pretrained.load_pretrained_encoder(TPoseResNet('18pt').encoder, 18,
                                           weights_path=bad,
                                           num_input_images=2)


def test_pose_resnet_pt_without_weights_raises(tmp_path, monkeypatch):
    """A 'pt' PoseResNet demands its weights as the depth net does; its own
    allow_random_init lets it start from random weights."""
    monkeypatch.setenv('PACKNET_WEIGHTS_DIR', str(tmp_path / 'empty'))
    monkeypatch.setenv('TORCH_HOME', str(tmp_path / 'torch'))
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    with pytest.raises(pretrained.PretrainedWeightsNotFound):
        port_train.build(TRAIN_KITTI, 'cpu', overrides=[
            'model.depth_net.allow_random_init', True])
    _, model = port_train.build(TRAIN_KITTI, 'cpu', overrides=[
        'model.depth_net.allow_random_init', True,
        'model.pose_net.allow_random_init', True])
    assert isinstance(model.pose_net, TPoseResNet)
