"""The port's pretrained-weight loads (packnet_sfm_tpu_torch/utils/
pretrained.py, called by train.build) against the JAX package's, on the CPU
in float32.

- ResNetSAN01 builds every version as JAX's parse_version does: '18pt' and
  '18A' give the same ResNet-18, and '18pt' matches the flax model's
  forward on the same variables (atol 1e-5 on the sigmoid map).
- A torchvision-layout state_dict the test writes (seeded numpy values,
  torch.save) loads into the port's encoder bit-equal to what the JAX
  package's `load_pretrained_encoder` makes of the same file.
- A 'pt' depth net without weights raises PretrainedWeightsNotFound from
  train.build, as the JAX trainer does, unless allow_random_init is set;
  weights_path and $PACKNET_WEIGHTS_DIR supply the file, and train.build
  loads it into an encoder bit-equal to JAX's key map of that file.
- model.depth_net.checkpoint_path loads a checkpoint written by the port's
  save_checkpoint into the depth net as JAX's utils/load.py
  `load_network` merges it (parameters only; BN statistics kept). A
  checkpoint that lacks one of the net's keys raises in the port, where
  `load_network` keeps that key's random init without a word.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.export import torch_import as jimport
from packnet_sfm_tpu.networks.depth.resnet_san import ResNetSAN01 as JSAN01
from packnet_sfm_tpu.utils.load import load_network
from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.networks.depth.resnet_san import (
    ResNetSAN01 as TSAN01)
from packnet_sfm_tpu_torch.utils import pretrained
from packnet_sfm_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint)
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_variables, load_flax_variables)
from tests.test_pretrained import synth_torchvision_resnet18_sd
from tests.test_torch_resnet_san import init, randomize
from tests.torch_fixtures import CONFIG, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

# the depth net without its SAN branch (a quarter of the weights): the
# loads under test touch the encoder and the checkpoint's keys alone
SMALL = ['model.depth_net.use_film', False]
PT = SMALL + ['model.depth_net.version', '18pt']


@pytest.fixture(scope='module')
def jax_18pt():
    """The flax ResNetSAN01('18pt') at 32x64 B1, its randomized variables,
    the input and one jitted eval apply for any variables of that tree."""
    rgb = np.random.RandomState(0).rand(1, 32, 64, 3).astype(np.float32)
    jm = JSAN01(version='18pt')
    v = randomize(init(jm, rgb, train=False), 21)
    fwd = jax.jit(lambda var, x: jm.apply(var, x, train=False)
                  ['inv_depths'][0])
    return rgb, v, fwd


@pytest.fixture
def no_weights(tmp_path, monkeypatch):
    """An environment where no torchvision file can be found."""
    monkeypatch.setenv('PACKNET_WEIGHTS_DIR', str(tmp_path / 'empty'))
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    monkeypatch.setenv('TORCH_HOME', str(tmp_path / 'torch'))
    monkeypatch.delenv('XDG_CACHE_HOME', raising=False)
    return tmp_path


def weights_file(path, seed=3):
    torch.save(synth_torchvision_resnet18_sd(seed=seed), str(path))
    return str(path)


def port_forward(model, rgb):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(rgb))['inv_depths'][0].numpy()


def test_resnet_san_builds_every_version_as_jax():
    """'18pt', '18A' and '' are all ResNet-18 (JAX parse_version ignores
    the variant); '50pt' the bottleneck ResNet-50."""
    shapes = {v: {k: t.shape for k, t in TSAN01(v).state_dict().items()}
              for v in ('18pt', '18A', '')}
    assert shapes['18pt'] == shapes['18A'] == shapes['']
    assert hasattr(TSAN01('50pt').encoder, 'Bottleneck_15')


def test_resnet_san_18pt_matches_jax(jax_18pt):
    rgb, v, fwd = jax_18pt
    model = load_flax_variables(TSAN01('18pt'), v)
    np.testing.assert_allclose(port_forward(model, rgb),
                               np.asarray(fwd(v, rgb)), atol=1e-5, rtol=0)


def test_weights_path_loads_the_encoder_as_jax(jax_18pt, tmp_path):
    """The same file through JAX's load_pretrained_encoder (then carried
    across) and through the port's: bit-equal encoders, the forward equal
    to the flax model's with the JAX-loaded variables."""
    rgb, v, fwd = jax_18pt
    path = weights_file(tmp_path / 'resnet18-test.pth')
    jv = jimport.load_pretrained_encoder(v, 18, weights_path=path,
                                         required=True)
    via_jax = load_flax_variables(TSAN01('18pt'), jv)
    port = load_flax_variables(TSAN01('18pt'), v)
    assert pretrained.load_pretrained_encoder(
        port.encoder, 18, weights_path=path, required=True) == path
    want = via_jax.encoder.state_dict()
    got = port.encoder.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_allclose(port_forward(port, rgb),
                               np.asarray(fwd(jv, rgb)), atol=1e-5, rtol=0)


def test_pt_config_without_weights_raises_unless_allowed(no_weights,
                                                         monkeypatch):
    """train.build on a '18pt' depth net: PretrainedWeightsNotFound as JAX
    raises it; allow_random_init keeps the seeded init ('18A' draws the
    same); weights_path, or a file in $PACKNET_WEIGHTS_DIR, loads it."""
    with pytest.raises(jimport.PretrainedWeightsNotFound):
        jimport.load_pretrained_encoder({'params': {}, 'batch_stats': {}},
                                        18, required=True)
    with pytest.raises(pretrained.PretrainedWeightsNotFound):
        port_train.build(CONFIG, 'cpu', overrides=PT)
    assert issubclass(pretrained.PretrainedWeightsNotFound,
                      FileNotFoundError)

    _, allowed = port_train.build(
        CONFIG, 'cpu', overrides=PT + ['model.depth_net.allow_random_init',
                                       True])
    _, plain = port_train.build(CONFIG, 'cpu', overrides=SMALL)
    for (k, a), (_, b) in zip(allowed.state_dict().items(),
                              plain.state_dict().items()):
        assert torch.equal(a, b), k

    # the encoder JAX's key map makes of the same file, carried across
    path = weights_file(no_weights / 'resnet18-given.pth')
    params, stats = jimport.torchvision_resnet_to_flax(
        synth_torchvision_resnet18_sd(seed=3))
    want = load_flax_variables(TSAN01('18pt').encoder, {
        'params': params, 'batch_stats': stats}).state_dict()
    _, given = port_train.build(
        CONFIG, 'cpu', overrides=PT + ['model.depth_net.weights_path', path])
    found_dir = no_weights / 'weights'
    found_dir.mkdir()
    weights_file(found_dir / 'resnet18-found.pth')
    monkeypatch.setenv('PACKNET_WEIGHTS_DIR', str(found_dir))
    _, found = port_train.build(CONFIG, 'cpu', overrides=PT)
    for model in (given, found):
        got = model.depth_net.encoder.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_checkpoint_path_loads_as_jax_load_network(tmp_path):
    """A checkpoint of another seed's model: the depth net's parameters
    come from it, as JAX's load_network merges them, and its BN
    statistics stay those of the build."""
    config, donor = port_train.build(CONFIG, 'cpu', seed=1, overrides=SMALL)
    path = save_checkpoint(str(tmp_path / 'donor.ckpt'), config, donor)
    _, fresh = port_train.build(CONFIG, 'cpu', seed=0, overrides=SMALL)
    _, model = port_train.build(
        CONFIG, 'cpu', seed=0,
        overrides=SMALL + ['model.depth_net.checkpoint_path', path])
    saved = load_checkpoint(path)['params']['depth_net']
    init_vars = flax_variables(fresh.depth_net)
    merged, n_loaded, n_total = load_network(init_vars['params'], saved,
                                             verbose=False)
    assert n_loaded == n_total
    got = flax_variables(model.depth_net)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        got['params'], merged)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           got['batch_stats'], init_vars['batch_stats'])
    assert not np.array_equal(got['params']['encoder']['Conv_0']['kernel'],
                              init_vars['params']['encoder']['Conv_0']
                              ['kernel'])


def test_checkpoint_path_missing_key_raises(tmp_path):
    """The port refuses a checkpoint without one of the depth net's keys;
    JAX's load_network keeps that key's init and loads the rest."""
    config, donor = port_train.build(CONFIG, 'cpu', seed=1, overrides=SMALL)
    state = load_checkpoint(save_checkpoint(str(tmp_path / 'full.ckpt'),
                                            config, donor))
    del state['params']['depth_net']['encoder']['Conv_0']['kernel']
    path = str(tmp_path / 'partial.ckpt')
    with open(path, 'wb') as f:
        pickle.dump(state, f)
    with pytest.raises(KeyError, match='Conv_0'):
        port_train.build(CONFIG, 'cpu', seed=0, overrides=SMALL + [
            'model.depth_net.checkpoint_path', path])
    init_params = jax.tree_util.tree_map(
        jnp.asarray, flax_variables(donor.depth_net)['params'])
    _, n_loaded, n_total = load_network(
        init_params, state['params']['depth_net'], verbose=False)
    assert n_loaded == n_total - 1
