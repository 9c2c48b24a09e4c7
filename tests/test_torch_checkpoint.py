"""Checkpoints between the two packages (packnet_sfm_tpu_torch/utils/
checkpoint.py): a checkpoint the JAX package writes, with real optax Adam
state, loads into the port in a process where jax, jaxlib, flax, optax,
chex and the JAX package cannot be imported, and the port's forward on it
matches the JAX model's; a checkpoint the port writes loads through the
JAX package's parse_test_file into the JAX model with the same outputs;
missing, extra or misshaped keys, torch checkpoints and foreign globals
(numpy's own code-running functions among them) are refused.

Tolerance: the sigmoid maps within atol 1e-5 (float32 convolutions summed
in another order); weights through a round trip bit-equal.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.config import parse_test_file as j_parse_test_file
from packnet_sfm_tpu.models.factory import setup_model as j_setup_model
from packnet_sfm_tpu_torch.config import parse_test_file
from packnet_sfm_tpu_torch.models.factory import init_weights, setup_model
from packnet_sfm_tpu_torch.utils.checkpoint import (
    Inert, load_checkpoint, load_weights, save_checkpoint)
from packnet_sfm_tpu_torch.utils.flax_weights import flax_variables
from tests.test_datasets import make_ncdb_tree
from tests.torch_fixtures import CLI_SHAPE, one_torch_thread  # noqa: F401
from tests.torch_fixtures import write_jax_checkpoint

pytestmark = pytest.mark.usefixtures('one_torch_thread')

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'chex', 'packnet_sfm_tpu')

# loads the checkpoint with the port and runs its forward on batch.npz,
# with every module of JAX's libraries and the JAX package unimportable
CHILD = '''
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {blocked!r}:
            raise ImportError('blocked: ' + name)

sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
import numpy as np
import torch
from packnet_sfm_tpu_torch.config import parse_test_file
from packnet_sfm_tpu_torch.models.factory import setup_model
from packnet_sfm_tpu_torch.utils.checkpoint import Inert, load_weights
config, state = parse_test_file({ckpt!r})
assert isinstance(state['opt_state'][0], Inert), state['opt_state']
assert not [m for m in sys.modules if m.split('.')[0] in {blocked!r}]
model = load_weights(setup_model(config), state).eval()
batch = {{k: torch.from_numpy(v) for k, v in np.load({batch!r}).items()}}
with torch.no_grad():
    out = model(batch)['inv_depths'][0]
np.save({out!r}, out.numpy())
print('epoch', state['epoch'], 'step', state['step'])
'''


def _batch(seed):
    rng = np.random.RandomState(seed)
    H, W = CLI_SHAPE
    return {'rgb': rng.rand(2, H, W, 3).astype(np.float32),
            'input_depth': ((rng.rand(2, H, W, 1) * 12) *
                            (rng.rand(2, H, W, 1) < 0.3)).astype(np.float32)}


def _jax_forward(cfg, variables, batch):
    out = j_setup_model(cfg).apply(variables, batch, train=False)
    return np.asarray(out['inv_depths'][0])


@pytest.fixture(scope='module')
def jax_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp('ckpt')
    root = str(d / 'ncdb')
    os.makedirs(root)
    make_ncdb_tree(root)
    path = str(d / 'jax.ckpt')
    yield path, write_jax_checkpoint(path, root)
    os.remove(path)     # ~590 MB: the model's weights and Adam's moments


def test_jax_checkpoint_loads_without_jax(jax_ckpt, tmp_path):
    path, variables = jax_ckpt
    batch = _batch(0)
    np.savez(tmp_path / 'batch.npz', **batch)
    out = str(tmp_path / 'out.npy')
    child = CHILD.format(blocked=BLOCKED, root=str(ROOT), ckpt=path,
                         batch=str(tmp_path / 'batch.npz'), out=out)
    run = subprocess.run([sys.executable, '-c', child], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-3000:]
    assert 'epoch 1 step 7' in run.stdout
    cfg, _ = j_parse_test_file(path)
    np.testing.assert_allclose(np.load(out),
                               _jax_forward(cfg, variables, batch),
                               atol=1e-5, rtol=0)


def test_port_checkpoint_loads_in_jax(jax_ckpt, tmp_path):
    config, _ = parse_test_file(jax_ckpt[0])
    model = init_weights(setup_model(config),
                         torch.Generator().manual_seed(3)).eval()
    path = save_checkpoint(str(tmp_path / 'port.ckpt'), config, model,
                           epoch=2, step=11)
    cfg, state = j_parse_test_file(path)
    assert (state['epoch'], state['step'], state['opt_state']) == (2, 11, None)
    assert cfg.to_dict() == parse_test_file(path)[0].to_dict()
    batch = _batch(1)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    want = _jax_forward(cfg, {'params': state['params'],
                              'batch_stats': state['batch_stats']}, batch)
    np.testing.assert_allclose(got['inv_depths'][0].numpy(), want,
                               atol=1e-5, rtol=0)
    again = load_weights(setup_model(config), load_checkpoint(path))
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_loading_refuses_missing_extra_and_misshaped_keys(jax_ckpt):
    config, state = parse_test_file(jax_ckpt[0])
    tree = flax_variables(load_weights(setup_model(config), state))
    missing = {'params': jax.tree_util.tree_map(np.copy, tree['params']),
               'batch_stats': tree['batch_stats']}
    del missing['params']['depth_net']['mconvs']['film_0']['bias']
    with pytest.raises(KeyError, match='film_0.bias'):
        load_weights(setup_model(config), missing)
    extra = dict(missing, params=dict(tree['params'], head={'w': np.ones(1)}))
    with pytest.raises(KeyError, match='head'):
        load_weights(setup_model(config), extra)
    bad = jax.tree_util.tree_map(np.copy, tree)
    conv = bad['params']['depth_net']['decoder']['dispconv_0']['Conv_0']
    conv['kernel'] = conv['kernel'][..., :1, :]
    with pytest.raises(ValueError, match='shape'):
        load_weights(setup_model(config), bad)


def test_load_checkpoint_refuses_torch_and_foreign_files(jax_ckpt, tmp_path):
    torch.save({'state_dict': {}}, tmp_path / 'ref.ckpt')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        load_checkpoint(str(tmp_path / 'ref.ckpt'))
    with open(tmp_path / 'evil.ckpt', 'wb') as f:
        pickle.dump({'x': os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match='posix.getcwd'):
        load_checkpoint(str(tmp_path / 'evil.ckpt'))
    # numpy holds code-execution gadgets too: only its array, dtype and
    # scalar reconstructors pass, by exact name
    gadget = 'testing._private.utils.runstring'
    with open(tmp_path / 'gadget.ckpt', 'wb') as f:
        f.write(b'\x80\x04\x8c\x05numpy\x94\x8c' + bytes([len(gadget)]) +
                gadget.encode() + b'\x94\x93\x94.')
    with pytest.raises(pickle.UnpicklingError, match='numpy.testing'):
        load_checkpoint(str(tmp_path / 'gadget.ckpt'))
    d = tmp_path / 'run'
    d.mkdir()
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(d))
    for name in ('epoch=01.ckpt', 'epoch=02.ckpt'):
        os.symlink(jax_ckpt[0], d / name)
    with open(d / 'epoch=03.ckpt', 'wb') as f:
        pickle.dump({'epoch': 3}, f)
    assert load_checkpoint(str(d)) == {'epoch': 3}
    found = set(_stand_ins(load_checkpoint(jax_ckpt[0])['opt_state']))
    assert {'optax._src.transform.ScaleByAdamState',
            'optax._src.base.EmptyState'} <= found, found


def _stand_ins(tree):
    """The qualified names of the Inert stand-ins in a payload tree."""
    if isinstance(tree, Inert):
        yield tree.qualname
        tree = tree.args
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _stand_ins(x)
