"""
Checkpoints in the JAX package's format (its utils/checkpoint.py): one
`.ckpt` file holding the pickled dict {config, epoch, step, params,
batch_stats, opt_state} with numpy leaves, params and batch_stats as flax
trees (nested dicts; conv kernels HWIO).

`load_checkpoint` reads what the JAX trainer writes without importing JAX:
its unpickler hands back an inert stand-in for every class of optax, flax,
jax, jaxlib or chex (the optimizer state's named tuples) and refuses every
other global but numpy's array, dtype and scalar reconstructors (numpy 1's
`numpy.core` and numpy 2's `numpy._core` names), a few builtins,
OrderedDict and `_codecs.encode` (bytes in a protocol-2 pickle), so a
crafted file reaches no function that runs its arguments. `save_checkpoint`
writes the port's model in the same layout with `opt_state` None, which the
JAX trainer takes on resume as "start a fresh optimizer"; Adam's state
waits for the trainer slice. A reference (packnet-sfm, torch) checkpoint
raises: its conversion is not ported.
"""

import os
import pickle

from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_variables, load_flax_variables)

_JAX_MODULES = ('optax', 'flax', 'jax', 'jaxlib', 'chex')
_BUILTINS = ('dict', 'list', 'tuple', 'set', 'frozenset', 'int', 'float',
             'complex', 'bool', 'str', 'bytes', 'bytearray', 'slice', 'range')
_ALLOWED = {('collections', 'OrderedDict'), ('_codecs', 'encode'),
            ('numpy', 'ndarray'), ('numpy', 'dtype')} | {
    (mod.format(core), name) for core in ('core', '_core')
    for mod, name in (('numpy.{}.multiarray', '_reconstruct'),
                      ('numpy.{}.multiarray', 'scalar'),
                      ('numpy.{}.numeric', '_frombuffer'))}
# a torch checkpoint: the zip container of torch >= 1.6, or the legacy
# pickle's magic number (the published packnet-sfm checkpoints)
_TORCH_LEGACY_MAGIC = b'\x80\x02\x8a\nl\xfc\x9cF\xf9 j\xa8P\x19'


class Inert:
    """Stand-in for a class of optax, flax, jax, jaxlib or chex met in a
    checkpoint: it keeps the arguments it was built with (`args`) and its
    pickled state (`state`), and runs nothing of the original."""

    qualname = 'Inert'

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.state = args, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return '<{} {}>'.format(self.qualname, self.args)


class _Unpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._stand_ins = {}

    def find_class(self, module, name):
        root = module.split('.')[0]
        if root in _JAX_MODULES:
            key = '{}.{}'.format(module, name)
            if key not in self._stand_ins:
                self._stand_ins[key] = type(name, (Inert,),
                                            {'qualname': key})
            return self._stand_ins[key]
        if (module, name) in _ALLOWED or \
                (module == 'builtins' and name in _BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            'checkpoint refers to {}.{}, which a checkpoint of the JAX '
            'package does not hold'.format(module, name))


def is_torch_checkpoint(path):
    """True for a torch checkpoint file (zip container or legacy pickle)."""
    with open(path, 'rb') as f:
        magic = f.read(len(_TORCH_LEGACY_MAGIC))
    return magic[:2] == b'PK' or magic == _TORCH_LEGACY_MAGIC


def load_checkpoint(path):
    """The payload dict of a JAX-package checkpoint, or of the last `.ckpt`
    by name in a directory. Leaves are numpy arrays; classes of JAX's
    libraries come back as `Inert` stand-ins."""
    if os.path.isdir(path):
        ckpts = sorted(p for p in os.listdir(path) if p.endswith('.ckpt'))
        if not ckpts:
            raise FileNotFoundError('No .ckpt files in {}'.format(path))
        path = os.path.join(path, ckpts[-1])
    if is_torch_checkpoint(path):
        raise NotImplementedError(
            '{} is a reference (torch) checkpoint; its conversion is not '
            'ported yet (ROADMAP.md section 1: reference torch-checkpoint '
            'conversion)'.format(path))
    with open(path, 'rb') as f:
        return _Unpickler(f).load()


def save_checkpoint(path, config, model, epoch=0, step=0):
    """Write `model`'s weights and `config` as a JAX-package checkpoint at
    `path` (opt_state None); returns the path."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    variables = flax_variables(model)
    payload = {
        'config': config.to_dict(),
        'epoch': int(epoch),
        'step': int(step),
        'params': variables['params'],
        'batch_stats': variables['batch_stats'],
        'opt_state': None,
    }
    tmp = '{}.tmp.{}'.format(path, os.getpid())
    with open(tmp, 'wb') as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def load_weights(model, state, key='params'):
    """Copy the checkpoint's `key` tree ('params' or 'ema_params') and its
    batch_stats into `model`; raises on any missing, unexpected or
    misshaped key (flax_weights.load_flax_variables). Returns the model."""
    return load_flax_variables(model, {'params': state[key],
                                       'batch_stats': state['batch_stats']})
