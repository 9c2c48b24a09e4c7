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
crafted file reaches no function that runs its arguments. A reference
(packnet-sfm, torch) checkpoint raises: its conversion is not ported.

`save_checkpoint` writes the port's model in the same layout. The port
cannot pickle optax's classes without importing JAX, so `opt_state` stays
None, which the JAX trainer takes on resume as "start a fresh optimizer",
and Adam's state goes under the port's own key, 'adam_state', in the flax
layout of `Optimizer.state_dict` with numpy leaves. `adam_state` reads it
back, or converts the optax state of a JAX checkpoint. `ModelCheckpoint`
keeps the top-k epoch checkpoints by the monitored metric (JAX
utils/checkpoint.py); its first save also writes `save_code`'s snapshot of
the sources. The JAX package's S3 sync needs the network and is left out.
"""

import os
import pickle
import tarfile

from packnet_sfm_tpu_torch.parallel.train_step import adam_state_from_optax
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_variables, load_flax_variables)

ADAM_KEY = 'adam_state'

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


def save_checkpoint(path, config, model, epoch=0, step=0, optimizer=None,
                    extra=None):
    """Write `model`'s weights and `config` as a JAX-package checkpoint at
    `path` (opt_state None), with `optimizer`'s Adam state under
    'adam_state' when given and the entries of `extra` (a mid-epoch save's
    {'loader': position}); returns the path. The file appears whole: it is
    written aside and renamed."""
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
    if optimizer is not None:
        payload[ADAM_KEY] = optimizer.state_dict()
    payload.update(extra or {})
    tmp = '{}.tmp.{}'.format(path, os.getpid())
    with open(tmp, 'wb') as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def adam_state(payload):
    """The Adam state of a checkpoint payload for `Optimizer.
    load_state_dict`: the port's 'adam_state', else the JAX package's
    optax `opt_state`; None when it holds neither."""
    if payload.get(ADAM_KEY) is not None:
        return payload[ADAM_KEY]
    if payload.get('opt_state') is not None:
        return adam_state_from_optax(payload['opt_state'])
    return None


def save_code(dirpath, root=None):
    """Snapshot the port's sources (packnet_sfm_tpu_torch, scripts,
    configs, tests, pyproject.toml) into <dirpath>/code.tar.gz, without
    caches and checkpoints; returns its path."""
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = os.path.join(dirpath, 'code.tar.gz')
    junk = {'.git', '__pycache__', '.pytest_cache'}

    def keep(info):
        if junk & set(info.name.split('/')) or info.name.endswith(
                ('.pyc', '.ckpt')):
            return None
        return info

    os.makedirs(dirpath, exist_ok=True)
    with tarfile.open(out, 'w:gz') as tar:
        for sub in ('packnet_sfm_tpu_torch', 'scripts', 'configs', 'tests',
                    'pyproject.toml'):
            p = os.path.join(root, sub)
            if os.path.exists(p):
                tar.add(p, arcname=sub, filter=keep)
    return out


class ModelCheckpoint:
    """Top-k epoch checkpoints on `monitor` (JAX utils/checkpoint.py,
    reference model_checkpoint.py:27-126). `filepath` is a directory plus
    a name template such as '{epoch:02d}_{depth-abs_rel:.3f}'; a template
    that names a missing metric gives 'epoch_<NN>', and a bare directory
    'model_{epoch:02d}'. mode 'auto' maximises metrics named a1, a2 or a3
    and minimises the rest. A save is due every `period` epochs."""

    def __init__(self, filepath, monitor='loss', save_top_k=5, mode='auto',
                 period=1):
        self.dirpath = os.path.dirname(filepath) or '.'
        self.filename_tpl = os.path.basename(filepath) or 'model_{epoch:02d}'
        self.monitor = monitor
        self.save_top_k = save_top_k
        self.period = period
        self.epochs_since_last = 0
        self.best_k_models = {}
        self._code_saved = False
        if mode == 'auto':
            mode = 'max' if any(k in monitor for k in ('a1', 'a2', 'a3')) \
                else 'min'
        self.mode = mode

    def _format_name(self, epoch, metrics):
        values = {'epoch': epoch, **{k: float(v) for k, v in metrics.items()}}
        try:
            name = self.filename_tpl.format(**values)
        except (KeyError, IndexError):
            name = 'epoch_{:02d}'.format(epoch)
        return name + '.ckpt'

    def check_and_save(self, config, model, optimizer, metrics, epoch,
                       step=0):
        """Save the epoch's checkpoint if one is due and drop the worst
        beyond the top k; returns the path written, or None."""
        self.epochs_since_last += 1
        if self.epochs_since_last < self.period:
            return None
        self.epochs_since_last = 0
        current = float(metrics.get(self.monitor, metrics.get('loss', 0.0)))
        path = os.path.join(self.dirpath, self._format_name(epoch, metrics))
        save_checkpoint(path, config, model, epoch, step, optimizer)
        if not self._code_saved:
            self._code_saved = True
            save_code(self.dirpath)
        self.best_k_models[path] = current
        if self.save_top_k > 0 and len(self.best_k_models) > self.save_top_k:
            pick = max if self.mode == 'min' else min
            worst = pick(self.best_k_models, key=self.best_k_models.get)
            self.best_k_models.pop(worst)
            if os.path.exists(worst):
                os.remove(worst)
        return path


def load_weights(model, state, key='params'):
    """Copy the checkpoint's `key` tree ('params' or 'ema_params') and its
    batch_stats into `model`; raises on any missing, unexpected or
    misshaped key (flax_weights.load_flax_variables). Returns the model."""
    return load_flax_variables(model, {'params': state[key],
                                       'batch_stats': state['batch_stats']})
