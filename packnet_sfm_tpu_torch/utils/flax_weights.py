"""
Carry the JAX package's flax variables into the port's modules.

The port's submodules are named after the flax module paths, so a flax
leaf `a/b/Conv_1/kernel` lands on `model.a.b.Conv_1`:
- nn.Conv2d (the port's `Conv`, the ResNet encoders', decoders' and pose
  decoder's convs among them): `kernel` HWIO -> `weight` OIHW, `bias`;
- nn.BatchNorm2d: `scale` -> `weight`, `bias`, and batch_stats `mean` /
  `var` -> `running_mean` / `running_var`;
- nn.GroupNorm (PoseNet's, under `pose_net/convN/GroupNorm_0`, and
  PackNet's, under `.../Conv2D_0/GroupNorm_0` and `ResidualConv_i/
  GroupNorm_0`): `scale` -> `weight`, `bias`;
- a module the flax model calls more than once (PoseResNet's `encoder`,
  once per context) has one set of leaves, as in flax;
- everything else (masked-conv `kernel` kept HWIO for the kernel,
  MaskedBatchNorm `scale`/`bias`/`mean`/`var`, the fusion gates `weight` /
  `bias`, PackNet's 3D conv `win2d_kernel` [kh, kw, dz, d] and
  `win2d_bias`): the same name, as it is.

Unlike the JAX package's utils/load.py, which keeps the random init for
names it cannot match, this raises on any missing or unexpected key and on
any shape mismatch. `flax_variables` is the inverse: the module's weights
as the flax tree the JAX model takes.
"""

import numpy as np
import torch
import torch.nn as nn

_BN_NAMES = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
             'var': 'running_var'}
_GN_NAMES = {'scale': 'weight', 'bias': 'bias'}
_BN_LEAVES = {v: k for k, v in _BN_NAMES.items()}
_GN_LEAVES = {v: k for k, v in _GN_NAMES.items()}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _target(mod, leaf, value):
    """(torch attribute name, converted array) for one flax leaf."""
    if isinstance(mod, nn.Conv2d):
        if leaf == 'kernel':
            return 'weight', np.transpose(value, (3, 2, 0, 1))
        return leaf, value
    if isinstance(mod, nn.BatchNorm2d):
        return _BN_NAMES.get(leaf, leaf), value
    if isinstance(mod, nn.GroupNorm):
        return _GN_NAMES.get(leaf, leaf), value
    return leaf, value


def _torch_values(model, col, tree, shapes, values, unexpected):
    """Convert the leaves of the flax collection `tree` ('params' or
    'batch_stats') into `values` {state-dict key: array in the torch
    layout} for the keys of `shapes` {key: shape}; names that find no key
    go to `unexpected`. Raises ValueError on a shape mismatch."""
    for path, value in _flatten(tree):
        name = '/'.join((col,) + path)
        try:
            mod = model.get_submodule('.'.join(path[:-1]))
        except AttributeError:
            unexpected.append(name)
            continue
        attr, arr = _target(mod, path[-1], np.asarray(value))
        key = '.'.join(path[:-1] + (attr,))
        if key not in shapes or key in values:
            unexpected.append(name)
            continue
        if tuple(arr.shape) != tuple(shapes[key]):
            raise ValueError('{}: flax shape {} vs torch {} {}'.format(
                name, arr.shape, key, tuple(shapes[key])))
        values[key] = arr


def flax_state_dict(model, variables):
    """The flax {'params', 'batch_stats'} tree (nested dicts of arrays) as
    {`model` state-dict key: numpy array in the torch layout}. A tree of
    the same structure (gradients, updated statistics) maps the same way.
    Raises KeyError on missing or unexpected keys and ValueError on a
    shape mismatch."""
    extra_cols = set(variables) - {'params', 'batch_stats'}
    if extra_cols:
        raise KeyError('unexpected variable collections: {}'.format(
            sorted(extra_cols)))
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    values, unexpected = {}, []
    for col in ('params', 'batch_stats'):
        _torch_values(model, col, variables.get(col, {}), shapes, values,
                      unexpected)
    missing = sorted(k for k in shapes if k not in values
                     and not k.endswith('num_batches_tracked'))
    if missing or unexpected:
        raise KeyError('flax -> torch weights: missing {}; unexpected {}'
                       .format(missing, sorted(unexpected)))
    return values


def flax_param_arrays(model, params):
    """A flax 'params'-shaped tree over some or all of `model`'s parameters
    (Adam's moments of one optimizer group) as {parameter name: numpy array
    in the torch layout}, through the same mapping as the weights. Raises
    KeyError on a leaf that names no parameter and ValueError on a shape
    mismatch."""
    shapes = {k: p.shape for k, p in model.named_parameters()}
    values, unexpected = {}, []
    _torch_values(model, 'params', params, shapes, values, unexpected)
    if unexpected:
        raise KeyError('flax -> torch parameters: unexpected {}'.format(
            sorted(unexpected)))
    return values


def load_flax_variables(model, variables):
    """Copy a flax {'params', 'batch_stats'} tree into `model` in place;
    returns the model. Raises as `flax_state_dict` does."""
    state = model.state_dict()
    with torch.no_grad():
        for key, arr in flax_state_dict(model, variables).items():
            state[key].copy_(torch.from_numpy(np.array(arr, order='C')))
    return model


def flax_tree(model, values):
    """{`model` state-dict key: tensor} (weights, buffers, or per-parameter
    state such as Adam's moments) as the nested flax tree of float32 numpy
    arrays: conv weights OIHW -> `kernel` HWIO, BN and GroupNorm names back
    to flax's; the inverse of `flax_state_dict` / `flax_param_arrays`."""
    tree = {}
    for key, value in values.items():
        *path, attr = key.split('.')
        leaf, perm = _flax_leaf(model.get_submodule('.'.join(path)), attr)
        arr = value.detach().cpu().float().numpy()
        if perm is not None:
            arr = np.transpose(arr, perm)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def _flax_leaf(mod, attr):
    """(flax leaf name, the transpose from the torch layout to flax's or
    None) of attribute `attr` of `mod`."""
    if isinstance(mod, nn.Conv2d) and attr == 'weight':
        return 'kernel', (2, 3, 1, 0)
    if isinstance(mod, nn.BatchNorm2d):
        return _BN_LEAVES.get(attr, attr), None
    if isinstance(mod, nn.GroupNorm):
        return _GN_LEAVES.get(attr, attr), None
    return attr, None


def flax_kernel_axis(model, name):
    """The axis of parameter `name` of `model` that holds the last axis of
    its flax leaf (a conv's output channel) when that leaf is a `kernel`,
    else None: 0 for an nn.Conv2d weight (OIHW), the last for a kernel the
    port keeps HWIO."""
    *path, attr = name.split('.')
    leaf, perm = _flax_leaf(model.get_submodule('.'.join(path)), attr)
    if leaf != 'kernel':
        return None
    ndim = getattr(model.get_submodule('.'.join(path)), attr).ndim
    return perm[-1] if perm is not None else ndim - 1


def flax_variables(model):
    """`model`'s weights as a flax {'params', 'batch_stats'} tree of float32
    numpy arrays (parameters under 'params', buffers under 'batch_stats'),
    checked by `flax_state_dict`."""
    param_keys = {name for name, _ in model.named_parameters()}
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith('num_batches_tracked')}
    tree = {'params': flax_tree(model, {k: v for k, v in state.items()
                                        if k in param_keys}),
            'batch_stats': flax_tree(model, {k: v for k, v in state.items()
                                             if k not in param_keys})}
    flax_state_dict(model, tree)
    return tree
