"""
Pretrained weights at model build: ImageNet encoders for the 'pt' depth
nets and PoseResNet, and the per-network `checkpoint_path` loads. The
port's own copy of the JAX package's export/torch_import.py (the
torchvision -> flax key map, the weight search,
`PretrainedWeightsNotFound`) and of `Trainer._maybe_load_pretrained`
(trainers/trainer.py:683-737), without JAX.

Fail-loud, as the JAX package: a 'pt' depth-net version (or
`use_imagenet_pretrained`) on a net with an `encoder`, and a 'pt'
PoseResNet, load torchvision ResNet weights into the encoder (PoseResNet's
first conv takes two stacked images: conv1 repeated over them and halved),
from the net's `weights_path` when set, else from the first
`resnet{N}*.pth` in $PACKNET_WEIGHTS_DIR, else from the torch hub cache.
Without a file it raises `PretrainedWeightsNotFound` unless the net's
`allow_random_init` is true; then it prints one line and keeps the random
init. Unlike a `checkpoint_path` load, the encoder's BN statistics come
from the file too.

The weights go through the flax layout and `load_flax_variables`, so a
file with a missing, unexpected or misshaped key raises. The same holds
for `model.<net>.checkpoint_path` (a JAX-package `.ckpt`), where the JAX
package's utils/load.py `load_network` keeps the random init for any key
it cannot match without a word. As there, only the net's parameters are
taken: its BN statistics stay as they are. The YOLOv8 backbones are not
ported.
"""

import glob
import os

import numpy as np
import torch

from packnet_sfm_tpu_torch.utils.checkpoint import load_checkpoint
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_variables, load_flax_variables)

# torchvision stage layouts (reference resnet_encoder.py:61-98)
_TV_BLOCKS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
              101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class PretrainedWeightsNotFound(FileNotFoundError):
    """A 'pt' config demands ImageNet weights that are not present. Pass
    model.depth_net.weights_path, put the file in $PACKNET_WEIGHTS_DIR, or
    set model.depth_net.allow_random_init to start from random weights."""


def _k(t):
    """torch OIHW conv weight -> flax HWIO kernel."""
    return np.transpose(np.asarray(t), (2, 3, 1, 0))


def torchvision_resnet_to_flax(state_dict, num_layers=18, num_input_images=1):
    """(params, batch_stats) of the encoder's flax tree from a torchvision
    ResNet state_dict: conv1/bn1 -> Conv_0/BatchNorm_0;
    layer{s}.{b}.conv{j}/bn{j} (+ downsample.0/1) -> BasicBlock_i or
    Bottleneck_i's Conv_j / BatchNorm_j in call order. A first conv for
    several stacked images repeats conv1 over them, divided by their
    number (reference resnet_encoder.py:56-58)."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    bottleneck = num_layers > 34
    n_main = 3 if bottleneck else 2
    blk_cls = 'Bottleneck' if bottleneck else 'BasicBlock'

    def bn(prefix):
        return ({'scale': sd[prefix + '.weight'],
                 'bias': sd[prefix + '.bias']},
                {'mean': sd[prefix + '.running_mean'],
                 'var': sd[prefix + '.running_var']})

    conv1 = sd['conv1.weight']
    if num_input_images > 1:
        conv1 = np.concatenate([conv1] * num_input_images, axis=1) \
            / num_input_images
    params = {'Conv_0': {'kernel': _k(conv1)}}
    stats = {}
    params['BatchNorm_0'], stats['BatchNorm_0'] = bn('bn1')
    b = 0
    for stage, n_blocks in enumerate(_TV_BLOCKS[num_layers]):
        for blk in range(n_blocks):
            pre = 'layer{}.{}.'.format(stage + 1, blk)
            p, s = {}, {}
            for j in range(n_main):
                p['Conv_{}'.format(j)] = {
                    'kernel': _k(sd[pre + 'conv{}.weight'.format(j + 1)])}
                p['BatchNorm_{}'.format(j)], s['BatchNorm_{}'.format(j)] = \
                    bn(pre + 'bn{}'.format(j + 1))
            if pre + 'downsample.0.weight' in sd:
                p['Conv_{}'.format(n_main)] = {
                    'kernel': _k(sd[pre + 'downsample.0.weight'])}
                p['BatchNorm_{}'.format(n_main)], \
                    s['BatchNorm_{}'.format(n_main)] = bn(pre + 'downsample.1')
            name = '{}_{}'.format(blk_cls, b)
            params[name], stats[name] = p, s
            b += 1
    return params, stats


def find_torchvision_weights(num_layers):
    """The first `resnet{N}*.pth` in $PACKNET_WEIGHTS_DIR, else the first
    `resnet{N}-*.pth` in the torch hub cache (torch.hub.get_dir(), then
    ~/.cache/torch/hub), else None. Nothing is downloaded."""
    patterns = []
    env_dir = os.environ.get('PACKNET_WEIGHTS_DIR', '')
    if env_dir:
        patterns.append(os.path.join(env_dir,
                                     'resnet{}*.pth'.format(num_layers)))
    name = 'resnet{}-*.pth'.format(num_layers)
    patterns += [os.path.join(torch.hub.get_dir(), 'checkpoints', name),
                 os.path.join(os.path.expanduser('~/.cache/torch/hub'),
                              'checkpoints', name)]
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def load_pretrained_encoder(encoder, num_layers=18, weights_path=None,
                            required=False, num_input_images=1):
    """Copy torchvision ImageNet weights into `encoder` (the port's
    ResnetEncoder) in place; returns the file's path, or None when there
    is none and `required` is false (one printed line, the random init
    kept). Raises PretrainedWeightsNotFound when it is required, and as
    load_flax_variables does on a file that does not fit."""
    path = weights_path or find_torchvision_weights(num_layers)
    if path is None:
        msg = ('no torchvision resnet{} ImageNet weights found (searched '
               '$PACKNET_WEIGHTS_DIR and the torch hub cache)'.format(
                   num_layers))
        if required:
            raise PretrainedWeightsNotFound(msg)
        print('[pretrained] {}; keeping random init'.format(msg))
        return None
    sd = torch.load(path, map_location='cpu', weights_only=True)
    params, stats = torchvision_resnet_to_flax(sd, num_layers,
                                               num_input_images)
    load_flax_variables(encoder, {'params': params, 'batch_stats': stats})
    print('[pretrained] loaded {} into the encoder'.format(path))
    return path


def load_net_checkpoint(net, path, key):
    """Copy the parameters of a JAX-package checkpoint's `key` subtree
    ('depth_net' / 'pose_net'; the whole tree when it has no such key, as
    JAX's `_maybe_load_pretrained` takes it) into `net`, keeping its
    buffers; raises on any missing, unexpected or misshaped key."""
    params = load_checkpoint(path)['params']
    load_flax_variables(net, {
        'params': params.get(key, params),
        'batch_stats': flax_variables(net)['batch_stats']})
    return net


def load_pretrained(config, model):
    """The counterpart of the JAX `Trainer._maybe_load_pretrained` on a
    freshly built model: the depth net's ImageNet encoder, a PoseResNet's
    two-image one, then each net's `checkpoint_path`. Returns the
    model."""
    dn = config.model.depth_net
    version = dn.get('version', '') or ''
    depth_net = model.depth_net
    if (version.endswith('pt') or dn.get('use_imagenet_pretrained', False)) \
            and hasattr(depth_net, 'encoder'):
        num_layers = int(version[:2]) if version[:2].isdigit() else 18
        load_pretrained_encoder(
            depth_net.encoder, num_layers,
            weights_path=dn.get('weights_path', '') or None,
            required=not bool(dn.get('allow_random_init', False)))
    pn = config.model.pose_net
    pn_version = pn.get('version', '') or ''
    if pn.name == 'PoseResNet' and pn_version.endswith('pt'):
        load_pretrained_encoder(
            model.pose_net.encoder,
            int(pn_version[:2]) if pn_version[:2].isdigit() else 18,
            weights_path=pn.get('weights_path', '') or None,
            required=not bool(pn.get('allow_random_init', False)),
            num_input_images=2)
    for key in ('depth_net', 'pose_net'):
        path = config.model[key].get('checkpoint_path', '')
        if path:
            if getattr(model, key, None) is None:
                raise ValueError('model.{}.checkpoint_path is set, but the '
                                 'model has no {}'.format(key, key))
            load_net_checkpoint(getattr(model, key), path, key)
    return model
