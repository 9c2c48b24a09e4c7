"""
Config parsing: default tree + YAML merge + per-dataset list broadcasting,
the train entry's YAML or checkpoint, and the test entry's checkpoint +
YAML (a copy of the JAX package's config/config.py).

Reference: packnet_sfm/utils/config.py:13-44 (prep_dataset), :89-119,
:163-199, :258-332.
"""

import os

from packnet_sfm_tpu_torch.config.defaults import get_cfg_defaults

_DATASET_LIST_KEYS = ['dataset', 'path', 'split', 'depth_type',
                      'input_depth_type', 'cameras', 'repeat',
                      'mask_file', 'use_mask']


def prep_dataset(node):
    """
    Broadcast per-dataset list entries to the number of datasets.

    The dataset count is the LONGEST list over all keys (reference
    utils/config.py:13-44).
    """
    if len(node.get('path', [])) == 0 and len(node.get('dataset', [])) == 0:
        return node
    lengths = []
    vals = {}
    for key in _DATASET_LIST_KEYS:
        if key not in node:
            continue
        val = node[key]
        if not isinstance(val, (list, tuple)):
            val = [val]
        vals[key] = list(val)
        lengths.append(len(vals[key]))
    n = max(lengths) if lengths else 0
    for key, val in vals.items():
        if len(val) == 0:
            val = ([[]] if key == 'cameras' else
                   [False] if key == 'use_mask' else
                   [1] if key == 'repeat' else [''])
        if len(val) == 1 and n > 1:
            val = val * n
        if len(val) != n:
            raise ValueError(
                'Wrong number of entries for {} ({} vs {} datasets)'.format(
                    key, len(val), n))
        node[key] = val
    return node


def prepare_config(cfg):
    """Finalize a merged config (dataset broadcasting, monitor key)."""
    if cfg.prepared:
        return cfg
    for split in ['train', 'validation', 'test']:
        prep_dataset(cfg.datasets[split])
    if cfg.checkpoint.filepath:
        name = cfg.name if cfg.name else 'model'
        cfg.checkpoint.filepath = os.path.join(
            cfg.checkpoint.filepath, name,
            '{epoch:02d}_{%s:.3f}' % cfg.checkpoint.monitor)
    cfg.prepared = True
    return cfg


def parse_train_config(yaml_path=None, overrides=None, defaults=None):
    """Build a config from defaults + YAML + CLI-style overrides."""
    cfg = (defaults or get_cfg_defaults()).clone()
    if yaml_path:
        cfg.merge_from_file(yaml_path)
        cfg.config = yaml_path
    if overrides:
        cfg.merge_from_list(overrides)
    return prepare_config(cfg)


def parse_train_file(path, overrides=None):
    """(config, checkpoint payload or None) of a train entry point: a YAML
    (merged over the defaults, then the flat ['a.b.c', value, ...]
    overrides), or a `.ckpt` or a directory of them (the last by name),
    whose config is merged over the defaults and then the overrides, and
    whose payload resumes the training (reference utils/config.py:163-199).
    """
    if not path:
        return parse_train_config(None, overrides), None
    if path.endswith(('.yaml', '.yml')):
        return parse_train_config(path, overrides), None
    if path.endswith('.ckpt') or os.path.isdir(path):
        from packnet_sfm_tpu_torch.utils.checkpoint import load_checkpoint
        state = load_checkpoint(path)
        cfg = get_cfg_defaults().clone()
        cfg.merge_from_dict(state['config'])
        if overrides:
            cfg.merge_from_list(overrides)
        cfg.prepared = True
        return cfg, state
    raise ValueError('Unknown train file {} (.yaml or .ckpt expected)'
                     .format(path))


def parse_test_file(ckpt_path, yaml_path=None, overrides=None):
    """(config, checkpoint payload) of a test entry point: the checkpoint's
    config, then the optional YAML and the flat ['a.b.c', value, ...]
    overrides merged over it (reference utils/config.py:258-332)."""
    from packnet_sfm_tpu_torch.utils.checkpoint import load_checkpoint
    state = load_checkpoint(ckpt_path)
    cfg = get_cfg_defaults().clone()
    cfg.merge_from_dict(state['config'])
    if yaml_path:
        cfg.merge_from_file(yaml_path)
    if overrides:
        cfg.merge_from_list(overrides)
    cfg.prepared = False
    return prepare_config(cfg), state
