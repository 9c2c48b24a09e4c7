"""
Eval-time per-sample output saving, driven by cfg.save (the JAX package's
utils/save.py; reference: utils/save.py:11-67 save_depth,
utils/logging.py:33-56 prepare_dataset_prefix).

Layout mirrors the reference:
    <save.folder>/depth/<dataset_prefix>/<ckpt_name>/<filename>_depth.npz
                                                    /<filename>_depth.png
                                                    /<filename>_rgb.png
                                                    /<filename>_viz.png
gated per-format by save.depth.{npz,png,rgb,viz}.
"""

import os

import numpy as np

from packnet_sfm_tpu_torch.datasets.io import write_depth, write_image
from packnet_sfm_tpu_torch.utils.viz import viz_inv_depth


def prepare_dataset_prefix(dataset_cfg, dataset_idx=0):
    """'<path basename>-<split stem>' for one dataset of a config list."""
    def pick(field):
        vals = dataset_cfg.get(field, [])
        if not vals:
            return ''
        return vals[min(dataset_idx, len(vals) - 1)]
    path = os.path.basename(str(pick('path')).rstrip('/'))
    split = os.path.splitext(os.path.basename(str(pick('split'))))[0]
    return '-'.join(p for p in (path, split) if p) or 'dataset'


def save_depth(batch, inv_depth, save_cfg, dataset_cfg=None,
               ckpt_name='model', dataset_idx=0):
    """Save one eval batch's predictions per cfg.save.

    batch: HOST batch dict ('filename' str/list, 'rgb' [B,H,W,3] in [0,1],
    optional 'intrinsics'); inv_depth: [B,H,W,1] array-like. Returns the
    number of samples written (0 when save.folder is empty)."""
    if not save_cfg.folder:
        return 0
    d = save_cfg.depth
    if not (d.rgb or d.viz or d.npz or d.png):
        return 0

    inv_depth = np.asarray(inv_depth)
    rgb = np.asarray(batch['rgb']) if 'rgb' in batch else None
    names = batch.get('filename', None)
    B = inv_depth.shape[0]
    if names is None:
        names = ['sample_{:06d}'.format(i) for i in range(B)]
    elif isinstance(names, str):
        names = [names]
    names = [os.path.splitext(os.path.basename(str(n)))[0] for n in names]

    prefix = prepare_dataset_prefix(dataset_cfg, dataset_idx) \
        if dataset_cfg is not None else 'dataset'
    save_path = os.path.join(save_cfg.folder, 'depth', prefix,
                             os.path.splitext(ckpt_name)[0])
    os.makedirs(save_path, exist_ok=True)

    intr = np.asarray(batch['intrinsics']) if 'intrinsics' in batch else None
    written = 0
    for i in range(min(B, len(names))):
        inv_i = inv_depth[i]
        depth_i = 1.0 / np.maximum(inv_i, 1e-6)
        base = os.path.join(save_path, names[i])
        if d.npz:
            write_depth(base + '_depth.npz', depth_i[..., 0],
                        intrinsics=None if intr is None else intr[i])
        if d.png:
            write_depth(base + '_depth.png', depth_i[..., 0])
        if d.rgb and rgb is not None:
            write_image(base + '_rgb.png', rgb[i])
        if d.viz:
            write_image(base + '_viz.png', viz_inv_depth(inv_i))
        written += 1
    return written
