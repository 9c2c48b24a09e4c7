"""
Inference entry point of the PyTorch port (the JAX package's
scripts/infer.py): one image or a folder of them -> depth .npz / .png and a
colour visualisation.

    python -m packnet_sfm_tpu_torch.infer --checkpoint model.ckpt \
        --input img_or_dir --output out_dir [--image_shape H W] \
        [--save npz png viz] [--mask mask.png] [--colormap plasma|depth]

The network sees RGB only (no LiDAR input). A dual-head model's depth is
integer * max_depth + fractional (max_depth 80 when unset). Runs on the
card unless --device cpu is passed.
"""

import argparse
import os

import numpy as np
import torch

from packnet_sfm_tpu_torch.config import parse_test_file
from packnet_sfm_tpu_torch.datasets.io import (
    load_image, write_depth, write_image)
from packnet_sfm_tpu_torch.datasets.transforms import resize_image
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.models.factory import setup_model
from packnet_sfm_tpu_torch.ops.depth import (
    dual_head_to_depth, inv2depth, sigmoid_to_inv_depth)
from packnet_sfm_tpu_torch.parallel.train_step import make_eval_step
from packnet_sfm_tpu_torch.utils.checkpoint import load_weights
from packnet_sfm_tpu_torch.utils.viz import viz_depth_metric, viz_inv_depth


def infer_and_save_depth(ckpt_file, input_path, output_path,
                         image_shape=None, save=('npz', 'viz'), mask=None,
                         colormap='plasma', device='cuda'):
    """Predict the depth of each .png/.jpg image at `input_path` (a file or
    a folder) with the checkpoint's model and write <stem>.npz (depth),
    <stem>.png (16-bit depth x 256) and <stem>_viz.png per `save` into
    `output_path`. `image_shape` (H, W) resizes the input first; `mask` is
    an image whose nonzero pixels keep the input."""
    dev = resolve_device(device)
    config, state = parse_test_file(ckpt_file)
    dual = bool(config.model.depth_net.get('use_dual_head', False))
    model = load_weights(setup_model(config), state).to(dev).eval()
    forward = make_eval_step(model)

    if os.path.isdir(input_path):
        files = sorted(
            os.path.join(input_path, f) for f in os.listdir(input_path)
            if f.lower().endswith(('.png', '.jpg', '.jpeg')))
    else:
        files = [input_path]
    os.makedirs(output_path, exist_ok=True)

    mask_img = None
    if mask:
        mask_img = (load_image(mask).mean(-1, keepdims=True) > 0
                    ).astype(np.float32)

    params = config.model.params
    min_d, max_d = params.min_depth or 0.5, params.max_depth or 80.0
    for f in files:
        rgb = load_image(f)
        if image_shape:
            rgb = resize_image(rgb, tuple(image_shape))
        if mask_img is not None:
            m = mask_img
            if m.shape[:2] != rgb.shape[:2]:
                m = resize_image(np.repeat(m, 3, -1), rgb.shape[:2])[..., :1]
            rgb = rgb * (m > 0)
        out = forward({'rgb': torch.from_numpy(
            np.ascontiguousarray(rgb[None], np.float32)).to(dev)})
        if dual:
            depth_map = dual_head_to_depth(out[('integer', 0)][0],
                                           out[('fractional', 0)][0], max_d)
            inv_depth = 1.0 / depth_map.clamp(min=1e-6)
            depth = depth_map[..., 0].cpu().numpy()
        else:
            inv_depth = sigmoid_to_inv_depth(
                out['inv_depths'][0][0].float(), min_d, max_d,
                params.use_log_space)
            depth = inv2depth(inv_depth)[..., 0].cpu().numpy()
        base = os.path.splitext(os.path.basename(f))[0]
        if 'npz' in save:
            write_depth(os.path.join(output_path, base + '.npz'), depth)
        if 'png' in save:
            write_depth(os.path.join(output_path, base + '.png'), depth)
        if 'viz' in save:
            if colormap == 'depth':
                viz = viz_depth_metric(depth, min_d, max_d)
            else:
                viz = viz_inv_depth(inv_depth[..., 0].cpu().numpy())
            write_image(os.path.join(output_path, base + '_viz.png'), viz)
        print('saved', base)


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--checkpoint', required=True)
    ap.add_argument('--input', required=True)
    ap.add_argument('--output', required=True)
    ap.add_argument('--image_shape', type=int, nargs=2, default=None)
    ap.add_argument('--save', nargs='+', default=['npz', 'viz'],
                    choices=['npz', 'png', 'viz'])
    ap.add_argument('--mask', default=None,
                    help='optional binary mask multiplied into the input')
    ap.add_argument('--colormap', default='plasma',
                    choices=('plasma', 'depth'),
                    help="'plasma': normalised inverse depth; 'depth': the "
                         "reference's metric red (near) to blue (far) map")
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args()
    infer_and_save_depth(a.checkpoint, a.input, a.output, a.image_shape,
                         a.save, a.mask, a.colormap, a.device)
