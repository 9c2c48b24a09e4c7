"""
Eval steps (the JAX package's parallel/train_step.py:233-355): the forward
alone, and the whole per-batch eval protocol with optional flip-TTA. The
JAX steps take a (params, batch_stats) state; here the module holds its
weights, so a step takes the batch alone. Train steps wait for the
training slice.
"""

import torch

from packnet_sfm_tpu_torch.ops.depth import (
    sigmoid_to_inv_depth, inv2depth, compute_depth_metrics,
    dual_head_to_depth, post_process_inv_depth)
from packnet_sfm_tpu_torch.ops.image import flip_lr


def make_eval_step(model):
    """batch -> model outputs, without autograd."""
    @torch.no_grad()
    def eval_step(batch):
        return model(batch)
    return eval_step


def make_eval_metrics_step(model, params_cfg, flip_tta=False,
                           int8_outputs=False):
    """
    Per-batch eval protocol: forward (+ the flip-TTA second forward),
    sigmoid -> depth conversions, and the 7 metrics for every conversion
    mode with and without GT median scaling (reference
    model_wrapper.py:621-790). Returns step(batch) -> {mode: [7] tensor};
    `batch` must hold 'depth' (GT).
    """
    if int8_outputs:
        raise NotImplementedError('int8_outputs is not ported yet')
    min_d = float(params_cfg.min_depth)
    max_d = float(params_cfg.max_depth)
    crop = params_cfg.get('crop', '')
    scale_output = params_cfg.get('scale_output', 'resize')
    use_log = bool(params_cfg.get('use_log_space', False))
    forward = make_eval_step(model)

    @torch.no_grad()
    def step(batch):
        gt = batch['depth']
        out = forward(batch)
        if 'inv_depths' in out:
            sig = out['inv_depths'][0]
            if flip_tta:
                flipped = dict(batch)
                flipped['rgb'] = flip_lr(batch['rgb'])
                if 'input_depth' in batch:
                    flipped['input_depth'] = flip_lr(batch['input_depth'])
                sig = post_process_inv_depth(
                    sig, forward(flipped)['inv_depths'][0])
            inv_lin = sigmoid_to_inv_depth(sig, min_d, max_d, False)
            inv_log = sigmoid_to_inv_depth(sig, min_d, max_d, True)
            depth_lin, depth_log = inv2depth(inv_lin), inv2depth(inv_log)
            cand = {'depth': depth_log if use_log else depth_lin,
                    'depth_lin': depth_lin, 'depth_log': depth_log}
        else:
            cand = {'depth': dual_head_to_depth(
                out[('integer', 0)], out[('fractional', 0)], max_d)}
        modes = {}
        for name, pred in cand.items():
            modes[name] = compute_depth_metrics(
                gt, pred, min_d, max_d, crop=crop,
                scale_output=scale_output, use_gt_scale=False)
            modes[name + '_gt'] = compute_depth_metrics(
                gt, pred, min_d, max_d, crop=crop,
                scale_output=scale_output, use_gt_scale=True)
        return modes

    return step
