"""
Optimizer, learning-rate schedule, the train step and the eval steps (the
JAX package's parallel/train_step.py). The JAX steps take a (params,
batch_stats, opt_state) state; here the module holds its weights and
statistics and the optimizer its own state, so a step takes the batch.

The train step is forward, loss, backward, the global-norm clip and the
Adam step, with the JAX step's non-finite guard: when the loss is not
finite, parameters, Adam's moments and the schedule's count stay as they
were, while the BN running statistics, which the forward moved, keep the
move (as `mutable=['batch_stats']` does in JAX). The guard reads the loss
on the host, one device sync per step.

Under QAT on weights (`qat_weights`) and int8 eval (`int8_weights`) the
model runs through torch.func.functional_call over its depth-net conv
kernels fake-quantized per output channel (ops/quantization.py): the
module's names, its state dict and Adam's layout stay as they are, the
BN running statistics update in place, and the straight-through gradient
reaches the latent float weights, which the optimizer updates and the
checkpoints keep.

`Optimizer.state_dict` / `load_state_dict` carry Adam's state in the flax
layout a checkpoint holds: per group ('depth', 'pose') the update count
and the moments `mu` (exp_avg) and `nu` (exp_avg_sq) as trees shaped like
that group's flax parameters (conv HWIO, Dense transposed, BN scale and
bias; utils/flax_weights.py), and the schedules' count. `adam_state_from_
optax` reads the same from the optax state of a JAX checkpoint.
"""

import math

import numpy as np
import torch

from packnet_sfm_tpu_torch.ops.depth import (
    sigmoid_to_inv_depth, inv2depth, compute_depth_metrics,
    dual_head_to_depth, post_process_inv_depth)
from packnet_sfm_tpu_torch.ops.image import flip_lr
from packnet_sfm_tpu_torch.ops.quantization import (
    depth_net_kernels, fake_quant_u8, quantize_depth_net_params)
from packnet_sfm_tpu_torch.utils.flax_weights import (
    flax_param_arrays, flax_tree)


def _int8_weights_forward(model):
    """call(*args, **kwargs) running `model` over its depth-net kernels
    fake-quantized to int8, without gradients. The quantized copy is made
    again only when a kernel changed (its storage or its version counter,
    which every in-place update bumps), so an evaluation quantizes once."""
    kernels = depth_net_kernels(model)
    cache = {}

    def call(*args, **kwargs):
        params = dict(model.named_parameters())
        key = tuple((params[n].data_ptr(), params[n]._version)
                    for n in kernels)
        if cache.get('key') != key:
            with torch.no_grad():
                cache['params'] = quantize_depth_net_params(model,
                                                            kernels=kernels)
            cache['key'] = key
        return torch.func.functional_call(model, cache['params'], args,
                                          kwargs)
    return call


def make_eval_step(model, int8_weights=False):
    """batch -> model outputs, without autograd. Runs the model in eval mode
    (the JAX step's train=False), whatever mode it was handed in;
    `int8_weights` runs it over its depth-net kernels fake-quantized per
    output channel (weight PTQ, or validation after QAT on weights)."""
    forward = _int8_weights_forward(model) if int8_weights else model

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        return forward(batch)
    return eval_step


def make_eval_metrics_step(model, params_cfg, flip_tta=False,
                           int8_outputs=False, int8_weights=False):
    """
    Per-batch eval protocol: forward (+ the flip-TTA second forward),
    sigmoid -> depth conversions, and the 7 metrics for every conversion
    mode with and without GT median scaling (reference
    model_wrapper.py:621-790). Returns step(batch) -> {mode: [7] tensor};
    `batch` must hold 'depth' (GT). `int8_outputs` fake-quantizes the
    sigmoid (after the flip-TTA fusion) or both dual-head maps to uint8
    before the depth conversion: the INT8 output cost is the metrics' move
    against an eval without it. `int8_weights` runs the forward over int8
    fake-quantized depth-net kernels (make_eval_step).
    """
    min_d = float(params_cfg.min_depth)
    max_d = float(params_cfg.max_depth)
    crop = params_cfg.get('crop', '')
    scale_output = params_cfg.get('scale_output', 'resize')
    use_log = bool(params_cfg.get('use_log_space', False))
    forward = make_eval_step(model, int8_weights)

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
            if int8_outputs:
                sig = fake_quant_u8(sig)
            inv_lin = sigmoid_to_inv_depth(sig, min_d, max_d, False)
            inv_log = sigmoid_to_inv_depth(sig, min_d, max_d, True)
            depth_lin, depth_log = inv2depth(inv_lin), inv2depth(inv_log)
            cand = {'depth': depth_log if use_log else depth_lin,
                    'depth_lin': depth_lin, 'depth_log': depth_log}
        else:
            int_sig, frac_sig = out[('integer', 0)], out[('fractional', 0)]
            if int8_outputs:
                int_sig, frac_sig = fake_quant_u8(int_sig), fake_quant_u8(
                    frac_sig)
            cand = {'depth': dual_head_to_depth(int_sig, frac_sig, max_d)}
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


def make_lr_schedule(scheduler_cfg, base_lr, steps_per_epoch):
    """count -> lr, per update step: epoch-wise StepLR or cosine (or a
    constant), with an optional linear warmup over `warmup_epochs`
    (train_step.py:38-71)."""
    name = scheduler_cfg.get('name', 'StepLR')
    spe = max(steps_per_epoch, 1)
    warmup_steps = int(float(scheduler_cfg.get('warmup_epochs', 0.0)) * spe)
    if name == 'StepLR':
        step_size = int(scheduler_cfg.get('step_size', 10))
        gamma = float(scheduler_cfg.get('gamma', 0.5))

        def sched(count):
            return base_lr * gamma ** ((count // spe) // step_size)
    elif name in ('CosineAnnealingLR', 'CosineAnnealing'):
        t_max = int(scheduler_cfg.get('T_max', 20))

        def sched(count):
            return base_lr * 0.5 * (1 + math.cos(
                math.pi * min(count // spe, t_max) / t_max))
    else:
        def sched(count):
            return base_lr
    if warmup_steps <= 0:
        return sched
    return lambda count: min((count + 1) / warmup_steps, 1.0) * sched(count)


class Optimizer:
    """Adam over the depth and pose parameter groups of `model`, each with
    its own lr schedule and optional L2 weight decay (optax's
    add_decayed_weights before adam is torch Adam's `weight_decay`), after
    a global-norm clip. `groups` is [(key, params, schedule, weight
    decay)]; a group without parameters is left out.

    The clip is optax's clip_by_global_norm: g * max / |g| when |g| >= max,
    without the +1e-6 of torch.nn.utils.clip_grad_norm_. A parameter left
    without a gradient gets zeros, as every leaf has a gradient in JAX.
    `count` is the number of applied updates (optax's schedule count)."""

    def __init__(self, model, groups, clip_grad=0.0):
        groups = [g for g in groups if g[1]]
        self.model = model
        self.keys = [key for key, _, _, _ in groups]
        self.params = [p for _, ps, _, _ in groups for p in ps]
        self.schedules = [sched for _, _, sched, _ in groups]
        self.adam = torch.optim.Adam(
            [{'params': ps, 'lr': sched(0), 'weight_decay': wd}
             for _, ps, sched, wd in groups], betas=(0.9, 0.999), eps=1e-8)
        self.clip_grad = float(clip_grad or 0.0)
        self.count = 0

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_grad > 0:
            grads = [p.grad for p in self.params]
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, torch.where(
                norm < self.clip_grad, 1.0, self.clip_grad / norm))
        for group, sched in zip(self.adam.param_groups, self.schedules):
            group['lr'] = sched(self.count)
        self.adam.step()
        self.count += 1

    def _names(self):
        return {p: n for n, p in self.model.named_parameters()}

    def state_dict(self):
        """{'schedule_count': n, 'groups': {key: {'count': n, 'mu': tree,
        'nu': tree}}} with numpy leaves; before the first update the
        moments are zeros."""
        names = self._names()
        groups = {}
        for key, group in zip(self.keys, self.adam.param_groups):
            moments = {'mu': {}, 'nu': {}}
            for p in group['params']:
                st = self.adam.state.get(p, {})
                for m, attr in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
                    moments[m][names[p]] = st.get(attr, torch.zeros_like(p))
            groups[key] = {'count': self.count,
                           **{m: flax_tree(self.model, v)
                              for m, v in moments.items()}}
        return {'schedule_count': self.count, 'groups': groups}

    def load_state_dict(self, state):
        """Put back the state `state_dict` or `adam_state_from_optax`
        gives. Raises ValueError unless every parameter of each group gets
        both moments, the counts agree, and a group this optimizer lacks
        (no parameters) holds no moment; KeyError or ValueError from the
        layout mapping on a leaf that names no parameter or has the wrong
        shape."""
        groups = state['groups']
        count = int(state['schedule_count'])
        for key, g in groups.items():
            if int(g['count']) != count:
                raise ValueError('Adam state: group {!r} count {} vs the '
                                 'schedule count {}'.format(key, g['count'],
                                                            count))
            if key not in self.keys and (g['mu'] or g['nu']):
                raise ValueError('Adam state: moments for group {!r}, which '
                                 'has no parameters here'.format(key))
        names = self._names()
        for key, group in zip(self.keys, self.adam.param_groups):
            if key not in groups:
                raise ValueError('Adam state: no group {!r}'.format(key))
            mu, nu = (flax_param_arrays(self.model, groups[key][m])
                      for m in ('mu', 'nu'))
            want = {names[p] for p in group['params']}
            if set(mu) != want or set(nu) != want:
                raise ValueError(
                    'Adam state of group {!r}: missing {}; unexpected {}'
                    .format(key, sorted(want - (set(mu) & set(nu))),
                            sorted((set(mu) | set(nu)) - want)))
            for p in group['params']:
                n = names[p]
                self.adam.state[p] = {
                    'step': torch.tensor(float(count)),
                    'exp_avg': _like(mu[n], p),
                    'exp_avg_sq': _like(nu[n], p)}
        self.count = count


def _like(arr, p):
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        p.device, p.dtype)


def _stand_in(node, name):
    """The fields of `node`, an optax NamedTuple come back from a
    checkpoint as a stand-in (utils/checkpoint.py `Inert`) whose class name
    is one of `name`; raises ValueError on anything else."""
    names = (name,) if isinstance(name, str) else name
    qualname = getattr(node, 'qualname', '')
    if qualname.rsplit('.', 1)[-1] not in names:
        raise ValueError('optax state: expected {}, found {!r}'.format(
            ' or '.join(names), node))
    return node.args


def _unmask(tree):
    """A moment tree of one optax group without its MaskedNode leaves (the
    other group's parameters)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _unmask(v)
            if sub:
                out[k] = sub
        elif isinstance(v, np.ndarray):
            out[k] = v
        else:
            _stand_in(v, 'MaskedNode')
    return out


def adam_state_from_optax(opt_state):
    """The Adam state of a JAX checkpoint's `opt_state`, in the format of
    `Optimizer.state_dict`. Its tree (JAX parallel/train_step.py
    make_optimizer): [chain(clip_by_global_norm ->] multi_transform({
    'depth': adam, 'pose': adam}) [)], each adam [chain(add_decayed_weights
    ->] (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))
    [)] under a MaskedState whose other group's leaves are MaskedNodes.
    Walked by field; raises ValueError on anything else (another
    optimizer, grad accumulation)."""
    node = opt_state
    if isinstance(node, tuple) and len(node) == 2 and \
            getattr(node[0], 'qualname', '').endswith('.EmptyState'):
        node = node[1]                      # clip_by_global_norm's state
    inner_states, = _stand_in(node, ('PartitionState',
                                     'MultiTransformState'))
    groups, counts = {}, set()
    for key, masked in inner_states.items():
        inner, = _stand_in(masked, 'MaskedState')
        if len(inner) == 2 and isinstance(inner[1], tuple):
            _stand_in(inner[0], 'EmptyState')    # add_decayed_weights
            inner = inner[1]
        if not isinstance(inner, tuple) or len(inner) != 2:
            raise ValueError('optax state of group {!r}: {!r}'.format(
                key, inner))
        count, mu, nu = _stand_in(inner[0], 'ScaleByAdamState')
        sched_count, = _stand_in(inner[1], 'ScaleByScheduleState')
        groups[key] = {'count': int(count), 'mu': _unmask(mu),
                       'nu': _unmask(nu)}
        counts |= {int(count), int(sched_count)}
    if len(counts) != 1:
        raise ValueError('optax state: counts {} disagree'.format(
            sorted(counts)))
    return {'schedule_count': counts.pop(), 'groups': groups}


def make_optimizer(model, optimizer_cfg, scheduler_cfg, steps_per_epoch,
                   clip_grad=0.0):
    """The depth/pose groups of `model` (parameters under `pose_net` are
    the pose group) with their lr and weight decay (train_step.py:90-124).
    Only Adam is ported; grad accumulation and EMA are not yet."""
    name = optimizer_cfg.get('name', 'Adam')
    if name.lower() != 'adam':
        raise NotImplementedError('optimizer {!r} is not ported yet'.format(
            name))
    if int(optimizer_cfg.get('grad_accumulation_steps', 1) or 1) > 1:
        raise NotImplementedError('grad accumulation is not ported yet')
    if float(optimizer_cfg.get('ema_decay', 0.0)) > 0:
        raise NotImplementedError('EMA of parameters is not ported yet')
    named = list(model.named_parameters())
    groups = []
    for key in ('depth', 'pose'):
        cfg = optimizer_cfg.get(key, {})
        params = [p for n, p in named
                  if (n.split('.')[0] == 'pose_net') == (key == 'pose')]
        groups.append((key, params,
                       make_lr_schedule(scheduler_cfg,
                                        float(cfg.get('lr', 2e-4)),
                                        steps_per_epoch),
                       float(cfg.get('weight_decay', 0.0))))
    return Optimizer(model, groups, clip_grad)


def make_train_step(model, optimizer, generator=None, augment=None,
                    qat_weights=False):
    """step(batch, progress=0.0, epoch=0) -> {'loss', **metrics} (detached
    tensors). Runs the model in training mode; `generator` feeds its random
    lr-flip and `augment(batch, generator)`, which runs first on the batch
    when given (ops/augment.py, tpu.device_augment). A non-finite loss
    skips the update (see the module note). `qat_weights`
    (model.params.qat holds 'weights'): the forward and backward see the
    depth-net kernels fake-quantized per output channel, and the
    straight-through gradient updates the latent float weights."""
    kernels = depth_net_kernels(model) if qat_weights else None

    def forward(batch, **kwargs):
        if kernels is None:
            return model(batch, **kwargs)
        return torch.func.functional_call(
            model, quantize_depth_net_params(model, kernels=kernels),
            (batch,), kwargs)

    def train_step(batch, progress=0.0, epoch=0):
        if augment is not None:
            batch = augment(batch, generator)
        model.train()
        optimizer.zero_grad()
        out = forward(batch, progress=progress, epoch=epoch,
                      generator=generator)
        loss = out['loss']
        loss.backward()
        if bool(torch.isfinite(loss)):
            optimizer.step()
        else:
            optimizer.zero_grad()
        return {'loss': loss.detach(),
                **{k: v.detach() for k, v in out['metrics'].items()}}
    return train_step
