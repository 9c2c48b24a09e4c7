#!/usr/bin/env python3
"""
Where the time of the PyTorch port's train step goes, on one CUDA card.

    python3 scripts/torch_profile_train.py [CONFIG [KEY VALUE ...]] \
        [--iters 5] [--batch-size N]
    python3 scripts/torch_profile_train.py \
        packnet_sfm_tpu_torch/configs/selfsup_kitti_192x640.yaml
    python3 scripts/torch_profile_train.py configs/train_omnicam.yaml \
        model.depth_net.allow_random_init true

Builds the model and optimizer of CONFIG (default
configs/train_resnet_san_ncdb_640x384.yaml; seeded weights; KEY VALUE
pairs merged over the YAML: a 'pt' config such as the omnicam one needs
model.depth_net.allow_random_init true without ImageNet weights), warms up
on one seeded batch (with context frames and intrinsics when the model has
a pose net) at the YAML's train batch size unless --batch-size is given, then
traces `--iters` train steps (forward, loss, backward, clip, Adam) with
torch.profiler and prints: the wall time per step, the device time per step
summed over kernels, the device busy share of the window, the device time
per step by kind of kernel (the masked-conv forward and dgrad kernels, the
warp forward and dgrid, photometric and generic-projection kernels, the
cuDNN/CUTLASS convs, elementwise and reductions, max-pool, the optimizer,
copies), the peak device memory, and the
kernels by device time. The whole table goes to chiprun_out/profile_train.json.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kind of kernel by its name, the first match wins
KINDS = (('generic projection forward kernel', ('proj_fwd_kernel',)),
         ('generic projection backward kernels', ('proj_bwd_',)),
         ('warp forward kernel', ('warp_out_kernel',)),
         ('warp dgrid kernel', ('warp_dgrid_kernel',)),
         ('photometric forward kernel', ('photometric_fwd_kernel',)),
         ('photometric backward kernel', ('photometric_bwd_kernel',)),
         # CUDA cores <T, k, dgrad>; tensor cores <k, tile, block_n,
         # dgrad, split>
         ('masked-conv dgrad kernel', ('masked_conv_kernel', ', true>')),
         ('masked-conv dgrad kernel', ('masked_conv_tc', ', true, ')),
         ('masked-conv forward kernel', ('masked_conv_kernel',)),
         ('masked-conv forward kernel', ('masked_conv_tc',)),
         ('masked-conv split-K reduction', ('splitk_reduce',)),
         ('max-pool', ('max_pool',)),
         ('optimizer (Adam, clip)', ('multi_tensor_apply',)),
         ('cuDNN / CUTLASS conv', ('conv', 'xmma', 'cutlass', 'sm90_',
                                   'implicit', 'cudnn', 'gemm')),
         ('reductions', ('reduce',)),
         ('elementwise', ('elementwise', 'vectorized', 'unrolled')),
         ('copies', ('copy', 'memcpy', 'memset', 'Memcpy', 'Memset')))


def kind(name):
    for label, keys in KINDS:
        if label.startswith('masked-conv dgrad'):
            if all(k in name for k in keys):
                return label
        elif any(k in name for k in keys):
            return label
    return 'other'


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('config', nargs='?', default=os.path.join(
        'configs', 'train_resnet_san_ncdb_640x384.yaml'))
    ap.add_argument('overrides', nargs='*',
                    help='KEY VALUE pairs merged over the YAML')
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--batch-size', type=int, default=None,
                    help='default: the YAML\'s datasets.train.batch_size')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_profile_train: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.trainers.trainer import Trainer

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    config, model = port_train.build(os.path.join(ROOT, args.config), 'cuda',
                                     seed=0, overrides=args.overrides)
    if args.batch_size is None:
        args.batch_size = int(config.datasets.train.batch_size)
    batch = port_eval.make_batches(port_eval.image_shape(config),
                                   args.batch_size, 1, 0, 'cuda',
                                   port_train.n_contexts(config))[0]
    trainer = Trainer(config, device='cuda', model=model)
    trainer.setup(1)
    step = trainer.train_step
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        # a user annotation (Optimizer.step#Adam.step) spans kernels that
        # are counted on their own
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(ev, 'is_user_annotation', False):
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total
            k[1] += 1
    device_us = sum(v[0] for v in kernels.values())
    rows = sorted(({'name': n, 'kind': kind(n),
                    'us_per_step': v[0] / args.iters,
                    'calls_per_step': v[1] / args.iters}
                   for n, v in kernels.items()),
                  key=lambda r: -r['us_per_step'])
    kinds = {}
    for r in rows:
        k = kinds.setdefault(r['kind'], {'ms_per_step': 0.0,
                                         'calls_per_step': 0.0})
        k['ms_per_step'] += r['us_per_step'] / 1e3
        k['calls_per_step'] += r['calls_per_step']
    summary = {'card': card, 'config': args.config,
               'batch_size': args.batch_size,
               'iters': args.iters,
               'wall_ms_per_step': wall * 1e3 / args.iters,
               'img_per_s': args.batch_size * args.iters / wall,
               'device_ms_per_step': device_us / 1e3 / args.iters,
               'device_busy_share': device_us / 1e6 / wall,
               'peak_memory_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
               'kinds': kinds, 'kernels': rows}
    print(card)
    print('B{} train step: wall {:.3f} ms/step ({:.2f} img/s), device {:.3f} '
          'ms/step, busy {:.3f}, peak memory {:.1f} GiB'.format(
              args.batch_size, summary['wall_ms_per_step'],
              summary['img_per_s'], summary['device_ms_per_step'],
              summary['device_busy_share'], summary['peak_memory_gib']))
    for label, v in sorted(kinds.items(), key=lambda kv: -kv[1]['ms_per_step']):
        print('{:10.3f} ms {:8.1f} calls  {}'.format(
            v['ms_per_step'], v['calls_per_step'], label))
    for r in rows[:15]:
        print('{:10.1f} us {:6.1f} calls  {}'.format(
            r['us_per_step'], r['calls_per_step'], r['name'][:110]))
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'profile_train.json'),
              'w') as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
