#!/usr/bin/env python3
"""
Where the time of the PyTorch port's eval forward goes, on one CUDA card.

    python3 scripts/torch_profile_eval.py [--iters 10] [--batch-size 1]

Builds the slice's model (configs/train_resnet_san_ncdb_640x384.yaml,
seeded weights), warms up, then traces `--iters` forwards with
torch.profiler and prints: the wall time per forward, the device time per
forward summed over kernels, the device busy share of the window, and the
kernels by device time. The whole table goes to
chiprun_out/profile_eval.json.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--batch-size', type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_profile_eval: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch.parallel.train_step import make_eval_step

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    config, model = port_eval.build(
        os.path.join(ROOT, 'configs', 'train_resnet_san_ncdb_640x384.yaml'),
        'cuda', seed=0)
    batch = port_eval.make_batches(port_eval.image_shape(config),
                                   args.batch_size, 1, 0, 'cuda')[0]
    step = make_eval_step(model)
    for _ in range(5):
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
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total
            k[1] += 1
    device_us = sum(v[0] for v in kernels.values())
    rows = sorted(({'name': n, 'us_per_forward': v[0] / args.iters,
                    'calls_per_forward': v[1] / args.iters}
                   for n, v in kernels.items()),
                  key=lambda r: -r['us_per_forward'])
    summary = {'card': card, 'batch_size': args.batch_size,
               'iters': args.iters,
               'wall_ms_per_forward': wall * 1e3 / args.iters,
               'device_ms_per_forward': device_us / 1e3 / args.iters,
               'device_busy_share': device_us / 1e6 / wall,
               'kernels': rows}
    print(card)
    print('wall {:.3f} ms/forward, device {:.3f} ms/forward, busy {:.3f}'
          .format(summary['wall_ms_per_forward'],
                  summary['device_ms_per_forward'],
                  summary['device_busy_share']))
    for r in rows[:15]:
        print('{:10.1f} us {:6.1f} calls  {}'.format(
            r['us_per_forward'], r['calls_per_forward'], r['name'][:110]))
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'profile_eval.json'),
              'w') as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
