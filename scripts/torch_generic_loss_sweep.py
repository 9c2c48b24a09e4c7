#!/usr/bin/env python3
"""
Does the generic-camera step learn in its first 10 steps, and on which
synthetic batch? On one CUDA card.

    python3 scripts/torch_generic_loss_sweep.py [--steps 10] [--seeds 0 1]

For each seed, texture cell (8, 16 px) and context shift (2, 4, 8 px):
train.main on configs/train_omnicam.yaml (B1 384x384, seeded weights:
model.depth_net.allow_random_init, as there is no ImageNet file) for
`--steps` steps in one epoch of `eval.shifted_context_batch` repeated, and
print the losses, the fall from the first step to the last in percent, and
the step of the least loss. Lines go to chiprun_out/generic_loss_sweep.json
too.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG = os.path.join(ROOT, 'configs', 'train_omnicam.yaml')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1])
    a = ap.parse_args()
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.config import parse_train_config
    shape = port_eval.image_shape(parse_train_config(CONFIG))
    rows = []
    for seed in a.seeds:
        base = port_eval.make_batches(shape, 1, 1, seed=seed, device='cuda',
                                      contexts=2)[0]
        for cell in (8, 16):
            for shift in (2, 4, 8):
                batch = port_eval.shifted_context_batch(base, shift, cell,
                                                        seed)
                losses = port_train.main(
                    CONFIG, 'cuda', n_steps=a.steps, seed=seed,
                    batches=[batch] * a.steps, overrides=[
                        'model.depth_net.allow_random_init', True])['losses']
                row = {'seed': seed, 'cell': cell, 'shift': shift,
                       'losses': losses,
                       'fall_pct': 100 * (losses[0] - losses[-1]) / losses[0],
                       'least_at': losses.index(min(losses))}
                rows.append(row)
                print('seed {} cell {:2d} shift {}: {} fall {:.2f}% least at '
                      'step {}'.format(seed, cell, shift,
                                       ['{:.4f}'.format(v) for v in losses],
                                       row['fall_pct'], row['least_at']),
                      flush=True)
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'generic_loss_sweep.json'),
              'w') as f:
        json.dump(rows, f, indent=1)


if __name__ == '__main__':
    main()
