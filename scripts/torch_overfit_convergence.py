"""
Overfit convergence of the PyTorch port: the counterpart of
scripts/overfit_convergence.py. It runs the port's Trainer.fit (loaders,
train step, validation, metric tables) on the synthetic SfM dataset of
configs/overfit_synthetic.yaml for N epochs, with no data on disk, and
writes the per-epoch trajectory (train loss, every validation metric) in
the JSON schema of the JAX script's artifacts/overfit_r04.json.

Usage:
    python scripts/torch_overfit_convergence.py [--epochs 12] [--device cpu]
        [--out artifacts/torch_overfit_r10.json]
        [--config configs/overfit_synthetic.yaml] [key value ...]

Runs on the card unless --device cpu is given.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class RecordingLogger:
    """Records every per-epoch metrics dict; images are not kept."""

    def __init__(self):
        self.history = {}

    def log_metrics(self, metrics, step=None):
        entry = self.history.setdefault(int(step or 0), {})
        entry.update({k: float(v) for k, v in metrics.items()
                      if isinstance(v, (int, float))})

    def log_images(self, *args, **kwargs):
        pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--config', default='configs/overfit_synthetic.yaml')
    ap.add_argument('--epochs', type=int, default=12)
    ap.add_argument('--out', default='artifacts/torch_overfit_r10.json')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('opts', nargs='*', default=[])
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch
    from packnet_sfm_tpu_torch.config import parse_train_file
    from packnet_sfm_tpu_torch.trainers.trainer import Trainer

    config, _ = parse_train_file(os.path.join(ROOT, args.config),
                                 list(args.opts))
    config.arch.max_epochs = args.epochs
    config.checkpoint.filepath = ''          # the trajectory only
    recorder = RecordingLogger()
    trainer = Trainer(config, logger=recorder, device=args.device)
    t0 = time.time()
    trainer.fit()
    wall = time.time() - t0

    epochs = sorted(recorder.history)
    traj = {'epochs': epochs,
            'loss': [recorder.history[e].get('train/loss') for e in epochs]}
    val_keys = sorted({k for e in epochs for k in recorder.history[e]
                       if k.startswith('val/')})
    for k in val_keys:
        traj[k.replace('val/', 'val_')] = [recorder.history[e].get(k)
                                           for e in epochs]
    losses = [v for v in traj['loss'] if v is not None]
    device = trainer.device
    result = {
        'config': args.config,
        'overrides': list(args.opts),
        'backend': device.type,
        'device': torch.cuda.get_device_name(device)
        if device.type == 'cuda' else 'cpu',
        'torch': torch.__version__,
        'n_epochs': len(epochs),
        'wall_s': round(wall, 1),
        'loss_first': losses[0] if losses else None,
        'loss_last': losses[-1] if losses else None,
        'converged': bool(losses and losses[-1] < 0.7 * losses[0]),
        'trajectory': traj,
        'final_val_metrics': {k: float(v) for k, v in
                              trainer.last_val_metrics.items()},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in
                      ('backend', 'n_epochs', 'loss_first', 'loss_last',
                       'converged', 'wall_s')}))
    return 0 if result['converged'] else 1


if __name__ == '__main__':
    sys.exit(main())
