"""
Training entry point of the PyTorch port.

    python -m packnet_sfm_tpu_torch.train <config.yaml | checkpoint.ckpt> \
        [--device cpu] [KEY VALUE ...]

trains from disk: `fit` parses the YAML (or resumes from the checkpoint:
an epoch-end one at the next epoch, a `mid_epoch.ckpt` at its loader
position), merges the KEY VALUE overrides and runs `Trainer.fit` over the
config's datasets, validating each epoch and writing checkpoints with
Adam's state (trainers/trainer.py).

    python -m packnet_sfm_tpu_torch.train \
        configs/train_resnet_san_ncdb_640x384.yaml --n-steps 4

trains `--n-steps` steps on batches held in memory instead (`main`): seeded
weights, KITTI-structured RGB + LiDAR + GT batches drawn from a seed at the
YAML's train batch size and image shape (eval.py `make_batches`), for
configs whose data is not on disk and for timing the step alone. A model
with a pose net gets `back_context + forward_context` context frames
(datasets.train) and intrinsics in each batch, for the photometric loss.

Both run on the card unless device='cpu' is passed.
"""

import argparse

from packnet_sfm_tpu_torch.config import parse_train_config, parse_train_file
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.eval import image_shape, make_batches
from packnet_sfm_tpu_torch.trainers.trainer import Trainer, seeded_model


def build(config_path, device='cuda', seed=0, overrides=None):
    """(config, training-mode model on `device`): seeded weights, then the
    pretrained ones the config asks for (trainers.trainer.seeded_model)."""
    dev = resolve_device(device)
    config = parse_train_config(config_path, overrides)
    return config, seeded_model(config, seed).to(dev).train()


def n_contexts(config):
    """Context frames per sample: those of datasets.train when the model has
    a pose net, else none."""
    if not config.model.pose_net.name:
        return 0
    train = config.datasets.train
    return int(train.back_context) + int(train.forward_context)


def main(config_path, device='cuda', n_steps=4, n_batches=2, seed=0,
         overrides=None, batches=None):
    """Train seeded weights on seeded batches. Returns {'losses': per-step
    floats, 'config', 'model' (in training mode; trainers.trainer.evaluate
    switches it to eval mode), 'trainer', 'batches'}. `overrides` is a flat
    ['a.b.c', value, ...] list merged over the YAML. `batches`, a list of
    batch dicts on `device`, replaces the seeded ones (`n_batches` is then
    unused)."""
    config, model = build(config_path, device, seed, overrides)
    if batches is None:
        batches = make_batches(image_shape(config),
                               int(config.datasets.train.batch_size),
                               n_batches, seed, device, n_contexts(config))
    trainer = Trainer(config, device=device, model=model)
    trainer.setup(len(batches))
    losses = trainer.train_batches(batches, n_steps)
    return {'losses': losses, 'config': config, 'model': model,
            'trainer': trainer, 'batches': batches}


def fit(path, device='cuda', overrides=None, logger=None):
    """Train from a YAML, or resume from a checkpoint, over the config's
    datasets (`Trainer.fit`); returns the Trainer."""
    config, resume_state = parse_train_file(path, overrides)
    trainer = Trainer(config, resume_state=resume_state, logger=logger,
                      device=device)
    return trainer.fit()


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('config', help='a YAML, or a .ckpt to resume from')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--n-steps', type=int, default=None,
                    help='train this many steps on seeded batches in memory '
                         'instead of the datasets')
    ap.add_argument('--n-batches', type=int, default=2,
                    help='with --n-steps: the seeded batches')
    ap.add_argument('--seed', type=int, default=0,
                    help='with --n-steps: the weights and batches seed')
    ap.add_argument('overrides', nargs='*',
                    help='KEY VALUE pairs merged over the config, e.g. '
                         'datasets.train.batch_size 2')
    a = ap.parse_args()
    if a.n_steps is None:
        fit(a.config, a.device, a.overrides)
    else:
        run = main(a.config, a.device, a.n_steps, a.n_batches, a.seed,
                   a.overrides)
        for i, loss in enumerate(run['losses']):
            print('step {} loss {:.6f}'.format(i, loss))
