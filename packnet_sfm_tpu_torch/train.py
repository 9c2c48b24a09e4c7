"""
Training entry point of the PyTorch port.

    python -m packnet_sfm_tpu_torch.train configs/train_resnet_san_ncdb_640x384.yaml

builds the model and the optimizer from the YAML, draws the weights from a
seeded torch.Generator, makes KITTI-structured RGB + LiDAR + GT batches
from a seed at the YAML's train batch size and image shape (there is no
dataset in the repository yet; see eval.py `make_batches`) and trains for
`n_steps` steps over `n_batches` batches. A model with a pose net gets
`back_context + forward_context` context frames (datasets.train) and
intrinsics in each batch, for the photometric loss:

    python -m packnet_sfm_tpu_torch.train packnet_sfm_tpu_torch/configs/selfsup_kitti_192x640.yaml

Runs on the card unless device='cpu' is passed.
"""

import argparse

import torch

from packnet_sfm_tpu_torch.config import parse_train_config
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.eval import image_shape, make_batches
from packnet_sfm_tpu_torch.models.factory import setup_model, init_weights
from packnet_sfm_tpu_torch.trainers.trainer import Trainer
from packnet_sfm_tpu_torch.utils.pretrained import load_pretrained


def build(config_path, device='cuda', seed=0, overrides=None):
    """(config, training-mode model on `device`): seeded weights, then the
    pretrained ones the config asks for (utils/pretrained.py: a 'pt' depth
    net's ImageNet encoder, which raises PretrainedWeightsNotFound without
    a file unless model.depth_net.allow_random_init is set; each net's
    checkpoint_path)."""
    dev = resolve_device(device)
    config = parse_train_config(config_path, overrides)
    model = init_weights(setup_model(config),
                         torch.Generator().manual_seed(seed))
    load_pretrained(config, model)
    return config, model.to(dev).train()


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
    trainer = Trainer(config, model, steps_per_epoch=len(batches),
                      generator=torch.Generator().manual_seed(seed + 1))
    losses = trainer.fit(batches, n_steps)
    return {'losses': losses, 'config': config, 'model': model,
            'trainer': trainer, 'batches': batches}


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('config')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--n-steps', type=int, default=4)
    ap.add_argument('--n-batches', type=int, default=2)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('overrides', nargs='*',
                    help='KEY VALUE pairs merged over the YAML, e.g. '
                         'datasets.train.batch_size 2')
    a = ap.parse_args()
    run = main(a.config, a.device, a.n_steps, a.n_batches, a.seed,
               a.overrides)
    for i, loss in enumerate(run['losses']):
        print('step {} loss {:.6f}'.format(i, loss))
