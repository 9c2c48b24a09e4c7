"""
Depth-completion evaluation entry points of the PyTorch port.

    python -m packnet_sfm_tpu_torch.eval --checkpoint model.ckpt \
        [--config cfg.yaml] [--half] [--int8] [--int8-weights] \
        [--save_folder dir] [KEY VALUE ...]

`test` is the JAX package's scripts/eval.py: the model and its config from
a checkpoint (the JAX package's format), the optional YAML and KEY VALUE
overrides merged over that config, the test split read from disk, and the
flat metrics of trainers/trainer.py `test`.

    python -m packnet_sfm_tpu_torch.eval configs/train_resnet_san_ncdb_640x384.yaml

`main` builds the model from the YAML, draws its weights from a seeded
torch.Generator, makes KITTI-structured RGB + LiDAR batches from a seed and
returns the flat metrics of trainers/trainer.py `evaluate`. Both run on the
card unless device='cpu' is passed.
"""

import argparse

import numpy as np
import torch

from packnet_sfm_tpu_torch.config import parse_test_file, parse_train_config
from packnet_sfm_tpu_torch.device import resolve_device
from packnet_sfm_tpu_torch.models.factory import setup_model, init_weights
from packnet_sfm_tpu_torch.trainers import trainer
from packnet_sfm_tpu_torch.utils.checkpoint import load_weights


def image_shape(config):
    shape = tuple(config.datasets.augmentation.image_shape)
    if len(shape) != 2:
        raise ValueError('datasets.augmentation.image_shape must be (H, W)')
    return shape


def build(config_path, device='cuda', seed=0, overrides=None):
    """(config, eval-mode model on `device` with seeded random weights)."""
    dev = resolve_device(device)
    config = parse_train_config(config_path, overrides)
    model = init_weights(setup_model(config),
                         torch.Generator().manual_seed(seed))
    return config, model.to(dev).eval()


def make_batches(shape, batch_size, n_batches, seed=0, device='cuda',
                 contexts=0):
    """KITTI-structured batches: uniform RGB; GT depth 1-71 m at 20% of the
    pixels; LiDAR on 64 beam rows spread from 40% of the height to the
    bottom (the rows above are empty, as above the horizon), 20% azimuth
    fill, depth 1-71 m. With `contexts` > 0, also that many uniform context
    frames ('rgb_context'), the un-jittered copies 'rgb_original' and
    'rgb_context_original' (the same tensors: nothing jitters them) and
    KITTI-like intrinsics (fx = fy = 721.5, principal point at the image
    centre), drawn as the JAX package's bench.py `_rand_batch` draws them."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    B, (H, W) = batch_size, shape
    beam_rows = np.linspace(int(H * 0.4), H - 1, 64).astype(int)
    K = np.tile(np.array([[721.5, 0, W / 2], [0, 721.5, H / 2], [0, 0, 1]],
                         np.float32)[None], (B, 1, 1))
    batches = []
    for _ in range(n_batches):
        rgb = rng.rand(B, H, W, 3).astype(np.float32)
        depth = ((rng.rand(B, H, W, 1) * 70 + 1) *
                 (rng.rand(B, H, W, 1) < 0.2)).astype(np.float32)
        mask = np.zeros((B, H, W, 1), np.float32)
        mask[:, beam_rows] = rng.rand(B, len(beam_rows), W, 1) < 0.20
        lidar = ((rng.rand(B, H, W, 1) * 70 + 1) * mask).astype(np.float32)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 (('rgb', rgb), ('depth', depth), ('input_depth', lidar))}
        if contexts:
            ctx = [torch.from_numpy(rng.rand(B, H, W, 3).astype(np.float32)
                                    ).to(dev) for _ in range(contexts)]
            batch.update(rgb_original=batch['rgb'], rgb_context=ctx,
                         rgb_context_original=list(ctx),
                         intrinsics=torch.from_numpy(K).to(dev))
        batches.append(batch)
    return batches


def shifted_context_batch(batch, shift=4, cell=8, seed=0):
    """`batch` (from make_batches with contexts) with something for the
    photometric loss to learn: a smooth target, uniform noise on a grid of
    `cell` px upsampled bilinearly, and context frames that are the target
    shifted `shift` px right and left, as a small yaw of the camera gives.
    make_batches' context frames are uniform noise drawn apart from the
    target, which leave that loss nothing to learn."""
    B, H, W, _ = batch['rgb'].shape
    dev = batch['rgb'].device
    low = torch.rand(B, 3, H // cell, W // cell, device=dev,
                     generator=torch.Generator(dev).manual_seed(seed))
    rgb = torch.nn.functional.interpolate(
        low, (H, W), mode='bilinear', align_corners=True).permute(
            0, 2, 3, 1).contiguous()
    ctx = [torch.roll(rgb, s, 2) for s in (shift, -shift)]
    return dict(batch, rgb=rgb, rgb_original=rgb, rgb_context=ctx,
                rgb_context_original=list(ctx))


def main(config_path, device='cuda', batch_size=1, n_batches=2, seed=0,
         overrides=None):
    """Evaluate seeded weights on seeded batches; returns the metrics dict.
    `overrides` is a flat ['a.b.c', value, ...] list merged over the YAML,
    e.g. ['model.params.flip_tta', True]."""
    config, model = build(config_path, device, seed, overrides)
    batches = make_batches(image_shape(config), batch_size, n_batches, seed,
                           device)
    return trainer.evaluate(config, model, batches)


def test(ckpt_file, cfg_file=None, half=False, int8=False, save_folder='',
         int8_weights=False, device='cuda', overrides=None):
    """Evaluate a checkpoint on its config's test split (datasets.test, all
    its datasets as one loader) and return the trainer's Metrics
    (`.skipped` counts the batches that failed). `cfg_file` is a YAML and
    `overrides` a flat ['a.b.c', value, ...] list merged over the
    checkpoint's config; `half` evaluates with bf16 convs; `int8` and
    `int8_weights` set model.params.int8_outputs and int8_weights (the
    sigmoids and the depth-net kernels fake-quantized to int8: the INT8
    deployment's metrics); `save_folder` also writes each sample's
    outputs there, from the float weights. The checkpoint's EMA weights
    are evaluated when it has them (model.optimizer.ema_eval)."""
    dev = resolve_device(device)
    config, state = parse_test_file(ckpt_file, cfg_file, overrides)
    if save_folder:
        config.save.folder = save_folder
        config.save.pretrained = ckpt_file
    if half:
        config.tpu.compute_dtype = 'bfloat16'
    if int8:
        config.model.params.int8_outputs = True
    if int8_weights:
        config.model.params.int8_weights = True
    key = 'ema_params' if state.get('ema_params') is not None and \
        config.model.optimizer.get('ema_eval', True) else 'params'
    model = load_weights(setup_model(config), state, key).to(dev).eval()
    loader = trainer.make_loader(config, 'test')
    if loader is None:
        raise ValueError('No test dataset configured (datasets.test)')
    return trainer.test(config, model, loader)


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--checkpoint', default=None,
                    help='evaluate this checkpoint on its test split')
    ap.add_argument('--config', default=None,
                    help='with --checkpoint: a YAML merged over its config')
    ap.add_argument('--half', action='store_true',
                    help='with --checkpoint: bf16 convs')
    ap.add_argument('--int8', action='store_true',
                    help='with --checkpoint: fake-quantize the outputs to '
                         'uint8 (the INT8 output cost)')
    ap.add_argument('--int8-weights', action='store_true',
                    help='with --checkpoint: fake-quantize the depth-net '
                         'conv kernels per output channel to int8')
    ap.add_argument('--save_folder', default='',
                    help='with --checkpoint: write per-sample outputs here')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--batch-size', type=int, default=1)
    ap.add_argument('--n-batches', type=int, default=2)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('args', nargs='*',
                    help='without --checkpoint: the YAML, then KEY VALUE '
                         'pairs merged over it; with --checkpoint: KEY VALUE '
                         'pairs, e.g. datasets.test.path "[\'/data\']"')
    a = ap.parse_args()
    if a.checkpoint:
        test(a.checkpoint, a.config, a.half, a.int8, a.save_folder,
             a.int8_weights, a.device, a.args)
    elif a.args:
        main(a.args[0], a.device, a.batch_size, a.n_batches, a.seed,
             a.args[1:])
    else:
        ap.error('give --checkpoint, or a YAML for seeded weights')
