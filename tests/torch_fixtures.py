"""Fixtures and helpers shared by the port's tests (tests/test_torch_*.py)."""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from packnet_sfm_tpu_torch.trainers.trainer import Trainer


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test: the port's test tensors are small,
    and the suite runs in several processes at once, where more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIG = str(Path(__file__).resolve().parents[1] / 'configs' /
             'train_resnet_san_ncdb_640x384.yaml')
OVERFIT = str(Path(__file__).resolve().parents[1] / 'configs' /
              'overfit_synthetic.yaml')
# 32x48 NCDB frames (tests/test_datasets.py make_ncdb_tree) read at 32x64,
# float32 convs, LiDAR input from the GT folder, as tests/test_ncdb_e2e.py
CLI_SHAPE = (32, 64)


def cli_overrides(ncdb_root):
    """Config overrides that point the NCDB YAML's test split at a fixture
    tree and cut it to CPU size."""
    return ['tpu.compute_dtype', 'float32',
            'datasets.augmentation.image_shape', CLI_SHAPE,
            'datasets.test.path', [ncdb_root],
            'datasets.test.split', ['split.json'],
            'datasets.test.input_depth_type', ['depth_original'],
            'datasets.test.batch_size', 2,
            'datasets.test.num_workers', 2,
            'checkpoint.filepath', '']


@contextlib.contextmanager
def jitted_jax_init():
    """Run the JAX Trainer's `init_state` (model.init and the optimizer's
    init from an example batch) as one jitted program instead of op by op:
    the same variables' shapes, and compiled once where the eager path
    compiles each of its ~500 ops. For tests whose JAX trainer resumes
    from a checkpoint or whose comparison starts from a checkpoint the
    JAX trainer writes, so that the initial values themselves are not what
    is compared."""
    from packnet_sfm_tpu.parallel import train_step as jts
    from packnet_sfm_tpu.trainers import trainer as jtrainer
    import jax

    def init_state(model, optimizer, batch, rng, ema=False):
        return jax.jit(lambda b, r: jts.init_state(model, optimizer, b, r,
                                                   ema))(batch, rng)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, 'init_state', init_state)
        yield


def randomize_variables(shapes, seed):
    """Every leaf of a flax variable tree of `shapes` drawn with numpy:
    kernels at 1/sqrt(fan-in), BN scales and variances in [0.5, 1.5],
    everything else at 0.1 N(0, 1)."""
    import jax
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == 'kernel':
            return (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))
                    ).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def write_jax_checkpoint(path, ncdb_root, seed=4):
    """A checkpoint written by the JAX package's save_checkpoint: the NCDB
    YAML's model with randomised variables (kernels ~ 1/sqrt(fan-in), BN
    scales and variances in [0.5, 1.5], the rest ~ 0.1 N(0, 1), from numpy
    seed `seed`) and real optax Adam state, its config pointed at
    `ncdb_root`. Returns the flax variables."""
    import jax
    from packnet_sfm_tpu.config import parse_train_config
    from packnet_sfm_tpu.models.factory import setup_model
    from packnet_sfm_tpu.parallel.train_step import TrainState, make_optimizer
    from packnet_sfm_tpu.utils.checkpoint import save_checkpoint

    cfg = parse_train_config(CONFIG, cli_overrides(ncdb_root))
    model = setup_model(cfg)
    rng = np.random.RandomState(seed)
    H, W = CLI_SHAPE
    batch = {'rgb': np.zeros((1, H, W, 3), np.float32),
             'input_depth': np.zeros((1, H, W, 1), np.float32)}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch,
                                               train=False))

    def leaf(p, x):
        name = p[-1].key
        if name == 'kernel':
            return (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))
                    ).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    opt = make_optimizer(cfg.model.optimizer, cfg.model.scheduler, 10,
                         clip_grad=cfg.arch.clip_grad)
    state = TrainState(params=variables['params'],
                       batch_stats=variables['batch_stats'],
                       opt_state=opt.init(variables['params']),
                       step=np.int32(7), epoch=np.int32(1))
    save_checkpoint(path, cfg, state)
    return variables


def ncdb_splits(n_train, n_val):
    """The split files of a `write_ncdb_tree` tree of n_train + n_val
    frames: 'train.json' the first `n_train`, 'val.json' the rest."""
    return {'train.json': range(n_train),
            'val.json': range(n_train, n_train + n_val)}


def ncdb_train_overrides(root, shape, batch_size=2):
    """Overrides that point the NCDB YAML's train and validation splits at
    a `write_ncdb_tree` tree with `ncdb_splits` and cut them to CPU size (float32 convs)."""
    return ['tpu.compute_dtype', 'float32',
            'datasets.augmentation.image_shape', tuple(shape),
            'datasets.train.path', [root], 'datasets.train.split',
            ['train.json'], 'datasets.train.batch_size', batch_size,
            'datasets.train.num_workers', 2,
            'datasets.validation.path', [root],
            'datasets.validation.split', ['val.json'],
            'datasets.validation.input_depth_type', ['depth_original'],
            'datasets.validation.num_workers', 2]


class RecordingTrainer(Trainer):
    """The port's Trainer, recording each step's loss in `losses`."""

    def _build_step(self):
        super()._build_step()
        step, self.losses = self.train_step, []

        def recorded(*args):
            out = step(*args)
            self.losses.append(float(out['loss']))
            return out
        self.train_step = recorded


def ckpt_files(folder):
    """The .ckpt files under `folder`, relative to it, sorted."""
    return sorted(str(p.relative_to(folder))
                  for p in Path(folder).rglob('*.ckpt'))
