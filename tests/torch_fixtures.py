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


def pooled_random_variables(shapes, seed, pool_size=1 << 20):
    """A flax variable tree of `shapes` filled from one pool of numpy
    normal draws (seed `seed`), each leaf a run of the pool from a random
    offset, wrapping: kernels at 1/sqrt(fan-in), scales and variances in
    [0.5, 1.5], the rest at 0.1 N(0, 1). For networks of ~1e8 weights,
    where a draw a weight costs seconds."""
    import jax
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal(pool_size, dtype=np.float32)

    def leaf(path, x):
        name = path[-1].key
        n = int(np.prod(x.shape))
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        v = np.resize(np.roll(pool, -int(rng.integers(pool_size))),
                      n).reshape(x.shape)
        if name in ('kernel', 'win2d_kernel'):
            v *= np.float32(1.0 / np.sqrt(np.prod(x.shape[:-1])))
        else:
            v *= np.float32(0.1)
        return v

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def assert_grads_match(model, jgrads, batch_stats, rel=2e-2, tag=''):
    """Each gradient leaf of `model` (after backward) against the JAX
    gradients `jgrads` (a flax 'params' tree): |g - g_jax| <= rel |g_jax| +
    1e-8 in the Frobenius norm; a leaf whose JAX gradient is below 1e-6 x
    the largest leaf's (analytically zero: a conv bias before a norm that
    removes it, float32 noise in both packages) within 1e-6 x that largest
    norm instead. Every parameter must have a leaf."""
    import jax
    from packnet_sfm_tpu_torch.utils.flax_weights import flax_state_dict
    want = flax_state_dict(model, {'params': jgrads,
                                   'batch_stats': batch_stats})
    params = dict(model.named_parameters())
    assert len(params) == len(jax.tree_util.tree_leaves(jgrads))
    top = max(float(np.linalg.norm(want[n])) for n in params)
    for name, p in params.items():
        g = (p.grad.numpy() if p.grad is not None
             else np.zeros(tuple(p.shape), np.float32))
        w = want[name]
        err, scale = np.linalg.norm(g - w), np.linalg.norm(w)
        if scale < 1e-6 * top:
            assert err <= 1e-6 * top, (tag, name, err, top)
        else:
            assert err <= rel * scale + 1e-8, (tag, name, err, scale)


def assert_stats_match(model, jstats, rel=1e-5):
    """The model's buffers (BatchNorm / MaskedBatchNorm statistics) against
    the JAX step's updated 'batch_stats', per leaf atol rel x max|leaf|."""
    import jax
    from packnet_sfm_tpu_torch.utils.flax_weights import flax_variables
    got = flax_variables(model)['batch_stats']
    a_leaves = jax.tree_util.tree_leaves_with_path(got)
    b_leaves = jax.tree_util.tree_leaves_with_path(jstats)
    assert len(a_leaves) == len(b_leaves)
    for (path, a), (_, b) in zip(a_leaves, b_leaves):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * float(np.abs(b).max()),
                                   err_msg=jax.tree_util.keystr(path))


def jax_run_once(fn, *args, opt_level=0):
    """fn(*args) jitted for one call, XLA's CPU backend at `opt_level`: at
    0 a narrow network's program compiles in about two thirds of the time
    and still runs in well under a second; a full-width one runs several
    times slower there, so it takes the default (None)."""
    import jax
    options = (None if opt_level is None else
               {'xla_backend_optimization_level': opt_level})
    return jax.jit(fn).lower(*args).compile(compiler_options=options)(*args)
