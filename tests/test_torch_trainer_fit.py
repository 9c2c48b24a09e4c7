"""The port's loader-driven training against the JAX package's, on the CPU
on configs/overfit_synthetic.yaml (ResNetSAN01 + PoseNet, Synthetic 64x96,
B2, 4 steps an epoch) in float32 with float32 photometric maps on both
sides:

(a) the JAX Trainer.fit trains epoch 0 and saves its checkpoint with
    optax's Adam state; both packages resume from that one file for epoch
    1. The port imports the moments exactly (0 tolerance, and back to the
    optax trees); the per-step losses agree to rtol 2e-4 (measured
    1.4e-5) and the parameter updates over the epoch in sign on >= 97% of
    the entries that move (measured 99.95%) and to a relative norm <= 0.15
    (measured 0.0046), the limits of
    tests/test_torch_train.py::test_three_adam_steps_match_jax_make_train_
    step with their reasons: Adam divides each gradient entry by its own
    magnitude, so entries whose gradient is within rounding of zero move
    by +-lr in either framework;
(c) ModelCheckpoint keeps the files JAX's keeps over one sequence of
    metrics;
and the reader of optax's state walks the Adam trees JAX's make_optimizer
builds (with and without the clip, with weight decay) exactly, and raises
on another optimizer's;
(e) calibrate_san_row_window and the trainer's auto window equal JAX's on
    an NCDB tree the test writes.
(b) and (d), the port's own resume and the JAX package reading the port's
checkpoints, are in tests/test_torch_trainer_resume.py; (f) and (g), the
train CLI and the overfit script, in tests/test_torch_train_cli.py (each
file runs within 120 s serially).

An epoch-end checkpoint holds the epoch it finished. The JAX Trainer.setup
resumes at that epoch and trains it again (pinned in
tests/test_torch_trainer_resume.py); the port resumes at the next. So (a)
hands the JAX trainer the payload with epoch 1, the epoch the port resumes
at.
"""

import io
import pickle
import types

import jax
import numpy as np
import optax
import pytest
import torch

from packnet_sfm_tpu.config import parse_train_config as j_parse
from packnet_sfm_tpu.config import parse_train_file as j_parse_train_file
from packnet_sfm_tpu.datasets import setup_dataset as j_setup_dataset
from packnet_sfm_tpu.networks.layers import san as jsan
from packnet_sfm_tpu.parallel.train_step import make_optimizer as j_make_opt
from packnet_sfm_tpu.trainers.trainer import Trainer as JTrainer
from packnet_sfm_tpu.utils.checkpoint import (
    ModelCheckpoint as JModelCheckpoint, load_checkpoint as j_load)
from packnet_sfm_tpu_torch.config import parse_train_config, parse_train_file
from packnet_sfm_tpu_torch.datasets import setup_dataset
from packnet_sfm_tpu_torch.datasets.ncdb import write_ncdb_tree
from packnet_sfm_tpu_torch.models.factory import setup_model
from packnet_sfm_tpu_torch.networks.layers import san as tsan
from packnet_sfm_tpu_torch.parallel.train_step import (
    adam_state_from_optax, make_optimizer)
from packnet_sfm_tpu_torch.trainers.trainer import Trainer
from packnet_sfm_tpu_torch.utils import checkpoint as tckpt
from packnet_sfm_tpu_torch.utils.checkpoint import (
    ModelCheckpoint, adam_state, load_checkpoint)
from packnet_sfm_tpu_torch.utils.flax_weights import flax_state_dict
from tests.torch_fixtures import (  # noqa: F401
    CONFIG, OVERFIT, RecordingTrainer, ckpt_files, jitted_jax_init,
    ncdb_splits, ncdb_train_overrides, one_torch_thread)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

FP32 = ['tpu.photometric_dtype', 'float32']


class RecordingJTrainer(JTrainer):
    """The JAX Trainer, recording each step's loss."""

    def _build_steps(self):
        super()._build_steps()
        step, self.losses = self.train_step, []

        def recorded(state, batch, rng, progress):
            state, metrics = step(state, batch, rng, progress)
            self.losses.append(float(metrics['loss']))
            return state, metrics
        self.train_step = recorded


@pytest.fixture(scope='module')
def jax_epoch0(tmp_path_factory):
    """The JAX Trainer.fit over epoch 0 and the checkpoint it saves (its
    init_state compiled as one program, tests/torch_fixtures.py
    jitted_jax_init: both packages start epoch 1 from what it saved)."""
    tmp = tmp_path_factory.mktemp('jax')
    cfg = j_parse(OVERFIT, FP32 + ['arch.max_epochs', 1,
                                   'checkpoint.filepath', str(tmp),
                                   'checkpoint.monitor', 'loss'])
    cfg.datasets.validation.dataset = []      # train only
    with jitted_jax_init():
        JTrainer(cfg).fit()
    paths = ckpt_files(tmp)
    assert len(paths) == 1
    return str(tmp / paths[0])


def test_resumed_epoch_matches_jax(jax_epoch0):
    payload = load_checkpoint(jax_epoch0)       # the port's reader
    assert payload['epoch'] == 0 and payload['step'] == 4

    # the moments, imported exactly and back to optax's trees
    jstate = j_load(jax_epoch0)                  # optax's own classes
    parts = jstate['opt_state'][1].inner_states
    tcfg, _ = parse_train_file(jax_epoch0)
    model = setup_model(tcfg)
    opt = make_optimizer(model, tcfg.model.optimizer, tcfg.model.scheduler,
                         4, clip_grad=tcfg.arch.clip_grad)
    opt.load_state_dict(adam_state(payload))
    assert opt.count == 4
    adams = {k: parts[k].inner_state[0] for k in ('depth', 'pose')}
    for moment, attr in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
        merged = {'depth_net': getattr(adams['depth'], moment)['depth_net'],
                  'pose_net': getattr(adams['pose'], moment)['pose_net']}
        want = flax_state_dict(model, {'params': merged,
                                       'batch_stats': payload['batch_stats']})
        for name, p in model.named_parameters():
            got = opt.adam.state[p][attr].numpy()
            assert np.array_equal(got, want[name]), (moment, name)
            assert int(opt.adam.state[p]['step']) == 4
    back = opt.state_dict()
    assert back['schedule_count'] == 4
    for key, adam in adams.items():
        assert back['groups'][key]['count'] == int(adam.count)
        for moment in ('mu', 'nu'):
            want = {k: v for k, v in getattr(adam, moment).items()
                    if isinstance(v, dict)}
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_array_equal(a, b),
                back['groups'][key][moment], want)

    # both packages train epoch 1 from the file
    jcfg, jpayload = j_parse_train_file(jax_epoch0)
    jcfg.arch.max_epochs = 2
    jcfg.checkpoint.filepath = ''
    jpayload['epoch'] = 1
    jt = RecordingJTrainer(jcfg, resume_state=jpayload)
    with jitted_jax_init():         # the file's values replace it
        jt.fit()
    cfg, _ = parse_train_file(jax_epoch0, ['arch.max_epochs', 2,
                                           'checkpoint.filepath', ''])
    tt = RecordingTrainer(cfg, resume_state=payload, device='cpu')
    tt.fit()
    assert len(tt.losses) == len(jt.losses) == 4
    np.testing.assert_allclose(tt.losses, jt.losses, rtol=2e-4)
    assert tt.step == 8 and tt.optimizer.count == 8 and tt.current_epoch == 1

    before = flax_state_dict(tt.model, {'params': payload['params'],
                                        'batch_stats':
                                        payload['batch_stats']})
    host = jax.device_get(jt.state)
    after = flax_state_dict(tt.model, {'params': host.params,
                                       'batch_stats': host.batch_stats})
    got = tt.model.state_dict()
    names = [n for n, _ in tt.model.named_parameters()]
    dt = np.concatenate([(got[n].numpy() - before[n]).ravel() for n in names])
    dj = np.concatenate([(after[n] - before[n]).ravel() for n in names])
    moved = dj != 0
    assert moved.mean() > 0.5
    assert (np.sign(dt[moved]) == np.sign(dj[moved])).mean() >= 0.97
    assert np.linalg.norm(dt - dj) <= 0.15 * np.linalg.norm(dj)


def _through_the_unpickler(tree):
    """`tree` as the port's checkpoint reader hands it back: optax's
    classes as stand-ins."""
    host = jax.tree_util.tree_map(np.asarray, tree)
    return tckpt._Unpickler(io.BytesIO(pickle.dumps(host))).load()


@pytest.mark.parametrize('clip,decay', [(10.0, 0.0), (0.0, 0.01)])
def test_optax_state_reader_walks_every_adam_tree(clip, decay):
    """Both groups, with and without the global clip's EmptyState and
    weight decay's; two updates on seeded gradients; then the moments in
    the port's optimizer; another optimizer raises."""
    rng = np.random.RandomState(0)
    shapes = {'depth_net': {'a': (3, 2), 'b': (4,)},
              'pose_net': {'c': (2, 2)}}
    params = {n: {k: rng.randn(*v).astype(np.float32) for k, v in d.items()}
              for n, d in shapes.items()}
    cfg = {'name': 'Adam', 'depth': {'lr': 1e-3, 'weight_decay': decay}}
    tx = j_make_opt(cfg, {'name': 'StepLR'}, 4, clip_grad=clip)
    state = tx.init(params)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*x.shape).astype(np.float32), params)
        _, state = tx.update(grads, state, params)
    got = adam_state_from_optax(_through_the_unpickler(state))
    assert got['schedule_count'] == 2
    inner = (state[1] if clip else state).inner_states
    for key, net in (('depth', 'depth_net'), ('pose', 'pose_net')):
        adam = inner[key].inner_state
        adam = (adam[1] if decay and key == 'depth' else adam)[0]
        assert got['groups'][key]['count'] == 2
        assert list(got['groups'][key]['mu']) == [net]
        for m in ('mu', 'nu'):
            jax.tree_util.tree_map(np.testing.assert_array_equal,
                                   got['groups'][key][m][net],
                                   getattr(adam, m)[net])
    model = torch.nn.Module()
    for net, leaves in shapes.items():
        sub = torch.nn.Module()
        for k, shape in leaves.items():
            setattr(sub, k, torch.nn.Parameter(torch.zeros(shape)))
        setattr(model, net, sub)
    opt = make_optimizer(model, cfg, {'name': 'StepLR'}, 4, clip_grad=clip)
    opt.load_state_dict(got)
    assert opt.count == 2
    np.testing.assert_array_equal(
        opt.adam.state[model.pose_net.c]['exp_avg'].numpy(),
        inner['pose'].inner_state[0].mu['pose_net']['c'])
    sgd = optax.sgd(1e-3, momentum=0.9).init(params)
    with pytest.raises(ValueError, match='optax state'):
        adam_state_from_optax(_through_the_unpickler(sgd))


@pytest.mark.parametrize('monitor,period', [('depth-abs_rel', 1),
                                            ('depth-a1', 1),
                                            ('depth-abs_rel', 2),
                                            ('missing', 1)])
def test_model_checkpoint_keeps_the_files_jax_keeps(tmp_path, monitor,
                                                    period):
    abs_rel = [0.5, 0.3, 0.4, 0.2, 0.6, 0.25, 0.35]
    a1 = [0.1, 0.5, 0.3, 0.7, 0.2, 0.6, 0.4]
    tpl = '{epoch:02d}_{%s:.3f}' % monitor
    jcfg = j_parse(OVERFIT)
    tcfg = parse_train_config(OVERFIT)
    jstate = types.SimpleNamespace(params={'w': np.zeros(2, np.float32)},
                                   batch_stats={}, opt_state=None, step=0,
                                   epoch=0)
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.zeros(2))
    jcb = JModelCheckpoint(str(tmp_path / 'j' / tpl), monitor=monitor,
                           save_top_k=3, period=period)
    tcb = ModelCheckpoint(str(tmp_path / 't' / tpl), monitor=monitor,
                          save_top_k=3, period=period)
    assert tcb.mode == jcb.mode
    for epoch, (r, a) in enumerate(zip(abs_rel, a1)):
        metrics = {'loss': 1.0 / (epoch + 1), 'depth-abs_rel': r,
                   'depth-a1': a}
        jcb.check_and_save(jcfg, jstate, metrics, epoch)
        tcb.check_and_save(tcfg, model, None, metrics, epoch)
        assert ckpt_files(tmp_path / 't') == ckpt_files(tmp_path / 'j'), epoch
    assert len(ckpt_files(tmp_path / 't')) == 3
    # a bare directory names its files model_<epoch>
    assert ModelCheckpoint(str(tmp_path / 'd') + '/').filename_tpl == \
        JModelCheckpoint(str(tmp_path / 'd') + '/').filename_tpl


def test_row_window_calibration_matches_jax(tmp_path):
    root = str(tmp_path / 'ncdb')
    write_ncdb_tree(root, (192, 64), 5, ncdb_splits(4, 1), rows=16, fill=0.3)
    over = ncdb_train_overrides(root, (192, 64)) + [
        'model.depth_net.san_row_window', -1.0]
    jcfg, tcfg = j_parse(CONFIG, list(over)), parse_train_config(
        CONFIG, list(over))
    got = tsan.calibrate_san_row_window(setup_dataset(
        tcfg.datasets.train, tcfg.datasets.augmentation, 'train')[0])
    want = jsan.calibrate_san_row_window(j_setup_dataset(
        jcfg.datasets.train, jcfg.datasets.augmentation, 'train')[0])
    assert got == want and 0 < got < 1
    JTrainer._maybe_autocalibrate_row_window(types.SimpleNamespace(
        config=jcfg))
    t = Trainer(tcfg, device='cpu')
    assert tcfg.model.depth_net.san_row_window == \
        jcfg.model.depth_net.san_row_window == want
    assert t.model.depth_net.san_row_window == want
