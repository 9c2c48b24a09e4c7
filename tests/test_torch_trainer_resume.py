"""The port's own resume, and the JAX package reading the port's
checkpoints, on the CPU on configs/overfit_synthetic.yaml (ResNetSAN01 +
PoseNet, Synthetic 64x96, B2, 4 steps an epoch, float32 photometric
maps); the satellites (b) and (d) of the trainer parity, beside (a), (c)
and (e) in tests/test_torch_trainer_fit.py:

(b) the port's 2-epoch fit writes a mid_epoch.ckpt every 2 steps; resumed
    from the one at step 2 of epoch 1, it runs exactly the 2 remaining
    steps and ends with the uninterrupted run's parameters, statistics
    and Adam state, bit for bit (the same single intra-op thread, so the
    same reduction order); an epoch-end checkpoint resumes at the next
    epoch;
(d) an epoch-end checkpoint the port writes is read by the JAX
    parse_train_file and Trainer.setup: the weights equal, the
    fresh-optimizer warning (the port keeps opt_state None and its Adam
    state under a key of its own). The JAX trainer resumes at the
    checkpoint's epoch, training it again, where the port goes on with
    the next (ROADMAP.md section 3).
"""

import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.config import parse_train_file as j_parse_train_file
from packnet_sfm_tpu.trainers.trainer import Trainer as JTrainer
from packnet_sfm_tpu.trainers.trainer import _to_device_batch
from packnet_sfm_tpu_torch.config import parse_train_config, parse_train_file
from packnet_sfm_tpu_torch.trainers import trainer as trainer_mod
from packnet_sfm_tpu_torch.trainers.trainer import Trainer
from packnet_sfm_tpu_torch.utils import profiling
from packnet_sfm_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_fixtures import (  # noqa: F401
    OVERFIT, RecordingTrainer, ckpt_files, jitted_jax_init, one_torch_thread)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

FP32 = ['tpu.photometric_dtype', 'float32']


@pytest.fixture(scope='module')
def port_run(tmp_path_factory):
    """The port's uninterrupted 2-epoch fit with a mid_epoch.ckpt every 2
    steps; the one at step 2 of epoch 1 is kept aside."""
    tmp = tmp_path_factory.mktemp('port')
    cfg = parse_train_config(OVERFIT, FP32 + [
        'arch.max_epochs', 2, 'checkpoint.filepath', str(tmp / 'ckpts'),
        'checkpoint.monitor', 'loss', 'checkpoint.save_every_n_steps', 2])
    cfg.datasets.validation.dataset = []
    kept = {}
    real = trainer_mod.save_checkpoint

    def capture(path, *args, extra=None, **kwargs):
        if extra is not None:
            # the epoch-end removal left no stale mid_epoch.ckpt behind
            assert os.path.exists(path) == (extra['loader'][
                'batches_consumed'] == 4)
        out = real(path, *args, extra=extra, **kwargs)
        if extra == {'loader': {'epoch': 1, 'batches_consumed': 2}}:
            kept['path'] = shutil.copy(path, str(tmp / 'kept_mid_epoch.ckpt'))
        return out

    # one intra-op thread, as the resumed run in the test: the same
    # reduction order, so the two runs can agree bit for bit
    threads = torch.get_num_threads()
    trainer_mod.save_checkpoint = capture
    torch.set_num_threads(1)
    try:
        trainer = Trainer(cfg, device='cpu').fit()
    finally:
        trainer_mod.save_checkpoint = real
        torch.set_num_threads(threads)
    return types.SimpleNamespace(trainer=trainer, tmp=tmp,
                                 mid=kept['path'])


def test_mid_epoch_resume_is_exact(port_run):
    trainer = port_run.trainer
    assert trainer.step == trainer.optimizer.count == 8
    ckdir = port_run.tmp / 'ckpts' / 'model'
    assert not (ckdir / 'mid_epoch.ckpt').exists()
    assert (ckdir / 'code.tar.gz').exists()
    payload = load_checkpoint(port_run.mid)
    assert payload['loader'] == {'epoch': 1, 'batches_consumed': 2}
    assert payload['step'] == 6 and payload['opt_state'] is None
    assert payload['adam_state']['schedule_count'] == 6

    cfg, state = parse_train_file(port_run.mid, ['checkpoint.filepath', ''])
    resumed = RecordingTrainer(cfg, resume_state=state, device='cpu').fit()
    assert len(resumed.losses) == 2
    assert resumed.step == resumed.optimizer.count == 8
    want = trainer.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, want[k]), k
    a, b = resumed.optimizer.state_dict(), trainer.optimizer.state_dict()
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)

    # an epoch-end checkpoint resumes at the next epoch
    end = next(p for p in ckpt_files(ckdir) if p.startswith('00_'))
    cfg, state = parse_train_file(str(ckdir / end))
    t = Trainer(cfg, resume_state=state, device='cpu')
    t.setup(4)
    assert (t.current_epoch, t.step, t.optimizer.count) == (1, 4, 4)


def test_jax_reads_a_port_checkpoint(port_run, capsys):
    ckdir = port_run.tmp / 'ckpts' / 'model'
    path = str(ckdir / next(p for p in ckpt_files(ckdir)
                            if p.startswith('00_')))
    config, state = j_parse_train_file(path)
    jt = JTrainer(config, resume_state=state)
    loader = jt._make_loader('train')
    jt._steps_per_epoch = len(loader)
    capsys.readouterr()
    with jitted_jax_init():         # the checkpoint's values replace it
        jt.setup(_to_device_batch(next(iter(loader)), jt.mesh))
    assert 'fresh optimizer' in capsys.readouterr().out
    host = jax.device_get(jt.state)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           (host.params, host.batch_stats),
                           (state['params'], state['batch_stats']))
    assert int(host.step) == 4
    # the JAX trainer trains the checkpoint's epoch again
    assert state['epoch'] == 0 and jt.current_epoch == 0




def test_saves_and_quick_evals_are_not_data_wait(tmp_path, monkeypatch):
    """train_epoch books its mid-epoch saves and quick evals to neither the
    data wait nor the step: on a StepTimer clock that only they advance,
    both stay 0 (a save after every step, a quick eval after steps 1-3)."""
    clock = [0.0]

    def slow(*args, **kwargs):
        clock[0] += 100.0

    monkeypatch.setattr(profiling, 'time', types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    monkeypatch.setattr(trainer_mod, 'save_checkpoint', slow)
    cfg = parse_train_config(OVERFIT, [
        'checkpoint.filepath', str(tmp_path / 'ckpts'),
        'checkpoint.save_every_n_steps', 1, 'arch.eval_during_training',
        True, 'arch.eval_progress_interval', 0.25])
    trainer = Trainer(cfg, device='cpu')
    monkeypatch.setattr(trainer, 'quick_eval', slow)
    monkeypatch.setattr(trainer, '_run_step',
                        lambda batch, epoch, index, n: torch.tensor(1.0))
    out = trainer.train_epoch(trainer_mod.make_loader(cfg, 'train'),
                              object(), 0)
    assert clock[0] == 100.0 * (4 + 3)
    assert out['data_ms_per_step'] == out['step_ms_per_step'] == 0.0
