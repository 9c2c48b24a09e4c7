"""The port's training entry points from disk, on the CPU; the satellites
(f) and (g) of the trainer parity (tests/test_torch_trainer_fit.py holds
(a), (c), (e); tests/test_torch_trainer_resume.py (b), (d)):

(f) `python -m packnet_sfm_tpu_torch.train <yaml> --device cpu` on an NCDB
    tree the test writes (4 train and 2 validation frames at 64x96, B2,
    float32 convs, 2 epochs, a mid_epoch.ckpt every step, a quick eval
    each epoch) writes the top-k checkpoints with Adam's state, one eval
    JSON an epoch holding the 6 x 7 metrics, the sources' snapshot, and
    no stale mid_epoch.ckpt; `train.fit` resumes from its last epoch-end
    checkpoint for one more epoch; without CUDA it raises unless the CPU
    is asked for;
(g) scripts/torch_overfit_convergence.py at 3 epochs writes the JAX
    script's JSON schema with a falling loss.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from packnet_sfm_tpu_torch import train as port_train
from packnet_sfm_tpu_torch.datasets.ncdb import write_ncdb_tree
from packnet_sfm_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_fixtures import (  # noqa: F401
    CONFIG, ckpt_files, ncdb_splits, ncdb_train_overrides, one_torch_thread)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (64, 96)


def test_train_cli_from_disk_checkpoints_and_resumes(tmp_path):
    root = str(tmp_path / 'ncdb')
    write_ncdb_tree(root, SHAPE, 6, ncdb_splits(4, 2), rows=16, fill=0.3)
    ck = tmp_path / 'ckpts'
    over = ncdb_train_overrides(root, SHAPE) + [
        'arch.max_epochs', 2, 'arch.eval_progress_interval', 0.5,
        'arch.eval_subset_size', 2, 'checkpoint.filepath', str(ck),
        'checkpoint.save_every_n_steps', 1]
    proc = subprocess.run(
        [sys.executable, '-m', 'packnet_sfm_tpu_torch.train', CONFIG,
         '--device', 'cpu'] + [str(x) for x in over],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='1', NO_COLOR='1'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count('[eval @ 1/2] abs_rel RGB') == 2
    run = ck / 'model'
    files = ckpt_files(run)
    assert len(files) == 2 and [f[:3] for f in files] == ['00_', '01_']
    assert not (run / 'mid_epoch.ckpt').exists()
    assert (run / 'code.tar.gz').exists()
    for epoch in (0, 1):
        with open(run / 'evaluation_results' /
                  'epoch_{}_results.json'.format(epoch)) as f:
            metrics = json.load(f)
        assert len(metrics) == 6 * 7 + 1
        assert all(np.isfinite(v) for v in metrics.values())
    last = load_checkpoint(str(run / files[-1]))
    assert (last['epoch'], last['step']) == (1, 4)
    assert last['adam_state']['schedule_count'] == 4
    assert last['opt_state'] is None

    # resume from the epoch-end checkpoint for one more epoch
    trainer = port_train.fit(str(run / files[-1]), 'cpu', [
        'arch.max_epochs', 3, 'checkpoint.filepath',
        str(tmp_path / 'resumed' / '{epoch:02d}')])
    assert (trainer.current_epoch, trainer.step,
            trainer.optimizer.count) == (2, 6, 6)
    assert ckpt_files(tmp_path / 'resumed') == ['02.ckpt']
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            port_train.fit(CONFIG, overrides=list(over))


def test_overfit_script_writes_a_falling_trajectory(tmp_path):
    spec = importlib.util.spec_from_file_location(
        'torch_overfit_convergence',
        ROOT / 'scripts' / 'torch_overfit_convergence.py')
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = tmp_path / 'overfit.json'
    script.main(['--epochs', '3', '--device', 'cpu', '--out', str(out)])
    with open(out) as f:
        got = json.load(f)
    with open(ROOT / 'artifacts' / 'overfit_r04.json') as f:
        jax_run = json.load(f)
    # the JAX script's schema, less nothing
    assert set(jax_run) <= set(got)
    assert set(jax_run['trajectory']) == set(got['trajectory'])
    loss = got['trajectory']['loss']
    assert got['n_epochs'] == len(loss) == 3 and got['backend'] == 'cpu'
    assert loss[-1] < loss[0] and all(np.isfinite(loss))
