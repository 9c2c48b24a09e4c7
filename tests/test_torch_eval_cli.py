"""The port's eval and inference CLIs (packnet_sfm_tpu_torch/eval.py `test`,
infer.py `infer_and_save_depth`) against the JAX package's scripts/eval.py
`test` and scripts/infer.py, from one JAX-written checkpoint, on the NCDB
fixture tree at 32x64 in float32 with LiDAR input (the inference CLI with
an input mask); and the trainer's warn-and-skip of failing batches.

Tolerances: the 6 x 7 metrics within atol 1e-4 (as tests/test_torch_eval.py:
float32 sums in another order); depth maps within rtol 1e-5; the
visualisations, 8-bit PNGs of a colormap, within one step of 255.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from packnet_sfm_tpu_torch import eval as port_eval
from packnet_sfm_tpu_torch import infer as port_infer
from packnet_sfm_tpu_torch.config import parse_test_file
from packnet_sfm_tpu_torch.models.factory import setup_model
from packnet_sfm_tpu_torch.trainers import trainer
from packnet_sfm_tpu_torch.utils.checkpoint import (
    load_weights, save_checkpoint)
from tests.test_datasets import make_ncdb_tree
from tests.torch_fixtures import CLI_SHAPE, one_torch_thread  # noqa: F401
from tests.torch_fixtures import jitted_jax_init, write_jax_checkpoint

pytestmark = pytest.mark.usefixtures('one_torch_thread')

ROOT = Path(__file__).resolve().parents[1]
SAVE = ('npz', 'png', 'viz')


def _files(folder):
    return sorted(str(p.relative_to(folder)) for p in Path(folder).rglob('*')
                  if p.is_file())


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """One JAX checkpoint; the JAX and the port eval CLI on it with a save
    folder, and both inference CLIs on the frame folder."""
    sys.path.insert(0, str(ROOT / 'scripts'))
    try:
        import eval as jax_eval
        import infer as jax_infer
    finally:
        sys.path.remove(str(ROOT / 'scripts'))
    d = tmp_path_factory.mktemp('cli')
    root = str(d / 'ncdb')
    os.makedirs(root)
    make_ncdb_tree(root)
    ckpt = str(d / 'jax.ckpt')
    write_jax_checkpoint(ckpt, root)
    frames = os.path.join(root, 'synced_data', 'image_a6')
    # a mask at another size than the frames: it is resized to them
    mask = np.zeros((16, 24, 3), np.uint8)
    mask[3:, 4:] = 255
    Image.fromarray(mask).save(str(d / 'mask.png'))
    out = {'root': root, 'ckpt': ckpt, 'dir': d}
    with jitted_jax_init():         # the checkpoint's values replace it
        out['jax'] = jax_eval.test(ckpt, save_folder=str(d / 'jax_save'))
    out['port'] = port_eval.test(ckpt, save_folder=str(d / 'port_save'),
                                 device='cpu')
    jax_infer.infer_and_save_depth(ckpt, frames, str(d / 'jax_infer'),
                                   image_shape=CLI_SHAPE, save=SAVE,
                                   mask=str(d / 'mask.png'))
    port_infer.infer_and_save_depth(ckpt, frames, str(d / 'port_infer'),
                                    image_shape=CLI_SHAPE, save=SAVE,
                                    mask=str(d / 'mask.png'), device='cpu')
    yield out
    os.remove(ckpt)     # ~590 MB: the model's weights and Adam's moments


def test_eval_cli_metrics_match_jax(runs):
    want, got = runs['jax'], runs['port']
    assert len(want) == 6 * 7 + 1
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert got.skipped == 0


def test_save_folder_writes_the_files_jax_writes(runs):
    d = runs['dir']
    files = _files(d / 'jax_save')
    assert len(files) == 3 * 4 and files == _files(d / 'port_save')
    for f in files:
        got, want = d / 'port_save' / f, d / 'jax_save' / f
        if f.endswith('.npz'):
            np.testing.assert_allclose(np.load(got)['depth'],
                                       np.load(want)['depth'], rtol=1e-5)
        elif f.endswith('_rgb.png'):
            assert got.read_bytes() == want.read_bytes(), f


def test_infer_cli_matches_jax(runs):
    d = runs['dir']
    files = _files(d / 'jax_infer')
    assert len(files) == 3 * 3 and files == _files(d / 'port_infer')
    for f in files:
        got, want = d / 'port_infer' / f, d / 'jax_infer' / f
        if f.endswith('.npz'):
            np.testing.assert_allclose(np.load(got)['depth'],
                                       np.load(want)['depth'], rtol=1e-5)
        else:
            with Image.open(got) as a, Image.open(want) as b:
                diff = np.abs(np.asarray(a, np.int64) -
                              np.asarray(b, np.int64))
            assert diff.max() <= (1 if f.endswith('_viz.png') else 0), f


def test_command_lines_and_refusals(runs, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    frame = os.path.join(runs['root'], 'synced_data', 'image_a6',
                         'frame_0001.png')
    # both command lines at once: each process reads the checkpoint
    runs_ = [subprocess.Popen(
        [sys.executable, '-m'] + cmd, env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in (['packnet_sfm_tpu_torch.eval', '--checkpoint',
                     runs['ckpt'], '--device', 'cpu',
                     'datasets.test.batch_size', '3', '--int8',
                     '--int8-weights'],
                    ['packnet_sfm_tpu_torch.infer', '--checkpoint',
                     runs['ckpt'], '--input', frame, '--output',
                     str(tmp_path / 'one'), '--image_shape', '32', '64',
                     '--device', 'cpu', '--colormap', 'depth'])]
    outputs = []
    for run in runs_:
        out, err = run.communicate(timeout=300)
        assert run.returncode == 0, err[-3000:]
        outputs.append(out)
    assert '| depth_log_gt ' in outputs[0]
    assert _files(tmp_path / 'one') == ['frame_0001.npz',
                                        'frame_0001_viz.png']
    # int8 eval and the dual head, which earlier slices refused, now run
    config, state = parse_test_file(runs['ckpt'])
    config.model.depth_net.use_dual_head = True
    dual = save_checkpoint(str(tmp_path / 'dual.ckpt'), config,
                           setup_model(config))
    port_infer.infer_and_save_depth(dual, frame, str(tmp_path / 'dual'),
                                    image_shape=(32, 64), device='cpu')
    assert _files(tmp_path / 'dual') == ['frame_0001.npz',
                                         'frame_0001_viz.png']
    os.remove(dual)


def test_validate_skips_failed_batches_and_raises_when_all_fail(runs,
                                                                 tmp_path):
    root = str(tmp_path / 'ncdb')
    shutil.copytree(runs['root'], root)
    config, state = parse_test_file(runs['ckpt'], overrides=[
        'datasets.test.path', [root]])
    model = load_weights(setup_model(config), state).eval()
    os.remove(os.path.join(root, 'synced_data', 'newest_original_depth_maps',
                           'frame_0000.png'))
    # batches of 2: [frame 0, frame 1] fails to load, [frame 2] is scored
    got = trainer.validate(config, model, trainer.make_loader(config, 'test'))
    assert got.skipped == 1
    config.datasets.test.split = ['one.json']
    with open(os.path.join(root, 'one.json'), 'w') as f:
        f.write('[{"dataset_root": "synced_data", '
                '"new_filename": "frame_0002"}]')
    want = trainer.validate(config, model, trainer.make_loader(config, 'test'))
    assert want.skipped == 0 and dict(got) == dict(want)
    config.datasets.test.split = ['split.json']
    config.datasets.test.batch_size = 3
    with pytest.raises(RuntimeError, match='all 1 evaluation batches'):
        trainer.test(config, model)
