"""The lane-gather probes' plain versions (the CPU side of
packnet_sfm_tpu_torch/ops/kernels/lane_gather.py) against the JAX package's
Pallas probe kernels of scripts/bench_dynamic_gather.py, run in interpret
mode with the script's block specs, on numpy-seeded inputs.

Tolerance: none, bit-equal. A gather moves values without arithmetic, and
the loop probe's sum is taken in the same order (i = 0 .. n-1) on both
sides.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from packnet_sfm_tpu_torch.ops.kernels import lane_gather as lg
from scripts.bench_dynamic_gather import _gather_kernel, _loop_kernel

ROOT = Path(__file__).resolve().parents[1]
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _interpret(kernel, out_shape, x, idx):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(
            jnp.asarray(x), jnp.asarray(idx)))


def _inputs(S, L, high, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(S, L).astype(np.float32),
            rng.randint(0, high, size=(S, L)).astype(np.int32))


@pytest.mark.parametrize('S,L', [(8, 128), (8, 256), (8, 640), (16, 128),
                                 (32, 128)])
def test_gather_matches_pallas_kernel(S, L):
    x, idx = _inputs(S, L, L, seed=S + L)
    want = _interpret(_gather_kernel, (S, L), x, idx)
    got = lg.lane_gather(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.take_along_axis(x, idx, axis=1))


@pytest.mark.parametrize('n_gathers', [16, 512])
def test_loop_matches_pallas_kernel(n_gathers):
    S = 8
    x, idx = _inputs(S, 512, 128, seed=n_gathers)
    want = _interpret(functools.partial(_loop_kernel, n_gathers), (S, 128),
                      x, idx)
    got = lg.lane_gather_loop(torch.from_numpy(x), torch.from_numpy(idx),
                              n_gathers).numpy()
    np.testing.assert_array_equal(got, want)


def test_loop_sums_in_order_and_cpu_launches_nothing():
    # the order matters: values of mixed magnitude give another float32
    # sum when the chunks are added chunk by chunk (n/4 times each)
    x, idx = _inputs(2, 512, 128, seed=3)
    x[:, :128] *= 1e6
    n = 7
    got = lg.lane_gather_loop(torch.from_numpy(x), torch.from_numpy(idx), n)
    g = [np.take_along_axis(x[:, c * 128:(c + 1) * 128],
                            idx[:, c * 128:(c + 1) * 128], axis=1)
         for c in range(4)]
    acc = np.zeros((2, 128), np.float32)
    for i in range(n):
        acc = acc + g[i % 4]
    np.testing.assert_array_equal(got.numpy(), acc)
    by_chunk = np.zeros((2, 128), np.float32)
    for c in range(4):
        for _ in range(len(range(c, n, 4))):
            by_chunk = by_chunk + g[c]
    assert not np.array_equal(by_chunk, acc)
    assert not lg.lane_gather_loop(torch.from_numpy(x), torch.from_numpy(idx),
                                   0).any()
    assert lg.lane_gather.launches == lg.lane_gather_loop.launches == 0


def test_wrappers_check_their_inputs():
    x, idx = (torch.from_numpy(v) for v in _inputs(2, 512, 128, seed=0))
    with pytest.raises(ValueError, match='one shape'):
        lg.lane_gather(x, idx[:, :256])
    with pytest.raises(TypeError, match='int32'):
        lg.lane_gather(x, idx.long())
    with pytest.raises(ValueError, match='512'):
        lg.lane_gather_loop(x[:, :256], idx[:, :256], 4)
    with pytest.raises(ValueError, match='n_gathers'):
        lg.lane_gather_loop(x, idx, -1)


def test_probe_script_on_the_cpu():
    out = subprocess.run(
        [sys.executable,
         str(ROOT / 'scripts' / 'torch_bench_dynamic_gather.py'),
         '--device', 'cpu', '--iters', '1'], capture_output=True,
        env=dict(os.environ, OMP_NUM_THREADS='1'), text=True,
        timeout=300, check=True).stdout
    assert out.count('OK (global indices correct)') == 5
    assert 'loop probe [32x128 gathers x512]' in out
