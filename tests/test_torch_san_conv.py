"""The PyTorch port's masked conv (packnet_sfm_tpu_torch/ops/kernels/
san_conv.py) against the JAX package's Pallas kernel in interpret mode and
its dense oracle, on the CPU, where the wrapper runs its plain version.

Tolerance: fp32 atol = rtol = 1e-4, as tests/test_san_conv_kernel.py holds
the Pallas kernel to the oracle (sums in another order). Empty masks must
give exact zeros. Also: the CUDA path raises instead of falling back, and
the port imports nothing of JAX.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.ops.pallas.san_conv import (
    masked_conv2d_pallas, _dense_oracle)
from packnet_sfm_tpu_torch import resolve_device
from packnet_sfm_tpu_torch.ops.kernels import build, san_conv

ROOT = Path(__file__).resolve().parents[1]


def _inputs(seed, B, H, W, Cin, Cout, k, mask_kind='rows'):
    rng = np.random.RandomState(seed)
    if mask_kind == 'rows':
        # KITTI-like: empty above 40% of the height, scattered returns below
        mask = np.zeros((B, H, W, 1), np.float32)
        h0 = int(H * 0.4)
        mask[:, h0:] = rng.rand(B, H - h0, W, 1) < 0.3
    else:
        mask = np.zeros((B, H, W, 1), np.float32)
    x = rng.randn(B, H, W, Cin).astype(np.float32) * mask
    kern = (rng.randn(k, k, Cin, Cout) * 0.1).astype(np.float32)
    bias = (rng.randn(Cout) * 0.1).astype(np.float32)
    return x, mask, kern, bias


def _port(x, mask, kern, bias):
    return san_conv.masked_conv2d(*(torch.from_numpy(v) for v in
                                    (x, mask, kern, bias))).numpy()


@pytest.mark.parametrize('k', [3, 5])
@pytest.mark.parametrize('shape', [
    (1, 12, 20, 1, 16),     # Cin = 1 (first SAN stage), W = 20
    (2, 13, 21, 16, 8),     # H, W not multiples of 8
    (1, 16, 24, 64, 32),
])
def test_reference_matches_pallas_and_oracle(k, shape):
    B, H, W, Cin, Cout = shape
    x, mask, kern, bias = _inputs(k * 100 + Cin, B, H, W, Cin, Cout, k)
    got = _port(x, mask, kern, bias)
    pallas = masked_conv2d_pallas(*(jnp.asarray(v) for v in
                                    (x, mask, kern, bias)), interpret=True)
    oracle = _dense_oracle(jnp.asarray(x), jnp.asarray(kern),
                           jnp.asarray(bias), jnp.asarray(mask))
    assert got.shape == (B, H, W, Cout)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=1e-4, rtol=1e-4)
    # inactive sites (all rows above the horizon) are exact zeros
    assert np.all(got[mask[..., 0] == 0] == 0.0)


def test_all_empty_mask_gives_exact_zeros():
    x, mask, kern, bias = _inputs(7, 1, 16, 20, 16, 16, 3, mask_kind='empty')
    bias += 1.0   # a bias alone must not leak into inactive sites
    got = _port(x, mask, kern, bias)
    assert got.shape == (1, 16, 20, 16)
    assert np.all(got == 0.0)


def test_bf16_reference_rounds_fp32_result():
    # the plain version accumulates in fp32 and rounds once to bf16
    x, mask, kern, bias = _inputs(3, 1, 10, 12, 8, 8, 3)
    t = [torch.from_numpy(v) for v in (x, mask, kern, bias)]
    want = san_conv.masked_conv2d(*t)
    got = san_conv.masked_conv2d(t[0].bfloat16(), t[1], t[2].bfloat16(),
                                 t[3].bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_cuda_path_raises_without_fallback():
    x, mask, kern, bias = (torch.from_numpy(v) for v in
                           _inputs(1, 1, 8, 8, 4, 4, 3))
    before = san_conv.masked_conv2d.launches
    # the kernel path refuses CPU tensors rather than computing anything
    with pytest.raises(ValueError, match='CUDA'):
        san_conv._launch(x, mask, kern, bias)
    # only a CPU tensor takes the plain version: any other device goes to
    # the kernel path, which raises
    with pytest.raises(ValueError, match='CUDA'):
        san_conv.masked_conv2d(*(t.to('meta') for t in (x, mask, kern, bias)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            resolve_device('cuda')
    assert san_conv.masked_conv2d.launches == before
    assert resolve_device('cpu').type == 'cpu'


def test_wrapper_checks_shapes():
    x, mask, kern, bias = (torch.from_numpy(v) for v in
                           _inputs(2, 1, 8, 8, 4, 4, 3))
    with pytest.raises(ValueError, match='k in'):
        san_conv.masked_conv2d(x, mask, torch.zeros(7, 7, 4, 4), bias)
    with pytest.raises(ValueError, match='channel'):
        san_conv.masked_conv2d(x, mask, kern[:, :, :2], bias)
    with pytest.raises(ValueError, match='mask'):
        san_conv.masked_conv2d(x, mask[:, :4], kern, bias)


def test_build_names_library_by_source_hash():
    path = build.library_path('san_conv')
    assert path.parent == ROOT / 'build' / 'kernels'
    assert re.fullmatch(r'san_conv-[0-9a-f]{16}\.so', path.name)
    assert (build.CSRC / 'san_conv.cu').is_file()


def test_port_imports_nothing_of_jax():
    # the port may speak of flax variables (utils/flax_weights.py reads
    # their tree as numpy), but imports neither JAX, flax nor the JAX package
    pattern = re.compile(r'import jax|from jax|import flax|from flax'
                         r'|import optax|from optax'
                         r'|\b(import|from)\s+packnet_sfm_tpu\b'
                         r'|packnet_sfm_tpu\.')
    files = sorted((ROOT / 'packnet_sfm_tpu_torch').rglob('*.py'))
    files += sorted((ROOT / 'packnet_sfm_tpu_torch').rglob('*.cu'))
    files += [ROOT / 'chip_smoke.py']
    files += sorted((ROOT / 'scripts').glob('torch_*.py'))
    assert len(files) > 15
    # the generic-camera slice's and the CLI slice's modules are among them
    port = ROOT / 'packnet_sfm_tpu_torch'
    for rel in ('geometry/camera_generic.py', 'losses/generic_photometric.py',
                'models/generic.py', 'networks/depth/ray_surface_resnet.py',
                'ops/kernels/generic_projection.py',
                'csrc/generic_projection.cu', 'ops/kernels/lane_gather.py',
                'csrc/lane_gather.cu', 'datasets/__init__.py',
                'datasets/io.py', 'datasets/transforms.py',
                'datasets/synthetic.py', 'datasets/ncdb.py',
                'datasets/concat.py', 'datasets/loader.py',
                'config/config.py', 'utils/checkpoint.py', 'utils/viz.py',
                'utils/save.py', 'trainers/trainer.py', 'eval.py',
                'infer.py'):
        assert port / rel in files, rel
    assert ROOT / 'scripts' / 'torch_bench_dynamic_gather.py' in files
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []


# the SAN levels of the slices' 384x640 input and their conv channel pairs
LEVELS = [(192, 320, 5, ((1, 64), (1, 128), (128, 64), (128, 128))),
          (96, 160, 5, ((64, 64), (64, 128), (128, 64), (128, 128))),
          (48, 80, 3, ((64, 128), (64, 256), (256, 128), (256, 256))),
          (24, 40, 3, ((128, 256), (128, 512), (512, 256), (512, 512))),
          (12, 20, 3, ((256, 512), (256, 1024), (1024, 512),
                       (1024, 1024)))]


@pytest.mark.parametrize('B,H,W,kc,nc,k,dtype,want', [
    (1, 192, 320, 1, 64, 5, torch.bfloat16, 'cuda-core'),
    (8, 192, 320, 128, 128, 5, torch.float32, 'cuda-core'),
    (1, 5, 3, 1, 1, 3, torch.bfloat16, 'cuda-core'),
    (1, 9, 20, 64, 1, 5, torch.bfloat16, 'cuda-core'),
    (8, 192, 320, 128, 128, 5, torch.bfloat16, 'tensor-core'),
    (2, 17, 33, 24, 96, 5, torch.bfloat16, 'tensor-core'),
    (2, 19, 35, 16, 24, 3, torch.bfloat16, 'tensor-core'),
    (1, 12, 20, 1024, 512, 3, torch.bfloat16, 'split-K'),
    (1, 12, 20, 512, 1024, 3, torch.bfloat16, 'split-K')])
def test_plan_picks_the_path(B, H, W, kc, nc, k, dtype, want):
    """float32 and channel counts that are not multiples of 8 take the CUDA
    cores; bf16 the tensor cores, with K split on the small B1 levels (the
    split-K cases of chip_smoke.py)."""
    path, tile, block_n, splits = san_conv.plan(B, H, W, kc, nc, k, dtype)
    assert path == want
    if path == 'cuda-core':
        assert (tile, block_n, splits) == ((0, 0, 0), 0, 1)
    else:
        assert (splits > 1) == (path == 'split-K')


@pytest.mark.parametrize('B', [1, 8])
def test_plan_tiles_and_splits_fit_the_kernel(B):
    """At every SAN shape of the slices: a tile the kernel has (8-wide ones
    for k = 3 only), 64 or 128 channels a block, every K range non-empty,
    the grid within CUDA's limits; at least one split at B1; the 12x20
    level on 4x8 tiles, of 4 images at B8."""
    splits_seen = 0
    for H, W, k, pairs in LEVELS:
        for cin, cout in pairs:
            for kc, nc in ((cin, cout), (cout, cin)):
                path, tile, block_n, splits = san_conv.plan(
                    B, H, W, kc, nc, k, torch.bfloat16)
                if kc % 8 or nc % 8:
                    assert path == 'cuda-core'
                    continue
                assert tile in san_conv.TC_TILES
                assert k == 3 or tile[1] == 16
                assert block_n in (64, 128) and nc % block_n == 0
                chunks = -(-kc // san_conv.TC_CK)
                per_split = -(-chunks // splits)
                assert 1 <= splits <= chunks
                assert (splits - 1) * per_split < chunks
                assert -(-B // tile[2]) * splits <= 65535
                if H == 12:
                    assert tile[:2] == (4, 8) and tile[2] == (4 if B == 8
                                                              else 1)
                splits_seen += splits > 1
    assert splits_seen > 0 or B == 8
