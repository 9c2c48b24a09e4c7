"""The port's file IO and eval transforms (packnet_sfm_tpu_torch/datasets/
io.py, transforms.py) against the JAX package's, on files Pillow writes
and on numpy-seeded arrays.

Tolerance: none, bit-equal. Both packages decode and resize through
Pillow, and the depth resizes are the same numpy indexing.
"""

import numpy as np
import pytest
from PIL import Image

from packnet_sfm_tpu.datasets import io as jio
from packnet_sfm_tpu.datasets import transforms as jtr
from packnet_sfm_tpu_torch.datasets import io as tio
from packnet_sfm_tpu_torch.datasets import transforms as ttr


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA'])
def test_load_image_matches_jax(tmp_path, mode):
    rng = np.random.RandomState(len(mode))
    channels = {'RGB': 3, 'RGBA': 4, 'L': 1, 'LA': 2}[mode]
    arr = (rng.rand(13, 21, channels) * 255).astype(np.uint8)
    path = str(tmp_path / 'im.png')
    Image.fromarray(arr[..., 0] if channels == 1 else arr, mode).save(path)
    got = tio.load_image(path)
    assert got.shape == (13, 21, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.load_image(path))


def test_depth_files_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    depth = (rng.rand(17, 23) * 40 * (rng.rand(17, 23) < 0.3)).astype(
        np.float32)
    png = str(tmp_path / 'port.png')
    tio.write_depth(png, depth)
    jio.write_depth(str(tmp_path / 'jax.png'), depth)
    want = jio.load_depth(str(tmp_path / 'jax.png'))
    np.testing.assert_array_equal(tio.load_depth(png), want)
    np.testing.assert_array_equal(jio.load_depth(png), want)
    with Image.open(png) as im:
        assert im.mode == 'I;16'
    npz = str(tmp_path / 'd.npz')
    tio.write_depth(npz, depth, intrinsics=np.eye(3))
    np.testing.assert_array_equal(tio.load_depth(npz), jio.load_depth(npz))
    # a PNG whose values all lie at or below 255 is no 16-bit depth map
    Image.fromarray((depth * 0 + 200).astype(np.uint16)).save(png)
    with pytest.raises(ValueError, match='Wrong .png depth'):
        tio.load_depth(png)
    with pytest.raises(NotImplementedError):
        tio.load_depth(str(tmp_path / 'd.exr'))


def test_write_image_matches_jax(tmp_path):
    img = np.random.RandomState(1).rand(9, 14, 3).astype(np.float32) * 1.2
    tio.write_image(str(tmp_path / 'a.png'), img)
    jio.write_image(str(tmp_path / 'b.png'), img)
    assert (tmp_path / 'a.png').read_bytes() == \
        (tmp_path / 'b.png').read_bytes()


@pytest.mark.parametrize('shape', [(24, 40), (61, 97), (48, 80)],
                         ids=['down', 'up', 'same'])
def test_resizes_match_jax(shape):
    rng = np.random.RandomState(2)
    img = rng.rand(48, 80, 3).astype(np.float32)
    sparse = (rng.rand(48, 80, 1) * 10 * (rng.rand(48, 80, 1) < 0.1)).astype(
        np.float32)
    np.testing.assert_array_equal(ttr.resize_image(img, shape),
                                  jtr.resize_image(img, shape))
    np.testing.assert_array_equal(ttr.resize_depth(sparse, shape),
                                  jtr.resize_depth(sparse, shape))
    np.testing.assert_array_equal(ttr.resize_depth_preserve(sparse, shape),
                                  jtr.resize_depth_preserve(sparse, shape))
    if shape == (48, 80):
        # the float -> uint8 quantization moves values even at the same size
        assert not np.array_equal(ttr.resize_image(img, shape), img)


@pytest.mark.parametrize('borders', [(), (4, -6), (20, 0.5), (2, 30, -50, 0),
                                     (0.5, 20, 3, -4)])
def test_crop_borders_and_eval_transforms_match_jax(borders):
    rng = np.random.RandomState(3)
    H, W = 40, 64
    sample = {'rgb': rng.rand(H, W, 3).astype(np.float32),
              'depth': rng.rand(H, W, 1).astype(np.float32),
              'input_depth': (rng.rand(H, W, 1) *
                              (rng.rand(H, W, 1) < 0.2)).astype(np.float32),
              'mask': (rng.rand(H, W, 1) > 0.5).astype(np.float32),
              'intrinsics': np.eye(3, dtype=np.float32) * 50,
              'distortion_coeffs': {'ux': np.float32(30.),
                                    'uy': np.float32(20.)}}
    assert ttr.parse_crop_borders(borders, (H, W)) == \
        jtr.parse_crop_borders(borders, (H, W))
    for name in ('validation', 'test'):
        t = ttr.get_transforms(name, (24, 32), crop_eval_borders=borders)
        j = jtr.get_transforms(name, (24, 32), crop_eval_borders=borders)
        got = t({k: (dict(v) if isinstance(v, dict) else v.copy())
                 for k, v in sample.items()})
        want = j({k: (dict(v) if isinstance(v, dict) else v.copy())
                  for k, v in sample.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            if k == 'distortion_coeffs':
                assert got[k] == want[k]
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    K = np.arange(9, dtype=np.float32).reshape(3, 3)
    np.testing.assert_array_equal(ttr.scale_intrinsics(K, 0.5, 2.0),
                                  jtr._scale_intrinsics_np(K, 0.5, 2.0))
    # the train transform exists, with the advanced augmentations enabled
    assert isinstance(ttr.get_transforms('train'), ttr.TrainTransform)
    t = ttr.get_transforms('train', augmentation={
        'randaugment': {'enabled': True}})
    assert [type(a).__name__ for a in t.advanced] == ['RandAugment']
