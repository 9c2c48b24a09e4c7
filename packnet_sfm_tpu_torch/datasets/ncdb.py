"""
NCDB fisheye dataset (VADAS camera model), read on the host with numpy, with
the JAX package's datasets/ncdb.py semantics (reference:
datasets/ncdb_dataset.py):
- the VADAS A6 calibration and lidar-to-world constants;
- JSON split files of {dataset_root, new_filename} entries, or of
  {image_path} entries taken relative to the root;
- RGB from <root>/<entry>/image_a6/<stem>.png, else .jpg;
- depth from rule-named folders: '{base}[_original]' ->
  'newest[_original]_{base}_maps', 16-bit PNG divided by 256 only when the
  map's max exceeds 255, zeros kept invalid;
- GT depth outside [min_depth, max_depth] set to 0;
- an optional global mask image multiplied into RGB and GT depth, and
  carried as 'mask' when use_mask is set;
- the sample carries 'distortion_coeffs' (k, s, div, ux, uy) and the
  18-value intrinsics vector.

As in the JAX reader, the environment may name the GT depth:
NCDB_DEPTH_FOLDER a folder, over any depth type; NCDB_DEPTH_TYPE a type,
when the config gives none.
"""

import json
import os
from pathlib import Path

import numpy as np
from PIL import Image

from packnet_sfm_tpu_torch.datasets.io import (
    load_image, write_depth, write_image)

DEFAULT_CALIB_A6 = {
    'model': 'vadas',
    'intrinsic': [-0.0004, 1.0136, -0.0623, 0.2852, -0.332, 0.1896, -0.0391,
                  1.0447, 0.0021, 44.9516, 2.48822, 0, 0.9965, -0.0067,
                  -0.0956, 0.1006, -0.054, 0.0106],
    'extrinsic': [0.0900425, -0.00450864, -0.356367, 0.00100918, -0.236104,
                  -0.0219886],
}

DEFAULT_LIDAR_TO_WORLD = np.array([
    [-0.998752, -0.00237052, -0.0498847, 0.0375091],
    [0.00167658, -0.999901, 0.0139481, 0.0349093],
    [-0.0499128, 0.0138471, 0.998658, 0.771878],
    [0., 0., 0., 1.]], np.float32)

SUPPORTED_BASE_TYPES = ['distance', 'depth']
DEFAULT_DEPTH_TYPE = 'depth_original'


def resolve_depth_folder(depth_type):
    """'{base}[_original]' -> 'newest[_original]_{base}_maps'."""
    depth_type = depth_type.lower().strip()
    original = depth_type.endswith('_original')
    base = depth_type.replace('_original', '') if original else depth_type
    if base not in SUPPORTED_BASE_TYPES:
        raise ValueError('Unknown NCDB depth type {!r}'.format(depth_type))
    return 'newest_{}{}_maps'.format('original_' if original else '', base)


def write_ncdb_tree(root, shape, n_frames, splits=None, rows=64, fill=0.2,
                    seed=0):
    """Write an NCDB-layout tree of `n_frames` synthetic frames at `shape`
    (for tests and smoke runs): uniform RGB frames in <root>/seq/image_a6
    and, in the depth_original folder that serves both the GT and the
    LiDAR input, 16-bit depth of 1-14 m on `rows` beam rows from 40% of
    the height down at `fill` azimuth fill; then the split files of
    `splits` ({name: frame indices}; by default split.json, every frame).
    Returns the image folder."""
    rng = np.random.RandomState(seed)
    H, W = shape
    beams = np.linspace(int(H * 0.4), H - 1, rows).astype(int)
    root = Path(root)
    images = root / 'seq' / 'image_a6'
    depths = root / 'seq' / resolve_depth_folder(DEFAULT_DEPTH_TYPE)
    for folder in (images, depths):
        folder.mkdir(parents=True, exist_ok=True)
    entries = []
    for i in range(n_frames):
        stem = 'frame_{:04d}'.format(i)
        write_image(str(images / (stem + '.png')),
                    rng.rand(H, W, 3).astype(np.float32))
        depth = np.zeros((H, W), np.float32)
        depth[beams] = (rng.rand(rows, W) * 13 + 1) * (
            rng.rand(rows, W) < fill)
        write_depth(str(depths / (stem + '.png')), depth)
        entries.append({'dataset_root': 'seq', 'new_filename': stem})
    for name, idx in (splits or {'split.json': range(n_frames)}).items():
        with open(root / name, 'w') as f:
            json.dump([entries[i] for i in idx], f)
    return str(images)


def load_depth_png(path):
    """16-bit PNG depth, divided by 256 when its max exceeds 255 (a map
    whose values all lie at or below 255 is taken as metres), zeros kept
    invalid."""
    with Image.open(path) as img:
        arr16 = np.asarray(img, dtype=np.uint16)
    depth = arr16.astype(np.float32)
    if depth.max() > 255:
        depth /= 256.0
    depth[arr16 == 0] = 0
    return depth


class NcdbDataset:
    def __init__(self, path, split, transform=None, mask_file='',
                 depth_type='', input_depth_type='', use_mask=False,
                 min_depth=None, max_depth=None, **kwargs):
        self.root = Path(path)
        self.transform = transform
        self.use_mask = bool(use_mask)
        self.min_depth, self.max_depth = min_depth, max_depth
        dt = depth_type or os.getenv('NCDB_DEPTH_TYPE', '').strip().lower() \
            or DEFAULT_DEPTH_TYPE
        self.depth_folder = os.getenv('NCDB_DEPTH_FOLDER', '').strip() or \
            resolve_depth_folder(dt)
        self.input_depth_folder = (resolve_depth_folder(input_depth_type)
                                   if input_depth_type else None)
        self.entries = self._load_split(split)
        self.mask = None
        if mask_file:
            mp = self.root / mask_file
            if mp.exists():
                with Image.open(mp) as img:
                    self.mask = (np.asarray(img.convert('L')) > 0
                                 ).astype(np.uint8)

    def _load_split(self, split_file):
        p = Path(split_file)
        if not p.is_absolute():
            p = self.root / split_file
        with open(p) as f:
            mapping = json.load(f)
        if not isinstance(mapping, list):
            raise ValueError('Split file must be a list: {}'.format(p))
        entries = []
        for item in mapping:
            if 'dataset_root' in item and 'new_filename' in item:
                entries.append((item['dataset_root'], item['new_filename']))
            elif 'image_path' in item:
                ip = Path(item['image_path'])
                base = ip.parent
                if base.name == 'image_a6':
                    base = base.parent
                try:
                    rel = str(base.relative_to(self.root))
                except ValueError:
                    rel = str(base)
                entries.append((rel, ip.stem))
            else:
                raise ValueError('Split entry missing keys: {}'.format(item))
        return entries

    def _image_path(self, base, stem):
        p = self.root / base / 'image_a6' / (stem + '.png')
        if not p.exists():
            p = self.root / base / 'image_a6' / (stem + '.jpg')
        return p

    def _depth_path(self, base, stem, folder):
        p = self.root / base / folder / (stem + '.png')
        return p if p.exists() else None

    def set_epoch(self, epoch):
        """Pass the epoch on to a transform keyed by it (TrainTransform)."""
        if hasattr(self.transform, 'set_epoch'):
            self.transform.set_epoch(epoch)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx):
        base, stem = self.entries[idx]
        rgb = load_image(str(self._image_path(base, stem)))
        H, W = rgb.shape[:2]

        dpath = self._depth_path(base, stem, self.depth_folder)
        if dpath is None:
            raise FileNotFoundError('Depth not found for {} (folder {})'
                                    .format(stem, self.depth_folder))
        depth = load_depth_png(dpath)
        if self.min_depth is not None:
            depth[depth < self.min_depth] = 0
        if self.max_depth is not None:
            depth[depth > self.max_depth] = 0

        mask01 = None
        if self.mask is not None:
            m = self.mask
            if m.shape[:2] != (H, W):
                m = np.asarray(Image.fromarray(m * 255).resize(
                    (W, H), Image.NEAREST)) > 0
                m = m.astype(np.uint8)
            # the global mask multiplies RGB and GT (reference :596-608)
            rgb = rgb * m[..., None]
            depth = depth * m
            if self.use_mask:
                mask01 = m

        intr = DEFAULT_CALIB_A6['intrinsic']
        sample = {
            'idx': idx,
            'filename': stem,
            'rgb': rgb.astype(np.float32),
            'intrinsics': np.asarray(intr, np.float32),
            'distortion_coeffs': {
                'k': np.asarray(intr[0:7], np.float32),
                's': np.float32(intr[7]),
                'div': np.float32(intr[8]),
                'ux': np.float32(intr[9]),
                'uy': np.float32(intr[10]),
            },
            'extrinsic': np.asarray(DEFAULT_CALIB_A6['extrinsic'], np.float32),
            'lidar_to_world': DEFAULT_LIDAR_TO_WORLD,
            'depth': depth[..., None],
        }
        if self.input_depth_folder:
            ip = self._depth_path(base, stem, self.input_depth_folder)
            if ip is not None:
                sample['input_depth'] = load_depth_png(ip)[..., None]
        if mask01 is not None:
            sample['mask'] = mask01[..., None].astype(np.float32)
        if self.transform:
            sample = self.transform(sample)
        return sample
