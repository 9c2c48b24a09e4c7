"""
KITTI_raw dataset, read on the host with numpy, with the JAX package's
datasets/kitti.py semantics (reference: datasets/kitti_dataset_optimized.py
and kitti_dataset_utils.py):
- split files list image paths relative to the root (first column taken);
- intrinsics = P_rect_0X[:3, :3] of the drive date's calib_cam_to_cam.txt;
- depth: 'groundtruth' -> proj_depth/groundtruth/image_0X 16-bit PNG / 256;
  any other type -> proj_depth/<type>/image_0X .npz under the key
  '<type>_depth' (not io.py's 'depth');
- context frames by filename index +- stride; a sample whose context or
  depth file is missing is dropped;
- with `with_pose`, the pose of a frame from its OXTS packet by Mercator
  projection, chained imu2cam @ origin^-1 @ pose @ imu2cam^-1 in float64
  and cast to float32 at the end; context poses as target -> context
  transforms (what the velocity loss reads);
- the validated path list of a split is cached on disk, keyed by the split
  file, its mtime and the options (KITTI_CACHE_DIR; '' turns it off). The
  JAX reader's key leaves out the stride; this one keeps it.

`write_kitti_tree` writes a KITTI_raw-layout drive for tests and smoke runs.
"""

import hashlib
import json
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from packnet_sfm_tpu_torch.datasets.io import (
    load_depth, load_image, write_image)

IMAGE_FOLDER = {'left': 'image_02', 'right': 'image_03'}
CALIB_FILE = {'cam2cam': 'calib_cam_to_cam.txt',
              'velo2cam': 'calib_velo_to_cam.txt',
              'imu2velo': 'calib_imu_to_velo.txt'}
PNG_DEPTH_DATASETS = ['groundtruth']
OXTS_POSE_DATA = 'oxts'
DEFAULT_CACHE_DIR = 'packnet_sfm_tpu_torch_kitti_cache'


def read_calib_file(path):
    """{key: float64 array} of a KITTI calibration text file; lines without
    a ':' or with non-numeric values are skipped."""
    data = {}
    with open(path) as f:
        for line in f:
            if ':' not in line:
                continue
            key, value = line.split(':', 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def transform_from_rot_trans(R, t):
    return np.vstack((np.hstack([R.reshape(3, 3), t.reshape(3, 1)]),
                      [0, 0, 0, 1]))


def rotx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def pose_from_oxts_packet(raw, scale):
    """(R, t) of an OXTS packet by Mercator projection, float64."""
    lat, lon, alt, roll, pitch, yaw = raw[:6]
    er = 6378137.0
    tx = scale * lon * np.pi * er / 180.0
    ty = scale * er * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    t = np.array([tx, ty, alt])
    R = rotz(yaw) @ roty(pitch) @ rotx(roll)
    return R, t


def _camera_folder(image_file):
    for cam in ('left', 'right'):
        if IMAGE_FOLDER[cam] in image_file:
            return IMAGE_FOLDER[cam]
    raise ValueError('Invalid KITTI path: ' + image_file)


class KITTIDataset:
    def __init__(self, path, split, depth_type='', input_depth_type='',
                 back_context=0, forward_context=0, strides=(1,),
                 with_pose=False, transform=None, **kwargs):
        self.root = path
        self.split = split
        self.depth_type = depth_type
        self.input_depth_type = input_depth_type
        self.back_context = back_context
        self.forward_context = forward_context
        self.stride = strides[0] if strides else 1
        self.with_pose = with_pose
        self.transform = transform
        self._calib_cache = {}
        self._oxts_cache = {}
        split_file = os.path.join(path, split) if split else ''
        if not os.path.isfile(split_file):
            raise FileNotFoundError('KITTI split file not found: {}'.format(
                split_file))
        self.paths = self._load_paths_cached(split_file)

    def _load_paths_cached(self, split_file):
        """The split's valid image paths, from the cache when it holds
        them (KITTI_CACHE_DIR, default <tempdir>/packnet_sfm_tpu_torch_
        kitti_cache; '' turns it off). The eigen splits cost ~200k stat
        calls without it."""
        cache_dir = os.environ.get('KITTI_CACHE_DIR', os.path.join(
            tempfile.gettempdir(), DEFAULT_CACHE_DIR))
        key = None
        if cache_dir:
            sig = '{}:{}:{}:{}:{}:{}:{}'.format(
                os.path.abspath(split_file), os.path.getmtime(split_file),
                self.depth_type, self.input_depth_type, self.back_context,
                self.forward_context, self.stride)
            key = os.path.join(cache_dir, hashlib.sha1(
                sig.encode()).hexdigest() + '.json')
            if os.path.isfile(key):
                with open(key) as f:
                    return json.load(f)
        with open(split_file) as f:
            lines = [line.strip().split()[0] for line in f if line.strip()]
        paths = [os.path.join(self.root, line) for line in lines]
        # stat-bound: threads release the GIL
        with ThreadPoolExecutor(16) as pool:
            ok = list(pool.map(
                lambda p: os.path.isfile(p) and self._valid(p), paths))
        paths = [p for p, o in zip(paths, ok) if o]
        if key:
            os.makedirs(cache_dir, exist_ok=True)
            # written whole, then renamed: a reader never sees half a file
            fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix='.tmp')
            with os.fdopen(fd, 'w') as f:
                json.dump(paths, f)
            os.replace(tmp, key)
        return paths

    # ------------------------------------------------------------ file maps
    @staticmethod
    def _get_depth_file(image_file, depth_type):
        folder = _camera_folder(image_file)
        if depth_type in PNG_DEPTH_DATASETS:
            return image_file.replace(
                '{}/data'.format(folder),
                'proj_depth/groundtruth/{}'.format(folder))
        return image_file.replace(
            '{}/data'.format(folder),
            'proj_depth/{}/{}'.format(depth_type, folder)).replace(
                '.png', '.npz')

    @staticmethod
    def _neighbor_file(image_file, offset):
        base, ext = os.path.splitext(os.path.basename(image_file))
        return os.path.join(os.path.dirname(image_file),
                            str(int(base) + offset).zfill(len(base)) + ext)

    def _context_files(self, image_file):
        offs = [-(i + 1) * self.stride
                for i in range(self.back_context)][::-1] + \
            [(i + 1) * self.stride for i in range(self.forward_context)]
        return [self._neighbor_file(image_file, o) for o in offs]

    def _valid(self, image_file):
        if not all(os.path.isfile(f) for f in self._context_files(image_file)):
            return False
        return all(os.path.isfile(self._get_depth_file(image_file, dt))
                   for dt in (self.depth_type, self.input_depth_type) if dt)

    # ----------------------------------------------------------- intrinsics
    @staticmethod
    def _parent_folder(image_file):
        """The drive date's folder, which holds the calib txts."""
        return os.path.abspath(os.path.join(os.path.dirname(image_file),
                                            '..', '..', '..'))

    def _calib(self, image_file):
        folder = self._parent_folder(image_file)
        if folder not in self._calib_cache:
            self._calib_cache[folder] = read_calib_file(
                os.path.join(folder, CALIB_FILE['cam2cam']))
        return self._calib_cache[folder]

    def _intrinsics(self, image_file):
        key = 'P_rect_{}'.format(_camera_folder(image_file)[-2:])
        return self._calib(image_file)[key].reshape(3, 4)[:3, :3].astype(
            np.float32)

    # ----------------------------------------------------------------- pose
    def _oxts(self, image_file):
        folder = _camera_folder(image_file)
        f = image_file.replace('{}/data'.format(folder),
                               OXTS_POSE_DATA + '/data').replace(
                                   '.png', '.txt')
        if f not in self._oxts_cache:
            self._oxts_cache[f] = np.loadtxt(f, delimiter=' ')
        return self._oxts_cache[f]

    def _imu2cam(self, image_file):
        folder = self._parent_folder(image_file)
        cam2cam = read_calib_file(os.path.join(folder, CALIB_FILE['cam2cam']))
        imu2velo = read_calib_file(os.path.join(folder,
                                                CALIB_FILE['imu2velo']))
        velo2cam = read_calib_file(os.path.join(folder,
                                                CALIB_FILE['velo2cam']))
        velo2cam_mat = transform_from_rot_trans(velo2cam['R'], velo2cam['T'])
        imu2velo_mat = transform_from_rot_trans(imu2velo['R'], imu2velo['T'])
        cam_2rect = transform_from_rot_trans(cam2cam['R_rect_00'],
                                             np.zeros(3))
        return cam_2rect @ velo2cam_mat @ imu2velo_mat

    def _pose(self, image_file):
        """The frame's pose in the drive's first frame, chained in float64
        and cast to float32 at the end."""
        base, ext = os.path.splitext(os.path.basename(image_file))
        origin_frame = os.path.join(os.path.dirname(image_file),
                                    '0'.zfill(len(base)) + ext)
        origin_oxts = self._oxts(origin_frame)
        scale = np.cos(origin_oxts[0] * np.pi / 180.0)
        oR, ot = pose_from_oxts_packet(origin_oxts, scale)
        origin_pose = transform_from_rot_trans(oR, ot)
        R, t = pose_from_oxts_packet(self._oxts(image_file), scale)
        pose = transform_from_rot_trans(R, t)
        imu2cam = self._imu2cam(image_file)
        return (imu2cam @ np.linalg.inv(origin_pose) @ pose @
                np.linalg.inv(imu2cam)).astype(np.float32)

    @staticmethod
    def _read_depth(path, depth_type):
        """[H,W,1] float32: a .npz under '<depth_type>_depth', a PNG / 256."""
        if path.endswith('.npz'):
            with np.load(path) as data:
                return data[depth_type + '_depth'].astype(
                    np.float32)[..., None]
        return load_depth(path)[..., None]

    # -------------------------------------------------------------- getitem
    def set_epoch(self, epoch):
        """Pass the epoch on to a transform keyed by it (TrainTransform)."""
        if hasattr(self.transform, 'set_epoch'):
            self.transform.set_epoch(epoch)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        image_file = self.paths[idx]
        sample = {
            'idx': idx,
            'filename': '{}_{:010d}'.format(
                os.path.splitext(os.path.basename(self.split))[0], idx),
            'rgb': load_image(image_file),
            'intrinsics': self._intrinsics(image_file),
        }
        if self.depth_type:
            sample['depth'] = self._read_depth(
                self._get_depth_file(image_file, self.depth_type),
                self.depth_type)
        if self.input_depth_type:
            sample['input_depth'] = self._read_depth(
                self._get_depth_file(image_file, self.input_depth_type),
                self.input_depth_type)
        ctx_files = self._context_files(image_file)
        if ctx_files:
            sample['rgb_context'] = [load_image(f) for f in ctx_files]
            if self.with_pose:
                pose_t = self._pose(image_file)
                sample['pose_context'] = [
                    (np.linalg.inv(pose_t) @ self._pose(f)).astype(np.float32)
                    for f in ctx_files]
        if self.with_pose:
            sample['pose'] = self._pose(image_file)
        if self.transform:
            sample = self.transform(sample)
        return sample


# ------------------------------------------------------------------ writer

DATE, DRIVE = '2011_09_26', '2011_09_26_drive_0001_sync'
HORIZON = 0.35                     # of the height: no depth above it
GT_FILL, LIDAR_FILL = 0.15, 0.05   # depth pixels below the horizon
SHIFT = 4                          # px the texture moves a frame
# KITTI-like rig: a 721.5 px focal length, the principal point near the
# image centre, small rotations between the IMU, the LiDAR and the camera
_R_RECT = [0.9999239, 0.00983776, -0.007445048, -0.009869795, 0.9999421,
           -0.004278459, 0.007402527, 0.004351614, 0.9999631]
_VELO2CAM = ([0.007533745, -0.9999714, -0.000616602, 0.01480249,
              0.0007280733, -0.9998902, 0.9998621, 0.00752379, 0.01480755],
             [-0.004069766, -0.07631618, -0.2717806])
_IMU2VELO = ([0.9999976, 0.0007553071, -0.002035826, -0.0007854027,
              0.9998898, -0.01482298, 0.002024406, 0.01482454, 0.9998881],
             [-0.8086759, 0.3195559, -0.7997231])


def _write_calib(path, entries):
    with open(path, 'w') as f:
        for key, values in entries:
            f.write('{}: {}\n'.format(key, ' '.join(
                '{:.9e}'.format(v) for v in np.ravel(values))))


def write_kitti_tree(root, shape, n_frames, splits=None, depth_margin=0):
    """Write one KITTI_raw drive of `n_frames` frames at `shape` (for tests
    and smoke runs) under `root`: the date folder's calibration txts
    (P_rect_02 / 03 with fx = fy = 721.5 and the principal point near the
    centre, R_rect_00, velo_to_cam, imu_to_velo), one OXTS packet a frame
    (the car driving ~1 m a frame along its heading, turning slowly),
    image_02 and image_03 PNGs (a smooth texture moving SHIFT px a frame,
    so that neighbouring frames match), and below the HORIZON the depth of
    a ground plane: 16-bit PNGs at GT_FILL under proj_depth/groundtruth
    and .npz maps at LIDAR_FILL under proj_depth/velodyne (key
    'velodyne_depth'), all drawn from a fixed seed. Frames within
    `depth_margin` of either end get no depth files, as KITTI's annotated
    depth leaves out each drive's first and last 5. Then the split files
    of `splits` ({name: frame indices}; by default 'split.txt', every
    frame), two columns (left, right image) as the eigen split files.
    Returns the left image folder."""
    rng = np.random.RandomState(0)
    H, W = shape
    date = os.path.join(root, DATE)
    drive = os.path.join(date, DRIVE)
    folders = {k: os.path.join(drive, *k.split('/')) for k in (
        'image_02/data', 'image_03/data', 'oxts/data',
        'proj_depth/groundtruth/image_02', 'proj_depth/velodyne/image_02')}
    for folder in folders.values():
        os.makedirs(folder, exist_ok=True)
    fx, cx, cy = 721.5377, W / 2 - 11.9, H / 2 - 14.6

    def P(tx):
        return [[fx, 0, cx, tx], [0, fx, cy, 0.2163791],
                [0, 0, 1, 0.002745884]]

    _write_calib(os.path.join(date, CALIB_FILE['cam2cam']), [
        ('P_rect_02', P(44.85728)), ('P_rect_03', P(-339.5242)),
        ('R_rect_00', _R_RECT)])
    _write_calib(os.path.join(date, CALIB_FILE['velo2cam']),
                 [('R', _VELO2CAM[0]), ('T', _VELO2CAM[1])])
    _write_calib(os.path.join(date, CALIB_FILE['imu2velo']),
                 [('R', _IMU2VELO[0]), ('T', _IMU2VELO[1])])
    # one smooth texture wide enough for every frame's window
    cell = 8
    wide = W + SHIFT * n_frames
    low = rng.rand(H // cell + 2, wide // cell + 2, 3).astype(np.float32)
    tex = np.asarray(Image.fromarray((low * 255).astype(np.uint8)).resize(
        (wide + 2 * cell, H + 2 * cell), Image.BILINEAR),
        np.float32)[cell:cell + H, cell:] / 255.0
    rows = np.arange(H, dtype=np.float32)[:, None]
    v0 = int(H * HORIZON)
    ground = np.where(rows > v0, 1.65 * fx / np.maximum(rows - v0, 1e-3),
                      0.0).clip(0, 80) * np.ones((1, W), np.float32)
    names = []
    for i in range(n_frames):
        name = '{:010d}'.format(i)
        names.append(name)
        img = tex[:, SHIFT * i:SHIFT * i + W]
        write_image(os.path.join(folders['image_02/data'], name + '.png'),
                    img)
        write_image(os.path.join(folders['image_03/data'], name + '.png'),
                    img[:, ::-1])
        # heading 0.5 rad from east: ~1 m a frame along it
        oxts = [49.011 + 4.3e-6 * i, 8.4167 + 1.2e-5 * i, 112.8, 0.01,
                0.02, 0.5 + 0.002 * i] + [0.0] * 24
        np.savetxt(os.path.join(folders['oxts/data'], name + '.txt'),
                   np.asarray(oxts)[None], delimiter=' ')
        if depth_margin <= i < n_frames - depth_margin:
            live = (ground >= 1.0)
            gt = ground * live * (rng.rand(H, W) < GT_FILL)
            Image.fromarray(np.clip(gt * 256, 0, 65535).astype(np.uint16)
                            ).save(os.path.join(
                                folders['proj_depth/groundtruth/image_02'],
                                name + '.png'))
            lidar = ground * live * (rng.rand(H, W) < LIDAR_FILL)
            np.savez_compressed(
                os.path.join(folders['proj_depth/velodyne/image_02'],
                             name + '.npz'),
                velodyne_depth=lidar.astype(np.float32))
    rel = '{}/{}/{}/data/{}.png'
    for name, idx in (splits or {'split.txt': range(n_frames)}).items():
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'w') as f:
            f.write(''.join('{} {}\n'.format(
                rel.format(DATE, DRIVE, 'image_02', names[i]),
                rel.format(DATE, DRIVE, 'image_03', names[i])) for i in idx))
    return folders['image_02/data']
