"""
DGP / DDAD scenes (TRI's Dataset Governance Policy layout), read on the host
with numpy, with the JAX package's datasets/dgp.py semantics (reference:
datasets/dgp_dataset.py:58-284, which wraps TRI's `dgp` library; neither
package depends on it):

    <root>/<scene_dir>/scene*.json          {'samples': [{'datums': [...]}]}
    <root>/<scene_dir>/rgb/<CAMERA>/<ts>.png
    <root>/<scene_dir>/point_cloud/<LIDAR>/<ts>.npz   structured 'data'
    <root>/<scene_dir>/calibration/<hash>.json        names, K, extrinsics

- the scenes are those of the split file under the root ({'scenes':
  [dirs]}), when one is given and exists, else every directory of the root
  holding a scene*.json, sorted;
- a sample is a scene sample with `back_context` samples before it and
  `forward_context` after it; it holds, for each of `cameras`, the image,
  the pinhole K of the calibration, the datum's pose (world <- camera, a
  quaternion and a translation) and the calibration's extrinsics, the
  context images and the target -> context motions ('pose_context');
- depth is the LiDAR sweep of the sample projected into each camera
  (`project_lidar_to_depth`), cached under
  <scene>/depth/<kind>/<camera>/NNNNNN.npz, in the JAX package's format: a
  cache written by either package is read by the other;
- the transform runs on each camera's sample; with more than one camera the
  samples are stacked on a leading camera axis (`stack_sample`), which
  loader.to_device_batch folds into the batch axis.

`write_dgp_tree` writes such scenes for tests and smoke runs.
"""

import glob
import json
import os

import numpy as np

from packnet_sfm_tpu_torch.datasets.image_dataset import smooth_texture
from packnet_sfm_tpu_torch.datasets.io import load_image, write_image


def quat_to_rot(q):
    """[qw, qx, qy, qz] -> [3, 3] float64 rotation."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def pose_from_dict(d):
    """A DGP pose {translation: {x, y, z}, rotation: {qw, qx, qy, qz}}
    (missing entries: identity) -> [4, 4] float32."""
    t = d.get('translation', {})
    r = d.get('rotation', {})
    T = np.eye(4)
    T[:3, :3] = quat_to_rot([r.get('qw', 1.0), r.get('qx', 0.0),
                             r.get('qy', 0.0), r.get('qz', 0.0)])
    T[:3, 3] = [t.get('x', 0.0), t.get('y', 0.0), t.get('z', 0.0)]
    return T.astype(np.float32)


def project_lidar_to_depth(points_world, cam_pose, K, H, W):
    """[H, W, 1] float32 sparse depth of world-frame points seen by a camera
    at `cam_pose` (world <- camera): points nearer than 0.1 m dropped, the
    pixel coordinates truncated toward zero (astype(int): a point at
    u = -0.5 lands in column 0), and where points share a pixel the nearest
    wins (written last, after a far-to-near argsort; numpy's fancy-index
    assignment keeps the last write)."""
    Tcw = np.linalg.inv(cam_pose)
    pts = (Tcw[:3, :3] @ points_world.T + Tcw[:3, 3:4]).T
    z = pts[:, 2]
    valid = z > 0.1
    pts = pts[valid]
    z = z[valid]
    u = (K[0, 0] * pts[:, 0] / z + K[0, 2]).astype(int)
    v = (K[1, 1] * pts[:, 1] / z + K[1, 2]).astype(int)
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    depth = np.zeros((H, W), np.float32)
    order = np.argsort(-z[inside])
    uu, vv, zz = u[inside][order], v[inside][order], z[inside][order]
    depth[vv, uu] = zz
    return depth[..., None]


class DGPDataset:
    def __init__(self, path, split='', cameras=('CAMERA_01',), depth_type='',
                 input_depth_type='', back_context=0, forward_context=0,
                 with_pose=True, transform=None, cache_depth_maps=True,
                 **kwargs):
        self.root = path
        self.cameras = list(cameras) if cameras else ['CAMERA_01']
        self.depth_type = depth_type
        self.input_depth_type = input_depth_type
        self.back_context = back_context
        self.forward_context = forward_context
        self.with_pose = with_pose
        self.transform = transform
        self.cache_depth_maps = cache_depth_maps
        if split and os.path.isfile(os.path.join(path, split)):
            with open(os.path.join(path, split)) as f:
                scene_dirs = json.load(f).get('scenes', [])
        else:
            scene_dirs = sorted(
                d for d in os.listdir(path)
                if os.path.isdir(os.path.join(path, d)) and
                glob.glob(os.path.join(path, d, 'scene*.json')))
        self.samples = []   # (scene_dir, sample index)
        self.scenes = {}
        for sd in scene_dirs:
            scene = self._load_scene(os.path.join(path, sd))
            if scene is None:
                continue
            self.scenes[sd] = scene
            n = len(scene['samples'])
            self.samples += [(sd, i) for i in range(
                self.back_context, n - self.forward_context)]

    @staticmethod
    def _load_scene(scene_dir):
        files = sorted(glob.glob(os.path.join(scene_dir, 'scene*.json')))
        if not files:
            return None
        with open(files[0]) as f:
            scene = json.load(f)
        calib = {}
        cal_files = glob.glob(os.path.join(scene_dir, 'calibration',
                                           '*.json'))
        if cal_files:
            with open(cal_files[0]) as f:
                cal = json.load(f)
            for name, k, ext in zip(cal.get('names', []),
                                    cal.get('intrinsics', []),
                                    cal.get('extrinsics', [])):
                K = np.array([[k['fx'], 0, k['cx']],
                              [0, k['fy'], k['cy']],
                              [0, 0, 1]], np.float32)
                calib[name] = {'K': K, 'extrinsics': pose_from_dict(ext)}
        samples = [s.get('datums', s)
                   for s in scene.get('samples', scene.get('data', []))]
        return {'dir': scene_dir, 'samples': samples, 'calibration': calib}

    def set_epoch(self, epoch):
        """Pass the epoch on to a transform keyed by it (TrainTransform)."""
        if hasattr(self.transform, 'set_epoch'):
            self.transform.set_epoch(epoch)

    def __len__(self):
        return len(self.samples)

    @staticmethod
    def _camera_datum(sample, cam):
        for d in sample:
            if d.get('sensor') == cam or d.get('id', {}).get('name') == cam:
                return d
        return None

    def _load_cam_sample(self, scene, sample, cam):
        datum = self._camera_datum(sample, cam)
        if datum is None:
            raise KeyError('camera {} missing in a sample of {}'.format(
                cam, scene['dir']))
        rgb = load_image(os.path.join(scene['dir'], datum['filename']))
        K = scene['calibration'][cam]['K']
        return rgb, K, pose_from_dict(datum.get('pose', {}))

    def _lidar_depth(self, scene, sample, cam_pose, K, H, W, si, cam, kind):
        """The sample's LiDAR sweep projected into camera `cam`, from the
        cache when it holds the map; None without a sweep."""
        cache = os.path.join(scene['dir'], 'depth', kind or 'lidar', cam,
                             '{:06d}.npz'.format(si))
        if self.cache_depth_maps and os.path.exists(cache):
            with np.load(cache) as data:
                return data['depth'].astype(np.float32)[..., None]
        lidar = next((d for d in sample
                      if 'point_cloud' in d.get('filename', '')), None)
        if lidar is None:
            return None
        with np.load(os.path.join(scene['dir'], lidar['filename'])) as data:
            pc = data['data']
        pts = np.stack([pc['X'], pc['Y'], pc['Z']], 1) \
            if pc.dtype.names else pc[:, :3]
        lidar_pose = pose_from_dict(lidar.get('pose', {}))
        world = (lidar_pose[:3, :3] @ pts.T + lidar_pose[:3, 3:4]).T
        depth = project_lidar_to_depth(world, cam_pose, K, H, W)
        if self.cache_depth_maps:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            tmp = '{}.tmp{}.npz'.format(cache[:-4], os.getpid())
            with open(tmp, 'wb') as f:
                np.savez_compressed(f, depth=depth[..., 0])
            os.replace(tmp, cache)
        return depth

    def __getitem__(self, idx):
        sd, si = self.samples[idx]
        scene = self.scenes[sd]
        sample = scene['samples'][si]
        offsets = list(range(-self.back_context, 0)) + \
            list(range(1, self.forward_context + 1))
        per_cam = []
        for cam in self.cameras:
            rgb, K, pose = self._load_cam_sample(scene, sample, cam)
            H, W = rgb.shape[:2]
            out = {'idx': idx, 'sensor_name': cam,
                   'filename': '{}_{}_{}'.format(sd, si, cam),
                   'rgb': rgb, 'intrinsics': K}
            if self.with_pose:
                out['pose'] = pose
                out['extrinsics'] = scene['calibration'].get(cam, {}).get(
                    'extrinsics', np.eye(4, dtype=np.float32))
            for key, kind in (('depth', self.depth_type),
                              ('input_depth', self.input_depth_type)):
                if kind:
                    depth = self._lidar_depth(scene, sample, pose, K, H, W,
                                              si, cam, kind)
                    if depth is not None:
                        out[key] = depth
            ctx = [self._load_cam_sample(scene, scene['samples'][si + off],
                                         cam) for off in offsets]
            if ctx:
                out['rgb_context'] = [c[0] for c in ctx]
                if self.with_pose:
                    inv_pose = np.linalg.inv(out['pose'])
                    out['pose_context'] = [(inv_pose @ c[2]).astype(
                        np.float32) for c in ctx]
            if self.transform:
                out = self.transform(out)
            per_cam.append(out)
        if len(per_cam) == 1:
            return per_cam[0]
        return stack_sample(per_cam)


def stack_sample(samples):
    """One sample from per-camera samples: arrays stacked on a leading
    camera axis, lists of arrays item by item, anything else (idx, names)
    the first camera's (reference: models/model_utils.py:68-94
    stack_batch)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], list):
            out[key] = [np.stack([v[i] for v in vals])
                        for i in range(len(vals[0]))]
        else:
            out[key] = vals[0]
    return out


# ------------------------------------------------------------------ writer

LIDAR = 'LIDAR'
FOCAL = 1.127          # fx = fy = FOCAL * W (DDAD's front camera: ~2181 px)
CAMERA_YAW = 60.0      # degrees between neighbouring cameras of the rig
SPEED = 1.0            # m the car moves a sample, along its heading


def _pose_dict(yaw, t):
    """A DGP pose: rotation `yaw` rad about the camera's y (down) axis,
    translation t."""
    return {'translation': dict(zip('xyz', map(float, t))),
            'rotation': {'qw': float(np.cos(yaw / 2)), 'qx': 0.0,
                         'qy': float(np.sin(yaw / 2)), 'qz': 0.0}}


def _world_points(rng, n, center):
    """n points around `center` (x, z in m; y down): two thirds on the
    ground 1.5 m below the sensors, the rest on walls 15-40 m away."""
    n_ground = 2 * n // 3
    r = np.sqrt(rng.uniform(3.0 ** 2, 60.0 ** 2, n))
    a = rng.uniform(-np.pi, np.pi, n)
    r[n_ground:] = rng.uniform(15.0, 40.0, n - n_ground)
    y = np.full(n, 1.5)
    y[n_ground:] = rng.uniform(-5.0, 1.5, n - n_ground)
    return np.stack([center[0] + r * np.sin(a), y,
                     center[1] + r * np.cos(a)], 1)


def write_dgp_tree(root, scenes, samples, cameras, H, W, n_points, seed=0):
    """Write `scenes` DGP scenes of `samples` samples each under `root` (for
    tests and smoke runs): per scene 'scene_<k>.json', a calibration file
    (K with fx = fy = FOCAL * W at the image centre; camera c yawed c x
    CAMERA_YAW degrees and 0.3 c m to the right of the rig's origin), for
    each camera and sample an H x W PNG (a smooth texture per camera, of
    cells of max(8, W // 80) px moving max(4, W // 64) px a sample: ~10 px
    at a 640-wide training size, a motion the first steps can learn where
    the unwarped context does not already match), and one LiDAR sweep a
    sample of `n_points`
    points around the car (the ground and walls; `_world_points`) in the
    sensor's frame, a structured X, Y, Z, INTENSITY float32 array under
    'data' of point_cloud/LIDAR/NNNNNN.npz. The car drives SPEED m a sample
    along z, turning 0.01 rad a sample; the datum poses are world <- sensor.
    All from numpy seed `seed`. Returns `root`."""
    rng = np.random.RandomState(seed)
    cell, shift = max(8, W // 80), max(4, W // 64)
    dtype = np.dtype([(c, '<f4') for c in ('X', 'Y', 'Z', 'INTENSITY')])
    ext = [(np.deg2rad(CAMERA_YAW) * c, np.array([0.3 * c, 0.0, 0.0]))
           for c in range(len(cameras))]
    for s in range(scenes):
        scene_dir = os.path.join(root, 'scene_{:03d}'.format(s))
        for sub in ['rgb/' + cam for cam in cameras] + \
                ['point_cloud/' + LIDAR, 'calibration']:
            os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
        textures = [smooth_texture(rng, H, W + shift * samples, cell)
                    for _ in cameras]
        entries = []
        for i in range(samples):
            heading = 0.01 * i
            R = np.array([[np.cos(heading), 0, np.sin(heading)], [0, 1, 0],
                          [-np.sin(heading), 0, np.cos(heading)]])
            car = np.array([0.0, 0.0, SPEED * i])
            datums = []
            for c, cam in enumerate(cameras):
                fn = 'rgb/{}/{:06d}.png'.format(cam, i)
                write_image(os.path.join(scene_dir, fn),
                            textures[c][:, shift * i:shift * i + W])
                yaw, t = ext[c]
                datums.append({'sensor': cam, 'filename': fn,
                               'pose': _pose_dict(heading + yaw,
                                                  car + R @ t)})
            world = _world_points(rng, n_points, car[[0, 2]])
            pts = np.zeros(n_points, dtype)
            pts['X'], pts['Y'], pts['Z'] = ((world - car) @ R).T
            pts['INTENSITY'] = rng.rand(n_points)
            fn = 'point_cloud/{}/{:06d}.npz'.format(LIDAR, i)
            np.savez(os.path.join(scene_dir, fn), data=pts)
            datums.append({'sensor': LIDAR, 'filename': fn,
                           'pose': _pose_dict(heading, car)})
            entries.append({'datums': datums})
        with open(os.path.join(scene_dir, 'scene_{:03d}.json'.format(s)),
                  'w') as f:
            json.dump({'samples': entries}, f)
        with open(os.path.join(scene_dir, 'calibration', 'rig.json'),
                  'w') as f:
            json.dump({'names': list(cameras),
                       'intrinsics': [{'fx': FOCAL * W, 'fy': FOCAL * W,
                                       'cx': W / 2, 'cy': H / 2}] *
                       len(cameras),
                       'extrinsics': [_pose_dict(yaw, t) for yaw, t in ext]},
                      f)
    return root
