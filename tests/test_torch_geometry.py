"""The PyTorch port's geometry (packnet_sfm_tpu_torch/geometry) against the
JAX package's on the CPU, in float32, on inputs drawn with numpy: euler
rotations, pose vectors, inverses, composition and point transforms,
intrinsics rescaling with the pixel-centre rule, the pinhole camera's Kinv,
reconstruct and project (with the depth clipped at 1e-5 behind the camera),
and view synthesis, single and row-concatenated.

Tolerance: atol 1e-5 x max|value| (float32 products and sums in another
order; sin/cos of another library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.geometry import camera as jcam
from packnet_sfm_tpu.geometry import camera_utils as jcu
from packnet_sfm_tpu.geometry import pose as jpose
from packnet_sfm_tpu_torch.geometry import camera as tcam
from packnet_sfm_tpu_torch.geometry import camera_utils as tcu
from packnet_sfm_tpu_torch.geometry import pose as tpose


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30))


def _vec(seed, B=3):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randn(B, 3) * 0.5, rng.randn(B, 3) * 0.3],
                          axis=1).astype(np.float32)


def _K(B, H, W):
    return jnp.asarray(np.tile(np.array(
        [[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
        np.float32)[None], (B, 1, 1)))


def test_pose_functions_match_jax():
    v = _vec(0)
    close(tpose.euler2mat(t(v[:, 3:])), jpose.euler2mat(v[:, 3:]))
    M = jpose.pose_vec2mat(v)
    close(tpose.pose_vec2mat(t(v)), M)
    close(tpose.invert_pose(t(M)), jpose.invert_pose(M))
    pts = np.random.RandomState(1).randn(3, 4, 5, 3).astype(np.float32)
    close(tpose.transform_points(t(M), t(pts)),
          jpose.transform_points(M, pts))
    close(tpose.transform_points(t(M), t(pts[:, 0])),
          jpose.transform_points(M, pts[:, 0]))
    with pytest.raises(ValueError, match='Rotation mode'):
        tpose.pose_vec2mat(t(v), 'quat')


def test_pose_class_matches_jax():
    a, b = _vec(2), _vec(3)
    ja, jb = jpose.Pose.from_vec(a), jpose.Pose.from_vec(b)
    ta, tb = tpose.Pose.from_vec(t(a)), tpose.Pose.from_vec(t(b))
    close((ta @ tb).mat, (ja @ jb).mat)
    close(ta.inverse().mat, ja.inverse().mat)
    close((ta @ ta.inverse()).mat, np.tile(np.eye(4, dtype=np.float32),
                                           (3, 1, 1)))
    pts = np.random.RandomState(4).randn(3, 2, 6, 3).astype(np.float32)
    close(ta @ t(pts), ja @ pts)
    close(ta.mat[:, :3, 3], ja.translation)
    close(tpose.Pose.identity(2).mat, jpose.Pose.identity(2).mat)
    # differentiable in the pose vector
    vt = t(a).requires_grad_(True)
    (tpose.Pose.from_vec(vt) @ t(pts)).sum().backward()
    assert vt.grad is not None and bool(torch.isfinite(vt.grad).all())


@pytest.mark.parametrize('sx,sy', [(0.5, 0.5), (0.25, 0.5), (1.0, 1.0)])
def test_scale_intrinsics_and_image_grid(sx, sy):
    K = _K(2, 24, 32)
    close(tcam.scale_intrinsics(t(K), sx, sy),
          jcam.scale_intrinsics(K, sx, sy))
    np.testing.assert_array_equal(tcam.image_grid(2, 3, 4).numpy(),
                                  np.asarray(jcam.image_grid(2, 3, 4)))


def test_camera_reconstruct_project_match_jax():
    B, H, W = 2, 12, 16
    rng = np.random.RandomState(5)
    K = _K(B, H, W)
    depth = (rng.rand(B, H, W, 1) * 20 + 0.5).astype(np.float32)
    # a few points behind the camera: projected depth below 1e-5 is clipped
    depth[0, 0, :3] = -1.0
    v = _vec(6, B)
    jc, jr = jcam.Camera.create(K), jcam.Camera(K=K, Tcw=jpose.Pose.from_vec(v))
    tc = tcam.Camera(t(K))
    tr = tcam.Camera(t(K), tpose.Pose.from_vec(t(v)))
    close(tc.Kinv, jc.Kinv)
    for frame in ('c', 'w'):
        close(tc.reconstruct(t(depth), frame), jc.reconstruct(depth, frame))
    X = jc.reconstruct(depth, 'w')
    for frame in ('c', 'w'):
        close(tr.project(t(X), frame), jr.project(X, frame))
    got = tr.project(t(X), 'c').numpy()
    assert np.abs(got[0, 0, :3]).max() > 1e4   # Z clipped, not divided by < 0


def test_view_synthesis_matches_jax():
    """One warp and the row-concatenated warp of three depth maps (the
    upsample_depth_maps path) give the same images as the JAX package."""
    B, H, W = 2, 12, 16
    rng = np.random.RandomState(7)
    K = _K(B, H, W)
    ref = rng.rand(B, H, W, 3).astype(np.float32)
    depths = [(rng.rand(B, H, W, 1) * 10 + 1).astype(np.float32)
              for _ in range(3)]
    v = (_vec(8, B) * 0.2).astype(np.float32)
    jc, jr = jcam.Camera.create(K), jcam.Camera(K=K, Tcw=jpose.Pose.from_vec(v))
    tc = tcam.Camera(t(K))
    tr = tcam.Camera(t(K), tpose.Pose.from_vec(t(v)))
    for mode in ('zeros', 'border'):
        close(tcu.view_synthesis(t(ref), t(depths[0]), tr, tc, mode),
              jax.jit(jcu.view_synthesis, static_argnums=4)(
                  ref, depths[0], jr, jc, mode))
        got = tcu.view_synthesis_multi(t(ref), [t(d) for d in depths], tr,
                                       tc, mode)
        want = jax.jit(jcu.view_synthesis_multi, static_argnums=4)(
            ref, depths, jr, jc, mode)
        assert len(got) == 3
        for g, w in zip(got, want):
            close(g, w)
    one = tcu.view_synthesis_multi(t(ref), [t(depths[0])], tr, tc)
    close(one[0], jcu.view_synthesis(jnp.asarray(ref), depths[0], jr, jc))
