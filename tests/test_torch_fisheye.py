"""The port's VADAS fisheye camera and the photometric loss through it,
against the JAX package's, on the CPU in float32 on the NCDB A6
calibration (the port's datasets/ncdb.py DEFAULT_CALIB_A6, as the NCDB
reader hands it to a batch):

- FisheyeCamera reconstruct (camera and world frames), project (through a
  pose, normalised by `image_size`) and `scaled_to` a pyramid level:
  rtol 1e-5, atol 1e-5. On the A6 calibration the reconstruction's
  theta ~= r_d runs to thousands of radians, where tan is ill-conditioned:
  there a one-ulp difference in r_d between the two libraries' float32
  arithmetic moves tan by cond x eps, so each point is held to rtol 1e-5 +
  2 cond(r_d) eps, cond the relative condition number of tan at r_d (both
  libraries' tan is within 6e-8 of float64's on these r_d). The A6
  calibration sends most rays far outside [-1, 1], as it does in JAX;
- project's gradient on the principal-point ray (the +1e-18 under the
  sqrt keeps it finite) and around it: atol 1e-5 x max|ref|;
- the multi-view photometric loss with `distortion` instead of K, over
  the per-scale warps (2 scales: each its own camera): loss rtol 1e-5,
  gradients (sigmoids, pose vectors) per leaf |g - g_jax| <= 2e-2 |g_jax|
  in the Frobenius norm;
- SelfSupModel hands a batch's 'distortion_coeffs' to the loss in place of
  K, so such a batch reaches the fisheye camera.
"""

import jax
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.geometry.camera import FisheyeCamera as JFisheye
from packnet_sfm_tpu.geometry.pose import Pose as JPose
from packnet_sfm_tpu.losses.photometric import MultiViewPhotometricLoss as JL
from packnet_sfm_tpu_torch.datasets.ncdb import DEFAULT_CALIB_A6
from packnet_sfm_tpu_torch.geometry import camera as tcamera
from packnet_sfm_tpu_torch.geometry.camera import FisheyeCamera as TFisheye
from packnet_sfm_tpu_torch.geometry.pose import Pose as TPose
from packnet_sfm_tpu_torch.losses.photometric import (
    MultiViewPhotometricLoss as TL)
from packnet_sfm_tpu_torch.models.sfm import SelfSupModel
from tests.torch_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

B, H, W = 2, 24, 40


def t(x):
    return torch.from_numpy(np.array(x))


def calib(batch=B):
    """The A6 calibration as a collated batch carries it."""
    intr = np.float32(DEFAULT_CALIB_A6['intrinsic'])
    return {'k': np.tile(intr[None, 0:7], (batch, 1)),
            's': np.full(batch, intr[7]), 'div': np.full(batch, intr[8]),
            'ux': np.full(batch, intr[9]), 'uy': np.full(batch, intr[10])}


def tcalib(c):
    return {k: t(v) for k, v in c.items()}


def pose_vec(seed):
    return (np.random.RandomState(seed).randn(B, 6) * 0.05).astype(
        np.float32)


def close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30))


def reconstruct_rtol(cam, h, w):
    """[B,h,w,1] rtol of a reconstruction: 1e-5 + 2 cond(tan, r_d) eps,
    r_d in float64 from the camera's float32 calibration."""
    u = np.arange(w, dtype=np.float64)[None, None, :]
    v = np.arange(h, dtype=np.float64)[None, :, None]
    ux, uy, s, div = (np.asarray(getattr(cam, k), np.float64)[:, None, None]
                      for k in ('ux', 'uy', 's', 'div'))
    rd = np.hypot((u - ux) / s, (v - uy) / div)
    tn = np.tan(rd)
    cond = rd * (1 + tn ** 2) / np.maximum(np.abs(tn), 1e-300)
    return (1e-5 + 2 * cond * np.finfo(np.float32).eps)[..., None]


def test_fisheye_camera_matches_jax():
    rng = np.random.RandomState(0)
    depth = rng.uniform(1, 20, (B, H, W, 1)).astype(np.float32)
    vec = pose_vec(1)
    c = calib()
    X = rng.uniform(-5, 5, (B, H, W, 3)).astype(np.float32)
    X[..., 2] = np.abs(X[..., 2]) + 0.5
    DH, DW = H // 2, W // 2

    @jax.jit
    def jax_side(c, vec, depth, X):
        cam = JFisheye.create(c, Tcw=JPose.from_vec(vec), image_size=(H, W))
        lvl = cam.scaled_to(DH, DW, H, W)
        return (cam.reconstruct(depth, 'c'), cam.reconstruct(depth, 'w'),
                cam.project(X), lvl.ux, lvl.uy, lvl.project(X),
                lvl.reconstruct(depth[:, :DH, :DW], 'w'))

    jc, jw, jp, jux, juy, jlp, jlw = jax_side(c, vec, depth, X)
    jcam = JFisheye.create(c, image_size=(H, W))
    tcam = TFisheye.create(tcalib(c), Tcw=TPose.from_vec(t(vec)),
                           image_size=(H, W))
    rtol = reconstruct_rtol(jcam, H, W)
    for frame, want in (('c', jc), ('w', jw)):
        want = np.asarray(want)
        got = tcam.reconstruct(t(depth), frame).numpy()
        # the world frame mixes the three axes: the largest of each point
        scale = np.abs(want).max(-1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-5 + rtol * scale), frame
    want = np.asarray(jp)
    got = tcam.project(t(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the A6 grids leave the image
    assert (np.abs(got) > 1).any(-1).mean() > 0.5
    tlvl = tcam.scaled_to(DH, DW, H, W)
    assert tlvl.image_size == (DH, DW)
    np.testing.assert_allclose(tlvl.ux.numpy(), np.asarray(jux), rtol=1e-6)
    np.testing.assert_allclose(tlvl.uy.numpy(), np.asarray(juy), rtol=1e-6)
    np.testing.assert_allclose(tlvl.project(t(X)).numpy(), np.asarray(jlp),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jlw)
    got = tlvl.reconstruct(t(depth[:, :DH, :DW]), 'w').numpy()
    assert np.all(np.abs(got - want) <= 1e-5 + reconstruct_rtol(
        jcam.scaled_to(DH, DW, H, W), DH, DW) *
        np.abs(want).max(-1, keepdims=True))


def test_project_gradient_on_the_principal_ray():
    """Points on the optical axis (x = y = 0) and near it: the gradient of
    a projection is finite and equal to JAX's."""
    c = calib(1)
    X = np.zeros((1, 2, 3, 3), np.float32)
    X[..., 2] = 5.0
    X[0, 1, :, 0] = [1e-6, -3e-4, 0.2]
    X[0, 1, :, 1] = [0.0, 2e-4, -0.1]
    w = np.random.RandomState(2).randn(1, 2, 3, 2).astype(np.float32)
    jcam = JFisheye.create(c, image_size=(H, W))
    want = jax.jit(jax.grad(lambda x: (jcam.project(x, 'c') * w).sum()))(X)
    tx = t(X).requires_grad_(True)
    (TFisheye.create(tcalib(c), image_size=(H, W)).project(tx, 'c') *
     t(w)).sum().backward()
    assert bool(torch.isfinite(tx.grad).all())
    close(tx.grad, want, 1e-5)


def _loss_inputs(seed, per_scale):
    rng = np.random.RandomState(seed)
    h, w = (16, 24) if per_scale else (H, W)
    image = rng.rand(B, h, w, 3).astype(np.float32)
    ctx = [np.clip(image + rng.randn(B, h, w, 3) * 0.1, 0, 1).astype(
        np.float32) for _ in range(2)]
    shapes = [(h >> i, w >> i) if per_scale else (h, w) for i in range(4)]
    sig = [rng.uniform(0.05, 0.6, (B, a, b, 1)).astype(np.float32)
           for a, b in shapes]
    vec = (rng.randn(B, 2, 6) * 0.05).astype(np.float32)
    return image, ctx, sig, vec


def test_photometric_loss_with_distortion_matches_jax():
    image, ctx, sig, vec = _loss_inputs(3, True)
    sig = sig[:2]
    c = calib()
    kw = dict(num_scales=2, automask_loss=True, smooth_loss_weight=1e-3,
              min_depth=0.05, max_depth=80.0)

    def jf(s, v, image, ctx, c):
        poses = [JPose.from_vec(v[:, i]) for i in range(2)]
        out = JL(**kw)(image, ctx, s, poses, distortion=c)
        return out['loss'], out['metrics']

    (want, want_m), (want_ds, want_dv) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(sig, vec, image, ctx, c)
    ts = [t(s).requires_grad_(True) for s in sig]
    tv = t(vec).requires_grad_(True)
    out = TL(**kw)(t(image), [t(x) for x in ctx], ts,
                   [TPose.from_vec(tv[:, i]) for i in range(2)],
                   distortion=tcalib(c))
    out['loss'].backward()
    np.testing.assert_allclose(float(out['loss'].detach()), float(want),
                               rtol=1e-5)
    for k in want_m:
        np.testing.assert_allclose(float(out['metrics'][k].detach()),
                                   float(want_m[k]), rtol=1e-5, err_msg=k)
    for a, b in zip(ts + [tv], list(want_ds) + [want_dv]):
        g, w = a.grad.numpy(), np.asarray(b)
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) + 1e-8


def test_selfsup_model_hands_distortion_to_the_loss(monkeypatch):
    """A batch with 'distortion_coeffs' takes the fisheye camera, and the
    loss gets no K; without it, the pinhole camera from K."""
    seen = []

    class Recording(TL):
        def __call__(self, *args, K=None, distortion=None, **kw):
            seen.append((K is None, distortion is None))
            return super().__call__(*args, K=K, distortion=distortion, **kw)

    created = []
    real = tcamera.FisheyeCamera.create.__func__
    monkeypatch.setattr(tcamera.FisheyeCamera, 'create', classmethod(
        lambda cls, *a, **k: created.append(1) or real(cls, *a, **k)))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.p = torch.nn.Parameter(torch.zeros(()))

        def forward(self, rgb, input_depth=None):
            return {'inv_depths': [torch.sigmoid(rgb[..., :1] + self.p)]}

    class Pose6(torch.nn.Module):
        def forward(self, image, context):
            return torch.zeros(image.shape[0], len(context), 6)

    image, ctx, _, _ = _loss_inputs(4, False)
    K = torch.eye(3)[None].repeat(B, 1, 1)
    model = SelfSupModel(Net(), Recording(num_scales=1),
                         pose_net=Pose6()).train()
    batch = {'rgb': t(image), 'rgb_context': [t(x) for x in ctx],
             'intrinsics': K, 'distortion_coeffs': tcalib(calib())}
    assert bool(torch.isfinite(model(batch)['loss']))
    # a target and a reference camera for each of the 2 contexts
    assert seen == [(True, False)] and len(created) == 4
    del batch['distortion_coeffs']
    model(batch)
    assert seen[-1] == (False, True) and len(created) == 4
