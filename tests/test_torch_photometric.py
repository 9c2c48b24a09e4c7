"""The PyTorch port's photometric map (packnet_sfm_tpu_torch/ops/kernels/
photometric.py: the plain forward and backward the wrappers run on CPU
tensors, through its autograd Function) against the JAX package's Pallas
kernels in interpret mode (ops/pallas/photometric.py, which runs
interpreted off the TPU) and their jax.grad; and the non-kernel
composition (ops/ssim.py, ops/image.py pools and pads, ops/depth.py
smoothness) against the JAX package's.

Cases: random images over more than one 48-row TPU tile with a ragged
tail, identical images (SSIM on the clamp), and bf16 inputs on the non-kernel
path. A channel count other than 3 raises. The backward kernel's sweep
(its lanes, strips and row segments, emulated in numpy float32) is held
bit-equal to the plain backward.

Tolerance: values rtol 1e-5 / atol 1e-6 and gradients rtol 1e-4 / atol
1e-5 in float32, as tests/test_pallas_photometric.py holds the Pallas
kernel to XLA; bf16 inputs (float32 moment islands on both sides): values
atol 1e-5 x max|value|, gradients, which cross the casts in bf16, within
one bf16 rounding (atol 1e-2 x max|value|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.ops import depth as jdepth
from packnet_sfm_tpu.ops import image as jimage
from packnet_sfm_tpu.ops import ssim as jssim
from packnet_sfm_tpu.ops.pallas.photometric import photometric_map_pallas
from packnet_sfm_tpu_torch.ops import depth as tdepth
from packnet_sfm_tpu_torch.ops import image as timage
from packnet_sfm_tpu_torch.ops import ssim as tssim
from packnet_sfm_tpu_torch.ops.kernels import photometric as tphoto


def t(x):
    return torch.from_numpy(np.array(x))


def _pair(seed, B, H, W, same=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, H, W, 3).astype(np.float32)
    y = x.copy() if same else rng.rand(B, H, W, 3).astype(np.float32)
    g = rng.rand(B, H, W, 1).astype(np.float32)
    return x, y, g


@pytest.mark.parametrize('shape,same', [((2, 61, 12), False),
                                        ((1, 12, 10), True)])
def test_photometric_map_matches_pallas_and_its_grad(shape, same):
    x, y, g = _pair(sum(shape), *shape, same=same)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want = photometric_map_pallas(jx, jy)
    want_dx, want_dy = jax.grad(
        lambda a, b: (photometric_map_pallas(a, b) * g).sum(),
        argnums=(0, 1))(jx, jy)
    tx, ty = t(x).requires_grad_(True), t(y).requires_grad_(True)
    got = tphoto.photometric_map_fn(tx, ty)
    (got * t(g)).sum().backward()
    assert got.shape == shape + (1,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(want_dy),
                               rtol=1e-4, atol=1e-5)
    if same:
        # SSIM == 1 and x == y: the strict gate and sign(0) give no gradient
        assert not tx.grad.any() and not ty.grad.any()


def test_backward_formula_matches_autograd_of_the_plain_forward():
    """The raw-moment backward against autograd through the plain forward
    (the composition chip_smoke.py holds the kernels to on the card)."""
    x, y, g = _pair(9, 2, 13, 17)
    tx, ty = t(x).requires_grad_(True), t(y).requires_grad_(True)
    (tphoto.photometric_map_reference(tx, ty) * t(g)).sum().backward()
    ux, uy = t(x).requires_grad_(True), t(y).requires_grad_(True)
    (tphoto.photometric_map_fn(ux, uy) * t(g)).sum().backward()
    np.testing.assert_allclose(ux.grad.numpy(), tx.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(uy.grad.numpy(), ty.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


# The backward kernel's sweep (csrc/photometric.cu photometric_bwd_kernel),
# emulated in numpy float32 with a warp's 32 lanes as a vector: strips of
# 30 q columns and 32 lanes, the rows cut into near-equal segments, each
# staged row added into the moment sums that are open, the coefficients of
# the closing p row, their right neighbours by shuffle (lane 31 and 30 keep
# their own value past the warp's end), the transpose sums of the closing q
# row. Same operations in the same order as the plain version: bit-equal.
STRIP, LANES = 30, 32


def _shfl_down(v, d):
    return np.concatenate([v[..., d:], v[..., LANES - d:]], -1)


def _sweep_bwd(xp, yp, g, n_segs, alpha=0.85, C1=1e-4, C2=9e-4):
    f = np.float32
    B, C, Hp, Wp = xp.shape
    H, W = Hp - 2, Wp - 2
    c_ssim, c_l1 = f(-0.5 * alpha / 3.0), f(1.0 - alpha)
    C1, C2, inv9, two = f(C1), f(C2), f(1.0 / 9.0), f(2.0)
    dxp = np.full_like(xp, np.nan)
    dyp = np.full_like(yp, np.nan)
    base, extra = divmod(Hp, n_segs)
    lane = np.arange(LANES)
    for b, seg, strip in np.ndindex(B, n_segs, -(-Wp // STRIP)):
        q0 = seg * base + min(seg, extra)
        q1 = q0 + base + (seg < extra)
        X = strip * STRIP - 2 + lane
        p_col = (X >= 0) & (X < W)
        q_col = (lane < STRIP) & (X + 2 < Wp)
        # loads stay in the image: columns Xc..Xc+2 and the row clamped;
        # a clamped lane's values only reach coefficients the gate zeroes
        Xc = np.clip(X, 0, Wp - 3)
        jq = np.minimum(X + 2 - Xc, 2)
        Xg = np.clip(X, 0, W - 1)

        def load(t):
            tc = min(max(t, 0), Hp - 1)
            vx = np.stack([xp[b][:, tc][:, Xc + j] for j in range(3)], 1)
            vy = np.stack([yp[b][:, tc][:, Xc + j] for j in range(3)], 1)
            vg = g[b, min(max(t - 2, 0), H - 1), Xg]
            return vx, vy, np.where(p_col & (0 <= t - 2 < H), vg, f(0.0))

        a, bb = np.zeros((C, 5, LANES), f), np.zeros((C, 5, LANES), f)
        ka, kb = np.zeros((C, 4, LANES), f), np.zeros((C, 4, LANES), f)
        xq, yq = np.zeros((C, 2, LANES), f), np.zeros((C, 2, LANES), f)
        l1_next = np.zeros(LANES, f)
        for t in range(q0 - 2, q1 + 2):
            cx, cy, cg = load(t)
            r = t - 2
            p_ok = p_col & (0 <= r < H)
            Gc = cg * c_ssim
            l1_q, l1_next = l1_next, _shfl_down(cg * c_l1 / f(3.0), 1)
            for c in range(C):
                x, y = cx[c], cy[c]
                v = np.stack([x, y, x * x, y * y, x * y])
                m = (((bb[c] + v[:, 0]) + v[:, 1]) + v[:, 2]) * inv9
                bb[c] = ((a[c] + v[:, 0]) + v[:, 1]) + v[:, 2]
                a[c] = (v[:, 0] + v[:, 1]) + v[:, 2]
                xr, yr = xq[c, 1].copy(), yq[c, 1].copy()
                xq[c, 1], yq[c, 1] = xq[c, 0], yq[c, 0]
                xq[c, 0] = np.choose(jq, x)
                yq[c, 0] = np.choose(jq, y)
                if t < q0:
                    continue
                m1, m2, m3, m4, m5 = m
                sxy2 = two * (m5 - m1 * m2) + C2
                n1 = two * m1 * m2 + C1
                d1 = m1 * m1 + m2 * m2 + C1
                d2 = (m3 - m1 * m1) + (m4 - m2 * m2) + C2
                N, D = n1 * sxy2, d1 * d2
                lin = (f(1.0) - N / D) * f(0.5)
                inv_D = f(1.0) / D
                NDD = N * inv_D * inv_D
                S1 = (two * m2 * (sxy2 - n1)) * inv_D - NDD * (
                    two * m1 * (d2 - d1))
                S2 = (two * m1 * (sxy2 - n1)) * inv_D - NDD * (
                    two * m2 * (d2 - d1))
                S3 = -NDD * d1
                S5 = two * n1 * inv_D
                gc = np.where(p_ok & (lin > 0) & (lin < 1), Gc, f(0.0))
                k = np.stack([gc * S1, gc * S2, gc * S3, gc * S5])
                kv = [k, _shfl_down(k, 1), _shfl_down(k, 2)]
                bs = (((kb[c] + kv[0]) + kv[1]) + kv[2]) * inv9
                kb[c] = ((ka[c] + kv[0]) + kv[1]) + kv[2]
                ka[c] = (kv[0] + kv[1]) + kv[2]
                if t < q0 + 2:
                    continue
                d = xr - yr
                sgn = ((d > 0).astype(f) - (d < 0).astype(f)) * l1_q
                out = X[q_col] + 2
                dxp[b, c, r, out] = ((bs[0] + two * xr * bs[2] + yr * bs[3])
                                     + sgn)[q_col]
                dyp[b, c, r, out] = ((bs[1] + two * yr * bs[2] + xr * bs[3])
                                     - sgn)[q_col]
    return dxp, dyp


@pytest.mark.parametrize('B,H,W,n_segs', [(2, 13, 45, 1), (2, 13, 45, 3),
                                          (1, 20, 61, 5), (1, 6, 9, 2)])
def test_backward_kernel_sweep_is_the_plain_backward(B, H, W, n_segs):
    """Every padded pixel is written once, bit-equal to the plain version
    (photometric_bwd_reference, which the Pallas kernel's interpret-mode
    gradient holds above), for one and several row segments, two strips
    with a ragged last one, and a strip narrower than a warp."""
    x, y, g = _pair(B * H + W, B, H, W)
    xp, yp = (tphoto._padded(t(v)).numpy() for v in (x, y))
    got = _sweep_bwd(xp, yp, g[..., 0], n_segs)
    assert not np.isnan(got[0]).any() and not np.isnan(got[1]).any()
    want = tphoto.photometric_bwd_reference(t(xp), t(yp), t(g[..., 0]))
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w.numpy())


def test_wrappers_refuse_what_they_do_not_take():
    xp = torch.rand(1, 4, 6, 7)
    with pytest.raises(ValueError, match='3 channels'):
        tphoto.photometric_fwd(xp, xp)
    with pytest.raises(ValueError, match='3 channels'):
        tphoto.photometric_map_fn(torch.rand(1, 4, 5, 4),
                                  torch.rand(1, 4, 5, 4))
    xp = torch.rand(1, 3, 6, 7)
    with pytest.raises(ValueError, match='g must be'):
        tphoto.photometric_bwd(xp, xp, torch.rand(1, 6, 7))
    before = (tphoto.photometric_fwd.launches,
              tphoto.photometric_bwd.launches)
    with pytest.raises(ValueError, match='CUDA'):
        tphoto._launch_fwd(xp, xp, 0.85, 1e-4, 9e-4)
    with pytest.raises(ValueError, match='CUDA'):
        tphoto.photometric_bwd(xp.to('meta'), xp.to('meta'),
                               torch.rand(1, 4, 5).to('meta'))
    assert (tphoto.photometric_fwd.launches,
            tphoto.photometric_bwd.launches) == before


@pytest.mark.parametrize('lowp', [False, True])
def test_ssim_loss_matches_jax(lowp):
    """Values and gradients; bf16 inputs on the clamp_variance path."""
    x, y, g = _pair(11, 2, 10, 14)
    g = np.repeat(g, 3, axis=-1)
    dt = (jnp.bfloat16, torch.bfloat16) if lowp else (jnp.float32,
                                                      torch.float32)

    def jf(a, b):
        s = jssim.ssim_loss(a.astype(dt[0]), b.astype(dt[0]),
                            clamp_variance=lowp)
        return (s * g).sum(), s

    (_, want), (want_dx, want_dy) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(y))
    tx, ty = t(x).requires_grad_(True), t(y).requires_grad_(True)
    got = tssim.ssim_loss(tx.to(dt[1]), ty.to(dt[1]), clamp_variance=lowp)
    (got * t(g)).sum().backward()
    assert got.dtype == torch.float32
    # under bf16 the cotangent crosses the casts in bf16: one rounding
    grad_tol = 1e-2 if lowp else 1e-5
    for a, b, tol in ((got.detach(), want, 1e-5), (tx.grad, want_dx, grad_tol),
                      (ty.grad, want_dy, grad_tol)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=tol * np.abs(b).max())


def test_clip_gradient_at_its_bounds_is_jax_s():
    """jnp.clip splits the gradient at a tie with a bound; torch.clamp
    would pass all of it. Identical images put (1 - SSIM) / 2 on 0."""
    v = np.array([0.0, 1.0, 0.5, -0.5, 1.5], np.float32)
    want = jax.grad(lambda a: jnp.clip(a, 0.0, 1.0).sum())(jnp.asarray(v))
    tv = t(v).requires_grad_(True)
    tssim.clip(tv, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(want))
    x, _, _ = _pair(12, 1, 6, 7)
    lin = (1.0 - tssim.ssim(t(x), t(x))) * 0.5
    assert bool((lin == 0).all())


def test_image_and_depth_helpers_match_jax():
    rng = np.random.RandomState(13)
    x = rng.rand(2, 7, 9, 3).astype(np.float32)
    for tf, jf in ((timage.gradient_x, jimage.gradient_x),
                   (timage.gradient_y, jimage.gradient_y),
                   (timage.reflect_pad_2d, jimage.reflect_pad_2d),
                   (timage.avg_pool_3x3, jimage.avg_pool_3x3)):
        np.testing.assert_allclose(tf(t(x)).numpy(), np.asarray(jf(x)),
                                   rtol=1e-6, atol=1e-7)
    sig = [rng.rand(2, 7 // 2 ** i + 1, 9 // 2 ** i + 1, 1).astype(np.float32)
           for i in range(3)]
    imgs = [rng.rand(*s.shape[:3], 3).astype(np.float32) for s in sig]
    np.testing.assert_allclose(
        tdepth.sigmoid_to_depth_linear(t(sig[0]), 0.5, 80.0).numpy(),
        np.asarray(jdepth.sigmoid_to_depth_linear(sig[0], 0.5, 80.0)),
        rtol=1e-6)
    for a, b in zip(tdepth.inv_depths_normalize([t(s) for s in sig]),
                    jdepth.inv_depths_normalize(sig)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    got = tdepth.calc_smoothness([t(s) for s in sig], [t(i) for i in imgs], 3)
    want = jdepth.calc_smoothness(sig, imgs, 3)
    for gl, wl in zip(got, want):
        for a, b in zip(gl, wl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
