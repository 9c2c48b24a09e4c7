"""The PyTorch port's photometric map (packnet_sfm_tpu_torch/ops/kernels/
photometric.py: the plain forward and backward the wrappers run on CPU
tensors, through its autograd Function) against the JAX package's Pallas
kernels in interpret mode (ops/pallas/photometric.py, which runs
interpreted off the TPU) and their jax.grad; and the non-kernel
composition (ops/ssim.py, ops/image.py pools and pads, ops/depth.py
smoothness) against the JAX package's.

Cases: random images over more than one 48-row TPU tile with a ragged
tail, identical images (SSIM on the clamp), row-slices of one tensor with the
cotangent of a mean (stride 0), and bf16 inputs on the non-kernel path. What
the kernels do not take raises. Both kernels' sweeps (their lanes, strips,
row segments, reflected loads and folded stores, emulated in numpy float32)
are held bit-equal to the plain compositions, and the plain reflect fold to
autograd of F.pad.

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


# The kernels' sweeps (csrc/photometric.cu photometric_fwd_kernel and
# photometric_bwd_kernel), emulated in numpy float32 with a warp's 32 lanes
# as a vector: strips of 30 columns and 32 lanes, the rows cut into
# near-equal segments, each staged row (its row and columns reflected into
# the NHWC image) added into the moment sums that are open, right
# neighbours by shuffle (lanes past the warp's end keep their own value).
# The forward closes a p row with the SSIM and L1 terms; the backward forms
# the coefficients of the closing p row and the transpose sums of the
# closing q row, and folds q rows 0 and H+1 and columns 0 and W+1 as it
# writes (rows held one slot a lane, columns by shuffle). Same operations in
# the same order as the plain composition: bit-equal.
STRIP, LANES = 30, 32


def _shfl_down(v, d):
    return np.concatenate([v[..., d:], v[..., LANES - d:]], -1)


def _shfl_up(v, d):
    return np.concatenate([v[..., :d], v[..., :LANES - d]], -1)


def _refl(i, n):
    """The image index padded index i + 1 reflects onto (n >= 2)."""
    return np.where(i < 0, -i, np.where(i >= n, 2 * n - 2 - i, i))


def _segment(n, n_segs, seg):
    base, extra = divmod(n, n_segs)
    r0 = seg * base + min(seg, extra)
    return r0, r0 + base + (seg < extra)


def _strip_origin(W):
    """csrc/photometric.cu strip_origin: no strip cut between q columns 0
    and 2 or W-1 and W+1."""
    k = next(k for k in range(STRIP)
             if k not in (1, 2, W % STRIP, (W + 1) % STRIP))
    return (STRIP - k) % STRIP


def _ssim_terms(m, C1, C2):
    """N, D, n1, sxy2, d1, d2 and (1 - N / D) / 2 of moments m [5, ...]."""
    f = np.float32
    m1, m2, m3, m4, m5 = m
    two = f(2.0)
    sxy2 = two * (m5 - m1 * m2) + C2
    n1 = two * m1 * m2 + C1
    d1 = m1 * m1 + m2 * m2 + C1
    d2 = (m3 - m1 * m1) + (m4 - m2 * m2) + C2
    N, D = n1 * sxy2, d1 * d2
    return N, D, n1, sxy2, d1, d2, (f(1.0) - N / D) * f(0.5)


def _sweep_fwd(x, y, n_segs, alpha=0.85, C1=1e-4, C2=9e-4):
    f = np.float32
    B, H, W, C = x.shape
    alpha, one_m, C1, C2 = f(alpha), f(1.0 - alpha), f(C1), f(C2)
    inv9 = f(1.0 / 9.0)
    out = np.full((B, H, W), np.nan, f)
    written = np.zeros((B, H, W), int)
    lane = np.arange(LANES)
    for b, seg, strip in np.ndindex(B, n_segs, -(-W // STRIP)):
        r0, r1 = _segment(H, n_segs, seg)
        q = strip * STRIP + lane
        col = _refl(np.minimum(q, W + 1) - 1, W)
        out_col = (lane < STRIP) & (q < W)
        sa, sb = np.zeros((C, 5, LANES), f), np.zeros((C, 5, LANES), f)
        l1 = np.zeros((C, LANES), f)
        for t in range(r0, r1 + 2):
            r = int(_refl(t - 1, H))
            cx, cy = x[b, r, col].T, y[b, r, col].T
            acc = None
            for c in range(C):
                x0, y0 = cx[c], cy[c]
                x1, x2 = _shfl_down(x0, 1), _shfl_down(x0, 2)
                y1, y2 = _shfl_down(y0, 1), _shfl_down(y0, 2)
                v = np.stack([np.stack(u) for u in (
                    (x0, x1, x2), (y0, y1, y2), (x0 * x0, x1 * x1, x2 * x2),
                    (y0 * y0, y1 * y1, y2 * y2), (x0 * y0, x1 * y1, x2 * y2))])
                m = (((sb[c] + v[:, 0]) + v[:, 1]) + v[:, 2]) * inv9
                sb[c] = ((sa[c] + v[:, 0]) + v[:, 1]) + v[:, 2]
                sa[c] = (v[:, 0] + v[:, 1]) + v[:, 2]
                if t >= r0 + 2:
                    lin = _ssim_terms(m, C1, C2)[-1]
                    st = np.minimum(np.maximum(lin, f(0.0)), f(1.0))
                    val = alpha * st + one_m * l1[c]
                    acc = val if c == 0 else acc + val
                l1[c] = np.abs(x1 - y1)
            if t >= r0 + 2:
                out[b, t - 2, q[out_col]] = (acc / f(3.0))[out_col]
                written[b, t - 2, q[out_col]] += 1
    assert (written == 1).all()
    return out


def _sweep_bwd(x, y, g, n_segs, need_dy=True, alpha=0.85, C1=1e-4,
               C2=9e-4):
    f = np.float32
    B, H, W, C = x.shape
    Hp, Wp = H + 2, W + 2
    c_ssim, c_l1 = f(-0.5 * alpha / 3.0), f(1.0 - alpha)
    C1, C2, inv9, two = f(C1), f(C2), f(1.0 / 9.0), f(2.0)
    out = [np.full_like(x, np.nan), np.full_like(y, np.nan)]
    written = np.zeros(x.shape, int)
    org = _strip_origin(W)
    lane = np.arange(LANES)
    for b, seg, strip in np.ndindex(B, n_segs, -(-(Wp + org) // STRIP)):
        q0, q1 = _segment(Hp, n_segs, seg)
        X = strip * STRIP - org - 2 + lane
        qc = X + 2
        p_col = (X >= 0) & (X < W)
        q_col = (lane < STRIP) & (qc >= 1) & (qc <= W)
        # loads stay in the image: columns Xc..Xc+2 and the row clamped;
        # a clamped lane's values only reach coefficients the gate zeroes
        Xc = np.clip(X, 0, Wp - 3)
        jq = np.clip(qc - Xc, 0, 2)
        Xg = np.clip(X, 0, W - 1)
        held = np.zeros((2, 2, C, LANES), f)

        def load(t):
            r = int(_refl(min(max(t, 0), Hp - 1) - 1, H))
            cols = [_refl(Xc + j - 1, W) for j in range(3)]
            vx = np.stack([x[b, r, cl].T for cl in cols], 1)
            vy = np.stack([y[b, r, cl].T for cl in cols], 1)
            vg = g[b, min(max(t - 2, 0), H - 1), Xg]
            return vx, vy, np.where(p_col & (0 <= t - 2 < H), vg, f(0.0))

        def store(d, c, r, v):
            if r == 0:
                held[0, d, c] = v
                return
            if r == 2:
                v = v + held[0, d, c]
            if r == H - 1:
                held[1, d, c] = v
                return
            ro = r - 1
            if r == H + 1:
                v, ro = held[1, d, c] + v, H - 2
            v = np.where(qc == 2, v + _shfl_up(v, 2), v)
            v = np.where(qc == W - 1, v + _shfl_down(v, 2), v)
            out[d][b, ro, qc[q_col] - 1, c] = v[q_col]
            if d == 0:
                written[b, ro, qc[q_col] - 1, c] += 1

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
                xv, yv = cx[c], cy[c]
                v = np.stack([xv, yv, xv * xv, yv * yv, xv * yv])
                m = (((bb[c] + v[:, 0]) + v[:, 1]) + v[:, 2]) * inv9
                bb[c] = ((a[c] + v[:, 0]) + v[:, 1]) + v[:, 2]
                a[c] = (v[:, 0] + v[:, 1]) + v[:, 2]
                xr, yr = xq[c, 1].copy(), yq[c, 1].copy()
                xq[c, 1], yq[c, 1] = xq[c, 0], yq[c, 0]
                xq[c, 0] = np.choose(jq, xv)
                yq[c, 0] = np.choose(jq, yv)
                if t < q0:
                    continue
                m1, m2 = m[0], m[1]
                N, D, n1, sxy2, d1, d2, lin = _ssim_terms(m, C1, C2)
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
                store(0, c, r, (bs[0] + two * xr * bs[2] + yr * bs[3]) + sgn)
                if need_dy:
                    store(1, c, r,
                          (bs[1] + two * yr * bs[2] + xr * bs[3]) - sgn)
    assert (written == 1).all()
    return out[0], out[1] if need_dy else None


@pytest.mark.parametrize('B,H,W,n_segs', [(2, 13, 45, 1), (2, 13, 45, 3),
                                          (1, 20, 61, 4), (1, 6, 9, 1),
                                          (1, 2, 2, 1), (1, 9, 31, 2)])
def test_forward_kernel_sweep_is_the_plain_forward(B, H, W, n_segs):
    """Every pixel is written once, bit-equal to the plain composition
    (photometric_fwd_plain: the reflect pad, then the formula), for one
    and several row segments, two strips with a ragged last one, a strip
    narrower than a warp, H = W = 2 and a last strip of one column."""
    x, y, _ = _pair(B * H + W + 1, B, H, W)
    got = _sweep_fwd(x, y, n_segs)
    want = tphoto.photometric_fwd_plain(t(x), t(y))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize('B,H,W,n_segs,need_dy', [
    (2, 13, 45, 1, True), (2, 13, 45, 3, True), (1, 20, 61, 5, True),
    (1, 6, 9, 2, True), (1, 2, 2, 1, True), (1, 3, 3, 1, True),
    (1, 9, 59, 2, True), (1, 4, 60, 1, True), (2, 7, 28, 2, False)])
def test_backward_kernel_sweep_is_the_plain_backward(B, H, W, n_segs,
                                                     need_dy):
    """Every pixel is written once, bit-equal to the plain composition
    (photometric_bwd_reference on the padded images, which the Pallas
    kernel's interpret-mode gradient holds above, then reflect_fold), for
    one and several row segments, two strips with a ragged last one, a strip
    narrower than a warp, H = W = 2 and 3 (both row folds into one row),
    widths whose default strip cut would separate W-1 from W+1 (59, 60: the
    strips start elsewhere), and without dy."""
    x, y, g = _pair(B * H + W, B, H, W)
    got = _sweep_bwd(x, y, g[..., 0], n_segs, need_dy)
    want = tphoto.photometric_bwd_plain(t(x), t(y), t(g[..., 0]), need_dy)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    if need_dy:
        np.testing.assert_array_equal(got[1], want[1].numpy())
    else:
        assert got[1] is None and want[1] is None


def test_strip_origin_keeps_the_column_folds_in_one_warp():
    """For every width, q columns 0 and 2, and W-1 and W+1, lie in one
    strip, on its written lanes."""
    for W in range(2, 200):
        org = _strip_origin(W)
        for qa, qb in ((0, 2), (W - 1, W + 1)):
            assert (qa + org) // STRIP == (qb + org) // STRIP


@pytest.mark.parametrize('H,W', [(2, 2), (2, 5), (5, 2), (3, 3), (6, 9)])
def test_reflect_fold_is_the_pad_adjoint(H, W):
    """reflect_fold against autograd of F.pad(mode='reflect'), which sums
    the same terms in another order: corners take four terms, edges two."""
    rng = np.random.RandomState(H * 10 + W)
    dp = rng.rand(2, 3, H + 2, W + 2).astype(np.float32)
    v = torch.zeros(2, 3, H, W, requires_grad=True)
    torch.nn.functional.pad(v, (1, 1, 1, 1), mode='reflect').backward(t(dp))
    got = tphoto.reflect_fold(t(dp))
    np.testing.assert_allclose(got.numpy(), v.grad.numpy(), rtol=1e-6,
                               atol=0)
    # a corner's order, rows first (from H, W = 4 on, nothing else folds
    # into image pixel (1, 1))
    a = t(dp)
    want = (a[..., 2, 2] + a[..., 0, 2]) + (a[..., 2, 0] + a[..., 0, 0])
    if H >= 4 and W >= 4:
        assert torch.equal(got[..., 1, 1], want)


def test_map_on_strided_slices_and_a_stride0_g_matches_pallas():
    """x and y as row-slices of one [B,4H,W,3] tensor each (as the warp
    returns its four scales) and the cotangent of a mean (stride 0), against
    the Pallas kernels in interpret mode and their jax.grad."""
    B, H, W = 2, 11, 14
    rng = np.random.RandomState(21)
    big_x = rng.rand(B, 4 * H, W, 3).astype(np.float32)
    big_y = rng.rand(B, 4 * H, W, 3).astype(np.float32)
    sl = slice(2 * H, 3 * H)
    jx, jy = jnp.asarray(big_x[:, sl]), jnp.asarray(big_y[:, sl])
    want = photometric_map_pallas(jx, jy)
    want_dx, want_dy = jax.grad(
        lambda a, b: photometric_map_pallas(a, b).mean(), argnums=(0, 1))(
            jx, jy)
    tx, ty = t(big_x).requires_grad_(True), t(big_y).requires_grad_(True)
    x, y = tx[:, sl], ty[:, sl]
    assert not x.is_contiguous() and x.stride(2) == 3
    got = tphoto.photometric_map_fn(x, y)
    got.mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for leaf, w in ((tx, want_dx), (ty, want_dy)):
        np.testing.assert_allclose(leaf.grad[:, sl].numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
        assert not leaf.grad[:, :2 * H].any() and \
            not leaf.grad[:, 3 * H:].any()
    # the wrapper on a stride-0 g against the same g made dense
    g0 = torch.full((1, 1, 1), 0.25).expand(B, H, W)
    assert g0.stride() == (0, 0, 0)
    for a, b in zip(tphoto.photometric_bwd(x.detach(), y.detach(), g0),
                    tphoto.photometric_bwd(x.detach(), y.detach(),
                                           g0.contiguous())):
        assert torch.equal(a, b)


def test_map_hands_the_kernels_their_layout_from_an_nchw_view():
    """x as an NCHW tensor seen through a permute (what ops/image.py
    interpolate returns when the resize keeps NCHW memory) and y in float64:
    photometric_map_fn copies both to the layout the kernels take (float32,
    channel stride 1, pixel stride 3), and the gradients go back through
    the copies; against the Pallas kernels in interpret mode and their
    jax.grad."""
    B, H, W = 2, 9, 13
    rng = np.random.RandomState(23)
    nchw = t(rng.rand(B, 3, H, W).astype(np.float32)).requires_grad_(True)
    y_np = rng.rand(B, H, W, 3).astype(np.float32)
    x = nchw.permute(0, 2, 3, 1)
    x.retain_grad()
    y = t(y_np).double().requires_grad_(True)
    assert x.stride()[2:] == (1, H * W)
    jx, jy = jnp.asarray(x.detach().numpy()), jnp.asarray(y_np)
    want = photometric_map_pallas(jx, jy)
    want_dx, want_dy = jax.grad(
        lambda a, b: photometric_map_pallas(a, b).sum(), argnums=(0, 1))(
            jx, jy)
    seen, saved = [], tphoto.photometric_fwd

    def spy(a, b, *rest):
        seen.extend((v.dtype, v.stride()[2:]) for v in (a, b))
        return saved(a, b, *rest)

    tphoto.photometric_fwd = spy
    try:
        got = tphoto.photometric_map_fn(x, y)
    finally:
        tphoto.photometric_fwd = saved
    assert seen == [(torch.float32, (3, 1))] * 2
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert y.grad.dtype == torch.float64 and nchw.grad is not None
    for leaf, w in ((x, want_dx), (y, want_dy)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


def test_without_need_dy_dx_is_unchanged_and_the_function_asks_for_none():
    x, y, g = _pair(17, 2, 9, 12)
    dx, dy = tphoto.photometric_bwd(t(x), t(y), t(g[..., 0]))
    dx1, dy1 = tphoto.photometric_bwd(t(x), t(y), t(g[..., 0]),
                                      need_dy=False)
    assert dy1 is None and dy is not None and torch.equal(dx, dx1)
    # y as data (the loss's target image): the Function asks for no dy
    asked, saved = [], tphoto.photometric_bwd

    def spy(*a, **k):
        asked.append(a[3])
        return saved(*a, **k)

    tx = t(x).requires_grad_(True)
    tphoto.photometric_bwd = spy
    try:
        (tphoto.photometric_map_fn(tx, t(y)) * t(g)).sum().backward()
    finally:
        tphoto.photometric_bwd = saved
    assert asked == [False] and torch.equal(tx.grad, dx)


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.rand(1, 6, 7, 4)
    with pytest.raises(ValueError, match='3 channels'):
        tphoto.photometric_fwd(x, x)
    with pytest.raises(ValueError, match='3 channels'):
        tphoto.photometric_map_fn(torch.rand(1, 4, 5, 4),
                                  torch.rand(1, 4, 5, 4))
    x = torch.rand(1, 6, 7, 3)
    with pytest.raises(ValueError, match='g must be'):
        tphoto.photometric_bwd(x, x, torch.rand(1, 6, 8))
    # where F.pad(mode='reflect') would refuse: H or W below 2
    for bad in (torch.rand(1, 1, 7, 3), torch.rand(1, 6, 1, 3)):
        with pytest.raises(ValueError, match='H, W >= 2'):
            tphoto.photometric_fwd(bad, bad)
        with pytest.raises(ValueError, match='H, W >= 2'):
            tphoto.photometric_bwd(bad, bad, torch.rand(bad.shape[:3]))
    with pytest.raises(TypeError, match='float32'):
        tphoto.photometric_fwd(x.double(), x.double())
    with pytest.raises(TypeError, match='float32'):
        tphoto.photometric_bwd(x, x, torch.rand(1, 6, 7).double())
    with pytest.raises(ValueError, match='one device'):
        tphoto.photometric_fwd(x, x.to('meta'))
    before = (tphoto.photometric_fwd.launches,
              tphoto.photometric_bwd.launches)
    with pytest.raises(ValueError, match='CUDA'):
        tphoto._launch_fwd(x, x, 0.85, 1e-4, 9e-4)
    with pytest.raises(ValueError, match='CUDA'):
        tphoto.photometric_bwd(x.to('meta'), x.to('meta'),
                               torch.rand(1, 6, 7).to('meta'))
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
