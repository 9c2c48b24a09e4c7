"""The PyTorch port's bilinear warp (packnet_sfm_tpu_torch/ops/kernels/
warp.py: the plain versions the wrappers run on CPU tensors, out, A and B
from `bilinear_warp_reference` and the grid cotangent from
`warp_dgrid_reference`) and its autograd Function against the JAX
package's grid_sample on the CPU, where it takes the XLA path
(ops/image.py `_gs_patches`, `_gs_derivs`, the custom VJP), and against the
Pallas warp kernel's taps in interpret mode.

Grids mix smooth in-image flow with the cases a naive port gets wrong:
coordinates far outside the image (|x| up to 1e7, as a depth clipped at
1e-5 gives), exact integer pixel coordinates, the image's last row and
column, an odd width and an output taller than the image (the loss stacks
four grids along the rows).

Tolerance: out, A, B and dgrid at atol 1e-6 x max|value| in float32 (the
same formulas in the same order; XLA may fuse differently); bf16 sources:
out within one bf16 rounding (atol 1e-2 x max), A and B at 1e-6 (the tap
differences are rounded to bf16 on both sides, the rest is float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.ops import image as jimage
from packnet_sfm_tpu.ops.pallas.warp import warp_taps_pallas
from packnet_sfm_tpu_torch.ops.image import grid_sample
from packnet_sfm_tpu_torch.ops.kernels import warp


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rel=1e-6):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float32), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-30))


def _grid(seed, B, Ho, Wo, H, W):
    """Normalised coordinates: 70% in and around the image, then far
    outside, exact integer pixels, and the last row and column."""
    rng = np.random.RandomState(seed)
    g = rng.uniform(-1.3, 1.3, (B, Ho, Wo, 2))
    flat = g.reshape(-1, 2)
    n = flat.shape[0]
    idx = rng.permutation(n)
    far, ints, edge = idx[:n // 10], idx[n // 10:n // 5], idx[n // 5:n * 3 // 10]
    flat[far] = rng.choice([-1e7, -3e5, 2e6, 1e7], size=(len(far), 2))
    px = np.stack([rng.randint(-1, W + 1, len(ints)),
                   rng.randint(-1, H + 1, len(ints))], axis=1)
    flat[ints] = 2.0 * px / [W - 1, H - 1] - 1.0
    flat[edge] = [[1.0, rng.uniform(-1, 1)] if i % 2 else
                  [rng.uniform(-1, 1), 1.0] for i in range(len(edge))]
    return g.astype(np.float32)


def _jax_warp(image, grid, mode):
    """(out, A, B) of the JAX package's XLA path."""
    taps = jimage._gs_patches(image, grid, mode)
    A, Bv = jimage._gs_derivs(*taps)
    return jimage.grid_sample(image, grid, mode), A, Bv


@pytest.mark.parametrize('mode', ['zeros', 'border'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_warp_and_dgrid_match_jax(mode, dtype):
    B, H, W, Ho = 2, 9, 13, 27           # odd W, Ho = 3 H
    rng = np.random.RandomState(1)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    grid = _grid(2, B, Ho, W, H, W)
    g = rng.randn(B, Ho, W, 3).astype(np.float32)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    jimg = jnp.asarray(img).astype(jdt)
    want = _jax_warp(jimg, grid, mode)
    _, vjp = jax.vjp(lambda gr: jimage.grid_sample(jimg, gr, mode), grid)
    want_dgrid, = vjp(jnp.asarray(g).astype(jdt))

    timg = t(img).to(getattr(torch, dtype))
    got = warp.bilinear_warp_reference(timg, t(grid), mode)
    assert got[0].dtype == timg.dtype and got[1].dtype == torch.float32
    assert torch.equal(warp.warp_bilinear_out(timg, t(grid), mode), got[0])
    if dtype == 'float32':
        close(got[0], want[0])
    else:
        close(got[0].float(), want[0].astype(jnp.float32), rel=1e-2)
    close(got[1], want[1])
    close(got[2], want[2])

    tgrid = t(grid).requires_grad_(True)
    out = grid_sample(timg, tgrid, mode)
    out.backward(t(g).to(out.dtype))
    close(tgrid.grad, want_dgrid)
    # far outside the image: zeros padding samples nothing
    far = np.abs(grid).max(-1) > 1e3
    if mode == 'zeros':
        assert far.any() and np.all(got[0].float().numpy()[far] == 0)
        assert np.all(tgrid.grad.numpy()[far] == 0)


def test_integer_coordinates_sample_the_pixel():
    B, H, W = 1, 5, 7
    img = np.random.RandomState(3).rand(B, H, W, 3).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    grid = np.stack([2.0 * xs / (W - 1) - 1, 2.0 * ys / (H - 1) - 1],
                    -1)[None].astype(np.float32)
    for mode in ('zeros', 'border'):
        out = warp.warp_bilinear_out(t(img), t(grid), mode)
        np.testing.assert_allclose(out.numpy(), img, rtol=0, atol=1e-6)


def test_taps_match_pallas_kernel_interpret():
    """The Pallas kernel's taps, combined by the XLA path's formulas, give
    the port's out, A and B (a smooth in-band flow, as the kernel needs;
    one 8-row tile and two lane chunks keep the interpreter short)."""
    B, H, W = 1, 8, 136
    rng = np.random.RandomState(4)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing='ij')
    x = xs + 6.0 * np.sin(xs / 17.0) + 0.37
    y = ys + 1.5 * np.cos(xs / 23.0) + 0.21
    grid = np.stack([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1],
                    -1)[None].astype(np.float32)
    p00, p01, p10, p11, wx, wy, viol = warp_taps_pallas(
        jnp.asarray(img), jnp.asarray(grid), 'zeros', interpret=True)
    assert not bool(viol)
    want_out = jimage._gs_combine(p00, p01, p10, p11, wx, wy)
    want_A, want_B = jimage._gs_derivs(p00, p01, p10, p11, wx, wy)
    got = warp.bilinear_warp_reference(t(img), t(grid), 'zeros')
    close(got[0], want_out)
    close(got[1], want_A)
    close(got[2], want_B)


def test_image_cotangent_through_the_plain_version():
    B, H, W = 2, 6, 8
    rng = np.random.RandomState(5)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    grid = _grid(6, B, H, W, H, W)
    g = rng.randn(B, H, W, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda im: jimage.grid_sample(im, grid, 'zeros'),
                     jnp.asarray(img))
    want, = vjp(jnp.asarray(g))
    before = warp.WarpFunction.image_grads
    timg = t(img).requires_grad_(True)
    grid_sample(timg, t(grid)).backward(t(g))
    assert warp.WarpFunction.image_grads == before + 1
    close(timg.grad, want)


def test_wrapper_refuses_what_it_does_not_take():
    img, grid = torch.rand(1, 4, 5, 3), torch.rand(1, 4, 5, 2)
    with pytest.raises(ValueError, match='channels'):
        warp.warp_bilinear_out(torch.rand(1, 4, 5, 4), grid)
    with pytest.raises(ValueError, match='padding'):
        warp.warp_bilinear_out(img, grid, 'reflection')
    with pytest.raises(ValueError, match='grid'):
        warp.warp_bilinear_out(img, grid[..., :1])
    with pytest.raises(ValueError, match='g must be'):
        warp.warp_bilinear_dgrid(img, grid, torch.rand(1, 4, 5, 2))
    before = (warp.warp_bilinear_out.launches,
              warp.warp_bilinear_dgrid.launches)
    # the kernel path refuses CPU tensors rather than computing anything,
    # and only a CPU tensor takes the plain version
    with pytest.raises(ValueError, match='CUDA'):
        warp._launch_out(img, grid, 'zeros')
    with pytest.raises(ValueError, match='CUDA'):
        warp._launch_dgrid(img, grid, img, 'zeros')
    with pytest.raises(ValueError, match='CUDA'):
        warp.warp_bilinear_out(img.to('meta'), grid.to('meta'))
    with pytest.raises(ValueError, match='CUDA'):
        warp.warp_bilinear_dgrid(img.to('meta'), grid.to('meta'),
                                 img.to('meta'))
    assert (warp.warp_bilinear_out.launches,
            warp.warp_bilinear_dgrid.launches) == before


@pytest.mark.parametrize('mode', ['zeros', 'border'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B,H,W,Ho', [(2, 9, 13, 27), (1, 7, 10, 7)])
def test_dgrid_reference_matches_jax_grid_cotangent(mode, dtype, B, H, W,
                                                    Ho):
    """warp_dgrid_reference (the dgrid kernel's plain version) against
    jax.vjp of the JAX grid_sample w.r.t. the grid (XLA path), on the
    seeded grids of the cases above (far out, integer, last row and column;
    Ho = 3 H with an odd W, and Ho = H); g in the image dtype, as autograd
    hands it over."""
    rng = np.random.RandomState(7 + H)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    grid = _grid(8 + W, B, Ho, W, H, W)
    g = rng.randn(B, Ho, W, 3).astype(np.float32)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    jimg = jnp.asarray(img).astype(jdt)
    _, vjp = jax.vjp(lambda gr: jimage.grid_sample(jimg, gr, mode), grid)
    want, = vjp(jnp.asarray(g).astype(jdt))
    tdt = getattr(torch, dtype)
    got = warp.warp_dgrid_reference(t(img).to(tdt), t(grid),
                                    t(g).to(tdt), mode)
    assert got.dtype == torch.float32 and got.shape == (B, Ho, W, 2)
    close(got, want)
    assert torch.equal(warp.warp_bilinear_dgrid(
        t(img).to(tdt), t(grid), t(g).to(tdt), mode), got)


@pytest.mark.parametrize('mode', ['zeros', 'border'])
def test_function_saves_image_and_grid_only(mode):
    """WarpFunction keeps (image, grid) for its backward, no derivative
    map; its CPU backward is the plain dgrid."""
    B, H, W = 2, 6, 9
    rng = np.random.RandomState(11)
    img = t(rng.rand(B, H, W, 3).astype(np.float32))
    grid = t(_grid(12, B, 2 * H, W, H, W)).requires_grad_(True)
    g = t(rng.randn(B, 2 * H, W, 3).astype(np.float32))
    out = grid_sample(img, grid, mode)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == img.data_ptr() and \
        saved[1].data_ptr() == grid.data_ptr()
    out.backward(g)
    assert torch.equal(grid.grad,
                       warp.warp_dgrid_reference(img, grid.detach(), g, mode))
