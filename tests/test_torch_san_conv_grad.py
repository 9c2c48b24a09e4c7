"""The PyTorch port's masked-conv gradient (packnet_sfm_tpu_torch/ops/
kernels/san_conv.py MaskedConv2dFunction and the dgrad wrapper) against
jax.vjp of the JAX package's masked_conv2d custom VJP, whose backward runs
the Pallas kernel in interpret mode for dx, on the CPU, where the port's
wrappers run their plain versions.

Tolerance: dx, dW and db at rtol 1e-4 and atol 1e-4 x max|JAX value|:
float32 sums over up to k*k*Cout terms (dx) or B*H*W sites (dW, db) in
another order, as tests/test_san_conv_kernel.py holds the Pallas forward.
Exact zeros where no site within the halo is active.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packnet_sfm_tpu.ops.pallas.san_conv import (
    masked_conv2d as j_masked_conv2d, tile_activity)
from packnet_sfm_tpu_torch.ops.kernels import san_conv


def _inputs(seed, B, H, W, Cin, Cout, k, mask_kind):
    rng = np.random.RandomState(seed)
    mask = np.zeros((B, H, W, 1), np.float32)
    if mask_kind == 'rows':
        # KITTI-like: empty above 40% of the height, scattered below
        h0 = int(H * 0.4)
        mask[:, h0:] = rng.rand(B, H - h0, W, 1) < 0.3
    elif mask_kind == 'halo':
        # one active row, the first of the second 8-row tile, and a few
        # sites at a 16-column edge: dx spreads across both tile borders
        mask[:, 8, ::3] = 1.0
        mask[:, 2, 15:17] = 1.0
    x = (rng.randn(B, H, W, Cin) * mask).astype(np.float32)
    kern = (rng.randn(k, k, Cin, Cout) * 0.1).astype(np.float32)
    bias = (rng.randn(Cout) * 0.1).astype(np.float32)
    g = rng.randn(B, H, W, Cout).astype(np.float32)
    return x, mask, kern, bias, g


def _jax_grads(x, mask, kern, bias, g):
    flags = tile_activity(jnp.asarray(mask), kern.shape[0])

    def f(x_, k_, b_):
        return j_masked_conv2d(x_, jnp.asarray(mask), k_, b_, flags, True)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(kern),
                       jnp.asarray(bias))
    return [np.asarray(a) for a in (out,) + vjp(jnp.asarray(g))]


def _port_grads(x, mask, kern, bias, g, x_grad=True):
    xt, kt, bt = (torch.tensor(v, requires_grad=True) for v in (x, kern, bias))
    xt.requires_grad_(x_grad)
    out = san_conv.masked_conv2d_fn(xt, torch.from_numpy(mask), kt, bt)
    out.backward(torch.from_numpy(g))
    return [None if t is None else t.detach().numpy()
            for t in (out, xt.grad, kt.grad, bt.grad)]


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize('case', [
    # (B, H, W, Cin, Cout, k, mask)
    (2, 13, 21, 16, 8, 3, 'rows'),     # ragged H, W; B > 1; 16 channels
    (1, 12, 20, 1, 16, 5, 'rows'),     # Cin = 1 (the first SAN stage)
    (1, 16, 24, 8, 24, 5, 'halo'),     # the halo crosses tile borders
    (2, 16, 20, 24, 16, 3, 'halo'),
])
def test_function_matches_jax_vjp_of_pallas_kernel(case):
    B, H, W, Cin, Cout, k, kind = case
    args = _inputs(sum(case[:6]), B, H, W, Cin, Cout, k, kind)
    want = _jax_grads(*args)
    got = _port_grads(*args)
    for name, a, b in zip(('out', 'dx', 'dkernel', 'dbias'), got, want):
        assert a.shape == b.shape, name
        _close(a, b, name)
    x, mask = args[0], args[1]
    dx = got[1]
    # dx is not masked: nonzero in the halo of active sites ...
    assert np.any(dx[np.broadcast_to(mask == 0, dx.shape)] != 0)
    # ... and exactly zero where no site within the halo is active
    p = k // 2
    near = torch.nn.functional.max_pool2d(
        torch.from_numpy(mask).permute(0, 3, 1, 2), k, 1, p)
    far = np.broadcast_to((near.permute(0, 2, 3, 1).numpy() == 0), dx.shape)
    assert np.all(dx[far] == 0.0)


def test_function_matches_autograd_through_plain_forward():
    x, mask, kern, bias, g = _inputs(5, 2, 11, 18, 12, 20, 3, 'rows')
    got = _port_grads(x, mask, kern, bias, g)
    xt, kt, bt = (torch.tensor(v, requires_grad=True) for v in (x, kern, bias))
    san_conv.masked_conv2d_reference(xt, torch.from_numpy(mask), kt,
                                     bt).backward(torch.from_numpy(g))
    for name, a, t in zip(('dx', 'dkernel', 'dbias'), got[1:], (xt, kt, bt)):
        _close(a, t.grad.numpy(), name)


def test_dgrad_skipped_when_input_needs_no_grad(monkeypatch):
    calls = []
    real = san_conv.masked_conv2d_dgrad

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(san_conv, 'masked_conv2d_dgrad', counting)
    args = _inputs(6, 1, 8, 16, 1, 8, 5, 'rows')
    out, dx, dkernel, dbias = _port_grads(*args, x_grad=False)
    assert dx is None and calls == []
    _close(dkernel, _jax_grads(*args)[2], 'dkernel')
    _port_grads(*args, x_grad=True)
    assert calls == [(1, 8, 16, 8)]


def test_noncontiguous_cotangent():
    x, mask, kern, bias, g = _inputs(7, 2, 9, 17, 8, 16, 3, 'rows')
    want = _port_grads(x, mask, kern, bias, g)
    xt, kt, bt = (torch.tensor(v, requires_grad=True) for v in (x, kern, bias))
    out = san_conv.masked_conv2d_fn(xt, torch.from_numpy(mask), kt, bt)
    # the NCHW fusion hands the conv a permuted cotangent
    (out.permute(0, 3, 1, 2) * torch.from_numpy(g).permute(0, 3, 1, 2)
     ).sum().backward()
    for name, a, t in zip(('dx', 'dkernel', 'dbias'), want[1:], (xt, kt, bt)):
        np.testing.assert_allclose(t.grad.numpy(), a, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_empty_mask_gives_zero_gradients():
    x, mask, kern, bias, g = _inputs(8, 1, 16, 20, 16, 16, 3, 'empty')
    out, dx, dkernel, dbias = _port_grads(x, mask, kern, bias, g)
    assert np.all(out == 0) and np.all(dx == 0)
    assert np.all(dkernel == 0) and np.all(dbias == 0)


def test_dgrad_cuda_path_raises_without_fallback():
    x, mask, kern, bias, g = (torch.from_numpy(v) for v in
                              _inputs(9, 1, 8, 8, 4, 4, 3, 'rows'))
    before = san_conv.masked_conv2d_dgrad.launches
    with pytest.raises(ValueError, match='CUDA'):
        san_conv._launch_dgrad(g, mask, kern)
    with pytest.raises(ValueError, match='CUDA'):
        san_conv.masked_conv2d_dgrad(*(t.to('meta') for t in (g, mask, kern)))
    assert san_conv.masked_conv2d_dgrad.launches == before


def test_dgrad_wrapper_checks_shapes():
    x, mask, kern, bias, g = (torch.from_numpy(v) for v in
                              _inputs(10, 1, 8, 8, 4, 6, 3, 'rows'))
    with pytest.raises(ValueError, match='channel'):
        san_conv.masked_conv2d_dgrad(g[..., :4], mask, kern)
    with pytest.raises(ValueError, match='mask'):
        san_conv.masked_conv2d_dgrad(g, mask[:, :4], kern)
    with pytest.raises(ValueError, match='k in'):
        san_conv.masked_conv2d_dgrad(g, mask, torch.zeros(7, 7, 4, 6))
