"""
The generic camera's softmax patch projection and its analytic gradient,
with the semantics of the JAX package's ops/pallas/generic_projection.py:

    generic_projection_fwd(ray_p, d_p, p) -> (rows, cols, m, s)

ray_p, d_p [B,3,H,W] float32 (NCHW): the ray plane and the unit directions
already divided by the softmax temperature. Each pixel matches its
direction against the rays of its (2p+1)^2 window (shifted into the image,
`window_starts`) and returns the softmax-expected window (row, col), plus
the final running max m and normaliser s of the online softmax, [B,H,W]
float32. `generic_projection_bwd` takes those residuals and the cotangents
gy, gx of rows and cols and returns (dray, dd) [B,3,H,W]:

    glogit_k = p_k * (gy * (row_k - rows) + gx * (col_k - cols)),
    dd = sum_k glogit_k * (g_k - g_c),   dray[window position k] += glogit_k * d,

with g_c the ray at the window's centre: the glogit_k sum to zero, so this
is the JAX kernel's sum_k glogit_k g_k, without its cancellation over
nearly parallel rays (which puts the kernel's dd outside JAX's own
cross-formulation limits of the exact gradient at the generic step's
192x192 plane; see csrc/generic_projection.cu).

The hand-written Hopper kernels are in
`packnet_sfm_tpu_torch/csrc/generic_projection.cu`; they replace the Pallas
`_proj_kernel` and `_proj_bwd_kernel`. A backward call is one launch
whose blocks each take a dray tile (ray-major) or a dd tile (pixel-major);
no atomics. The kernels stage a pixel tile's window rays in shared memory,
which bounds the window at p <= 66 on planes wider than 2p + 9
(`staged_bytes`); the wrappers raise beyond it, on any device. On CPU
tensors the wrappers run the plain versions,
`generic_projection_fwd_reference` (the JAX package's XLA twin
`_expected_xla`: the online softmax streamed over window rows, with the
logits summed in the kernel's order) and
`generic_projection_bwd_reference` (the kernel's formula as tensor ops over
the same residuals); there is no other fall back. Each wrapper counts its
calls that reach the card in its `launches` attribute.

`expected_patch_coords_fn(ray_p, d_p, p)` -> (rows, cols) is the
differentiable op: `ExpectedPatchCoordsFunction` (the JAX custom VJP) on
CUDA tensors, the plain forward under autograd on CPU tensors.
`expected_patch_coords_reference` is the plain forward under plain autograd
on any device.
"""

import numpy as np
import torch

from packnet_sfm_tpu_torch.ops.kernels import build


def window_starts(n, p):
    """Per-pixel window start along one axis (numpy): clip(c - p, 0, n - k1)
    with k1 = 2p + 1, which goes negative iff k1 > n."""
    k1 = 2 * p + 1
    s = np.maximum(np.arange(n) - p, 0)
    return (s - np.maximum(s + k1 - n, 0)).astype(np.int64)


def _windows(H, W, p, device):
    """Window starts of the rows [H] and the window columns [W, k1]."""
    sy = torch.as_tensor(window_starts(H, p), device=device)
    sx = torch.as_tensor(window_starts(W, p), device=device)
    cols = sx[:, None] + torch.arange(2 * p + 1, device=device)[None]
    return sy, cols


def _window_row(ray_p, r, cols):
    """The rays of window row r of every pixel: ray_p[b, :, r[y], cols[x, j]]
    as three [B,H,W,k1] planes."""
    g = ray_p[:, :, r][:, :, :, cols]
    return g[:, 0], g[:, 1], g[:, 2]


def _logits(d_p, g0, g1, g2):
    """d0*g0 + d1*g1 + d2*g2 summed left to right, as the kernels sum."""
    return (d_p[:, 0, ..., None] * g0 + d_p[:, 1, ..., None] * g1
            + d_p[:, 2, ..., None] * g2)


def generic_projection_fwd_reference(ray_p, d_p, p):
    """Plain PyTorch version of the forward: (rows, cols, m, s) [B,H,W] by
    the online softmax over window rows (the XLA twin's recurrence, m from
    -inf). Differentiable."""
    B, _, H, W = ray_p.shape
    sy, cols = _windows(H, W, p, ray_p.device)
    colf = cols.to(ray_p.dtype)
    m = torch.full((B, H, W), -float('inf'), dtype=ray_p.dtype,
                   device=ray_p.device)
    s = ey = ex = torch.zeros_like(m)
    for i in range(2 * p + 1):
        r = sy + i
        logits = _logits(d_p, *_window_row(ray_p, r, cols))
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(logits - m_new[..., None])
        psum = pexp.sum(-1)
        s = s * alpha + psum
        ey = ey * alpha + r.to(ray_p.dtype)[None, :, None] * psum
        ex = ex * alpha + (pexp * colf).sum(-1)
        m = m_new
    return ey / s, ex / s, m, s


def generic_projection_bwd_reference(ray_p, d_p, rows, cols, m, s, gy, gx,
                                     p):
    """Plain PyTorch version of the backward: (dray, dd) [B,3,H,W], the
    kernels' formula over the saved residuals, one window row at a time
    (dray by index_add_ into the window positions)."""
    B, _, H, W = ray_p.shape
    sy, wcols = _windows(H, W, p, ray_p.device)
    colf = wcols.to(ray_p.dtype)
    centre = ray_p[:, :, sy + p][:, :, :, wcols[:, p]]          # [B,3,H,W]
    dd = torch.zeros_like(d_p)
    dray = torch.zeros(B, 3, H * W, dtype=ray_p.dtype, device=ray_p.device)
    for i in range(2 * p + 1):
        r = sy + i
        g = _window_row(ray_p, r, wcols)
        pk = torch.exp(_logits(d_p, *g) - m[..., None]) / s[..., None]
        gy_row = gy * (r.to(ray_p.dtype)[None, :, None] - rows)
        gl = pk * (gy_row[..., None] + gx[..., None] * (colf - cols[..., None]))
        idx = (r[:, None, None] * W + wcols[None]).reshape(-1)   # [H*W*k1]
        for c in range(3):
            dd[:, c] += (gl * (g[c] - centre[:, c, ..., None])).sum(-1)
            dray[:, c].index_add_(1, idx, (gl * d_p[:, c, ..., None]
                                           ).reshape(B, -1))
    return dray.reshape(B, 3, H, W), dd


def _check(ray_p, d_p, p, residuals=()):
    if ray_p.dim() != 4 or ray_p.shape[1] != 3 or d_p.shape != ray_p.shape:
        raise ValueError('the generic projection expects ray_p, d_p '
                         '[B,3,H,W] of one shape, got {} and {}'.format(
                             tuple(ray_p.shape), tuple(d_p.shape)))
    B, _, H, W = ray_p.shape
    if any(tuple(t.shape) != (B, H, W) for t in residuals):
        raise ValueError('the residuals and cotangents must be [B,H,W] = {}'
                         .format((B, H, W)))
    tensors = (ray_p, d_p) + tuple(residuals)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError('the generic projection takes float32 tensors')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('the generic projection needs contiguous tensors')
    if len({t.device for t in tensors}) != 1:
        raise ValueError('the generic projection needs tensors on one device')
    k1 = 2 * int(p) + 1
    if p < 0 or k1 > H or k1 > W:
        raise ValueError('the projection window 2p+1 = {} must fit the '
                         '{}x{} image (patch_side {}): project at a larger '
                         'resolution or with a smaller patch'.format(
                             k1, H, W, p))
    need = max(staged_bytes(H, W, p))
    if need > MAX_SMEM:
        raise ValueError('the projection window 2p+1 = {} needs {} bytes of '
                         'shared memory for the kernels\' staged rays, above '
                         "the card's {} (patch_side {} > 66)".format(
                             k1, need, MAX_SMEM, p))


# the kernels' shared memory (csrc/generic_projection.cu `layout`): the rays
# of the forward's 4x8 pixel tile's windows, (k1 + 3) x (k1 + 7) x 12
# bytes; of dd's 4x4 tile, (k1 + 3)^2 x 12 with the row stride padded for
# banks; 8 pixel rows of an 8-column ray tile's pixel range x 36
MAX_SMEM = 232448


def staged_bytes(H, W, p):
    """(forward rays, dd rays, dray pixel band) shared memory bytes of the
    kernels at an H x W plane and window p, as `layout` in the CUDA source
    sizes them."""
    k1 = 2 * p + 1
    rh, ncols, h = min(3 + k1, H), min(3 + k1, W), (k1 + 1) // 2
    rw = next((w for w in range(ncols, ncols + 32)
               if 7 <= (h * w) % 32 <= 25), ncols)
    pw = max(_phi(min(c0 + 7, W - 1), p, W) - _plo(c0, p) + 1
             for c0 in range(0, W, 8))
    return rh * min(7 + k1, W) * 12, rh * rw * 12, 8 * pw * 36


def _plo(c, p):
    return 0 if c <= 2 * p else c - p


def _phi(c, p, n):
    return n - 1 if c >= n - (2 * p + 1) else c + p


def _launch_fwd(ray_p, d_p, p):
    B, _, H, W = ray_p.shape
    rows, cols, m, s = (torch.empty((B, H, W), dtype=torch.float32,
                                    device=ray_p.device) for _ in range(4))
    fn = build.function('generic_projection', 'generic_projection_fwd', 6, 4)
    with torch.cuda.device(ray_p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ray_p.data_ptr(), d_p.data_ptr(), rows.data_ptr(),
                cols.data_ptr(), m.data_ptr(), s.data_ptr(), B, H, W, p,
                stream)
    if rc != 0:
        raise RuntimeError('generic_projection_fwd launch failed: cudaError '
                           '{}'.format(rc))
    generic_projection_fwd.launches += 1
    return rows, cols, m, s


def _launch_bwd(ray_p, d_p, rows, cols, m, s, gy, gx, p):
    B, _, H, W = ray_p.shape
    dray, dd = torch.empty_like(ray_p), torch.empty_like(d_p)
    fn = build.function('generic_projection', 'generic_projection_bwd', 10, 4)
    with torch.cuda.device(ray_p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ray_p.data_ptr(), d_p.data_ptr(), rows.data_ptr(),
                cols.data_ptr(), m.data_ptr(), s.data_ptr(), gy.data_ptr(),
                gx.data_ptr(), dray.data_ptr(), dd.data_ptr(), B, H, W, p,
                stream)
    if rc != 0:
        raise RuntimeError('generic_projection_bwd launch failed: cudaError '
                           '{}'.format(rc))
    generic_projection_bwd.launches += 1
    return dray, dd


def generic_projection_fwd(ray_p, d_p, p):
    """(rows, cols, m, s) [B,H,W], without autograd. CUDA tensors go to the
    Hopper kernel (counted in `generic_projection_fwd.launches`); CPU
    tensors to the plain version."""
    p = int(p)
    _check(ray_p, d_p, p)
    if ray_p.device.type == 'cpu':
        with torch.no_grad():
            return generic_projection_fwd_reference(ray_p, d_p, p)
    return _launch_fwd(ray_p, d_p, p)


def generic_projection_bwd(ray_p, d_p, rows, cols, m, s, gy, gx, p):
    """(dray, dd) [B,3,H,W] from the forward's residuals and the cotangents
    gy, gx of rows and cols. CUDA tensors go to the Hopper kernels (one
    call, one launch, counted in `generic_projection_bwd.launches`);
    CPU tensors to the plain version."""
    p = int(p)
    _check(ray_p, d_p, p, (rows, cols, m, s, gy, gx))
    if ray_p.device.type == 'cpu':
        return generic_projection_bwd_reference(ray_p, d_p, rows, cols, m, s,
                                                gy, gx, p)
    return _launch_bwd(ray_p, d_p, rows, cols, m, s, gy, gx, p)


generic_projection_fwd.launches = 0
generic_projection_bwd.launches = 0


class ExpectedPatchCoordsFunction(torch.autograd.Function):
    """(rows, cols) under autograd, as the JAX `expected_patch_coords`
    custom VJP: forward by `generic_projection_fwd`, which also gives the
    residuals m and s, and both cotangents by `generic_projection_bwd`."""

    @staticmethod
    def forward(ctx, ray_p, d_p, p):
        rows, cols, m, s = generic_projection_fwd(ray_p, d_p, p)
        ctx.p = p
        ctx.save_for_backward(ray_p, d_p, rows, cols, m, s)
        return rows, cols

    @staticmethod
    def backward(ctx, gy, gx):
        ray_p, d_p, rows, cols, m, s = ctx.saved_tensors
        # a cotangent may come expanded (a mean's gradient) or be None
        gy = torch.zeros_like(rows) if gy is None else gy.float().contiguous()
        gx = torch.zeros_like(cols) if gx is None else gx.float().contiguous()
        dray, dd = generic_projection_bwd(ray_p, d_p, rows, cols, m, s, gy,
                                          gx, ctx.p)
        return dray, dd, None


def expected_patch_coords_reference(ray_p, d_p, p):
    """(rows, cols) through the plain forward under plain autograd."""
    _check(ray_p, d_p, int(p))
    return generic_projection_fwd_reference(ray_p, d_p, int(p))[:2]


def expected_patch_coords_fn(ray_p, d_p, p):
    """Differentiable expected window (rows, cols) [B,H,W]: through the
    kernels' Function on CUDA tensors, the plain forward under autograd on
    CPU tensors."""
    if ray_p.device.type == 'cpu':
        return expected_patch_coords_reference(ray_p, d_p, p)
    return ExpectedPatchCoordsFunction.apply(ray_p, d_p, int(p))
