#!/usr/bin/env python3
"""
Drive the PyTorch port (packnet_sfm_tpu_torch) on one NVIDIA GPU and check
it, with nothing of JAX:

1. print the card (nvidia-smi name and power limit), the torch/CUDA
   versions, and build the CUDA kernels from the checkout's sources;
2. hold the masked-conv kernel against its plain PyTorch version at every
   shape the slice's 30 SAN convs take at 384x640 B1 (on the main path's
   own LiDAR masks) and at edge cases, in float32 (TF32 off, atol = rtol =
   1e-4) and bfloat16 (rtol 2e-2, atol 1e-2 x max|ref|: one bf16 rounding
   of the same fp32 sum), and check that an empty mask gives exact zeros;
3. run the slice: eval.main on configs/train_resnet_san_ncdb_640x384.yaml
   (ResNet18-SAN, FiLM at scale 0, bf16 convs) on the card with flip-TTA,
   with the kernel's launch count reset just before and read just after
   (30 launches per forward, 60 per flip-TTA batch); check the metrics are
   finite, and that the whole forward agrees with the same forward through
   the plain version (float32: atol 1e-5; bfloat16: atol 1e-2, on the
   sigmoid maps);
4. time eval img/s at B1 384x640, and the kernel, its plain version and
   one dense F.conv2d (the library yardstick, never called by the port) at
   each of the 30 shapes, beside the bound for the work the data needs;
5. print the kernels line, then the device line last.

Run with no arguments: `python3 chip_smoke.py`. Exits nonzero without a
card. Extra output goes to chiprun_out/chip_smoke_convs.json.
"""

import json
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12            # HBM3, H100 SXM data sheet
H100_FLOPS = {'float32': 67e12,       # CUDA cores, no tensor cores
              'bfloat16': 989e12}     # dense tensor cores
CONFIG = 'configs/train_resnet_san_ncdb_640x384.yaml'
N_EVAL_BATCHES = 3
CONVS_PER_FORWARD = 30


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, atol, rtol):
    import torch
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError('{}: {} of {} values differ, max |err| {:.3e}'
                             .format(name, int(bad.sum()), bad.numel(),
                                     float(err.max())))
    return float(err.max()) if err.numel() else 0.0


def main_path_convs(model, batch):
    """Each masked conv of one forward: (module, the mask it sees), in the
    order the forward runs them, recorded by forward hooks."""
    import torch
    from packnet_sfm_tpu_torch.networks.layers.san import _MaskedConv
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[1])))
        for m in model.modules() if isinstance(m, _MaskedConv)]
    try:
        with torch.no_grad():
            model(batch)
    finally:
        for h in hooks:
            h.remove()
    return seen


def conv_inputs(mod, mask, dtype, gen):
    """x (unit normal at active sites), the module's kernel, a random bias."""
    import torch
    B, H, W, _ = mask.shape
    k, _, cin, cout = mod.kernel.shape
    x = torch.randn(B, H, W, cin, device=mask.device, generator=gen) * mask
    bias = torch.randn(cout, device=mask.device, generator=gen) * 0.1
    return (x.to(dtype).contiguous(), mask, mod.kernel.detach().to(dtype),
            bias.to(dtype))


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch.ops.kernels import build, san_conv
    from packnet_sfm_tpu_torch.networks.layers.san import _MaskedConv
    from packnet_sfm_tpu_torch.parallel.train_step import (
        make_eval_step, make_eval_metrics_step)

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log('card:', card)
    log('torch {} cuda {} python {}'.format(
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    t0 = time.time()
    lib_path, ptxas = build.build('san_conv')
    log('kernel build: {:.1f} s -> {}'.format(time.time() - t0,
                                               os.path.relpath(lib_path)))
    for line in ptxas.splitlines():
        if 'registers' in line or 'spill' in line:
            log('  ptxas:', line.strip())
    # the comparisons below are against float32 math: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)

    config, model = port_eval.build(CONFIG, 'cuda', seed=0)
    dtype = model.depth_net.encoder.Conv_0.dtype
    dname = str(dtype).replace('torch.', '')
    shape = port_eval.image_shape(config)
    batch = port_eval.make_batches(shape, 1, 1, seed=0, device='cuda')[0]
    convs = main_path_convs(model, batch)
    if len(convs) != CONVS_PER_FORWARD:
        raise AssertionError('{} masked convs per forward, expected {}'
                             .format(len(convs), CONVS_PER_FORWARD))

    # ---------------------------------------------------------------- 2
    max_err = {'float32': 0.0, 'bfloat16': 0.0}
    cases = [(mod, mask) for mod, mask in convs]
    # edge cases: H, W not multiples of the 8x16 tile, B=2, Cin=1, k=3/5
    for k, cin, cout, B, H, W in [(3, 16, 64, 2, 13, 21), (5, 1, 64, 1, 9, 20),
                                  (5, 24, 96, 2, 17, 33), (3, 1, 1, 1, 5, 3)]:
        mod = _MaskedConv(cin, cout, k).to(dev)
        with torch.no_grad():
            mod.kernel.normal_(0.0, 0.1, generator=gen)
        mask = (torch.rand(B, H, W, 1, device=dev, generator=gen) < 0.3).float()
        mask[:, :H // 3] = 0.0
        cases.append((mod, mask))
    for i, (mod, mask) in enumerate(cases):
        for dt in (torch.float32, torch.bfloat16):
            args = conv_inputs(mod, mask, dt, gen)
            got = san_conv.masked_conv2d(*args)
            torch.cuda.synchronize()
            want = san_conv.masked_conv2d_reference(*args)
            name = 'conv {} {} {}'.format(i, tuple(args[0].shape[1:]),
                                          tuple(args[2].shape))
            if dt == torch.float32:
                err = check_close(name, got, want, 1e-4, 1e-4)
            else:
                err = check_close(name, got, want,
                                  1e-2 * float(want.float().abs().max()), 2e-2)
            key = str(dt).replace('torch.', '')
            max_err[key] = max(max_err[key], err)
            if bool((got[(mask[..., 0] == 0)] != 0).any()):
                raise AssertionError(name + ': nonzero output at an '
                                     'inactive site')
        empty = conv_inputs(mod, torch.zeros_like(mask), torch.float32, gen)
        out = san_conv.masked_conv2d(*empty)
        torch.cuda.synchronize()
        if bool((out != 0).any()):
            raise AssertionError('empty mask: nonzero output')
    log('kernel vs plain: {} cases x fp32/bf16 ok, max |err| fp32 {:.3e} '
        'bf16 {:.3e}'.format(len(cases), max_err['float32'],
                             max_err['bfloat16']))

    # ---------------------------------------------------------------- 3
    san_conv.masked_conv2d.launches = 0
    flat = port_eval.main(CONFIG, device='cuda', batch_size=1,
                          n_batches=N_EVAL_BATCHES, seed=0,
                          overrides=['model.params.flip_tta', True])
    torch.cuda.synchronize()
    launches = san_conv.masked_conv2d.launches
    want_launches = 2 * CONVS_PER_FORWARD * N_EVAL_BATCHES
    if launches != want_launches:
        raise AssertionError('main path launched the kernel {} times, '
                             'expected {}'.format(launches, want_launches))
    if len(flat) != 6 * 7 + 1 or not all(np.isfinite(v)
                                         for v in flat.values()):
        raise AssertionError('metrics not finite: {}'.format(flat))
    log('eval.main: {} batches flip-TTA, {} kernel launches, depth-abs_rel '
        '{:.4f}'.format(N_EVAL_BATCHES, launches, flat['depth-abs_rel']))

    fwd_err = {}
    for dt_name, overrides in (('float32', ['tpu.compute_dtype', 'float32']),
                               (dname, None)):
        _, m = port_eval.build(CONFIG, 'cuda', seed=0, overrides=overrides)
        with torch.no_grad():
            got = m(batch)['inv_depths'][0]
            kernel_fn = san_conv.masked_conv2d
            san_conv.masked_conv2d = san_conv.masked_conv2d_reference
            try:
                want = m(batch)['inv_depths'][0]
            finally:
                san_conv.masked_conv2d = kernel_fn
        torch.cuda.synchronize()
        atol = 1e-5 if dt_name == 'float32' else 1e-2
        fwd_err[dt_name] = check_close('forward ' + dt_name, got, want,
                                       atol, 0.0)
        if not bool(torch.isfinite(got).all()) or got.shape != (1,) + tuple(
                shape) + (1,):
            raise AssertionError('forward output {} not finite or of the '
                                 'wrong shape'.format(tuple(got.shape)))
        del m
    log('forward kernel vs plain: max |err| on sigmoids {}'.format(
        {k: float('{:.3e}'.format(v)) for k, v in fwd_err.items()}))

    # ---------------------------------------------------------------- 4
    step = make_eval_step(model)
    fwd_ms = cuda_time_ms(lambda: step(batch), iters=20)
    log('eval forward B1 {}x{} {}: {:.3f} ms, {:.2f} img/s'.format(
        shape[0], shape[1], dname, fwd_ms, 1e3 / fwd_ms))
    mstep = make_eval_metrics_step(model, config.model.params, flip_tta=True)
    tta_ms = cuda_time_ms(lambda: mstep(batch), iters=10)
    log('eval protocol step (flip-TTA + 6x7 metrics) B1: {:.3f} ms, {:.2f} '
        'img/s'.format(tta_ms, 1e3 / tta_ms))

    import torch.nn.functional as F
    rows, tot = [], {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
                     'bound_ms': 0.0, 'bytes_ms': 0.0, 'ops_ms': 0.0}
    esize = torch.tensor([], dtype=dtype).element_size()
    for i, (mod, mask) in enumerate(convs):
        x, mk, kern, bias = conv_inputs(mod, mask, dtype, gen)
        k, _, cin, cout = kern.shape
        B, H, W, _ = x.shape
        x_cl = x.permute(0, 3, 1, 2)          # NCHW view, channels-last memory
        w_oihw = kern.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        m_nchw = mk.permute(0, 3, 1, 2)
        with torch.no_grad():
            ms = cuda_time_ms(lambda: san_conv._launch(x, mk, kern, bias))
            plain = cuda_time_ms(
                lambda: san_conv.masked_conv2d_reference(x, mk, kern, bias))
            lib = cuda_time_ms(
                lambda: F.conv2d(x_cl, w_oihw, bias, padding=k // 2) * m_nchw)
        active = int((mk > 0).sum())
        tiles = (F.max_pool2d(F.pad(mk[..., 0][:, None], (
            0, -W % 16, 0, -H % 8)), (8, 16), (8, 16)) > 0).float().mean()
        # x is read only in the rows within k//2 of an active output row
        row_active = (mk[..., 0] > 0).any(dim=2).float()[:, None]
        x_rows = int((F.max_pool1d(row_active, k, 1, k // 2) > 0).sum())
        nbytes = (x_rows * W * cin + kern.numel() + bias.numel() +
                  B * H * W * cout) * esize + mk.numel() * 4
        flops = 2.0 * k * k * cin * cout * active
        b_ms = nbytes / H100_BYTES_PER_S * 1e3
        o_ms = flops / H100_FLOPS[dname] * 1e3
        row = {'conv': i, 'B': B, 'H': H, 'W': W, 'k': int(k),
               'cin': int(cin), 'cout': int(cout), 'dtype': dname,
               'active_sites': active, 'active_site_frac':
               active / (B * H * W), 'active_tile_frac': float(tiles),
               'ms': ms, 'plain_ms': plain, 'library_ms': lib,
               'bound_ms': max(b_ms, o_ms),
               'bound_by': 'bytes' if b_ms > o_ms else 'operations'}
        rows.append(row)
        for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms'):
            tot[key] += row[key]
        tot['bytes_ms'] += b_ms
        tot['ops_ms'] += o_ms
        log('conv {:2d} {}x{} k{} {:4d}->{:4d} sites {:.3f} tiles {:.3f}: '
            'kernel {:.4f} ms plain {:.4f} library {:.4f} bound {:.4f} ({})'
            .format(i, H, W, k, cin, cout, row['active_site_frac'],
                    row['active_tile_frac'], ms, plain, lib, row['bound_ms'],
                    row['bound_by']))
    log('30 convs of one forward: kernel {:.3f} ms, plain {:.3f}, library '
        '{:.3f}, bound {:.4f} ms'.format(tot['ms'], tot['plain_ms'],
                                         tot['library_ms'], tot['bound_ms']))
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/chip_smoke_convs.json', 'w') as f:
        json.dump({'card': card, 'torch': torch.__version__,
                   'forward_ms': fwd_ms, 'flip_tta_step_ms': tta_ms,
                   'fwd_err': fwd_err, 'max_err': max_err, 'convs': rows},
                  f, indent=1)

    # ---------------------------------------------------------------- 5
    log(json.dumps({'kernels': [{
        'name': 'san_masked_conv2d', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/san_conv.cu',
        'replaces': 'packnet_sfm_tpu/ops/pallas/san_conv.py:53',
        'launches': launches, 'max_abs_err': max_err['float32'],
        'max_abs_err_bf16': max_err['bfloat16'],
        'timed_as': '30 launches of one B1 384x640 forward, {}'.format(dname),
        'ms': tot['ms'], 'plain_ms': tot['plain_ms'],
        'bound_ms': tot['bound_ms'],
        'bound_by': 'bytes' if tot['bytes_ms'] > tot['ops_ms']
        else 'operations',
        'library_ms': tot['library_ms']}]}))
    log(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
