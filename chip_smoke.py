#!/usr/bin/env python3
"""
Drive the PyTorch port (packnet_sfm_tpu_torch) on one NVIDIA GPU and check
it, with nothing of JAX:

1. print the card (nvidia-smi name and power limit), the torch/CUDA
   versions, and build the CUDA kernels from the checkout's sources;
2. hold the masked-conv forward kernel against its plain PyTorch version at
   every shape the slice's 30 SAN convs take at 384x640 B1 (on the eval
   path's own LiDAR masks) and at edge cases, in float32 (TF32 off, atol =
   rtol = 1e-4) and bfloat16 (rtol 2e-2, atol 1e-2 x max|ref|: one bf16
   rounding of the same fp32 sum), and check that an empty mask gives exact
   zeros; then (a) the dgrad kernel against its plain version at every
   shape the training step's 27 dgrad launches take at B8 384x640 (on that
   batch's own LiDAR masks) and at edge cases, under the same rules, with
   exact zeros wherever no site within the halo is active and on an empty
   mask, and (b) the whole autograd Function (forward kernel, dgrad kernel,
   dW/db) against plain autograd through the plain forward (F.conv2d's own
   backward), on dx, dW and db in float32 and in bfloat16;
3. run the eval path: eval.main on configs/train_resnet_san_ncdb_640x384.yaml
   (ResNet18-SAN, FiLM at scale 0, bf16 convs) with flip-TTA, with the
   launch counts reset just before and read just after (30 forward
   launches per forward), the metrics finite, and the whole forward against
   the same forward through the plain version (float32 atol 1e-5, bfloat16
   atol 1e-2 on the sigmoid maps); then (c) the training path: train.main
   on the same YAML at its B8 384x640 bf16, the counts reset just before and
   read just after each run (30 forward and 27 dgrad launches per step), 4
   steps over two batches, then 10 steps on one batch with the last loss
   below the first, every loss finite and no step skipped by the guard; and
   one float32 step's loss and gradients through the kernels against the
   same step through the plain forward under plain autograd;
4. (d) time eval img/s at B1 and the train step and img/s at B8, the
   forward kernel at the eval shapes and both kernels at the train shapes
   beside their plain versions, the library yardstick (one cuDNN call the
   port never makes: F.conv2d, torch.nn.grad.conv2d_input) and the bound
   for the work the data needs, and the dW library time per step;
5. (e) print the kernels line with both kernels, then the device line last.

Run with no arguments: `python3 chip_smoke.py`. Exits nonzero without a
card. Extra output goes to chiprun_out/chip_smoke_convs.json.
"""

import contextlib
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
DGRADS_PER_STEP = 27                  # the 3 Cin=1 convs read the LiDAR
TRAIN_RUNS = ((4, 2), (10, 1))        # (steps, batches) of the two runs
# one float32 step through the kernels vs through the plain versions:
# loss rtol; per gradient leaf max|g - g_plain| / max|g_plain| and the same
# in the Frobenius norm (leaves whose plain gradient is below 1e-6 x the
# largest leaf's are zero analytically, the conv biases that feed a BN, and
# are held to that floor). Float32 sums in another order flip ReLU and
# max-pool decisions near ties, which moves single gradient entries.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-1
TRAIN_GRAD_NORM = 2e-2


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


def check_kernel(name, got, want, dtype):
    """The comparison rule of both kernels: fp32 atol = rtol = 1e-4; bf16
    one rounding of the same fp32 sum (rtol 2e-2, atol 1e-2 x max|ref|)."""
    import torch
    if dtype == torch.float32:
        return check_close(name, got, want, 1e-4, 1e-4)
    return check_close(name, got, want,
                       1e-2 * float(want.float().abs().max()), 2e-2)


@contextlib.contextmanager
def plain_versions():
    """Run every masked conv as the plain forward under plain autograd
    (F.conv2d and its own backward): no kernel and no autograd Function,
    so dx, dW and db all come from other code than the port's (the SAN
    layer looks `masked_conv2d_fn` up at call time)."""
    from packnet_sfm_tpu_torch.ops.kernels import san_conv
    saved = san_conv.masked_conv2d_fn
    san_conv.masked_conv2d_fn = san_conv.masked_conv2d_reference
    try:
        yield
    finally:
        san_conv.masked_conv2d_fn = saved


def path_convs(model, batch, train=False):
    """Each masked conv of one forward: (module, the mask it sees, whether
    its input needs a gradient), in the order the forward runs them,
    recorded by forward hooks."""
    import torch
    from packnet_sfm_tpu_torch.networks.layers.san import _MaskedConv
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[1],
                                            args[0].requires_grad)))
        for m in model.modules() if isinstance(m, _MaskedConv)]
    try:
        with torch.set_grad_enabled(train):
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


def dgrad_inputs(mod, mask, dtype, gen):
    """gm = unit normal times the mask, the module's kernel."""
    import torch
    B, H, W, _ = mask.shape
    cout = mod.kernel.shape[3]
    gm = torch.randn(B, H, W, cout, device=mask.device, generator=gen) * mask
    return gm.to(dtype).contiguous(), mask, mod.kernel.detach().to(dtype)


def halo_empty(mask, k):
    """[B,H,W,1] True where no site within k//2 is active."""
    import torch.nn.functional as F
    near = F.max_pool2d(mask.permute(0, 3, 1, 2), k, 1, k // 2)
    return near.permute(0, 2, 3, 1) == 0


def edge_modules(dev, gen):
    """Edge cases: H, W not multiples of the 8x16 tile, B=2, Cin=1, narrow
    channels (16, 24), k=3/5; masks empty above a third of the height."""
    import torch
    from packnet_sfm_tpu_torch.networks.layers.san import _MaskedConv
    cases = []
    for k, cin, cout, B, H, W in [(3, 16, 64, 2, 13, 21), (5, 1, 64, 1, 9, 20),
                                  (5, 24, 96, 2, 17, 33), (3, 1, 1, 1, 5, 3),
                                  (3, 24, 16, 2, 19, 35)]:
        mod = _MaskedConv(cin, cout, k).to(dev)
        with torch.no_grad():
            mod.kernel.normal_(0.0, 0.1, generator=gen)
        mask = (torch.rand(B, H, W, 1, device=dev, generator=gen) < 0.3).float()
        mask[:, :H // 3] = 0.0
        cases.append((mod, mask))
    return cases


def site_stats(mask, k):
    """Active sites, active-row count (rows a kernel must read), the share
    of 8x16 tiles with an active site, for the bound and the tables."""
    import torch.nn.functional as F
    B, H, W, _ = mask.shape
    m = mask[..., 0]
    active = int((m > 0).sum())
    tiles = (F.max_pool2d(F.pad(m[:, None], (0, -W % 16, 0, -H % 8)),
                          (8, 16), (8, 16)) > 0).float().mean()
    row_active = (m > 0).any(dim=2).float()[:, None]
    halo_rows = int((F.max_pool1d(row_active, k, 1, k // 2) > 0).sum())
    return active, int(row_active.sum()), halo_rows, float(tiles)


def compare_grads(got, want):
    """(max over leaves of max|err| / max|want|, the leaf where it is, max
    over leaves of |err| / |want| in the Frobenius norm, max|err| of the
    leaves that are zero analytically over the largest gradient). A leaf
    whose gradient is below 1e-6 x the largest leaf's counts as zero."""
    gmax = max(float(g.abs().max()) for g in want.values())
    rel, worst, norm, zero = 0.0, '', 0.0, 0.0
    for n, w in want.items():
        scale = float(w.abs().max())
        err = float((got[n] - w).abs().max())
        if scale > 1e-6 * gmax:
            norm = max(norm, float((got[n] - w).norm() / w.norm()))
            if err / scale > rel:
                rel, worst = err / scale, n
        else:
            zero = max(zero, err / gmax)
    return rel, worst, norm, zero


def bound(nbytes, flops, dname):
    b_ms = nbytes / H100_BYTES_PER_S * 1e3
    o_ms = flops / H100_FLOPS[dname] * 1e3
    return max(b_ms, o_ms), b_ms, o_ms


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch.nn.functional as F
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.ops.kernels import build, san_conv
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
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            log('  ptxas:', line.strip())
    # the comparisons below are against float32 math: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    counts = {'fwd': 0, 'dgrad': 0}

    def reset_counts():
        san_conv.masked_conv2d.launches = 0
        san_conv.masked_conv2d_dgrad.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return (san_conv.masked_conv2d.launches,
                san_conv.masked_conv2d_dgrad.launches)

    config, model = port_eval.build(CONFIG, 'cuda', seed=0)
    dtype = model.depth_net.encoder.Conv_0.dtype
    dname = str(dtype).replace('torch.', '')
    shape = port_eval.image_shape(config)
    batch = port_eval.make_batches(shape, 1, 1, seed=0, device='cuda')[0]
    convs = [(mod, mask) for mod, mask, _ in path_convs(model, batch)]
    if len(convs) != CONVS_PER_FORWARD:
        raise AssertionError('{} masked convs per forward, expected {}'
                             .format(len(convs), CONVS_PER_FORWARD))
    train_bs = int(config.datasets.train.batch_size)
    _, tmodel = port_train.build(CONFIG, 'cuda', seed=0)
    tbatch = port_eval.make_batches(shape, train_bs, 1, seed=0,
                                    device='cuda')[0]
    tconvs = path_convs(tmodel, tbatch, train=True)
    dconvs = [(mod, mask) for mod, mask, needs in tconvs if needs]
    del tmodel
    if len(tconvs) != CONVS_PER_FORWARD or len(dconvs) != DGRADS_PER_STEP:
        raise AssertionError('train forward: {} masked convs, {} with an '
                             'input gradient; expected {} and {}'.format(
                                 len(tconvs), len(dconvs), CONVS_PER_FORWARD,
                                 DGRADS_PER_STEP))

    # ---------------------------------------------------------------- 2
    max_err = {'float32': 0.0, 'bfloat16': 0.0}
    cases = convs + edge_modules(dev, gen)
    for i, (mod, mask) in enumerate(cases):
        for dt in (torch.float32, torch.bfloat16):
            args = conv_inputs(mod, mask, dt, gen)
            got = san_conv.masked_conv2d(*args)
            torch.cuda.synchronize()
            want = san_conv.masked_conv2d_reference(*args)
            name = 'conv {} {} {}'.format(i, tuple(args[0].shape[1:]),
                                          tuple(args[2].shape))
            key = str(dt).replace('torch.', '')
            max_err[key] = max(max_err[key], check_kernel(name, got, want, dt))
            if bool((got[(mask[..., 0] == 0)] != 0).any()):
                raise AssertionError(name + ': nonzero output at an '
                                     'inactive site')
        empty = conv_inputs(mod, torch.zeros_like(mask), torch.float32, gen)
        out = san_conv.masked_conv2d(*empty)
        torch.cuda.synchronize()
        if bool((out != 0).any()):
            raise AssertionError('empty mask: nonzero output')
    log('forward kernel vs plain: {} cases x fp32/bf16 ok, max |err| fp32 '
        '{:.3e} bf16 {:.3e}'.format(len(cases), max_err['float32'],
                                    max_err['bfloat16']))

    # (a) the dgrad kernel at the train step's shapes and the edge cases
    dmax_err = {'float32': 0.0, 'bfloat16': 0.0}
    dcases = dconvs + edge_modules(dev, gen)
    for i, (mod, mask) in enumerate(dcases):
        k = mod.kernel.shape[0]
        far = halo_empty(mask, k)
        for dt in (torch.float32, torch.bfloat16):
            gm, mk, kern = dgrad_inputs(mod, mask, dt, gen)
            got = san_conv.masked_conv2d_dgrad(gm, mk, kern)
            torch.cuda.synchronize()
            want = san_conv.masked_conv2d_dgrad_reference(gm, mk, kern)
            name = 'dgrad {} {} {}'.format(i, tuple(gm.shape),
                                           tuple(kern.shape))
            key = str(dt).replace('torch.', '')
            dmax_err[key] = max(dmax_err[key],
                                check_kernel(name, got, want, dt))
            if bool((got[far.expand_as(got)] != 0).any()):
                raise AssertionError(name + ': nonzero dx where no site '
                                     'within the halo is active')
        gm, mk, kern = dgrad_inputs(mod, torch.zeros_like(mask),
                                    torch.float32, gen)
        out = san_conv.masked_conv2d_dgrad(gm, mk, kern)
        torch.cuda.synchronize()
        if bool((out != 0).any()):
            raise AssertionError('dgrad, empty mask: nonzero dx')
    log('dgrad kernel vs plain: {} cases x fp32/bf16 ok, max |err| fp32 '
        '{:.3e} bf16 {:.3e}'.format(len(dcases), dmax_err['float32'],
                                    dmax_err['bfloat16']))

    # (b) the autograd Function (forward kernel, dgrad kernel, dW / db)
    # against plain autograd through the plain forward (fp32 math, one cast
    # at the end): float32 atol 1e-4 x max|ref|, rtol 1e-4; bfloat16 the
    # kernels' rule (rtol 2e-2, atol 1e-2 x max|ref|)
    fn_err = {}                 # 'dtype grad' -> max |err| / max|ref|
    for mod, mask in [dconvs[3], dconvs[14], dconvs[-1]] + edge_modules(
            dev, gen)[:1]:
        for dt in (torch.float32, torch.bfloat16):
            x, mk, kern, bias = conv_inputs(mod, mask, dt, gen)
            g = torch.randn(mask.shape[:3] + (kern.shape[3],), device=dev,
                            generator=gen).to(dt)
            grads = []
            for fn in (san_conv.masked_conv2d_fn,
                       san_conv.masked_conv2d_reference):
                leaves = [t.clone().requires_grad_(True)
                          for t in (x, kern, bias)]
                fn(leaves[0], mk, leaves[1], leaves[2]).backward(g)
                grads.append([t.grad for t in leaves])
            for nm, a, b in zip(('dx', 'dW', 'db'), *grads):
                key = '{} {}'.format(str(dt).replace('torch.', ''), nm)
                name = 'Function {} {}'.format(key, tuple(kern.shape))
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError('{}: {} {} against {} {}'.format(
                        name, a.dtype, tuple(a.shape), b.dtype,
                        tuple(b.shape)))
                if dt == torch.float32:
                    err = check_close(name, a, b, 1e-4 * float(
                        b.abs().max()), 1e-4)
                else:
                    err = check_kernel(name, a, b, dt)
                fn_err[key] = max(fn_err.get(key, 0.0),
                                  err / max(float(b.abs().max()), 1e-30))
    torch.cuda.synchronize()
    log('autograd Function vs plain autograd, max |err| / max|ref|: ' +
        ', '.join('{} {:.3e}'.format(k, v) for k, v in fn_err.items()))

    # ---------------------------------------------------------------- 3
    reset_counts()
    flat = port_eval.main(CONFIG, device='cuda', batch_size=1,
                          n_batches=N_EVAL_BATCHES, seed=0,
                          overrides=['model.params.flip_tta', True])
    eval_launches, eval_dgrads = read_counts()
    want_launches = 2 * CONVS_PER_FORWARD * N_EVAL_BATCHES
    if (eval_launches, eval_dgrads) != (want_launches, 0):
        raise AssertionError('eval path launched the kernels {} / {} times, '
                             'expected {} / 0'.format(
                                 eval_launches, eval_dgrads, want_launches))
    if len(flat) != 6 * 7 + 1 or not all(np.isfinite(v)
                                         for v in flat.values()):
        raise AssertionError('metrics not finite: {}'.format(flat))
    log('eval.main: {} batches flip-TTA, {} kernel launches, depth-abs_rel '
        '{:.4f}'.format(N_EVAL_BATCHES, eval_launches, flat['depth-abs_rel']))

    fwd_err = {}
    for dt_name, overrides in (('float32', ['tpu.compute_dtype', 'float32']),
                               (dname, None)):
        _, m = port_eval.build(CONFIG, 'cuda', seed=0, overrides=overrides)
        with torch.no_grad():
            got = m(batch)['inv_depths'][0]
            with plain_versions():
                want = m(batch)['inv_depths'][0]
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

    # (c) the training path
    train_runs = []
    for n_steps, n_batches in TRAIN_RUNS:
        reset_counts()
        t0 = time.time()
        run = port_train.main(CONFIG, device='cuda', n_steps=n_steps,
                              n_batches=n_batches, seed=0)
        launches = read_counts()
        wall = time.time() - t0
        losses = run['losses']
        want = (CONVS_PER_FORWARD * n_steps, DGRADS_PER_STEP * n_steps)
        if launches != want:
            raise AssertionError('train path ({} steps) launched the kernels '
                                 '{} times (forward, dgrad), expected {}'
                                 .format(n_steps, launches, want))
        if not all(np.isfinite(losses)) or \
                run['trainer'].optimizer.count != n_steps:
            raise AssertionError('train path: non-finite loss or a step '
                                 'skipped: {}'.format(losses))
        if run['batches'][0]['rgb'].shape != (train_bs,) + tuple(shape) + (3,):
            raise AssertionError('train batch of the wrong shape')
        counts['fwd'] += launches[0]
        counts['dgrad'] += launches[1]
        train_runs.append({'steps': n_steps, 'batches': n_batches,
                           'losses': losses, 'wall_s': wall})
        log('train.main B{} {}x{} {}: {} steps over {} batch(es), launches '
            '{} forward / {} dgrad, losses {}'.format(
                train_bs, shape[0], shape[1], dname, n_steps, n_batches,
                launches[0], launches[1], ['{:.4f}'.format(v) for v in losses]))
    fixed = train_runs[-1]['losses']
    if not fixed[-1] < fixed[0]:
        raise AssertionError('loss did not fall over {} steps on one batch: '
                             '{}'.format(len(fixed), fixed))
    trainer, run_batch = run['trainer'], run['batches'][0]
    del run

    # one float32 step through the kernels, through the plain forward under
    # plain autograd, and (the control) plain again on the batch's images
    # in reverse order: the loss is the same function, only sums change order
    _, fmodel = port_train.build(CONFIG, 'cuda', seed=0,
                                 overrides=['tpu.compute_dtype', 'float32'])
    step_grads = []
    for plain, b in ((False, tbatch), (True, tbatch),
                     (True, {k: v.flip(0) for k, v in tbatch.items()})):
        fmodel.zero_grad(set_to_none=True)
        with plain_versions() if plain else contextlib.nullcontext():
            out = fmodel(b)
            out['loss'].backward()
        step_grads.append((float(out['loss'].detach()),
                           {n: p.grad.detach().clone()
                            for n, p in fmodel.named_parameters()}))
        del out
    del fmodel
    (loss_k, gk), (loss_p, gp), (_, gr) = step_grads
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_check = compare_grads(gk, gp)
    order_check = compare_grads(gr, gp)
    log('train step fp32 B{}, kernels vs plain: loss {:.6f} vs {:.6f} (rel '
        '{:.2e}); per gradient leaf max|err|/max|g| {:.3e} (at {}), '
        '|err|/|g| {:.3e}; zero leaves {:.2e} of the largest gradient. '
        'Plain vs plain on the reversed batch: {:.3e} (at {}), {:.3e}, '
        '{:.2e}'.format(train_bs, loss_k, loss_p, loss_rel, *grad_check,
                        *order_check))
    rel, _, norm, zero_leaf = grad_check
    if loss_rel > TRAIN_LOSS_RTOL or rel > TRAIN_GRAD_REL or \
            norm > TRAIN_GRAD_NORM or zero_leaf > 1e-6:
        raise AssertionError('train step through the kernels disagrees with '
                             'the plain versions')

    # ---------------------------------------------------------------- 4
    step = make_eval_step(model)
    fwd_ms = cuda_time_ms(lambda: step(batch), iters=20)
    log('eval forward B1 {}x{} {}: {:.3f} ms, {:.2f} img/s'.format(
        shape[0], shape[1], dname, fwd_ms, 1e3 / fwd_ms))
    mstep = make_eval_metrics_step(model, config.model.params, flip_tta=True)
    tta_ms = cuda_time_ms(lambda: mstep(batch), iters=10)
    log('eval protocol step (flip-TTA + 6x7 metrics) B1: {:.3f} ms, {:.2f} '
        'img/s'.format(tta_ms, 1e3 / tta_ms))
    del model, mstep, step

    for _ in range(2):
        trainer.train_step(run_batch)
    torch.cuda.synchronize()
    n_timed = 5
    t0 = time.perf_counter()
    for _ in range(n_timed):
        trainer.train_step(run_batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    log('train step B{} {}x{} {}: {:.3f} ms, {:.2f} img/s'.format(
        train_bs, shape[0], shape[1], dname, step_ms,
        train_bs * 1e3 / step_ms))
    del trainer

    esize = torch.tensor([], dtype=dtype).element_size()
    fwd_rows = []
    fwd_tot = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
               'bound_ms': 0.0, 'bytes_ms': 0.0, 'ops_ms': 0.0}
    for i, (mod, mask) in enumerate(convs):
        row = time_forward(i, mod, mask, dtype, dname, esize, gen, san_conv)
        fwd_rows.append(row)
        for key in fwd_tot:
            fwd_tot[key] += row[key]
    log('30 forward convs, B1 eval: kernel {:.3f} ms, plain {:.3f}, library '
        '{:.3f}, bound {:.4f} ms'.format(fwd_tot['ms'], fwd_tot['plain_ms'],
                                         fwd_tot['library_ms'],
                                         fwd_tot['bound_ms']))
    fwd8_rows = []
    fwd8 = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 'bound_ms': 0.0,
            'bytes_ms': 0.0, 'ops_ms': 0.0}
    dw_ms = 0.0
    for i, (mod, mask, _) in enumerate(tconvs):
        row = time_forward(i, mod, mask, dtype, dname, esize, gen, san_conv)
        x, mk, kern, _ = conv_inputs(mod, mask, dtype, gen)
        gm = dgrad_inputs(mod, mask, dtype, gen)[0]
        k, _, cin, cout = kern.shape
        row['dw_library_ms'] = cuda_time_ms(
            lambda: torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (cout, cin, k, k),
                gm.permute(0, 3, 1, 2), padding=k // 2), iters=10)
        dw_ms += row['dw_library_ms']
        fwd8_rows.append(row)
        for key in fwd8:
            fwd8[key] += row[key]
    log('30 forward convs, B{} train: kernel {:.3f} ms, plain {:.3f}, '
        'library {:.3f}, bound {:.4f} ms; dW (cuDNN conv2d_weight, bf16) '
        '{:.3f} ms per step'.format(train_bs, fwd8['ms'], fwd8['plain_ms'],
                                    fwd8['library_ms'], fwd8['bound_ms'],
                                    dw_ms))

    dg_rows = []
    dg_tot = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
              'bound_ms': 0.0, 'bytes_ms': 0.0, 'ops_ms': 0.0}
    for i, (mod, mask) in enumerate(dconvs):
        gm, mk, kern = dgrad_inputs(mod, mask, dtype, gen)
        k, _, cin, cout = kern.shape
        B, H, W, _ = gm.shape
        w_oihw = kern.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        g_cl = gm.permute(0, 3, 1, 2)       # NCHW view, channels-last memory
        with torch.no_grad():
            ms = cuda_time_ms(lambda: san_conv._launch_dgrad(gm, mk, kern),
                              iters=10)
            plain = cuda_time_ms(
                lambda: san_conv.masked_conv2d_dgrad_reference(gm, mk, kern),
                iters=10)
            lib = cuda_time_ms(lambda: torch.nn.grad.conv2d_input(
                (B, cin, H, W), w_oihw, g_cl, padding=k // 2), iters=10)
        active, act_rows, _, tiles = site_stats(mk, k)
        # gm is read only in its rows with an active site (zero elsewhere)
        nbytes = (act_rows * W * cout + kern.numel() + B * H * W * cin) * \
            esize + mk.numel() * 4
        b_all, b_ms, o_ms = bound(nbytes, 2.0 * k * k * cin * cout * active,
                                  dname)
        halo_tiles = float((F.max_pool2d(F.pad(
            (~halo_empty(mk, k))[..., 0].float()[:, None],
            (0, -W % 16, 0, -H % 8)), (8, 16), (8, 16)) > 0).float().mean())
        row = {'conv': i, 'B': B, 'H': H, 'W': W, 'k': int(k),
               'cin': int(cin), 'cout': int(cout), 'dtype': dname,
               'active_sites': active, 'active_site_frac':
               active / (B * H * W), 'active_tile_frac': tiles,
               'halo_tile_frac': halo_tiles, 'ms': ms, 'plain_ms': plain,
               'library_ms': lib, 'bound_ms': b_all, 'bytes_ms': b_ms,
               'ops_ms': o_ms,
               'bound_by': 'bytes' if b_ms > o_ms else 'operations'}
        dg_rows.append(row)
        for key in dg_tot:
            dg_tot[key] += row[key]
        log('dgrad {:2d} {}x{} k{} {:4d}<-{:4d} sites {:.3f} halo tiles '
            '{:.3f}: kernel {:.4f} ms plain {:.4f} library {:.4f} bound '
            '{:.4f} ({})'.format(i, H, W, k, cin, cout,
                                 row['active_site_frac'], halo_tiles, ms,
                                 plain, lib, b_all, row['bound_by']))
    log('27 dgrad launches of one B{} step: kernel {:.3f} ms, plain {:.3f}, '
        'library {:.3f}, bound {:.4f} ms'.format(
            train_bs, dg_tot['ms'], dg_tot['plain_ms'], dg_tot['library_ms'],
            dg_tot['bound_ms']))
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/chip_smoke_convs.json', 'w') as f:
        json.dump({'card': card, 'torch': torch.__version__,
                   'forward_ms': fwd_ms, 'flip_tta_step_ms': tta_ms,
                   'train_step_ms': step_ms, 'train_batch': train_bs,
                   'train_runs': train_runs, 'dw_library_ms': dw_ms,
                   'train_fp32_check': {
                       'loss_rel': loss_rel,
                       'kernels_vs_plain': grad_check,
                       'plain_reversed_batch_vs_plain': order_check},
                   'fwd_err': fwd_err, 'max_err': max_err,
                   'dgrad_max_err': dmax_err, 'function_rel_err': fn_err,
                   'convs': fwd_rows, 'train_convs': fwd8_rows,
                   'dgrads': dg_rows}, f, indent=1)

    # ---------------------------------------------------------------- 5
    def by(tot):
        return 'bytes' if tot['bytes_ms'] > tot['ops_ms'] else 'operations'

    log(json.dumps({'kernels': [{
        'name': 'san_masked_conv2d', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/san_conv.cu',
        'replaces': 'packnet_sfm_tpu/ops/pallas/san_conv.py:53',
        'launches': counts['fwd'],
        'launches_by_path': {'eval': eval_launches, 'train': counts['fwd']},
        'max_abs_err': max_err['float32'],
        'max_abs_err_bf16': max_err['bfloat16'],
        'timed_as': '30 launches of one B1 {}x{} eval forward, {}'.format(
            shape[0], shape[1], dname),
        'ms': fwd_tot['ms'], 'plain_ms': fwd_tot['plain_ms'],
        'bound_ms': fwd_tot['bound_ms'], 'bound_by': by(fwd_tot),
        'library_ms': fwd_tot['library_ms'],
        'train_step_ms': fwd8['ms'], 'train_step_plain_ms': fwd8['plain_ms'],
        'train_step_bound_ms': fwd8['bound_ms'],
        'train_step_library_ms': fwd8['library_ms']}, {
        'name': 'san_masked_conv2d_dgrad', 'route': 'cuda',
        'source': 'packnet_sfm_tpu_torch/csrc/san_conv.cu',
        'replaces': 'packnet_sfm_tpu/ops/pallas/san_conv.py:184',
        'launches': counts['dgrad'],
        'max_abs_err': dmax_err['float32'],
        'max_abs_err_bf16': dmax_err['bfloat16'],
        'timed_as': '27 launches of one B{} {}x{} train step, {}'.format(
            train_bs, shape[0], shape[1], dname),
        'ms': dg_tot['ms'], 'plain_ms': dg_tot['plain_ms'],
        'bound_ms': dg_tot['bound_ms'], 'bound_by': by(dg_tot),
        'library_ms': dg_tot['library_ms']}]}))
    log(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def time_forward(i, mod, mask, dtype, dname, esize, gen, san_conv):
    """One forward conv's kernel, plain and library (dense bf16 F.conv2d +
    bias times the mask, channels-last) times and its bound; x is read only
    in the rows within k//2 of an active output row."""
    import torch
    import torch.nn.functional as F
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
    active, _, x_rows, tiles = site_stats(mk, k)
    nbytes = (x_rows * W * cin + kern.numel() + bias.numel() +
              B * H * W * cout) * esize + mk.numel() * 4
    b_all, b_ms, o_ms = bound(nbytes, 2.0 * k * k * cin * cout * active,
                              dname)
    row = {'conv': i, 'B': B, 'H': H, 'W': W, 'k': int(k), 'cin': int(cin),
           'cout': int(cout), 'dtype': dname, 'active_sites': active,
           'active_site_frac': active / (B * H * W),
           'active_tile_frac': tiles, 'ms': ms, 'plain_ms': plain,
           'library_ms': lib, 'bound_ms': b_all, 'bytes_ms': b_ms,
           'ops_ms': o_ms, 'bound_by': 'bytes' if b_ms > o_ms
           else 'operations'}
    log('conv {:2d} B{} {}x{} k{} {:4d}->{:4d} sites {:.3f} tiles {:.3f}: '
        'kernel {:.4f} ms plain {:.4f} library {:.4f} bound {:.4f} ({})'
        .format(i, B, H, W, k, cin, cout, row['active_site_frac'], tiles, ms,
                plain, lib, b_all, row['bound_by']))
    return row


if __name__ == '__main__':
    sys.exit(main())
