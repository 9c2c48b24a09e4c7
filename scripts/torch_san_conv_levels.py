#!/usr/bin/env python3
"""
The masked-conv kernels (packnet_sfm_tpu_torch/csrc/san_conv.cu) alone, on
the card: build the library, count the HMMA instructions of its SASS,
hold both kernels against their plain versions in bf16 and time them per
SAN level beside cuDNN and the bound.

    python3 scripts/torch_san_conv_levels.py [--plans]

The shapes and masks are those of chip_smoke.py: the 30 forward convs of
one B1 384x640 eval forward of configs/train_resnet_san_ncdb_640x384.yaml
on its seeded batch, the 30 forward and 27 dgrad convs of one B8 train
step, and the edge and split-K cases. It prints one line per conv shape and
per level, and writes them to chiprun_out/torch_san_conv_levels.json.

--plans: the data behind ops/kernels/san_conv.py `plan`. At each distinct
tensor-core shape of the three timed sets, every launch plan the kernel
takes (tile, output channels a block, K splits of 1, 2, 4, 8), each checked
against the plain version and timed in a CUDA graph; one line a shape with
the plan's own time and the four fastest.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--plans', action='store_true',
                    help='also time every launch plan at each shape')
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_san_conv_levels: no CUDA device', file=sys.stderr)
        return 2
    os.chdir(ROOT)
    from packnet_sfm_tpu_torch import eval as port_eval
    from packnet_sfm_tpu_torch import train as port_train
    from packnet_sfm_tpu_torch.ops.kernels import build, san_conv

    card = os.popen('nvidia-smi --query-gpu=name,power.limit '
                    '--format=csv,noheader').read().strip()
    smoke.log('card:', card)
    t0 = time.time()
    lib_path, ptxas = build.build('san_conv')
    smoke.log('build {:.1f} s'.format(time.time() - t0))
    for line in ptxas.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            smoke.log('  ptxas:', line.strip())
    smoke.log('SASS: {} HMMA instructions'.format(smoke.hmma_count(lib_path)))

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    config, model = port_eval.build(smoke.CONFIG, 'cuda', seed=0)
    shape = port_eval.image_shape(config)
    batch = port_eval.make_batches(shape, 1, 1, seed=0, device='cuda')[0]
    convs = [(m, mk) for m, mk, _ in smoke.path_convs(model, batch)]
    del model
    bs = int(config.datasets.train.batch_size)
    _, tmodel = port_train.build(smoke.CONFIG, 'cuda', seed=0)
    tbatch = port_eval.make_batches(shape, bs, 1, seed=0, device='cuda')[0]
    tconvs = smoke.path_convs(tmodel, tbatch, train=True)
    del tmodel
    dconvs = [(m, mk) for m, mk, needs in tconvs if needs]
    extra = smoke.edge_modules(dev, gen) + smoke.split_modules(dev, gen)

    dt = torch.bfloat16
    err = {'forward': 0.0, 'dgrad': 0.0}
    for mod, mask in convs + [(m, mk) for m, mk, _ in tconvs] + extra:
        args = smoke.conv_inputs(mod, mask, dt, gen)
        got = san_conv.masked_conv2d(*args)
        want = san_conv.masked_conv2d_reference(*args)
        err['forward'] = max(err['forward'], smoke.check_kernel(
            'forward {} {}'.format(tuple(mask.shape), tuple(args[2].shape)),
            got, want, dt))
    for mod, mask in dconvs + extra:
        gm, mk, kern = smoke.dgrad_inputs(mod, mask, dt, gen)
        got = san_conv.masked_conv2d_dgrad(gm, mk, kern)
        want = san_conv.masked_conv2d_dgrad_reference(gm, mk, kern)
        err['dgrad'] = max(err['dgrad'], smoke.check_kernel(
            'dgrad {} {}'.format(tuple(mask.shape), tuple(kern.shape)),
            got, want, dt))
    torch.cuda.synchronize()
    smoke.log('bf16 kernels vs plain ok, max |err| {}'.format(err))

    esize = 2
    rows = {'forward_b1': [smoke.time_forward(i, m, mk, dt, 'bfloat16', esize,
                                              gen, san_conv)
                           for i, (m, mk) in enumerate(convs)],
            'forward_b{}'.format(bs): [
                smoke.time_forward(i, m, mk, dt, 'bfloat16', esize, gen,
                                   san_conv)
                for i, (m, mk, _) in enumerate(tconvs)],
            'dgrad_b{}'.format(bs): [
                smoke.time_dgrad(i, m, mk, dt, 'bfloat16', esize, gen,
                                 san_conv)
                for i, (m, mk) in enumerate(dconvs)]}
    levels = {}
    for what, rs in rows.items():
        levels[what] = smoke.level_lines(rs, what)
        tot = {f: sum(r[f] for r in rs) for f in smoke.LEVEL_KEYS}
        smoke.log('{}: kernel {:.4f} ms (graph {:.4f}) cuDNN {:.4f} (graph '
                  '{:.4f}) bound {:.4f}'.format(
                      what, tot['ms'], tot['graph_ms'], tot['library_ms'],
                      tot['library_graph_ms'], tot['bound_ms']))
    plans = None
    if opts.plans:
        plans = sweep_plans(
            [('forward_b1', m, mk, False) for m, mk in convs] +
            [('forward_b{}'.format(bs), m, mk, False) for m, mk, _ in tconvs] +
            [('dgrad_b{}'.format(bs), m, mk, True) for m, mk in dconvs], gen)
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/torch_san_conv_levels.json', 'w') as f:
        json.dump({'card': card, 'max_err': err, 'rows': rows,
                   'levels': levels, 'plans': plans}, f, indent=1)
    return 0


def sweep_plans(cases, gen):
    """Every launch plan the tensor-core kernel takes at each distinct
    (set, shape) of `cases` [(set name, module, mask, dgrad)]: checked
    against the plain version, timed in a CUDA graph. Returns one row a
    shape."""
    import torch
    from packnet_sfm_tpu_torch.ops.kernels import san_conv
    dt, rows, seen = torch.bfloat16, [], set()
    plan = san_conv.plan
    try:
        for what, mod, mask, dgrad in cases:
            k, _, cin, cout = mod.kernel.shape
            B, H, W = mask.shape[:3]
            kc, nc = (cout, cin) if dgrad else (cin, cout)
            if (what, H, W, k, cin, cout) in seen or \
                    plan(B, H, W, kc, nc, k, dt)[0] == 'cuda-core':
                continue
            seen.add((what, H, W, k, cin, cout))
            if dgrad:
                args = smoke.dgrad_inputs(mod, mask, dt, gen)
                fn, ref = (san_conv._launch_dgrad,
                           san_conv.masked_conv2d_dgrad_reference)
            else:
                args = smoke.conv_inputs(mod, mask, dt, gen)
                fn, ref = san_conv._launch, san_conv.masked_conv2d_reference
            want = ref(*args)
            _, own_tile, own_n, own_splits = plan(B, H, W, kc, nc, k, dt)
            own = '{}x{}x{}/{}/{}'.format(*own_tile, own_n, own_splits)
            chunks = -(-kc // san_conv.TC_CK)
            tiles = san_conv.TC_TILES if k == 3 else \
                (san_conv.TC_TILES[0], san_conv.TC_TILES[3])
            times = {}
            for tile in tiles:
                for block_n in (64, 128):
                    for splits in sorted({1, 2, 4, 8, own_splits}):
                        # a split count the kernel forms from its ranges
                        if tile[2] > B or nc % block_n or splits > chunks or \
                                -(-chunks // -(-chunks // splits)) != splits:
                            continue
                        san_conv.plan = (lambda *a, p=(tile, block_n, splits):
                                         ('x',) + p)
                        name = '{}x{}x{}/{}/{}'.format(*tile, block_n, splits)
                        smoke.check_kernel(name, fn(*args), want, dt)
                        times[name] = smoke.graph_time_ms(lambda: fn(*args))
                        san_conv.plan = plan
            best = sorted(times.items(), key=lambda kv: kv[1])[:4]
            rows.append({'set': what, 'H': H, 'W': W, 'k': int(k),
                         'cin': int(cin), 'cout': int(cout), 'plan': own,
                         'plan_ms': times[own], 'best': best})
            smoke.log('plans {} {}x{} k{} {}->{}: plan {} {:.4f} ms; fastest '
                      '{}'.format(what, H, W, k, cin, cout, own, times[own],
                                  ', '.join('{} {:.4f}'.format(n, t)
                                            for n, t in best)))
    finally:
        san_conv.plan = plan
    return rows


if __name__ == '__main__':
    sys.exit(main())
