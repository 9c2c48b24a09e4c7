#!/usr/bin/env python3
"""
The generic-projection kernels (csrc/generic_projection.cu of the port)
alone, on the card: build the source of one or more trees, hold each tree's
forward and backward against the plain versions of this checkout, and time
them at the generic step's planes, (i) B1 192x192 and (ii) B1 384x384, and
at the edge shapes 41x41 and 41x97, all at p = 20.

    python3 scripts/torch_generic_projection_levels.py [--parent DIR]

--parent DIR: also build DIR/packnet_sfm_tpu_torch/csrc/generic_projection.cu
(a `git archive` copy of an earlier commit, whose C entry points are the
same) and time both trees on the same seeded inputs in the order parent,
this tree, this tree, parent.

Per tree and shape: the forward's and the backward call's time in a loop of
C calls (CUDA events, the host's issue included) and replayed in a CUDA
graph (without it); torch.profiler's kernel times over a loop of calls,
by kernel name (an earlier tree's backward launched dd and dray as two
kernels); where the tree has the entry points generic_projection_bwd_dd
and generic_projection_bwd_dray, dd and dray each in a CUDA graph; the
plain versions' times and the bound (chip_smoke.projection_bound). The inputs are
rays near the pinhole template and directions divided by the temperature of
progress 0 (a peaked softmax, as in the step). The work is the same for any
values, but the time need not be: IEEE division takes a slow path where the
quotient is subnormal. Prints one line per tree and shape and writes
chiprun_out/torch_generic_projection_levels.json; exits 1 if a check
failed.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

SHAPES = (('i', 1, 192, 192), ('ii', 1, 384, 384), ('edge', 1, 41, 41),
          ('edge', 1, 41, 97))
P = 20
SRC = os.path.join('packnet_sfm_tpu_torch', 'csrc', 'generic_projection.cu')


def build_tree(tag, tree):
    """nvcc the tree's generic_projection.cu with this checkout's flags into
    build/kernels/levels-<tag>.so; returns (ctypes library, ptxas lines)."""
    from packnet_sfm_tpu_torch.ops.kernels import build
    out = os.path.join(str(build.BUILD_DIR), 'levels-{}.so'.format(tag))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, '-o', out,
                           os.path.join(tree, SRC)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError('nvcc failed for {}:\n{}'.format(
            tag, proc.stdout + proc.stderr))
    log = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
           if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]
    return ctypes.CDLL(out), log


def bind(lib, symbol, n_ptr):
    fn = getattr(lib, symbol, None)
    if fn is not None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


class Kernels:
    """One tree's C entry points on preallocated outputs; each call raises
    on a nonzero cudaError."""

    def __init__(self, lib, ray, d, gy, gx):
        import torch
        self.fwd = bind(lib, 'generic_projection_fwd', 6)
        self.bwd = bind(lib, 'generic_projection_bwd', 10)
        self.dd = bind(lib, 'generic_projection_bwd_dd', 10)
        self.dray = bind(lib, 'generic_projection_bwd_dray', 10)
        B, _, H, W = ray.shape
        self.dims = (B, H, W, P)
        self.ray, self.d, self.gy, self.gx = ray, d, gy, gx
        self.res = [torch.empty(B, H, W, device=ray.device) for _ in range(4)]
        self.grads = [torch.empty_like(ray), torch.empty_like(d)]

    def _call(self, fn, *tensors):
        import torch
        rc = fn(*[t.data_ptr() for t in tensors], *self.dims,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError('cudaError {}'.format(rc))

    def run_fwd(self):
        self._call(self.fwd, self.ray, self.d, *self.res)

    def _bwd_args(self):
        return (self.ray, self.d, *self.res, self.gy, self.gx, *self.grads)

    def run_bwd(self):
        self._call(self.bwd, *self._bwd_args())

    def run_dd(self):
        self._call(self.dd, *self._bwd_args())

    def run_dray(self):
        self._call(self.dray, *self._bwd_args())


def profiled_split(fn, iters=20):
    """Device ms a call of each kernel that fn launches, by name, from
    torch.profiler over `iters` calls; {} when the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, 'device_time_total', None)
        if total is None:
            total = getattr(evt, 'cuda_time_total', 0.0)
        for name in ('proj_fwd', 'proj_bwd_dd', 'proj_bwd_dray',
                     'proj_bwd_kernel'):
            if name in evt.key and total:
                out[name] = out.get(name, 0.0) + total / 1e3 / iters
    return out


def check(tag, kern, gp):
    """The tree's kernels against this checkout's plain versions, under
    chip_smoke's phase G rules; the backward run twice, bit-equal."""
    import torch
    ray, d, gy, gx = kern.ray, kern.d, kern.gy, kern.gx
    kern.run_fwd()
    got = [t.clone() for t in kern.res]
    want = gp.generic_projection_fwd_reference(ray, d, P)
    H, W = ray.shape[2:]
    err = {}
    err['rows_cols_px'] = max(
        smoke.check_close(tag + ' rows', got[0], want[0], 1e-5 * (H - 1), 0),
        smoke.check_close(tag + ' cols', got[1], want[1], 1e-5 * (W - 1), 0))
    err['m_rel'] = smoke.check_close(tag + ' m', got[2], want[2], 0, 1e-6) \
        / float(want[2].abs().max())
    err['s_rel'] = smoke.check_close(tag + ' s', got[3], want[3], 0, 1e-5) \
        / float(want[3].abs().max())
    kern.run_bwd()
    first = [t.clone() for t in kern.grads]
    kern.run_bwd()
    torch.cuda.synchronize()
    want = gp.generic_projection_bwd_reference(ray, d, *kern.res, gy, gx, P)
    err['bwd_rel'] = 0.0
    for nm, a, b, c in zip(('dray', 'dd'), first, want, kern.grads):
        scale = float(b.abs().max())
        err['bwd_rel'] = max(err['bwd_rel'], smoke.check_close(
            '{} {}'.format(tag, nm), a, b, 2e-4 * scale, 0) / scale)
        if not torch.equal(a, c):
            raise AssertionError('{} {}: two calls differ'.format(tag, nm))
    if kern.dd is not None and kern.dray is not None:
        kern.run_dd()
        kern.run_dray()
        torch.cuda.synchronize()
        for nm, a, b in zip(('dray', 'dd'), kern.grads, first):
            if not torch.equal(a, b):
                raise AssertionError('{} {} alone differs from the backward '
                                     'call'.format(tag, nm))
    return err


def time_tree(kern):
    import torch
    row = {'fwd_ms': smoke.cuda_time_ms(kern.run_fwd),
           'fwd_graph_ms': smoke.graph_time_ms(kern.run_fwd),
           'bwd_ms': smoke.cuda_time_ms(kern.run_bwd),
           'bwd_graph_ms': smoke.graph_time_ms(kern.run_bwd)}
    if kern.dd is not None and kern.dray is not None:
        row['dd_graph_ms'] = smoke.graph_time_ms(kern.run_dd)
        row['dray_graph_ms'] = smoke.graph_time_ms(kern.run_dray)
    split = profiled_split(kern.run_fwd)
    split.update(profiled_split(kern.run_bwd))
    row['profiler_ms'] = split
    torch.cuda.synchronize()
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', help='a tree whose kernels to time beside '
                    "this checkout's")
    ap.add_argument('--sass', action='store_true',
                    help="print each kernel's SASS instructions by opcode "
                    'and write the SASS to chiprun_out/')
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_generic_projection_levels: no CUDA device',
              file=sys.stderr)
        return 2
    os.chdir(ROOT)
    from packnet_sfm_tpu_torch.geometry.camera_generic import (
        softmax_temperature)
    from packnet_sfm_tpu_torch.ops.kernels import generic_projection as gp

    card = os.popen('nvidia-smi --query-gpu=name,power.limit '
                    '--format=csv,noheader').read().strip()
    smoke.log('card:', card)
    smoke.log('torch', torch.__version__, 'cuda', torch.version.cuda)
    trees = [('pr', ROOT)]
    if opts.parent:
        trees.insert(0, ('parent', os.path.abspath(opts.parent)))
    libs = {}
    for tag, tree in trees:
        t0 = time.time()
        libs[tag], ptxas = build_tree(tag, tree)
        smoke.log('build {} ({}): {:.1f} s'.format(tag, tree,
                                                   time.time() - t0))
        for line in ptxas:
            smoke.log('  ptxas:', line)
        if opts.sass:
            sass_histogram(tag, libs[tag]._name)
    order = [t for t, _ in trees]
    if opts.parent:
        order = ['parent', 'pr', 'pr', 'parent']

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    results, failed = [], []
    for name, B, H, W in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        ray = smoke.pinhole_planes(B, H, W, gen, 0.01)
        d = (smoke.pinhole_planes(B, H, W, gen, 0.01)
             / softmax_temperature(0.0)).contiguous()
        gy, gx = (torch.randn(B, H, W, device=dev, generator=gen)
                  for _ in range(2))
        fb = smoke.projection_bound(ray, P, 10, 12)
        bb = smoke.projection_bound(ray, P, 18, 24)
        with torch.no_grad():
            plain = {
                'fwd_ms': smoke.cuda_time_ms(
                    lambda: gp.generic_projection_fwd_reference(ray, d, P),
                    iters=3, warmup=1)}
            res = gp.generic_projection_fwd_reference(ray, d, P)
            plain['bwd_ms'] = smoke.cuda_time_ms(
                lambda: gp.generic_projection_bwd_reference(
                    ray, d, *res, gy, gx, P), iters=3, warmup=1)
        shape = {'shape': name, 'B': B, 'H': H, 'W': W, 'p': P,
                 'fwd_bound_ms': fb[0], 'fwd_bound_set_by': fb[3],
                 'bwd_bound_ms': bb[0], 'bwd_bound_set_by': bb[3],
                 'plain': plain, 'runs': []}
        for i, tag in enumerate(order):
            kern = Kernels(libs[tag], ray, d, gy, gx)
            err = None
            if tag not in order[:i]:
                try:
                    err = check('{} {} {}x{}'.format(tag, name, H, W), kern,
                                gp)
                except AssertionError as exc:
                    err = {'failed': str(exc)}
                    failed.append(str(exc))
                occ = occupancy(libs[tag], H, W)
                if occ:
                    smoke.log('{} {}x{}: resident blocks an SM forward {} '
                              'backward {}; shared memory {} B (forward '
                              'rays), {} B (dd rays), {} B (dray pixel '
                              'band)'.format(tag, H, W, *occ))
            row = time_tree(kern)
            row.update(tree=tag, check=err)
            shape['runs'].append(row)
            split = row['profiler_ms']
            smoke.log(
                '{} {} B{} {}x{} p{}: fwd loop {:.4f} graph {:.4f} ms; bwd '
                'loop {:.4f} graph {:.4f} ms (dd {} dray {} in graphs); '
                'profiler fwd {} dd {} dray {} bwd {}; bound fwd {:.4f} bwd '
                '{:.4f} '
                '({}); plain fwd {:.3f} bwd {:.3f}{}'.format(
                    tag, name, B, H, W, P, row['fwd_ms'],
                    row['fwd_graph_ms'], row['bwd_ms'], row['bwd_graph_ms'],
                    fmt(row.get('dd_graph_ms')), fmt(row.get('dray_graph_ms')),
                    fmt(split.get('proj_fwd')), fmt(split.get('proj_bwd_dd')),
                    fmt(split.get('proj_bwd_dray')),
                    fmt(split.get('proj_bwd_kernel')), fb[0], bb[0], bb[3],
                    plain['fwd_ms'], plain['bwd_ms'],
                    '' if err is None else '; checks: ' + ', '.join(
                        '{} {}'.format(k, v) for k, v in err.items())))
            del kern
        results.append(shape)
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/torch_generic_projection_levels.json', 'w') as f:
        json.dump({'card': card, 'order': order, 'shapes': results,
                   'failed': failed}, f, indent=1)
    for msg in failed:
        smoke.log('FAILED:', msg)
    return 1 if failed else 0


def occupancy(lib, H, W):
    """(forward and backward resident blocks an SM, shared memory bytes of
    the forward's and dd's ray tiles and of dray's pixel band) where the
    tree reports them, else None."""
    fn = getattr(lib, 'generic_projection_occupancy', None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    if fn(H, W, P, ctypes.cast(out, ctypes.c_void_p)):
        return None
    return list(out)


def sass_histogram(tag, lib_path, top=24):
    """cuobjdump -sass of a built library: the SASS to
    chiprun_out/generic_projection_<tag>.sass and, per kernel, its
    instruction count and the most frequent opcodes."""
    from packnet_sfm_tpu_torch.ops.kernels import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/generic_projection_{}.sass'.format(tag), 'w') as f:
        f.write(sass)
    kernels, name = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :')[1].strip()
            kernels[name] = {}
        elif name and line.strip().startswith('/*') and '*/' in line:
            words = line.split('*/', 1)[1].replace(';', ' ').split()
            if words and words[0].startswith('@'):
                words = words[1:]
            if words:
                op = words[0]
                kernels[name][op] = kernels[name].get(op, 0) + 1
    for name, ops in kernels.items():
        short = next((k for k in ('proj_fwd', 'proj_bwd_dd', 'proj_bwd_dray')
                      if k in name), name)
        smoke.log('  SASS {} {}: {} instructions; {}'.format(
            tag, short, sum(ops.values()), ', '.join(
                '{} {}'.format(k, v) for k, v in sorted(
                    ops.items(), key=lambda kv: -kv[1])[:top])))


def fmt(v):
    return 'n/a' if v is None else '{:.4f}'.format(v)


if __name__ == '__main__':
    sys.exit(main())
