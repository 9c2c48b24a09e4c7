#!/usr/bin/env python3
"""
The warp and photometric kernels (csrc/warp.cu and csrc/photometric.cu of
the port) alone, on the card: build the sources of one or more trees, hold
each tree's kernels against the plain versions of this checkout, and time
them at the steps' shapes.

    python3 scripts/torch_warp_photometric_levels.py [--parent DIR]
        [--variant DIR] [--sass]

--parent DIR: also build DIR/packnet_sfm_tpu_torch/csrc/{warp,photometric}.cu
(a `git archive` copy of an earlier commit) and time both trees on the same
seeded inputs in the order parent, this tree, this tree, parent.
--variant DIR: a third tree with this checkout's C entry points (an
intermediate design), timed in the order parent, variant, this tree, this
tree, variant, parent.
--sass: print each kernel's SASS instruction count and its most frequent
opcodes, and write the SASS to chiprun_out/.

A tree's warp is either the out-only forward and the dgrid kernel
(`warp_bilinear_out`, `warp_bilinear_dgrid`) or an earlier commit's single
kernel that writes out and the derivative maps A, B (`warp_bilinear`), whose
backward is WarpFunction.backward's dgrid math in PyTorch ops over A, B.
Per tree, the forward (`fwd`), the backward (`bwd`) and both in turn
(`pair`) over one step's launches, each on its own inputs:
- selfsup (i): B8, a 192x640 source and a 768x640 grid (the four scales
  stacked along the rows), 2 launches (one per context), bf16 as the step
  runs it and fp32;
- generic: B1, a 384x384 fp32 source and grid, 2 launches; planes (i) and
  (ii) give the warp the same shapes (the projection is resampled to the
  image's resolution before the warp).
The photometric function of a selfsup (ii) step at B8 192x640 on NHWC
inputs as the loss hands them over: forward over the step's 10 maps (per
context, the four row-slices of one warped [8,768,640,3] tensor and the
unwarped context frame, each against the target image), backward over the
8 warped maps without dy (the target is data), g a strided slice of the
[8,192,640,4] cotangent of the step's min over the maps. A tree whose
kernels take reflect-padded NCHW copies (an earlier interface) is timed
with the glue PhotometricFunction then ran around them: the permute,
reflect pad and `.float().contiguous()` of x and y before the forward; the
cotangent's `.float().contiguous()` and the pad's gradient of dx after the
backward.
Each in a loop of calls (CUDA events, the host's issue included) and
replayed in a CUDA graph (without it), with torch.profiler's kernel times
and the number and time of the other kernels a call runs (the glue), the
plain versions' times, PyTorch's own warp pair (F.grid_sample and
aten.grid_sampler_2d_backward, grid gradient only, on float32 NCHW copies)
and the bounds (chip_smoke.bound: bytes once at 3.35 TB/s or fp32
operations at 67 TFLOP/s). Prints the card and one line per tree and shape,
writes chiprun_out/torch_warp_photometric_levels.json and exits 1 if a
check failed.
"""

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

CSRC = os.path.join('packnet_sfm_tpu_torch', 'csrc')
SOURCES = ('warp', 'photometric')
DTYPES = {'float32': 0, 'bfloat16': 1}
WARP_SHAPES = (('selfsup_i', 'bfloat16', 8, 192, 640, 768),
               ('selfsup_i', 'float32', 8, 192, 640, 768),
               ('generic', 'float32', 1, 384, 384, 384))
WARPS_PER_STEP = 2
PHOTO_SHAPE = (8, 192, 640)
N_SCALES, N_CONTEXTS = 4, 2     # the (ii) step's warped maps a context
ALPHA, C1, C2 = 0.85, 1e-4, 9e-4
KERNEL_NAMES = ('warp_out_kernel', 'warp_dgrid_kernel', 'warp_kernel',
                'photometric_fwd_kernel', 'photometric_bwd_kernel')


def build_tree(tag, tree):
    """nvcc the tree's warp.cu and photometric.cu with this checkout's
    flags, both at once, into build/kernels/levels-<tag>-<name>.so; returns
    ({name: ctypes library}, {name: library path}, ptxas lines)."""
    from packnet_sfm_tpu_torch.ops.kernels import build
    os.makedirs(str(build.BUILD_DIR), exist_ok=True)
    jobs = {}
    for name in SOURCES:
        out = os.path.join(str(build.BUILD_DIR),
                           'levels-{}-{}.so'.format(tag, name))
        jobs[name] = (out, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, '-o', out,
             os.path.join(tree, CSRC, name + '.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, paths, log = {}, {}, []
    for name, (out, proc) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError('nvcc failed for {} {}:\n{}'.format(
                tag, name, text))
        log += [ln.strip() for ln in text.splitlines()
                if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]
        libs[name], paths[name] = ctypes.CDLL(out), out
    return libs, paths, log


def bind(lib, symbol, n_ptr, n_int, n_float=0):
    fn = getattr(lib, symbol, None)
    if fn is not None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def checked(rc, what):
    if rc:
        raise RuntimeError('{}: cudaError {}'.format(what, rc))


class Warp:
    """One tree's warp on one input (image, grid, g) with preallocated
    outputs: run_fwd writes out (and, for a tree with the derivative-map
    kernel, A and B), run_bwd writes dgrid."""

    def __init__(self, lib, image, grid, g):
        import torch
        self.out_fn = bind(lib, 'warp_bilinear_out', 3, 8)
        self.dgrid_fn = bind(lib, 'warp_bilinear_dgrid', 4, 8)
        self.maps_fn = None
        if self.out_fn is None:
            self.maps_fn = bind(lib, 'warp_bilinear', 5, 8)
        B, H, W, C = image.shape
        _, Ho, Wo, _ = grid.shape
        self.image, self.grid, self.g = image, grid, g
        self.dims = (B, H, W, C, Ho, Wo, DTYPES[str(image.dtype)[6:]], 0)
        self.out = torch.empty(B, Ho, Wo, C, dtype=image.dtype,
                               device=image.device)
        self.dgrid = torch.empty_like(grid)
        if self.maps_fn is not None:
            self.A = torch.empty(B, Ho, Wo, C, device=image.device)
            self.Bv = torch.empty_like(self.A)

    def run_fwd(self):
        if self.maps_fn is not None:
            checked(self.maps_fn(self.image.data_ptr(), self.grid.data_ptr(),
                                 self.out.data_ptr(), self.A.data_ptr(),
                                 self.Bv.data_ptr(), *self.dims, stream()),
                    'warp_bilinear')
        else:
            checked(self.out_fn(self.image.data_ptr(), self.grid.data_ptr(),
                                self.out.data_ptr(), *self.dims, stream()),
                    'warp_bilinear_out')

    def run_bwd(self):
        if self.maps_fn is None:
            checked(self.dgrid_fn(self.image.data_ptr(), self.grid.data_ptr(),
                                  self.g.data_ptr(), self.dgrid.data_ptr(),
                                  *self.dims, stream()),
                    'warp_bilinear_dgrid')
            return
        # the earlier commit's WarpFunction.backward (zeros padding): the
        # cotangent's cast, two products, two sums, two scalings, the stack
        import torch
        H, W = self.image.shape[1], self.image.shape[2]
        g32 = self.g.float()
        dgx = (g32 * self.A).sum(-1) * (0.5 * (W - 1))
        dgy = (g32 * self.Bv).sum(-1) * (0.5 * (H - 1))
        self.dgrid = torch.stack([dgx, dgy], dim=-1)

    def run_pair(self):
        self.run_fwd()
        self.run_bwd()


class PhotoFn:
    """One tree's photometric function on one map (x, y [B,H,W,3] as the
    loss holds them, g [B,H,W] strided or None) with preallocated outputs:
    run_fwd writes photo, run_bwd dx. `padded`: the tree's kernels take
    reflect-padded NCHW copies, made (and the pad's gradient taken) around
    them as that tree's PhotometricFunction did."""

    def __init__(self, lib, padded, x, y, g):
        import torch
        self.lib, self.padded = lib, padded
        self.x, self.y, self.g = x, y, g
        B, H, W, _ = x.shape
        self.dims = (B, H, W)
        self.photo = torch.empty(B, H, W, device=x.device)
        if padded:
            self.fwd_fn = bind(lib, 'photometric_fwd', 3, 3, 4)
            self.bwd_fn = bind(lib, 'photometric_bwd', 5, 3, 4)
            # the copies the forward saves for the backward
            self.xp, self.yp = pad(x), pad(y)
            self.dyp = torch.empty_like(self.yp)
        else:
            self.fwd_fn = bind(lib, 'photometric_fwd', 3, 7, 4)
            self.bwd_fn = bind(lib, 'photometric_bwd', 5, 11, 4)
            self.dx = torch.empty_like(
                x, memory_format=torch.contiguous_format)

    def run_fwd(self):
        if self.padded:
            xp, yp = pad(self.x), pad(self.y)
            checked(self.fwd_fn(xp.data_ptr(), yp.data_ptr(),
                                self.photo.data_ptr(), *self.dims, ALPHA,
                                1.0 - ALPHA, C1, C2, stream()),
                    'photometric_fwd')
        else:
            x, y = self.x, self.y
            checked(self.fwd_fn(x.data_ptr(), y.data_ptr(),
                                self.photo.data_ptr(), *self.dims,
                                x.stride(0), x.stride(1), y.stride(0),
                                y.stride(1), ALPHA, 1.0 - ALPHA, C1, C2,
                                stream()), 'photometric_fwd')

    def run_bwd(self):
        import torch
        if self.padded:
            g = self.g.float().contiguous()
            dxp = torch.empty_like(self.xp)
            checked(self.bwd_fn(self.xp.data_ptr(), self.yp.data_ptr(),
                                g.data_ptr(), dxp.data_ptr(),
                                self.dyp.data_ptr(), *self.dims,
                                -0.5 * ALPHA / 3.0, 1.0 - ALPHA, C1, C2,
                                stream()), 'photometric_bwd')
            self.dx = torch.ops.aten.reflection_pad2d_backward(
                dxp, self.x.permute(0, 3, 1, 2), [1, 1, 1, 1]).permute(
                    0, 2, 3, 1)
        else:
            x, y, g = self.x, self.y, self.g
            checked(self.bwd_fn(x.data_ptr(), y.data_ptr(), g.data_ptr(),
                                self.dx.data_ptr(), None, *self.dims,
                                x.stride(0), x.stride(1), y.stride(0),
                                y.stride(1), *g.stride(), 0,
                                -0.5 * ALPHA / 3.0, 1.0 - ALPHA, C1, C2,
                                stream()), 'photometric_bwd')


def pad(v):
    """The parent's glue: NHWC -> reflect-padded float32 NCHW."""
    import torch.nn.functional as F
    return F.pad(v.permute(0, 3, 1, 2), (1, 1, 1, 1),
                 mode='reflect').float().contiguous()


def takes_padded(tree):
    """Whether the tree's photometric kernels take padded NCHW copies (the
    earlier C entry points have no stride arguments)."""
    with open(os.path.join(tree, CSRC, 'photometric.cu')) as f:
        return 'int sxb' not in f.read()


def smooth_image(B, H, W, C, gen):
    """Values in [0, 1] that vary smoothly (a bilinear upsample of an 8 px
    noise grid) plus a little pixel noise, as a camera frame does."""
    import torch
    import torch.nn.functional as F
    dev = gen.device
    coarse = torch.rand(B, C, H // 8 + 2, W // 8 + 2, device=dev,
                        generator=gen)
    img = F.interpolate(coarse, size=(H, W), mode='bilinear',
                        align_corners=True)
    img = img + 0.02 * torch.randn(B, C, H, W, device=dev, generator=gen)
    return img.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def flow_grid(B, Ho, Wo, H, W, gen):
    """Normalised coordinates of a smooth flow (a few pixels, some of it
    leaving the image at the borders), one block of H rows per stacked
    scale, as the step's reprojection gives."""
    import torch
    dev = gen.device
    blocks = []
    for _ in range(Ho // H):
        ys, xs = torch.meshgrid(torch.arange(H, device=dev).float(),
                                torch.arange(Wo, device=dev).float(),
                                indexing='ij')
        ph = torch.rand(B, 4, 1, 1, device=dev, generator=gen) * 2 * math.pi
        x = xs + 6.0 * torch.sin(xs / 37.0 + ph[:, 0]) + 3.0 * torch.cos(
            ys / 23.0 + ph[:, 1]) + 0.37
        y = ys + 2.0 * torch.sin(xs / 51.0 + ph[:, 2]) + 1.5 * torch.cos(
            ys / 19.0 + ph[:, 3]) + 0.21
        blocks.append(torch.stack([2.0 * x / (W - 1) - 1.0,
                                   2.0 * y / (H - 1) - 1.0], -1))
    return torch.cat(blocks, 1).contiguous()


def photo_inputs(gen):
    """The (ii) step's photometric maps: ([(x, y, g)] forward, the first
    N_SCALES * N_CONTEXTS with their g for the backward). x is a row-slice
    of one warped [B,4H,W,3] tensor a context (a shifted, noisier target)
    or the context frame itself; y the target; g a strided slice of the
    [B,H,W,4] cotangent of the min over a scale's four maps."""
    import torch
    B, H, W = PHOTO_SHAPE
    dev = gen.device
    target = smooth_image(B, H, W, 3, gen)
    fwd, bwd = [], []
    for _ in range(N_CONTEXTS):
        ref = smooth_image(B, H, W, 3, gen)
        warped = torch.cat([(torch.roll(target, (1, 2), (1, 2)) + 0.05 * (
            torch.randn(target.shape, device=dev, generator=gen))).clamp(
                0.0, 1.0) for _ in range(N_SCALES)], 1)
        for i in range(N_SCALES):
            g = (torch.rand(B, H, W, 4, device=dev, generator=gen)
                 / (B * H * W))[..., i % 4]
            fwd.append((warped[:, i * H:(i + 1) * H], target, g))
            bwd.append(fwd[-1])
        fwd.append((ref, target, None))
    return fwd, bwd


def profiled(fn, names, iters=20):
    """Device ms a call of each kernel whose name holds one of `names`,
    from torch.profiler over `iters` calls of fn, and under 'other' the
    number and ms a call of every other kernel (the glue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out, other = {}, {'kernels': 0.0, 'ms': 0.0}
    for evt in prof.key_averages():
        total = getattr(evt, 'device_time_total', None)
        if total is None:
            total = getattr(evt, 'cuda_time_total', 0.0)
        if not total:
            continue
        hit = [name for name in names if name in evt.key]
        for name in hit:
            out[name] = out.get(name, 0.0) + total / 1e3 / iters
        if not hit:
            other['kernels'] += evt.count / iters
            other['ms'] += total / 1e3 / iters
    out['other'] = other
    return out


def times(fns):
    """Loop and graph ms of calling every fn in turn, and the profiler's
    kernel ms over the same calls."""
    run = lambda: [f() for f in fns]
    return {'ms': smoke.cuda_time_ms(run, iters=20),
            'graph_ms': smoke.graph_time_ms(run),
            'profiler_ms': profiled(run, KERNEL_NAMES)}


def check_warp(tag, kerns, wr):
    """out and dgrid of each input against this checkout's plain versions:
    atol 1e-6 x max|ref|, rtol 1e-6 (chip_smoke's warp rule); returns
    (max |err| of out, of dgrid, share of values bit-equal)."""
    import torch
    err, same, n = [0.0, 0.0], 0, 0
    for k in kerns:
        k.run_pair()
        torch.cuda.synchronize()
        want = (wr.bilinear_warp_reference(k.image, k.grid)[0],
                wr.warp_dgrid_reference(k.image, k.grid, k.g))
        for i, (nm, a, b) in enumerate(zip(('out', 'dgrid'), (k.out, k.dgrid),
                                           want)):
            err[i] = max(err[i], smoke.check_close(
                '{} warp {}'.format(tag, nm), a, b, 1e-6 * max(
                    float(b.float().abs().max()), 1e-30), 1e-6))
            same += int((a == b).sum())
            n += a.numel()
    return err[0], err[1], same / n


def check_photo(tag, fns, ph):
    """photo and dx of each map against this checkout's plain compositions
    (photometric_fwd_plain; photometric_bwd_plain without dy): forward
    atol = rtol = 1e-6, backward atol 1e-6 x max|ref|, rtol 1e-5
    (chip_smoke's rules); identical images give exact zeros."""
    import torch
    err = [0.0, 0.0]
    for k in fns:
        k.run_fwd()
        torch.cuda.synchronize()
        want = ph.photometric_fwd_plain(k.x, k.y)
        err[0] = max(err[0], smoke.check_close(
            '{} photometric fwd'.format(tag), k.photo, want, 1e-6, 1e-6))
        if k.g is None:
            continue
        k.run_bwd()
        torch.cuda.synchronize()
        want = ph.photometric_bwd_plain(k.x, k.y, k.g, False)[0]
        err[1] = max(err[1], smoke.check_close(
            '{} photometric bwd'.format(tag), k.dx, want,
            1e-6 * float(want.abs().max()), 1e-5))
    k = fns[0]
    same = PhotoFn(k.lib, k.padded, k.x, k.x, k.g)
    same.run_fwd()
    same.run_bwd()
    torch.cuda.synchronize()
    if bool(same.photo.any()) or bool(same.dx.any()):
        raise AssertionError('{} photometric: identical images must give '
                             'exact zeros'.format(tag))
    return err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', help='a tree whose kernels to time beside '
                    "this checkout's")
    ap.add_argument('--variant', help="a tree with this checkout's entry "
                    'points (an intermediate design) to time beside it')
    ap.add_argument('--sass', action='store_true',
                    help="print each kernel's SASS instructions by opcode "
                    'and write the SASS to chiprun_out/')
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_warp_photometric_levels: no CUDA device',
              file=sys.stderr)
        return 2
    os.chdir(ROOT)
    import torch.nn.functional as F
    from packnet_sfm_tpu_torch.ops.kernels import photometric as ph
    from packnet_sfm_tpu_torch.ops.kernels import warp as wr

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    smoke.log('card:', card)
    smoke.log('torch', torch.__version__, 'cuda', torch.version.cuda)
    trees = [('pr', ROOT)]
    if opts.variant:
        trees.insert(0, ('variant', os.path.abspath(opts.variant)))
    if opts.parent:
        trees.insert(0, ('parent', os.path.abspath(opts.parent)))
    libs = {}
    for tag, tree in trees:
        t0 = time.time()
        libs[tag], paths, ptxas = build_tree(tag, tree)
        smoke.log('build {} ({}): {:.1f} s'.format(tag, tree,
                                                   time.time() - t0))
        for line in ptxas:
            smoke.log('  ptxas:', line)
        if opts.sass:
            for name, path in paths.items():
                sass_histogram(tag, name, path)
    first = [t for t, _ in trees]
    order = first + first[::-1]
    if len(trees) == 1:
        order = first

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    results, failed = {'warp': [], 'photometric': None}, []

    for name, dname, B, H, W, Ho in WARP_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        dt = getattr(torch, dname)
        items = []
        for _ in range(WARPS_PER_STEP):
            image = smooth_image(B, H, W, 3, gen).to(dt)
            grid = flow_grid(B, Ho, W, H, W, gen)
            g = (torch.randn(B, Ho, W, 3, device=dev, generator=gen)
                 / (B * Ho * W)).to(dt)
            items.append((image, grid, g))
        # the function's bound: image, grid, g read once, out and dgrid
        # written once; the forward's: image, grid read, out written.
        # ~12 FLOPs a pixel for the coordinates and ~16 a channel for the
        # taps and weights forward, ~24 a channel backward
        es = items[0][0].element_size()
        n_out = B * Ho * W
        fb = [smoke.bound(i.numel() * es + gr.numel() * 4 + n_out * 3 * es,
                          n_out * (12 + 16 * 3), 'float32')
              for i, gr, _ in items]
        pb = [smoke.bound(i.numel() * es + gr.numel() * 4 + 2 * n_out * 3 * es
                          + gr.numel() * 4, n_out * (24 + 40 * 3), 'float32')
              for i, gr, _ in items]
        with torch.no_grad():
            plain = smoke.cuda_time_ms(lambda: [
                (wr.bilinear_warp_reference(i, gr)[0],
                 wr.warp_dgrid_reference(i, gr, g)) for i, gr, g in items],
                iters=3, warmup=1)
            lib_items = [(i.float().permute(0, 3, 1, 2).contiguous(), gr,
                          g.float().permute(0, 3, 1, 2).contiguous())
                         for i, gr, g in items]

            def library():
                for im, gr, g in lib_items:
                    F.grid_sample(im, gr, mode='bilinear',
                                  padding_mode='zeros', align_corners=True)
                    torch.ops.aten.grid_sampler_2d_backward(
                        g, im, gr, 0, 0, True, [False, True])
            lib = {'graph_ms': smoke.graph_time_ms(library),
                   'ms': smoke.cuda_time_ms(library)}
        row = {'shape': name, 'dtype': dname, 'B': B, 'H': H, 'W': W,
               'Ho': Ho, 'Wo': W, 'launches_per_step': WARPS_PER_STEP,
               'fwd_bound_ms': sum(b[0] for b in fb),
               'pair_bound_ms': sum(b[0] for b in pb),
               'plain_pair_ms': plain, 'library_pair': lib, 'runs': []}
        for i, tag in enumerate(order):
            kerns = [Warp(libs[tag]['warp'], *it) for it in items]
            check = None
            if tag not in order[:i]:
                try:
                    e_out, e_dg, share = check_warp(
                        '{} {} {}'.format(tag, name, dname), kerns, wr)
                    check = {'out_err': e_out, 'dgrid_err': e_dg,
                             'bit_equal_share': share}
                except AssertionError as exc:
                    check = {'failed': str(exc)}
                    failed.append(str(exc))
            with torch.no_grad():
                run = {'tree': tag, 'check': check,
                       'fwd': times([k.run_fwd for k in kerns]),
                       'bwd': times([k.run_bwd for k in kerns]),
                       'pair': times([k.run_pair for k in kerns])}
            row['runs'].append(run)
            smoke.log(
                '{} warp {} {} B{} {}x{} -> {}x{} x{}: fwd {:.4f} (graph '
                '{:.4f}) bwd {:.4f} ({:.4f}) pair {:.4f} ({:.4f}) ms; '
                'profiler {}; bound fwd {:.4f} pair {:.4f}; library pair '
                '{:.4f} (graph {:.4f}); plain pair {:.3f}{}'.format(
                    tag, name, dname, B, H, W, Ho, W, WARPS_PER_STEP,
                    run['fwd']['ms'], run['fwd']['graph_ms'],
                    run['bwd']['ms'], run['bwd']['graph_ms'],
                    run['pair']['ms'], run['pair']['graph_ms'],
                    fmt_split(run['pair']['profiler_ms']),
                    row['fwd_bound_ms'], row['pair_bound_ms'], lib['ms'],
                    lib['graph_ms'], plain,
                    '' if check is None else '; check ' + json.dumps(check)))
            del kerns
        results['warp'].append(row)
        del items, lib_items

    # the photometric function over a (ii) step's 10 forward and 8
    # backward maps
    gen = torch.Generator(device=dev).manual_seed(1)
    f_maps, b_maps = photo_inputs(gen)
    B, H, W = PHOTO_SHAPE
    n = B * H * W
    # bounds: x, y read and photo written once, ~100 FLOPs a pixel and
    # channel; x, y, g read and dx written once, ~180
    fb = [smoke.bound((2 * 3 * n + n) * 4, n * 300, 'float32')
          for _ in f_maps]
    bb = [smoke.bound((3 * 3 * n + n) * 4, n * 540, 'float32')
          for _ in b_maps]
    with torch.no_grad():
        plain = {'fwd': smoke.cuda_time_ms(lambda: [
            ph.photometric_fwd_plain(x, y) for x, y, _ in f_maps],
            iters=3, warmup=1),
                 'bwd': smoke.cuda_time_ms(lambda: [
                     ph.photometric_bwd_plain(x, y, g, False)
                     for x, y, g in b_maps], iters=3, warmup=1)}
    row = {'shape': [B, H, W, 3], 'fwd_launches_per_step': len(f_maps),
           'bwd_launches_per_step': len(b_maps),
           'fwd_bound_ms': sum(b[0] for b in fb),
           'bwd_bound_ms': sum(b[0] for b in bb),
           'bound_by': 'bytes' if fb[0][1] > fb[0][2] else 'operations',
           'plain_ms': plain, 'runs': []}
    for i, tag in enumerate(order):
        padded = takes_padded(dict(trees)[tag])
        fns = [PhotoFn(libs[tag]['photometric'], padded, *m) for m in f_maps]
        check = None
        if tag not in order[:i]:
            try:
                e_f, e_b = check_photo('{} photometric'.format(tag), fns, ph)
                check = {'fwd_err': e_f, 'bwd_err': e_b}
            except AssertionError as exc:
                check = {'failed': str(exc)}
                failed.append(str(exc))
        with torch.no_grad():
            run = {'tree': tag, 'padded_glue': padded, 'check': check,
                   'fwd': times([k.run_fwd for k in fns]),
                   'bwd': times([k.run_bwd for k in fns
                                 if k.g is not None])}
        row['runs'].append(run)
        smoke.log(
            '{} photometric B{} {}x{} NHWC: fwd x{} {:.4f} ms (graph {:.4f}; '
            'profiler {}), bound {:.4f}; bwd x{} {:.4f} (graph {:.4f}; '
            'profiler {}), bound {:.4f} ({}); plain fwd {:.3f} bwd {:.3f}{}'
            .format(tag, B, H, W, len(f_maps), run['fwd']['ms'],
                    run['fwd']['graph_ms'],
                    fmt_split(run['fwd']['profiler_ms']),
                    row['fwd_bound_ms'], len(b_maps), run['bwd']['ms'],
                    run['bwd']['graph_ms'],
                    fmt_split(run['bwd']['profiler_ms']),
                    row['bwd_bound_ms'], row['bound_by'], plain['fwd'],
                    plain['bwd'],
                    '' if check is None else '; check ' + json.dumps(check)))
        del fns
    results['photometric'] = row

    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/torch_warp_photometric_levels.json', 'w') as f:
        json.dump({'card': card, 'order': order, 'results': results,
                   'failed': failed}, f, indent=1)
    for msg in failed:
        smoke.log('FAILED:', msg)
    smoke.log(card)
    return 1 if failed else 0


def fmt_split(split):
    """The profiler's kernel ms a call, and the other kernels' count and
    ms."""
    parts = ['{} {:.4f}'.format(k, v) for k, v in split.items()
             if k != 'other']
    other = split.get('other')
    if other:
        parts.append('other kernels {:g} ({:.4f} ms)'.format(
            other['kernels'], other['ms']))
    return ', '.join(parts) or 'n/a'


def sass_histogram(tag, name, lib_path, top=20):
    """cuobjdump -sass of a built library: the SASS to
    chiprun_out/levels_<tag>_<name>.sass and, per kernel function, its
    instruction count, its memory, shuffle and division instructions and
    its most frequent opcodes."""
    from packnet_sfm_tpu_torch.ops.kernels import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/levels_{}_{}.sass'.format(tag, name), 'w') as f:
        f.write(sass)
    kernels, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            fn = line.split('Function :')[1].strip()
            kernels[fn] = {}
        elif fn and line.strip().startswith('/*') and '*/' in line:
            words = line.split('*/', 1)[1].replace(';', ' ').split()
            if words and words[0].startswith('@'):
                words = words[1:]
            if words:
                kernels[fn][words[0]] = kernels[fn].get(words[0], 0) + 1
    keys = ('LDG', 'STG', 'LDS', 'STS', 'SHFL', 'MUFU', 'FCHK', 'BAR',
            'FADD', 'FMUL', 'FFMA', 'CALL')
    for fn, ops in kernels.items():
        cls = {k: sum(v for op, v in ops.items() if op.split('.')[0] == k)
               for k in keys}
        smoke.log('  SASS {} {} {}: {} instructions; {}; top: {}'.format(
            tag, name, fn, sum(ops.values()), ', '.join(
                '{} {}'.format(k, v) for k, v in cls.items() if v),
            ', '.join('{} {}'.format(k, v) for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top])))


if __name__ == '__main__':
    sys.exit(main())
