"""
Build the port's CUDA kernels from the sources in `packnet_sfm_tpu_torch/csrc`
into `build/kernels/` at the repository root, at first use.

Each source compiles with `nvcc -gencode arch=compute_90a,code=sm_90a` into
a shared library with a plain C interface, loaded with ctypes. The library's
file name carries a hash of the source and the flags, so an edited source
builds anew and an unchanged one is reused. `build_all` starts one nvcc per
source, all at once. Nothing here runs at import.

`-fmad=false`: nvcc does not fuse a product into a following sum unless the
source asks for it with fmaf, so a kernel that keeps its plain PyTorch
version's order of operations gives its results bit for bit.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v']

_loaded = {}


def find_nvcc():
    """The nvcc on PATH, else the CUDA toolkit's; raises when there is none."""
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                       'machine with the CUDA toolkit')


def library_path(name):
    """Path of the built library for csrc/<name>.cu at its current hash."""
    src = CSRC / '{}.cu'.format(name)
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / '{}-{}.so'.format(name, digest.hexdigest()[:16])


def build_all(names):
    """Compile each csrc/<name>.cu whose library does not exist, one nvcc
    process per source, all started together; returns {name: (path,
    compiler log or '' when reused)}. Raises if any compile fails."""
    results, jobs = {}, []
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = (out, '')
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-o', tmp, str(CSRC / '{}.cu'.format(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        try:
            log = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)
                results[name] = (out, log)
            else:
                failed.append('nvcc failed for {}.cu:\n{}'.format(name, log))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return results


def build(name):
    """Compile csrc/<name>.cu unless its library exists; returns
    (path, compiler log or '' when reused)."""
    return build_all([name])[name]


def load(name):
    """Build (if needed) and load csrc/<name>.cu as a ctypes library."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def function(name, symbol, n_ptr, n_int, n_float=0):
    """The C function `symbol` of csrc/<name>.cu, typed as n_ptr pointers,
    n_int ints, n_float floats and the stream (pointers and the stream as
    c_void_p: a default int would cut them); it returns an int."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
