"""
Build the port's CUDA kernels from the sources in `packnet_sfm_tpu_torch/csrc`
into `build/kernels/` at the repository root, at first use.

Each source compiles with `nvcc -gencode arch=compute_90a,code=sm_90a` into
a shared library with a plain C interface, loaded with ctypes. The library's
file name carries a hash of the source and the flags, so an edited source
builds anew and an unchanged one is reused. Nothing here runs at import.
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
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

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


def build(name):
    """Compile csrc/<name>.cu unless its library exists; returns
    (path, compiler log or '' when reused)."""
    out = library_path(name)
    if out.exists():
        return out, ''
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, '-o', tmp, str(CSRC / '{}.cu'.format(name))],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed for {}.cu:\n{}{}'.format(
                name, proc.stdout, proc.stderr))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load(name):
    """Build (if needed) and load csrc/<name>.cu as a ctypes library."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
