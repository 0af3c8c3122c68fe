"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface, at first use, into build/kernels/,
and loaded through ctypes.  Importing this module needs no nvcc: the
tests import every module on machines without the CUDA toolkit.

A build is keyed by a hash of the source, of every csrc/*.cuh header
(a header shared by two sources rebuilds both) and of the flags.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ['build_kernels', 'load', 'check_cuda', 'launch', 'NVCC_FLAGS']

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

_libs = {}


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'opty_tpu_torch are built at first use on a '
                           'machine with the CUDA toolkit')
    return path


def _target(src):
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / '{}-{}.so'.format(src.stem, digest.hexdigest()[:16])


def build_kernels():
    """Compile every csrc/*.cu that has no current build, one nvcc per
    source, all started together.  Returns {source name: compiler
    output} for the sources built by this call (ptxas -v reports
    registers, shared memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC.glob('*.cu')):
        target = _target(src)
        if target.exists():
            continue
        tmp = target.with_suffix('.{}.tmp'.format(os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
        jobs[src.name] = (target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = {}
    for name, (target, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on {}:\n{}'.format(name, out))
        os.replace(tmp, target)        # atomic: concurrent builds agree
        logs[name] = out
    return logs


def load(stem, signatures):
    """The library built from csrc/<stem>.cu, with ``argtypes`` set from
    ``signatures`` ({C function name: [ctypes types]}; every function
    returns an int cudaError_t)."""
    if stem not in _libs:
        target = _target(CSRC / (stem + '.cu'))
        if not target.exists():
            build_kernels()
        lib = ctypes.CDLL(str(target))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[stem] = lib
    return _libs[stem]


def check_cuda(name, tensors, shapes):
    """Raise unless every tensor lies on one CUDA device in one dtype,
    float32 or float64, contiguous and of its expected shape; returns
    the C functions' dtype suffix ('f32' or 'f64')."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.dtype != dtype:
            raise ValueError('{}: every input must share one device and '
                             'dtype'.format(name))
        if tuple(t.shape) != tuple(shape):
            raise ValueError('{}: expected shape {}, got {}'.format(
                name, tuple(shape), tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('{}: inputs must be contiguous'.format(name))
    if dev.type != 'cuda':
        raise ValueError('{}: tensors must lie on the CPU or on a CUDA '
                         'device, not {}'.format(name, dev))
    if dtype == torch.float32:
        return 'f32'
    if dtype == torch.float64:
        return 'f64'
    raise ValueError('{}: the kernels take float32 or float64, not '
                     '{}'.format(name, dtype))


def launch(name, fn, args, device):
    """Call the C entry ``fn(*args, stream)`` on ``device``'s current
    stream and raise if it returns a cudaError other than 0 (a refused
    launch never runs, and no later synchronize reports it)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError('{} launch failed: cudaError {}'.format(name, err))
