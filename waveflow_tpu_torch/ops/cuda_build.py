"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use, for Hopper only (``sm_90a``), into ``build/lib<name>_<hash>.so``
inside the package; the hash covers the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt.  ``build()``
compiles several sources at once, one ``nvcc`` process each, all started
together.  ``bind()`` declares a library's C signatures once, when it is
loaded; ``device_limits()`` asks a library's init entry point, once per
device, for the SM count and the shared memory a block may use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / 'build'
KERNELS = ('sampler', 'basis_jet', 'spline_eval')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# an H100: what the launch plans assume where no device is asked
N_SM = 132
SMEM_PER_BLOCK = 232_448      # dynamic shared memory a block may opt in to
SMEM_PER_SM = 233_472         # shared by the blocks resident on one SM
SMEM_BLOCK_RESERVE = 1024     # the system's own share of each resident block

_LOADED: dict = {}
_BOUND: dict = {}
_LIMITS: dict = {}

# the raw handle of PyTorch's current stream on a CUDA device, by its index;
# the direct getter where this build of torch has it (it skips the Stream
# object, which costs more than the rest of a wrapper's launch)
current_stream = getattr(
    torch._C, '_cuda_getCurrentRawStream',
    lambda index: torch.cuda.current_stream(index).cuda_stream)


class LaunchPlan(NamedTuple):
    """How a wrapper launches its kernel at one shape."""
    grid: int
    threads: int
    smem_bytes: int           # dynamic shared memory per block
    regime: str               # the kernel's variant at this shape
    group: int = 1            # work items a block takes together


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and (Path(cand) / 'bin' / 'nvcc').exists():
            return str(Path(cand) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f'{name}.cu').read_bytes()
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        src += header.read_bytes()
    digest = hashlib.sha1(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}_{digest[:12]}.so'


def build(names=KERNELS) -> dict:
    """Compile every missing library among ``names`` in parallel.

    Returns {name: (seconds, ptxas report)}; an up-to-date library reports
    (0.0, ''). Raises with nvcc's output if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    report = {}
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            report[name] = (0.0, '')
            continue
        tmp = target.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, target)
        report[name] = (time.perf_counter() - t0, out)
    if failures:
        raise RuntimeError('\n'.join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        build((name,))
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """``load(name)`` with the C signatures declared, once: ``signatures``
    maps an entry point to (argtypes, restype).  Without them ctypes passes
    a pointer as a 32-bit int."""
    if name not in _BOUND:
        lib = load(name)
        for entry, (argtypes, restype) in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = list(argtypes), restype
        _BOUND[name] = lib
    return _BOUND[name]


def device_limits(lib: ctypes.CDLL, init_entry: str, index: int) -> tuple:
    """(SM count, dynamic shared bytes a block may use) of CUDA device
    ``index``, from the library's ``init_entry(int*, int*)``, which also
    lifts its kernels' shared-memory limit there.  Asked once per library
    and device."""
    key = (init_entry, index)
    if key not in _LIMITS:
        n_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = getattr(lib, init_entry)(ctypes.byref(n_sm), ctypes.byref(smem))
        if err:
            raise RuntimeError(f"{init_entry} failed with CUDA error {err}")
        _LIMITS[key] = (n_sm.value, smem.value)
    return _LIMITS[key]
