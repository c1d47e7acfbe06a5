"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use, for Hopper only (``sm_90a``), into ``build/lib<name>_<hash>.so``
inside the package; the hash covers the source and the flags, so an edited
source is rebuilt.  ``build()`` compiles several sources at once, one
``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / 'build'
KERNELS = ('sampler', 'basis_jet', 'spline_eval')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOADED: dict = {}


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

