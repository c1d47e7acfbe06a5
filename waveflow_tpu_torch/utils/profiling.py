"""Profiling hooks: profiler traces and steady-state timers.

Port of waveflow_tpu/utils/profiling.py.  ``trace(logdir)`` records the
enclosed block with ``torch.profiler`` (the host, and the card where there
is one) and writes a Chrome-format trace file under ``logdir`` through
``tensorboard_trace_handler``, which needs no tensorboard package;
``time_fn`` times a call in its steady state, by CUDA events when its
output lies on the card.  ``enable_persistent_compilation_cache`` keeps
the JAX package's signature: there is no XLA executable cache to turn on,
so it only makes and returns the directory.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the enclosed block and write one trace file
    (``*.pt.trace.json``) under ``logdir`` (default: a directory in the
    system's temporary directory); yields ``logdir``.  CUDA activity is
    recorded when CUDA is available."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), 'waveflow_tpu_trace')
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


def _on_cuda(out) -> bool:
    """Whether any tensor in ``out`` (a tensor, or a tuple, list or dict of
    them) lies on a CUDA device."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_cuda(o) for o in out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(o) for o in out)
    return False


def time_fn(fn, *args, iters: int = 20, warmup: int = 2) -> float:
    """Steady-state time per call of ``fn(*args)`` in seconds: ``warmup``
    calls, then ``iters`` timed ones (``fn`` runs ``warmup + iters`` times).
    When the last output lies on the card, the time is read from CUDA
    events recorded around the timed calls after a synchronise; otherwise
    from the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    events = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    if events is not None and _on_cuda(out):
        events[1].record()
        events[1].synchronize()
        return events[0].elapsed_time(events[1]) / 1e3 / iters
    return (time.perf_counter() - t0) / iters


def enable_persistent_compilation_cache(
        cache_dir: str = "~/.cache/waveflow_tpu/xla",
        min_compile_secs: float = 1.0) -> str:
    """Make ``cache_dir`` and return its expanded path, as the JAX
    package's function does.  Nothing else is set: PyTorch's eager kernels
    and the port's CUDA kernels (built once per source into
    ``waveflow_tpu_torch/build/``) have no XLA executable cache, so
    ``min_compile_secs`` has no effect."""
    del min_compile_secs
    path = os.path.expanduser(cache_dir)
    os.makedirs(path, exist_ok=True)
    return path
