"""The traced window of a ``--trace 1`` run: device activity from
``torch.profiler`` (CUPTI), reduced to what the per-layer metrics read.

``traced(fn, units, warm)`` profiles one call of ``fn`` with the device's
activities and the host's CUDA runtime calls only (recording the host's
operators too lengthened the traced 1D epoch by 13-33%), and returns a
``Trace``:

  * the device's activities (kernels, copies, sets) inside the window, with
    their names, starts and durations;
  * ``window_s``: from the start of the call's first CUDA runtime call to
    the end of its last, the closing synchronise; ``busy_s``: the union of
    the device's activities inside it;
  * ``units``: the epochs the call ran, for per-unit readings.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class Trace:
    units: int
    window_s: float
    busy_s: float
    device: list = field(default_factory=list)   # (name, start_us, dur_us)
    host: list = field(default_factory=list)     # (name, start_us, end_us)
    start_us: float = 0.0
    end_us: float = 0.0

    def kernels(self, pattern: str):
        """(count, seconds) of the device activities whose name matches."""
        rx = re.compile(pattern)
        hits = [d for _, _, d in (a for a in self.device if rx.search(a[0]))]
        return len(hits), sum(hits) * 1e-6

    def kernel_count(self) -> int:
        return sum(1 for name, _, _ in self.device
                   if not name.startswith(('Memcpy', 'Memset')))

    def breakdown(self) -> dict:
        """The ten device operations that took most time (by name), and the
        fifty longest idle gaps summed by what the host was doing in each
        (the shortest CUDA runtime call around the gap's midpoint; none:
        the host was in Python or the program's own code)."""
        ops: dict = {}
        for name, _, dur in self.device:
            ops[name] = ops.get(name, 0.0) + dur * 1e-6
        gaps: dict = {}
        for lo, hi in sorted(self._gaps(), key=lambda g: g[0] - g[1])[:50]:
            mid = 0.5 * (lo + hi)
            around = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            name = min(around)[1] if around else 'host: outside any CUDA call'
            gaps[name] = gaps.get(name, 0.0) + (hi - lo) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {'device_ops': top(ops), 'idle_gaps': top(gaps)}

    def _gaps(self):
        t, out = self.start_us, []
        for s, e in _union((s, s + d) for _, s, d in self.device):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end_us > t:
            out.append((t, self.end_us))
        return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _profile(fn):
    """The events of one profiled call of ``fn``: the device's activities
    and the host's CUDA runtime calls (no host operators: recording those
    lengthens the window it measures)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def traced(fn, units: int, warm=None) -> Trace:
    """Profile one call of ``fn``, after a discarded profiled call of
    ``warm`` (the profiler's first session runs slower).  The window runs
    from the start of the call's first CUDA runtime call to the end of its
    last (the closing synchronise); the profiler's own buffer work is left
    out of the host events."""
    from torch.autograd import DeviceType

    if warm is not None:
        _profile(warm)
    events = _profile(fn)
    device, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, 'is_user_annotation', False):
                device.append((e.name, s, t - s))
        elif e.name.startswith('cuda'):
            host.append((e.name, s, t))
    if not device or not host:
        raise RuntimeError("the profiler recorded no device activity")
    lo, hi = min(s for _, s, _ in host), max(t for _, _, t in host)
    device = [(n, max(s, lo), min(s + d, hi) - max(s, lo)) for n, s, d in device
              if min(s + d, hi) > max(s, lo)]
    busy = sum(e - s for s, e in _union((s, s + d) for _, s, d in device))
    return Trace(units=units, window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6,
                 device=device, host=host, start_us=lo, end_us=hi)
