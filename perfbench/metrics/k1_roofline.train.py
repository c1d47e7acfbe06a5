"""K1's share of its roofline in training: the least device time of an
epoch's ancestral draw (kernels/k1.py) over K1's device time per epoch in
the traced window, in %."""

from perfbench.kernels import k1


def read(run):
    if run.job != 'train' or run.trace is None:
        return None
    count, seconds = run.trace.kernels(k1.NAME)
    bound = k1.bound_per_draw(run.cfg, run.walkers, run.device_kind)
    if not count or bound is None:
        return None
    return 100.0 * bound * run.trace.units / seconds
