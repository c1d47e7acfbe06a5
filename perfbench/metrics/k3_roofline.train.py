"""K3's share of its roofline (train): the least device time of the basis
jets the algorithm needs per epoch (kernels/k3.py) over K3's device time per
epoch in the traced window, in %."""

from perfbench.kernels import k3


def read(run):
    if run.job != 'train' or run.trace is None:
        return None
    count, seconds = run.trace.kernels(k3.NAME)
    bound = k3.bound_per_site_set(run.cfg, run.walkers, run.device_kind)
    if not count or bound is None:
        return None
    site_sets = 1
    return 100.0 * bound * site_sets * run.trace.units / seconds
