"""Device kernels per replayed training epoch, counted in the traced
window (copies and sets left out)."""


def read(run):
    if run.job != 'train' or run.trace is None:
        return None
    return run.trace.kernel_count() / run.trace.units
