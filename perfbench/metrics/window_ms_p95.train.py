"""The 95th percentile of the host-clock time of the run's training
windows (``trainer.train`` of one window, synchronised), in ms."""

from perfbench.harness import percentile


def read(run):
    if run.job != 'train' or not run.windows:
        return None
    return percentile(run.windows, 95) * 1e3
