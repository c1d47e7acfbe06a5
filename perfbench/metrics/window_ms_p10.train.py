"""The 10th percentile of the host-clock time of the run's training
windows, in ms: the fast level of a run whose windows sit at two levels
(PERF.md), steadier from run to run than the window's rate."""

from perfbench.harness import percentile


def read(run):
    if run.job != 'train' or not run.windows:
        return None
    return percentile(run.windows, 10) * 1e3
