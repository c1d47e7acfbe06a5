"""The whole training epoch's share of the card's f32 peak (outside the
tensor cores: the port runs matmul precision 'highest'): the model FLOPs
(flops/waveflow.py) of the epochs of the measured, unprofiled window over
that window's host-clock seconds × the peak of peaks.json, in %."""

from perfbench.flops import waveflow
from perfbench.kernels import peaks


def read(run):
    p = peaks(run.device_kind)
    if run.job != 'train' or not run.epochs or p is None:
        return None
    flops = waveflow.train_epoch(run.cfg, run.walkers) * run.epochs
    return 100.0 * flops / (run.elapsed_s * p['f32_flop_per_s'])
