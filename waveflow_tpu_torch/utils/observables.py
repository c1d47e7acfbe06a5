"""Training observables: sliding statistics and robust energy estimators.

The port's own copy of waveflow_tpu/utils/observables.py (numpy only).

Covers the role of the reference's smoothing helpers (helpers.py:125-145)
plus outlier-controlled energy estimators the reference lacks (SURVEY §6
caveat: the committed energies.npy is a raw heavy-tailed trace, not an
outlier-controlled estimate).
"""

from __future__ import annotations

import numpy as np


def _edge_padded(data: np.ndarray, window: int) -> np.ndarray:
    data = np.asarray(data, dtype=float)
    pad = [(0, 0)] * (data.ndim - 1) + [(window - 1, 0)]
    return np.pad(data, pad, mode='edge')


def _window_sums(padded: np.ndarray, window: int) -> np.ndarray:
    """Trailing window sums along the last axis via prefix sums."""
    csum = np.cumsum(padded, axis=-1)
    zero = np.zeros(csum.shape[:-1] + (1,))
    csum = np.concatenate([zero, csum], axis=-1)
    return csum[..., window:] - csum[..., :-window]


def uniform_sliding_average(data: np.ndarray, window: int) -> np.ndarray:
    """Trailing moving average, edge-padded so output matches input shape."""
    return _window_sums(_edge_padded(data, window), window) / window


def uniform_sliding_stdev(data: np.ndarray, window: int) -> np.ndarray:
    """Trailing moving standard deviation (same edge padding as the mean)."""
    padded = _edge_padded(data, window)
    m = _window_sums(padded, window) / window
    m2 = _window_sums(padded ** 2, window) / window
    return np.sqrt(np.maximum(m2 - m * m, 0.0))


def moving_average(running, new, beta):
    """EMA update."""
    return running - beta * (running - new)


def clipped_energy_estimate(trace: np.ndarray, clip: float = 100.0,
                            tail_fraction: float = 0.2,
                            block_size: int = 100):
    """Clip-±clip tail mean with blocked stderr.

    Matches the reference's training clip (vqmc.py:184).  NOTE: a fixed
    absolute clip is *biased* on heavy-tailed local-energy traces (nodal
    spikes are one-sided); prefer ``median_energy_estimate`` as the primary
    statistic for n>=3 fermion systems — see RESULTS.md.
    """
    trace = np.asarray(trace, dtype=float).ravel()
    tail = trace[int(len(trace) * (1 - tail_fraction)):]
    tail = np.clip(tail, -clip, clip)
    n_blocks = max(1, len(tail) // block_size)
    blocks = tail[:n_blocks * block_size].reshape(n_blocks, block_size)
    means = blocks.mean(-1)
    return float(means.mean()), float(means.std(ddof=1) / np.sqrt(n_blocks)
                                      if n_blocks > 1 else np.inf)


def median_energy_estimate(trace: np.ndarray, tail_fraction: float = 0.2,
                           block_size: int = 100):
    """Clip-free robust tail estimate: (tail median, blocked-median stderr).

    The median of the per-epoch batch-mean trace is immune to the one-sided
    nodal spikes that bias any fixed-clip mean (the variational-bound
    violations flagged in round-1 review); the stderr is the spread of
    per-block medians, respecting autocorrelation like the blocked mean.
    """
    trace = np.asarray(trace, dtype=float).ravel()
    tail = trace[int(len(trace) * (1 - tail_fraction)):]
    n_blocks = max(1, len(tail) // block_size)
    blocks = tail[:n_blocks * block_size].reshape(n_blocks, block_size)
    medians = np.median(blocks, axis=-1)
    stderr = (medians.std(ddof=1) / np.sqrt(n_blocks)
              if n_blocks > 1 else np.inf)
    return float(np.median(tail)), float(stderr)
