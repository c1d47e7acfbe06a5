"""2D density-estimation benchmark datasets, generated with NumPy alone.

Port of waveflow_tpu/benchmark/datasets.py.  ``halfmoon`` and ``circles``
are the two-moons and concentric-circles constructions (points on the
curves, one shuffle, Gaussian noise of 0.05), drawn from
``np.random.RandomState(seed)`` in that order, then min-max scaled into
the unit square with a margin.  ``gaussian_mixtures`` needs a fitted
Gaussian mixture and is not ported.
"""

from __future__ import annotations

import numpy as np

NOISE = 0.05
CIRCLES_FACTOR = 0.5      # inner radius over outer radius


def _minmax_scale(X: np.ndarray, margin: float) -> np.ndarray:
    lo, hi = X.min(0), X.max(0)
    X01 = (X - lo) / (hi - lo)
    return X01 * (1 - 2 * margin) + margin


def _two_curves(outer: np.ndarray, inner: np.ndarray, seed: int) -> np.ndarray:
    """Stack two (n, 2) point sets, shuffle the rows once and add the
    noise, in the draw order of the reference generators."""
    rng = np.random.RandomState(seed)
    X = np.concatenate([outer, inner], axis=0)
    order = np.arange(len(X))
    rng.shuffle(order)
    X = X[order]
    return X + rng.normal(scale=NOISE, size=X.shape)


def get_dataset(name: str = 'circles', n_samples: int = 1000,
                margin: float = 0.025, seed: int = 42) -> np.ndarray:
    """(n_samples, 2) float32 points in [margin, 1 − margin]²."""
    n_out = n_samples // 2
    n_in = n_samples - n_out
    if name == 'gaussian_mixtures':
        raise NotImplementedError(
            "the 'gaussian_mixtures' dataset draws from a fitted Gaussian "
            "mixture and is not ported yet (ROADMAP Queue 1, item 16b)")
    if name == 'halfmoon':
        t_out = np.linspace(0, np.pi, n_out)
        t_in = np.linspace(0, np.pi, n_in)
        outer = np.stack([np.cos(t_out), np.sin(t_out)], -1)
        inner = np.stack([1 - np.cos(t_in), 1 - np.sin(t_in) - 0.5], -1)
    elif name in ('circles', 'double_circles'):
        t_out = np.linspace(0, 2 * np.pi, n_out, endpoint=False)
        t_in = np.linspace(0, 2 * np.pi, n_in, endpoint=False)
        outer = np.stack([np.cos(t_out), np.sin(t_out)], -1)
        inner = np.stack([np.cos(t_in), np.sin(t_in)], -1) * CIRCLES_FACTOR
    else:
        raise ValueError(f"unknown dataset {name!r}")
    X = _two_curves(outer, inner, seed)
    return _minmax_scale(np.asarray(X, dtype=np.float32), margin)
