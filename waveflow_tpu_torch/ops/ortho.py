"""Orthonormalization of spline bases (host-side NumPy, init-time only).

The reference (ortho_splines.py:43-112) builds an orthonormal B-spline basis
with a symmetrized two-sided Gram-Schmidt sweep that is only approximately
orthonormal and only supports an even number of bases.  Here we use Löwdin
symmetric orthogonalization instead:

    OB = S^{-1/2} B,   S_ij = ∫_0^1 B_i(x) B_j(x) dx  (trapezoid quadrature)

Löwdin is the unique orthonormalization that is closest to the original basis
in least-squares sense; it preserves the reflection symmetry of a clamped
uniform B-spline basis (the property the reference's symmetrized sweep was
after), works for any basis count, and is exactly orthonormal up to
quadrature error.  The basis-change matrices become exact inverses of each
other: b_to_ob = S^{-1/2}, ob_to_b = S^{1/2}.

Copy of waveflow_tpu/ops/ortho.py for the PyTorch port (pure NumPy).
"""

from __future__ import annotations

import numpy as np


def trapezoid_weights(n_points: int, a: float = 0.0, b: float = 1.0) -> np.ndarray:
    """Trapezoid-rule quadrature weights on a uniform mesh of n_points."""
    h = (b - a) / (n_points - 1)
    w = np.full(n_points, h)
    w[0] = w[-1] = h / 2
    return w


def loewdin_orthonormalize(values: np.ndarray, quad_weights: np.ndarray | None = None):
    """Löwdin-orthonormalize a family of functions sampled on a mesh.

    Args:
      values: (n_bases, n_points) function samples on a uniform mesh of [0,1].
      quad_weights: optional (n_points,) quadrature weights; trapezoid default.

    Returns:
      ob_values: (n_bases, n_points) with ∫ OB_i OB_j ≈ δ_ij.
      b_to_ob:   (n_bases, n_bases) = S^{-1/2}; ob rows = b_to_ob @ values.
      ob_to_b:   (n_bases, n_bases) = S^{1/2} = inverse of b_to_ob.
    """
    values = np.asarray(values, dtype=np.float64)
    n_bases, n_points = values.shape
    if quad_weights is None:
        quad_weights = trapezoid_weights(n_points)
    gram = (values * quad_weights[None, :]) @ values.T
    gram = 0.5 * (gram + gram.T)
    evals, evecs = np.linalg.eigh(gram)
    if evals.min() <= 0:
        raise ValueError(
            f"B-spline Gram matrix not positive definite (min eig {evals.min()}); "
            "increase n_mesh or reduce basis size")
    inv_sqrt = (evecs * (evals ** -0.5)[None, :]) @ evecs.T
    sqrt = (evecs * (evals ** 0.5)[None, :]) @ evecs.T
    ob_values = inv_sqrt @ values
    return ob_values, inv_sqrt, sqrt
