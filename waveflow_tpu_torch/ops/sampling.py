"""Exact inverse-CDF sampling of spline densities.

Port of waveflow_tpu/ops/sampling.py (``sample_squared_amplitude``,
``sample_linear_density`` and the cell locate they share).  The runtime
density is built on the linearly interpolated table ψ = w · T: p ∝ ψ² for
the squared-B-spline conditionals (closed-form cubic cell masses, in-cell
solve by bracketing bisection + Newton polish) and p ∝ max(ψ, 0) for the
M-spline priors (trapezoid cell masses, closed-form quadratic in-cell
solve).  Both: density on the mesh (one matmul), cell masses, prefix-sum
CDF, cell locate, in-cell solve.

``impl='auto'`` sends every CUDA tensor to the fused kernel (K1 'squared',
K2 'linear'; ops/cuda_sampler.py) and a CPU tensor to the plain paths
below, which are the kernels' plain versions.
"""

from __future__ import annotations

import torch

from waveflow_tpu_torch.ops.spline_eval import SplineEvaluator

# above this many (batch x n_cells) elements the two-level block locate is
# used (fewer passes over the row block than one flat cumsum + compare)
TWO_LEVEL_MIN_ELEMENTS = 2 ** 23
COARSE_BLOCKS = 64


def _cdf0(masses: torch.Tensor) -> torch.Tensor:
    """Prefix-sum CDF with a leading zero: (..., M) -> (..., M+1)."""
    return torch.cat([torch.zeros_like(masses[..., :1]),
                      torch.cumsum(masses, dim=-1)], dim=-1)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, idx[..., None])[..., 0]


def _locate_in_masses(masses: torch.Tensor, u: torch.Tensor):
    """Cell j of the draw u∈[0,1) against the normalized mass CDF, and the
    residual mass q inside cell j.  Flat cumsum + compare up to
    TWO_LEVEL_MIN_ELEMENTS elements, coarse-block / in-block above."""
    M = masses.shape[-1]
    if masses.numel() <= TWO_LEVEL_MIN_ELEMENTS:
        cdf = _cdf0(masses)
        target = u * cdf[..., -1]
        j = torch.clamp((cdf <= target[..., None]).sum(-1) - 1, 0, M - 1)
        return j, target - _take(cdf, j)

    C = COARSE_BLOCKS
    K = -(-M // C)
    pad = C * K - M
    if pad:
        masses = torch.cat([masses, masses.new_zeros(masses.shape[:-1] + (pad,))],
                           dim=-1)
    blocks = masses.reshape(masses.shape[:-1] + (C, K))
    bcdf = _cdf0(blocks.sum(-1))                           # (..., C+1)
    target = u * bcdf[..., -1]
    c = torch.clamp((bcdf <= target[..., None]).sum(-1) - 1, 0, C - 1)
    q1 = target - _take(bcdf, c)
    fine = torch.gather(
        blocks, -2, c[..., None, None].expand(c.shape + (1, K)))[..., 0, :]
    fcdf = _cdf0(fine)                                     # (..., K+1)
    jf = torch.clamp((fcdf <= q1[..., None]).sum(-1) - 1, 0, K - 1)
    q = q1 - _take(fcdf, jf)
    j = torch.clamp(c * K + jf, 0, M - 1)
    return j, q


def _flat_batch(coeffs: torch.Tensor, u: torch.Tensor):
    """The kernels take one (N, n_bases) batch: leading dims flattened."""
    if u.shape != coeffs.shape[:-1]:
        raise ValueError(f"u {tuple(u.shape)} does not match the batch "
                         f"of coeffs {tuple(coeffs.shape)}")
    return coeffs.reshape(-1, coeffs.shape[-1]), u.reshape(-1)


def sample_linear_density(evaluator: SplineEvaluator,
                          coeffs: torch.Tensor,
                          u: torch.Tensor,
                          impl: str = 'auto') -> torch.Tensor:
    """Inverse-CDF sample of the piecewise-linear density d(x) = w·T(x),
    clamped at 0.

    coeffs: (..., n_bases) spline coefficients (M-splines), u: (...,)
    uniforms in [0, 1) -> (...,) exact samples of the normalized
    table-interpolated density.  ``impl`` as in sample_squared_amplitude:
    'auto' (K2 for a CUDA tensor, the plain path for a CPU one), 'cuda' or
    'plain'.  In-cell mass h(a s + b s²/2), inverted in closed form.
    """
    if impl == 'auto':
        impl = 'cuda' if coeffs.is_cuda else 'plain'
    if impl == 'cuda':
        from waveflow_tpu_torch.ops.cuda_sampler import (
            sample_linear_density_cuda)
        x = sample_linear_density_cuda(evaluator, *_flat_batch(coeffs, u))
        return x.reshape(u.shape)
    if impl != 'plain':
        raise ValueError(f"unknown impl {impl!r}")
    dens = torch.clamp(evaluator.density_on_mesh(coeffs), min=0.0)   # (B, P)
    h = 1.0 / (dens.shape[-1] - 1)
    d_l = dens[..., :-1]
    d_r = dens[..., 1:]
    masses = 0.5 * (d_l + d_r) * h
    j, q = _locate_in_masses(masses, u)
    a = _take(d_l, j)
    b = _take(d_r, j) - a
    # solve h*(a s + b s^2/2) = q for s in [0, 1]
    qn = q / h
    flat = b.abs() < 1e-12
    disc = torch.sqrt(torch.clamp(a * a + 2.0 * b * qn, min=0.0))
    s_quad = (disc - a) / torch.where(flat, torch.ones_like(b), b)
    s_lin = qn / torch.clamp(a, min=1e-12)
    s = torch.clamp(torch.where(flat, s_lin, s_quad), 0.0, 1.0)
    return (j + s) * h


def sample_squared_amplitude(evaluator: SplineEvaluator,
                             coeffs: torch.Tensor,
                             u: torch.Tensor,
                             n_bisect: int = 12,
                             n_newton: int = 3,
                             impl: str = 'auto') -> torch.Tensor:
    """Inverse-CDF sample of p(x) ∝ (w·T(x))², ψ piecewise linear.

    coeffs: (..., n_bases), u: (...,) uniforms -> (...,) samples in [0, 1].
    ``impl``: 'auto' (K1 for a CUDA tensor, the plain path for a CPU one),
    'cuda' or 'plain'.  The kernel takes the leading dims flattened to one
    batch.  In-cell mass m(s) = h(ψ_l² s + ψ_l Δ s² + Δ² s³/3), inverted
    by n_bisect bracketing steps + n_newton clipped Newton steps.
    """
    if impl == 'auto':
        impl = 'cuda' if coeffs.is_cuda else 'plain'
    if impl == 'cuda':
        from waveflow_tpu_torch.ops.cuda_sampler import (
            sample_squared_amplitude_cuda)
        x = sample_squared_amplitude_cuda(
            evaluator, *_flat_batch(coeffs, u), n_bisect, n_newton)
        return x.reshape(u.shape)
    if impl != 'plain':
        raise ValueError(f"unknown impl {impl!r}")
    psi = evaluator.density_on_mesh(coeffs)                # (B, P)
    h = 1.0 / (psi.shape[-1] - 1)
    p_l = psi[..., :-1]
    delta = psi[..., 1:] - p_l
    masses = h * (p_l * p_l + p_l * delta + delta * delta / 3.0)
    j, q = _locate_in_masses(masses, u)
    a = _take(p_l, j)
    d = _take(delta, j)

    def mass(s):
        return h * (a * a * s + a * d * s * s + d * d * s ** 3 / 3.0)

    lo = torch.zeros_like(q)
    hi = torch.ones_like(q)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        gt = mass(mid) > q
        lo = torch.where(gt, lo, mid)
        hi = torch.where(gt, mid, hi)
    s = 0.5 * (lo + hi)
    for _ in range(n_newton):
        v = a + d * s
        s = torch.minimum(torch.maximum(
            s - (mass(s) - q) / torch.clamp(h * v * v, min=1e-14), lo), hi)
    return (j + s) * h
