"""Rational-quadratic spline (RQS) coupling layer.

Port of waveflow_tpu/bijections/rqs.py (Durkan et al., "Neural Spline
Flows", arXiv:1906.04032): an elementwise monotone RQS on [-B, B] with the
identity outside, closed-form forward and inverse, analytic log-det, and a
coupling layer whose lower half conditions an RQS of the upper half.  Plain
PyTorch: the JAX package runs it as XLA, with no Pallas kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

DEFAULT_MIN_BIN = 1e-3
DEFAULT_MIN_DERIV = 1e-3


def _normalize_bins(unnormalized: torch.Tensor, total: float,
                    min_bin: float) -> torch.Tensor:
    n = unnormalized.shape[-1]
    w = torch.softmax(unnormalized, dim=-1)
    return (min_bin + (1 - min_bin * n) * w) * total


def rational_quadratic_spline(x, unnorm_widths, unnorm_heights,
                              unnorm_derivs, interval: float = 3.0,
                              inverse: bool = False,
                              min_bin: float = DEFAULT_MIN_BIN,
                              min_deriv: float = DEFAULT_MIN_DERIV):
    """Elementwise monotone RQS on [-interval, interval], identity outside.

    x (...,), unnorm_widths / heights (..., K), unnorm_derivs (..., K-1) ->
    (y, log_abs_det), the log-det 0 outside the interval."""
    K = unnorm_widths.shape[-1]
    B = interval
    widths = _normalize_bins(unnorm_widths, 2 * B, min_bin)
    heights = _normalize_bins(unnorm_heights, 2 * B, min_bin)
    # the shift makes zero raw parameters a derivative of exactly 1 (the
    # identity at init); the boundary derivatives are pinned to 1
    shift = math.log(math.expm1(1.0 - min_deriv))
    derivs = min_deriv + nn.functional.softplus(unnorm_derivs + shift)
    pad = torch.ones_like(derivs[..., :1])
    derivs = torch.cat([pad, derivs, pad], dim=-1)               # (..., K+1)

    edge = torch.full_like(widths[..., :1], -B)
    cumw = torch.cat([edge, torch.cumsum(widths, -1) - B], -1)
    cumh = torch.cat([edge, torch.cumsum(heights, -1) - B], -1)

    inside = (x > -B) & (x < B)
    x_safe = torch.where(inside, x, torch.zeros_like(x))
    # the bin: the number of knots at or below x, minus 1 (JAX's
    # compare-sum, the same rule at ties)
    ref = cumh if inverse else cumw
    k = (ref[..., :-1] <= x_safe[..., None]).sum(-1) - 1
    k = torch.clamp(k, 0, K - 1)[..., None]

    def take(a):
        return torch.gather(a, -1, k)[..., 0]

    xk, yk, wk, hk = take(cumw), take(cumh), take(widths), take(heights)
    dk, dk1 = take(derivs), take(derivs[..., 1:])
    sk = hk / wk

    if not inverse:
        xi = (x_safe - xk) / wk
        xi1m = xi * (1 - xi)
        denom = sk + (dk1 + dk - 2 * sk) * xi1m
        y = yk + hk * (sk * xi ** 2 + dk * xi1m) / denom
        deriv = sk ** 2 * (dk1 * xi ** 2 + 2 * sk * xi1m
                           + dk * (1 - xi) ** 2) / denom ** 2
        return (torch.where(inside, y, x),
                torch.where(inside, torch.log(deriv), torch.zeros_like(x)))
    y_rel = x_safe - yk
    a = hk * (sk - dk) + y_rel * (dk1 + dk - 2 * sk)
    b = hk * dk - y_rel * (dk1 + dk - 2 * sk)
    c = -sk * y_rel
    disc = b ** 2 - 4 * a * c
    xi = torch.clamp(2 * c / (-b - torch.sqrt(torch.clamp(disc, min=0.0))),
                     0.0, 1.0)
    x_out = xi * wk + xk
    xi1m = xi * (1 - xi)
    denom = sk + (dk1 + dk - 2 * sk) * xi1m
    deriv = sk ** 2 * (dk1 * xi ** 2 + 2 * sk * xi1m
                       + dk * (1 - xi) ** 2) / denom ** 2
    return (torch.where(inside, x_out, x),
            torch.where(inside, -torch.log(deriv), torch.zeros_like(x)))


class NeuralSplineCoupling(nn.Module):
    """RQS coupling: the lower half of the coordinates (``input_dim // 2``)
    conditions, through a ReLU MLP of ``n_hidden`` layers of
    ``hidden_dim``, an RQS of ``n_bins`` bins on each upper coordinate.
    Weights start N(0, 1/fan_in) from ``generator``, biases at zero, and
    the last layer at zero: the layer starts as the identity.  The weights
    are ``W.i`` / ``b.i`` in the JAX (fan_in, fan_out) layout."""

    def __init__(self, input_dim: int, n_bins: int = 8,
                 interval: float = 3.0, hidden_dim: int = 64,
                 n_hidden: int = 2, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cutoff = input_dim // 2
        self.upper_dim = input_dim - self.cutoff
        self.n_bins, self.interval = n_bins, interval
        sizes = ([self.cutoff] + [hidden_dim] * n_hidden
                 + [self.upper_dim * (3 * n_bins - 1)])
        self.W = nn.ParameterList()
        self.b = nn.ParameterList()
        for i in range(len(sizes) - 1):
            W = torch.randn((sizes[i], sizes[i + 1]), generator=generator)
            W = W / math.sqrt(sizes[i]) if i < len(sizes) - 2 else W * 0.0
            self.W.append(nn.Parameter(W.to(device)))
            self.b.append(nn.Parameter(torch.zeros(sizes[i + 1],
                                                   device=device)))

    def _spline_params(self, lower: torch.Tensor):
        h = lower
        for i, (W, b) in enumerate(zip(self.W, self.b)):
            h = h @ W + b
            if i < len(self.W) - 1:
                h = torch.relu(h)
        theta = h.reshape(lower.shape[0], self.upper_dim, 3 * self.n_bins - 1)
        K = self.n_bins
        return theta[..., :K], theta[..., K:2 * K], theta[..., 2 * K:]

    def _couple(self, x: torch.Tensor, inverse: bool):
        lower, upper = x[:, :self.cutoff], x[:, self.cutoff:]
        y, ld = rational_quadratic_spline(upper, *self._spline_params(lower),
                                          self.interval, inverse=inverse)
        return torch.cat([lower, y], 1), ld.sum(-1)

    def forward(self, x: torch.Tensor):
        return self._couple(x, False)

    def inverse(self, y: torch.Tensor):
        return self._couple(y, True)
