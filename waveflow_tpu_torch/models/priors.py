"""Fixed prior distributions for flow models: ``Normal``, ``Uniform`` and
``GMM``.

Port of waveflow_tpu/models/priors.py.  A prior has ``log_pdf(inputs) -> (batch,)`` and ``sample(num_samples,
input_dim, generator, device) -> (num_samples, input_dim)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Normal:
    """Standard normal density of ``inputs + offset``, independent columns."""

    def __init__(self, offset: float = 0.0):
        self.offset = offset

    def log_pdf(self, inputs: torch.Tensor) -> torch.Tensor:
        z = inputs + self.offset
        return (-0.5 * z * z - 0.5 * math.log(2.0 * math.pi)).sum(1)

    def sample(self, num_samples: int, input_dim: int,
               generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
        return torch.randn((num_samples, input_dim), generator=generator,
                           device=device)


class Uniform:
    """Uniform density on the unit cube: log-density 0 inside, −inf outside."""

    def log_pdf(self, inputs: torch.Tensor) -> torch.Tensor:
        inside = (inputs >= 0.0) & (inputs <= 1.0)
        zero = inputs.new_zeros(())
        return torch.where(inside, zero, zero - math.inf).sum(1)

    def sample(self, num_samples: int, input_dim: int,
               generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
        return torch.rand((num_samples, input_dim), generator=generator,
                          device=device)


class GMM:
    """Gaussian-mixture prior: means (K, D), covariances (K, D, D) and
    weights (K,) (normalized here).  The log-density is a logsumexp over
    the components of the log-weight plus the component's Gaussian
    log-density; a draw takes a categorical component index and
    reparameterizes with that component's Cholesky factor."""

    def __init__(self, means, covariances, weights, device=None):
        self.means = torch.as_tensor(np.asarray(means, np.float32),
                                     device=device)
        self.covs = torch.as_tensor(np.asarray(covariances, np.float32),
                                    device=device)
        log_w = torch.log(torch.as_tensor(np.asarray(weights, np.float32),
                                          device=device))
        self.log_w = log_w - torch.logsumexp(log_w, 0)
        self.chols = torch.linalg.cholesky(self.covs)        # (K, D, D)

    def log_pdf(self, inputs: torch.Tensor) -> torch.Tensor:
        diff = inputs[None] - self.means[:, None]            # (K, B, D)
        # z = L^-1 (x - m), so (x - m)^T Σ^-1 (x - m) = |z|^2
        z = torch.linalg.solve_triangular(
            self.chols, diff.transpose(-1, -2), upper=False)  # (K, D, B)
        half_log_det = torch.log(torch.diagonal(
            self.chols, dim1=-2, dim2=-1)).sum(-1)           # (K,)
        D = inputs.shape[-1]
        comp = (-0.5 * (z * z).sum(-2) - half_log_det[:, None]
                - 0.5 * D * math.log(2.0 * math.pi))         # (K, B)
        return torch.logsumexp(self.log_w[:, None] + comp, 0)

    def sample(self, num_samples: int, input_dim: int,
               generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
        ks = torch.multinomial(torch.exp(self.log_w), num_samples,
                               replacement=True, generator=generator)
        eps = torch.randn((num_samples, self.means.shape[-1]),
                          generator=generator, device=self.means.device)
        return (self.means[ks]
                + torch.einsum('nij,nj->ni', self.chols[ks], eps)).to(device)
