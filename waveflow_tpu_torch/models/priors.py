"""Fixed prior distributions for flow models: ``Normal`` and ``Uniform``.

Port of waveflow_tpu/models/priors.py (the ``GMM`` prior is not ported).
A prior has ``log_pdf(inputs) -> (batch,)`` and ``sample(num_samples,
input_dim, generator, device) -> (num_samples, input_dim)``.
"""

from __future__ import annotations

import math

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
