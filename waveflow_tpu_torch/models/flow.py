"""Flow model: a bijection stack over a fixed prior.

Port of waveflow_tpu/models/flow.py.
"""

from __future__ import annotations

import torch
from torch import nn

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.models.priors import Normal


class Flow(nn.Module):

    def __init__(self, transformation: nn.Module, input_dim: int,
                 prior=None, prior_support=None, *, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.input_dim = input_dim
        self.transform = transformation
        self.prior = Normal() if prior is None else prior
        self.prior_support = prior_support

    def log_pdf(self, inputs: torch.Tensor, return_sample: bool = False):
        """log p(x): (B, D) -> (B,); with ``return_sample`` also the
        prior-space point u = T(x) (clipped to ``prior_support``)."""
        u, log_det = self.transform(inputs)
        if self.prior_support is not None:
            u = torch.clamp(u, *self.prior_support)
        log_probs = self.prior.log_pdf(u) + log_det
        return (log_probs, u) if return_sample else log_probs

    @torch.no_grad()
    def sample(self, num_samples: int = 1,
               generator: torch.Generator | None = None,
               return_original_samples: bool = False):
        """Prior draws (from ``generator``, on the model's device) mapped
        back through the inverse flow; with ``return_original_samples``
        also the prior draws."""
        prior_samples = self.prior.sample(num_samples, self.input_dim,
                                          generator, self.device)
        final = self.transform.inverse(prior_samples)[0]
        return (final, prior_samples) if return_original_samples else final


# the JAX package exposes the same model under this name too
InvFlow = Flow
