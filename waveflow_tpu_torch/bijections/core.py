"""Bijection combinators: ``Serial``, ``Reverse`` and the affine ``MADE``.

Port of the combinators of waveflow_tpu/bijections/core.py that the
Waveflow and density-estimation paths use.  A layer is an ``nn.Module``
with ``forward(x) -> (y, log_det)`` and ``inverse(y) -> (x, log_det)`` over
a (batch, dim) tensor.
"""

from __future__ import annotations

import torch
from torch import nn


class Reverse(nn.Module):
    """Static dimension reversal."""

    def forward(self, x: torch.Tensor):
        return x.flip(-1), x.new_zeros(x.shape[:1])

    def inverse(self, y: torch.Tensor):
        return y.flip(-1), y.new_zeros(y.shape[:1])


class MADE(nn.Module):
    """Affine masked autoregressive layer.

    ``transform_factory(input_dim, *, generator, device)`` builds the masked
    network (``simple_masked_transform()``), which emits (batch, 2 *
    input_dim) concatenated (log_scale, shift)."""

    def __init__(self, transform_factory, input_dim: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.transform = transform_factory(input_dim, generator=generator,
                                           device=device)

    def forward(self, x: torch.Tensor):
        log_weight, bias = self.transform(x).chunk(2, dim=1)
        return (x - bias) * torch.exp(-log_weight), -log_weight.sum(-1)

    def inverse(self, y: torch.Tensor):
        # column i's (log_weight, bias) depend only on columns < i, which
        # are final by iteration i, so the per-column log-dets summed in the
        # loop are the true inverse log-det +Σ log_weight(x)
        outputs = torch.zeros_like(y)
        log_det = y.new_zeros(y.shape[:1])
        cols = torch.arange(y.shape[1], device=y.device)
        for i_col in range(y.shape[1]):
            log_weight, bias = self.transform(outputs).chunk(2, dim=1)
            col = y[:, i_col] * torch.exp(log_weight[:, i_col]) + bias[:, i_col]
            outputs = torch.where(cols == i_col, col[:, None], outputs)
            log_det = log_det + log_weight[:, i_col]
        return outputs, log_det


class Serial(nn.Module):
    """Sequential composition; accumulates log-dets."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor):
        log_det = x.new_zeros(x.shape[:1])
        for layer in self.layers:
            x, ldj = layer(x)
            log_det = log_det + ldj
        return x, log_det

    def inverse(self, y: torch.Tensor):
        log_det = y.new_zeros(y.shape[:1])
        for layer in reversed(self.layers):
            y, ldj = layer.inverse(y)
            log_det = log_det + ldj
        return y, log_det
