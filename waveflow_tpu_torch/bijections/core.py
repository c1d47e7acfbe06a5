"""Bijection combinators: ``Serial`` and ``Reverse``.

Port of the two combinators of waveflow_tpu/bijections/core.py that the
Waveflow path uses.  A layer is an ``nn.Module`` with
``forward(x) -> (y, log_det)`` and ``inverse(y) -> (x, log_det)`` over a
(batch, dim) tensor.
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
