"""MADE autoregressive masks and masked-dense conditioners.

Port of waveflow_tpu/bijections/masks.py.  Layers keep the JAX layout:
weights are (fan_in, fan_out) and a layer is ``h @ (W * m) + b``, so JAX
parameters load unchanged (convert.py).  Degrees follow the reference
scheme: input degrees 0..D-1, hidden degrees i % (D-1), output degrees
(i % D) - 1, connection allowed iff downstream >= upstream degree.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def made_degrees(input_dim: int, hidden_dim: int, num_hidden: int):
    if input_dim == 1:
        # one output slot conditioned on nothing: all-zero mask, bias only
        return [np.arange(1), np.arange(1) - 1]
    if input_dim < 1:
        raise ValueError("MADE masks require input_dim >= 1")
    degrees = [np.arange(input_dim)]
    for _ in range(num_hidden + 1):
        degrees.append(np.arange(hidden_dim) % (input_dim - 1))
    degrees.append(np.arange(input_dim) % input_dim - 1)
    return degrees


def made_masks(input_dim: int, hidden_dim: int = 64, num_hidden: int = 1):
    """List of (fan_in, fan_out) float32 masks, one per dense layer."""
    degs = made_degrees(input_dim, hidden_dim, num_hidden)
    return [(d1[None, :] >= d0[:, None]).astype(np.float32)
            for d0, d1 in zip(degs[:-1], degs[1:])]


def _uniform(shape, bound, generator, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return nn.Parameter((2.0 * u - 1.0).mul_(bound).to(device))


class MaskedMLP(nn.Module):
    """Masked MLP (batch, input_dim) -> (batch, input_dim * n_out_params);
    the port of the JAX ``masked_mlp``.

    The final mask is tiled n_out_params times along the output axis, so
    each parameter group inherits its dimension's autoregressive degree.
    Weights and biases start U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
    """

    def __init__(self, input_dim: int, n_out_params: int,
                 hidden_dim: int = 64, num_hidden: int = 1, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        masks = made_masks(input_dim, hidden_dim, num_hidden)
        masks[-1] = np.tile(masks[-1], n_out_params)
        self.W = nn.ParameterList()
        self.b = nn.ParameterList()
        for i, m in enumerate(masks):
            bound = 1.0 / np.sqrt(m.shape[0])
            self.W.append(_uniform(m.shape, bound, generator, device))
            self.b.append(_uniform((m.shape[1],), bound, generator, device))
            self.register_buffer(f'mask{i}', torch.as_tensor(m, device=device),
                                 persistent=False)
        self.n_layers = len(masks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            h = h @ (self.W[i] * getattr(self, f'mask{i}')) + self.b[i]
            if i < self.n_layers - 1:
                h = torch.tanh(h)
        return h


class MaskedConditioner(nn.Module):
    """(batch, input_dim) -> (batch, input_dim, n_out_params) sum-normalized
    spline parameters: a masked MLP, a sigmoid unless negative parameters
    are allowed, and free ``zero_params`` used by the optional cubed-input
    product (``set_nn_output_grad_to_zero``)."""

    def __init__(self, input_dim: int, n_out_params: int,
                 set_nn_output_grad_to_zero: bool = False,
                 allow_negative_params: bool = False, hidden_dim: int = 64,
                 num_hidden: int = 1, *, generator=None, device=None):
        super().__init__()
        self.mlp = MaskedMLP(input_dim, n_out_params, hidden_dim, num_hidden,
                             generator=generator, device=device)
        u = torch.rand((input_dim, n_out_params), generator=generator)
        self.zero_params = nn.Parameter((u - 0.5).to(device))
        self.n_out_params = n_out_params
        self.allow_negative_params = allow_negative_params
        self.set_nn_output_grad_to_zero = set_nn_output_grad_to_zero

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raw = self.mlp(x)                                   # (B, D*n_out)
        # group g of the tiled output is parameter slot g of every dimension
        p = raw.reshape(x.shape[0], self.n_out_params, x.shape[-1]).transpose(-1, -2)
        if self.allow_negative_params:
            zp = self.zero_params
        else:
            p = torch.sigmoid(p)
            zp = self.zero_params.abs()
        if self.set_nn_output_grad_to_zero:
            cube = torch.cumprod(x ** 3, dim=-1)
            cube = torch.cat([torch.ones_like(cube[:, :1]), cube[:, :-1]], dim=-1)
            p = cube[..., None] * p + zp
        return p / p.sum(-1, keepdim=True)


def masked_mlp(input_dim: int, n_out_params: int, hidden_dim: int = 64,
               num_hidden: int = 1, *, generator: torch.Generator | None = None,
               device=None) -> MaskedMLP:
    """The masked MLP emitting (batch, input_dim * n_out_params) features:
    the JAX ``masked_mlp(rng, ...) -> (params, apply)`` as one module."""
    return MaskedMLP(input_dim, n_out_params, hidden_dim, num_hidden,
                     generator=generator, device=device)


def simple_masked_transform(output_shape: int = 2, hidden_dim: int = 64,
                            num_hidden: int = 1):
    """Plain masked MLP factory for the affine MADE layer: ``(input_dim, *,
    generator, device) -> MaskedMLP`` emitting (batch, output_shape *
    input_dim) grouped features; the port of the JAX factory of the same
    name."""

    def make(input_dim, *, generator=None, device=None):
        return MaskedMLP(input_dim, output_shape, hidden_dim, num_hidden,
                         generator=generator, device=device)

    return make


def masked_conditioner(allow_negative_params: bool = False,
                       hidden_dim: int = 64, num_hidden: int = 1):
    """Factory ``(input_dim, n_out_params, set_nn_output_grad_to_zero, *,
    generator, device) -> MaskedConditioner``, the port of the JAX
    factory of the same name."""

    def make(input_dim, n_out_params, set_nn_output_grad_to_zero=False, *,
             generator=None, device=None):
        return MaskedConditioner(input_dim, n_out_params,
                                 set_nn_output_grad_to_zero,
                                 allow_negative_params, hidden_dim, num_hidden,
                                 generator=generator, device=device)

    return make
