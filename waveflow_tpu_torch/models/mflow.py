"""MFlow — flow with an M-spline conditional (autoregressive) prior.

Port of waveflow_tpu/models/mflow.py.  The prior density per dimension is
a conditional M-spline whose weights come from a second masked
autoregressive network evaluated on u-space.  ``log_pdf`` evaluates it by
table lerp (ops/spline_eval.py — kernel K4 on the card, forward and
backward); ancestral sampling draws each dimension from its conditional
by the exact inverse-CDF sampler (ops/sampling.py — kernel K2 on the card)
and maps back through the inverse flow.
"""

from __future__ import annotations

import torch
from torch import nn

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.ops import (
    get_tables, make_bias_remover, make_boundary_projector, make_evaluator,
    sample_linear_density,
)

LOG_TOL = 1e-7


class MFlow(nn.Module):

    def __init__(self, transformation: nn.Module, conditioner_factory,
                 input_dim: int, spline_degree: int, n_internal_knots: int,
                 constraints_dict_left={0: 0}, constraints_dict_right={0: 0},
                 set_nn_output_grad_to_zero: bool = False,
                 n_spline_base_mesh_points: int = 2000, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.input_dim = input_dim
        self.transform = transformation
        tabs = get_tables('M', spline_degree, n_internal_knots,
                          n_mesh=n_spline_base_mesh_points)
        self.ev = make_evaluator(tabs, device=device)
        self.project = make_boundary_projector(
            self.ev, constraints_dict_left, constraints_dict_right,
            normalization='sum')
        self.debias = make_bias_remover(self.ev.n_bases, spline_degree, 'M',
                                        device=device)
        self.conditioner = conditioner_factory(
            input_dim, self.ev.n_bases,
            set_nn_output_grad_to_zero=set_nn_output_grad_to_zero,
            generator=generator, device=device)

    def prior_weights(self, u: torch.Tensor) -> torch.Tensor:
        """Conditional M-spline weights: (B, D) -> (B, D, n_bases)."""
        return self.project(self.debias(self.conditioner(u)))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """log p(x): (B, D) -> (B,), so that ``torch.func.functional_call``
        evaluates the density under other parameters (the parameter
        posterior, vmc/hmc.py)."""
        return self.log_pdf(inputs)

    def log_pdf(self, inputs: torch.Tensor, return_sample: bool = False):
        """log p(x): (B, D) -> (B,); with ``return_sample`` also the
        prior-space point u = T(x)."""
        if inputs.ndim == 1:
            inputs = inputs[None]
        u, log_det = self.transform(inputs)
        w = self.prior_weights(u)
        probs = self.ev(w, torch.clamp(u, 0.0, 1.0))         # (B, D)
        log_probs = torch.log(probs + LOG_TOL).sum(-1) + log_det
        return (log_probs, u) if return_sample else log_probs

    @torch.no_grad()
    def sample(self, num_samples: int = 1,
               generator: torch.Generator | None = None,
               u: torch.Tensor | None = None,
               return_original_samples: bool = False):
        """Exact ancestral draws: (num_samples, D); with
        ``return_original_samples`` also the prior-space draws.

        Column i uses the uniforms ``u[i]`` (shape (D, num_samples)) when
        given, else draws them from ``generator``."""
        D = self.input_dim
        if u is None:
            u = torch.rand((D, num_samples), generator=generator,
                           device=self.device)
        cols = torch.arange(D, device=self.device)
        outputs = torch.zeros((num_samples, D), device=self.device)
        for i_col in range(D):
            w = self.prior_weights(outputs)[:, i_col]
            col = sample_linear_density(self.ev, w, u[i_col])
            outputs = torch.where(cols == i_col, col[:, None], outputs)
        final = self.transform.inverse(outputs)[0]
        return (final, outputs) if return_original_samples else final
