"""IMADE — the invertible monotone autoregressive spline layer.

Port of waveflow_tpu/bijections/imade.py with every forward backend.  A
masked autoregressive conditioner emits per-dimension I-spline weight
vectors (bias removal + boundary projection); the forward map evaluates the
monotone I-spline per coordinate — through the fused basis jet under 'poly'
and 'poly_pallas', through the table evaluator's ``pair`` (value and
derivative in one K4 launch on the card) under 'table' — and the log-det is
the sum of log spline derivatives; the inverse runs dimension-sequential
exact table inversion, plus one Newton step against the polynomial forward
under the poly backends.
"""

from __future__ import annotations

import torch
from torch import nn

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.ops import (
    batched_monotone_inverse, get_tables, make_bias_remover,
    make_boundary_projector, make_evaluator, make_poly_evaluator,
)

LOG_TOL = 1e-7


class IMADE(nn.Module):

    def __init__(self, conditioner_factory, input_dim: int,
                 spline_degree: int = 4, n_internal_knots: int = 12,
                 spline_regularization: float = 0.0,
                 constraints_dict_left={0: 0.0},
                 constraints_dict_right={0: 1.0},
                 set_nn_output_grad_to_zero: bool = False,
                 n_spline_base_mesh_points: int = 2000,
                 eval_backend: str = 'poly', *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if eval_backend not in ('poly', 'poly_pallas', 'table'):
            raise ValueError(f"unknown eval_backend {eval_backend!r}")
        device = resolve_device(device)
        self.use_poly = eval_backend != 'table'
        tabs = get_tables('I', spline_degree, n_internal_knots,
                          n_mesh=n_spline_base_mesh_points)
        # the table evaluator serves the inverse and the projector, and the
        # forward under 'table'; the polynomial evaluator the forward under
        # the poly backends (jet backend 'pallas' = K3)
        self.ev = make_evaluator(tabs, device=device)
        self.fwd_ev = make_poly_evaluator(
            tabs, jet_backend='pallas' if eval_backend == 'poly_pallas' else 'xla',
            device=device) if self.use_poly else self.ev
        self.project = make_boundary_projector(
            self.ev, constraints_dict_left, constraints_dict_right,
            normalization='sum', ispline_right_convention=True)
        self.debias = make_bias_remover(self.ev.n_bases, spline_degree, 'I',
                                        device=device)
        self.spline_regularization = spline_regularization
        self.conditioner = conditioner_factory(
            input_dim, self.ev.n_bases,
            set_nn_output_grad_to_zero=set_nn_output_grad_to_zero,
            generator=generator, device=device)

    def spline_params(self, inputs: torch.Tensor) -> torch.Tensor:
        p = self.conditioner(inputs) + self.spline_regularization
        return self.project(self.debias(p))               # (B, D, n_bases)

    def forward(self, inputs: torch.Tensor):
        sp = self.spline_params(inputs)
        if self.use_poly:
            # one basis-jet call gives value and derivative bases; nested
            # jvps and parameter cotangents reuse it through its rules
            B = self.fwd_ev.basis_jet(inputs)              # (B, D, 4, n_b)
            outputs = (sp * B[..., 0, :]).sum(-1)
            deriv = (sp * B[..., 1, :]).sum(-1)
        else:
            outputs, deriv = self.fwd_ev.pair(sp, inputs)  # (B, D) each
        return outputs, torch.log(deriv + LOG_TOL).sum(-1)

    def inverse(self, inputs: torch.Tensor):
        outputs = torch.zeros_like(inputs)
        cols = torch.arange(inputs.shape[-1], device=inputs.device)
        for i_col in range(inputs.shape[-1]):
            sp = self.spline_params(outputs)[:, i_col]
            y = inputs[:, i_col]
            col = batched_monotone_inverse(self.ev, sp, y)
            if self.use_poly:
                # the exact inverse inverts the TABLE spline; one Newton
                # step against the polynomial forward closes the
                # table-vs-poly gap
                f, df = self.fwd_ev.value_and_derivative(sp, col)
                col = torch.clamp(col - (f - y) / torch.clamp(df, min=1e-12),
                                  0.0, 1.0)
            outputs = torch.where(cols == i_col, col[:, None], outputs)
        return outputs, inputs.new_zeros(inputs.shape[:1])
