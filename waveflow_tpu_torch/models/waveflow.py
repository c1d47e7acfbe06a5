"""Waveflow — the square-flow wavefunction ansatz.

Port of waveflow_tpu/models/waveflow.py with every amplitude backend
('poly' and 'poly_pallas' through the basis jet, 'table' through the table
evaluator: K4 on the card) and both sampling densities:

    ψ(x) = [ Π_i  c_i(u_{<i}) · OB(u_i) ] · exp(½ log|det J_T(x)|),
    u = T(x) ∈ [0,1]^n (BoxTransform + IMADE stack),
    c_i = (w_i @ S^{1/2}) / ||w_i @ S^{1/2}||   (unit L2 ⇒ ∫(c·OB)² = 1).

Dimensions in ``constrained_dimension_indices_left`` (the gap coordinates
of sorted fermions) contribute ψ/√2.  Ancestral sampling draws each
dimension by exact inverse CDF of the table-interpolated (c·OB)²
(ops/sampling.py — kernel K1 on the card) and maps back through the
inverse flow.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.ops import (
    get_tables, make_boundary_projector, make_evaluator, make_poly_evaluator,
    sample_squared_amplitude, sample_squared_amplitude_poly,
)

LOG_TOL = 1e-7


def check_sampling_backend(eval_backend: str, sampling_backend: str):
    """'table' or 'poly'; 'poly' only under a poly eval backend (the JAX
    package ignores it under eval_backend='table' and draws from the table;
    the port refuses what it does not do)."""
    if sampling_backend not in ('table', 'poly'):
        raise ValueError(f"unknown sampling_backend {sampling_backend!r}")
    if sampling_backend == 'poly' and eval_backend not in ('poly',
                                                           'poly_pallas'):
        raise NotImplementedError(
            "sampling_backend='poly' needs a poly eval backend ('poly' or "
            f"'poly_pallas'), not {eval_backend!r}")


class Waveflow(nn.Module):

    def __init__(self, transformation: nn.Module, sp_transformation,
                 input_dim: int, spline_degree: int, n_internal_knots: int,
                 constraints_dict_left={0: 0, 2: 0},
                 constraints_dict_right={0: 0},
                 constrained_dimension_indices_left=(),
                 set_nn_output_grad_to_zero: bool = True,
                 n_spline_base_mesh_points: int = 2000,
                 eval_backend: str = 'poly', sampling_backend: str = 'table',
                 *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        if eval_backend not in ('poly', 'poly_pallas', 'table'):
            raise ValueError(f"unknown eval_backend {eval_backend!r}")
        check_sampling_backend(eval_backend, sampling_backend)
        self.use_poly = eval_backend != 'table'
        self.sampling_backend = sampling_backend
        device = resolve_device(device)
        self.device = device
        self.input_dim = input_dim
        self.transform = transformation
        tabs = get_tables('B', spline_degree, n_internal_knots,
                          n_mesh=n_spline_base_mesh_points)
        ev_b = make_evaluator(tabs, device=device)          # constraints
        self.ev_ob = make_evaluator(tabs, use_ob=True, device=device)  # sampling
        self.fwd_ob = make_poly_evaluator(
            tabs, use_ob=True,
            jet_backend='pallas' if eval_backend == 'poly_pallas' else 'xla',
            device=device) if self.use_poly else self.ev_ob
        self.ob_to_b = torch.as_tensor(tabs.ob_to_b, device=device)
        self.project = make_boundary_projector(
            ev_b, constraints_dict_left, constraints_dict_right,
            normalization='l2')
        self.conditioner = sp_transformation(
            input_dim, ev_b.n_bases,
            set_nn_output_grad_to_zero=set_nn_output_grad_to_zero,
            generator=generator, device=device)
        constrained = torch.zeros(input_dim, dtype=torch.bool)
        constrained[list(constrained_dimension_indices_left)] = True
        self.register_buffer('constrained', constrained.to(device),
                             persistent=False)

    def ob_coeffs(self, u: torch.Tensor) -> torch.Tensor:
        """Conditional OB coefficients with unit L2 norm: (B, D, n_bases)."""
        w = self.project(self.conditioner(u))
        c = w @ self.ob_to_b.to(w.dtype)
        return c / torch.sqrt((c ** 2).sum(-1, keepdim=True))

    def _amplitudes(self, x: torch.Tensor):
        if x.ndim == 1:
            x = x[None]
        u, log_det = self.transform(x)
        c = self.ob_coeffs(u)
        u_c = torch.clamp(u, 0.0, 1.0)
        if self.use_poly:
            amps = (c * self.fwd_ob.basis_jet(u_c)[..., 0, :]).sum(-1)
        else:
            amps = self.fwd_ob(c, u_c)         # (B, D) per-dim amplitudes
        return amps, log_det

    def psi(self, x: torch.Tensor) -> torch.Tensor:
        """ψ(x): (B, D) box coordinates -> (B,)."""
        amps, log_det = self._amplitudes(x)
        amps = torch.where(self.constrained, amps / math.sqrt(2.0), amps)
        # the product over coordinates as explicit multiplications, in
        # order: torch.prod's backward counts zero factors on the host,
        # which a CUDA graph cannot capture (vmc/graphs.py)
        prod = amps[..., 0]
        for i in range(1, amps.shape[-1]):
            prod = prod * amps[..., i]
        return prod * torch.exp(0.5 * log_det)

    # torch.func.functional_call runs a module's forward: ψ of given
    # parameters (the natural-gradient steps, vmc/sr.py)
    forward = psi

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """log |ψ(x)|² (up to LOG_TOL): (B, D) -> (B,)."""
        amps, log_det = self._amplitudes(x)
        probs = torch.where(self.constrained, amps ** 2 / 2, amps ** 2)
        return torch.log(probs + LOG_TOL).sum(-1) + log_det

    @torch.no_grad()
    def sample(self, num_samples: int,
               generator: torch.Generator | None = None,
               u: torch.Tensor | None = None) -> torch.Tensor:
        """Exact ancestral draws from |ψ|²: (num_samples, D) box coordinates.

        Column i uses the uniforms ``u[i]`` (shape (D, num_samples)) when
        given, else draws them from ``generator``."""
        D = self.input_dim
        if u is None:
            u = torch.rand((D, num_samples), generator=generator,
                           device=self.device)
        cols = torch.arange(D, device=self.device)
        outputs = torch.zeros((num_samples, D), device=self.device)
        for i_col in range(D):
            c = self.ob_coeffs(outputs)[:, i_col]
            if self.sampling_backend == 'poly':
                col = sample_squared_amplitude_poly(self.fwd_ob, c, u[i_col])
            else:
                col = sample_squared_amplitude(self.ev_ob, c, u[i_col])
            outputs = torch.where(cols == i_col, col[:, None], outputs)
        return self.transform.inverse(outputs)[0]
