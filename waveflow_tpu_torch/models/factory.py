"""Configured model assemblies: the MFlow density model and the Waveflow ψ
ansatz.

Port of waveflow_tpu/models/factory.py (``get_model`` and
``get_waveflow_model`` with every coordinate map).  The module trees
mirror the JAX params pytrees: ``transform.layers`` = [(BoxTransform,)
(IMADE, Reverse) × n_flow_layers] and ``conditioner`` = the prior's masked
conditioner (see convert.py).
"""

from __future__ import annotations

import torch

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.bijections import (
    BoxTransform, IMADE, Reverse, Serial, masked_conditioner,
)
from waveflow_tpu_torch.models.mflow import MFlow
from waveflow_tpu_torch.models.waveflow import (
    Waveflow, check_sampling_backend,
)


def get_model(input_dim, base_spline_degree=5, i_spline_degree=5,
              n_prior_internal_knots=15, n_i_internal_knots=15,
              i_spline_reg=0.0, i_spline_reverse_fun_tol=1e-6,
              n_flow_layers=1,
              prior_constraint_dict_left={}, prior_constraint_dict_right={},
              i_constraint_dict_left={}, i_constraint_dict_right={},
              set_nn_output_grad_to_zero=False,
              n_spline_base_mesh_points=2000, *,
              generator: torch.Generator | None = None,
              device=None) -> MFlow:
    """MFlow density model: n × (IMADE + Reverse) over an M-spline prior.

    ``i_spline_reverse_fun_tol`` is accepted and unused: the IMADE inverse
    is the exact table inverse, which has no tolerance.  Weights are drawn
    from ``generator`` (CPU generator; seed it for reproducible inits)."""
    device = resolve_device(device)
    layers = []
    for _ in range(n_flow_layers):
        layers.append(IMADE(masked_conditioner(), input_dim,
                            spline_degree=i_spline_degree,
                            n_internal_knots=n_i_internal_knots,
                            spline_regularization=i_spline_reg,
                            constraints_dict_left=i_constraint_dict_left,
                            constraints_dict_right=i_constraint_dict_right,
                            set_nn_output_grad_to_zero=set_nn_output_grad_to_zero,
                            n_spline_base_mesh_points=n_spline_base_mesh_points,
                            generator=generator, device=device))
        layers.append(Reverse())
    return MFlow(Serial(*layers), masked_conditioner(), input_dim,
                 spline_degree=base_spline_degree,
                 n_internal_knots=n_prior_internal_knots,
                 constraints_dict_left=prior_constraint_dict_left,
                 constraints_dict_right=prior_constraint_dict_right,
                 set_nn_output_grad_to_zero=set_nn_output_grad_to_zero,
                 n_spline_base_mesh_points=n_spline_base_mesh_points,
                 generator=generator, device=device)


def constrained_dims(n_dimension: int, xu_coord_type: str) -> range:
    """The dimensions whose amplitude carries the left-edge zero boundary
    (the gaps of sorted fermions): 'mean' 0..n-2, 'first' 1..n-1,
    'paired2d' the x-gaps 0..n/2-2, 'independent' none."""
    return {'mean': range(n_dimension - 1),
            'first': range(1, n_dimension),
            'paired2d': range(n_dimension // 2 - 1),
            'independent': range(0)}[xu_coord_type]


def get_waveflow_model(n_dimension, base_spline_degree=5, i_spline_degree=5,
                       n_prior_internal_knots=16, n_i_internal_knots=16,
                       i_spline_reg=0.0, i_spline_reverse_fun_tol=1e-6,
                       n_flow_layers=1, box_size=1.0,
                       xu_coord_type='mean', n_spline_base_mesh_points=2000,
                       eval_backend='poly', sampling_backend='table', *,
                       generator: torch.Generator | None = None,
                       device=None) -> Waveflow:
    """Waveflow ψ: BoxTransform + n × (IMADE + Reverse) over a squared
    orthonormal-B-spline prior.  The gap dimensions of the coordinate map
    (``constrained_dims``) carry the left-edge zero boundary.
    ``i_spline_reverse_fun_tol``
    is accepted and unused, as in ``get_model``.  Weights are drawn from
    ``generator`` (CPU generator; seed it for reproducible inits)."""
    check_sampling_backend(eval_backend, sampling_backend)
    device = resolve_device(device)
    layers = [BoxTransform(box_size, xu_coord_type=xu_coord_type)]
    for _ in range(n_flow_layers):
        layers.append(IMADE(masked_conditioner(), n_dimension,
                            spline_degree=i_spline_degree,
                            n_internal_knots=n_i_internal_knots,
                            spline_regularization=i_spline_reg,
                            constraints_dict_left={0: 0.0},
                            constraints_dict_right={0: 1.0},
                            set_nn_output_grad_to_zero=False,
                            n_spline_base_mesh_points=n_spline_base_mesh_points,
                            eval_backend=eval_backend,
                            generator=generator, device=device))
        layers.append(Reverse())
    return Waveflow(
        Serial(*layers), masked_conditioner(allow_negative_params=True),
        n_dimension, spline_degree=base_spline_degree,
        n_internal_knots=n_prior_internal_knots,
        constraints_dict_left={0: 0.0}, constraints_dict_right={0: 0.0},
        constrained_dimension_indices_left=constrained_dims(n_dimension,
                                                            xu_coord_type),
        set_nn_output_grad_to_zero=False,
        n_spline_base_mesh_points=n_spline_base_mesh_points,
        eval_backend=eval_backend, sampling_backend=sampling_backend,
        generator=generator, device=device)
