"""Parity of the port's Laplacian forms (physics/hamiltonian.py) with the
JAX package, on the CPU: Hψ under every ``laplacian_mode`` and under the
finite difference ``eps=0.1`` against JAX's ``h_fn`` on He (2 coordinates)
and Li (3 coordinates, where the finite difference sums only the first
two, as the reference does); and the float64 run that fixes the
tolerances of ``chip_smoke.py``'s lap-forms phase."""

import importlib.util
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.physics import construct_hamiltonian_function

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=8, n_i_internal_knots=8, i_spline_reg=0.1,
             n_flow_layers=1, box_size=10.0, n_spline_base_mesh_points=400)
FLAGSHIP = dict(base_spline_degree=6, i_spline_degree=6,
                n_prior_internal_knots=23, n_i_internal_knots=23,
                i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)
# (laplacian_mode, eps): every analytic form and the finite difference
FORMS = [('fwd_batched', 0.0), ('fwd', 0.0), ('hvp', 0.0), ('dense', 0.0),
         ('fwd', 0.1)]


@pytest.fixture(scope='module', params=['He', 'Li'])
def system(request):
    """(name, protons, JAX params and psi, port model, 16 JAX walkers)."""
    protons, n = system_catalogue[1][request.param]
    n = int(n)
    jparams, jpsi, _, jsample = jget_waveflow_model(n, **SMALL)(
        jax.random.PRNGKey(3), n)
    m = get_waveflow_model(n, **SMALL, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    x = np.array(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(5), jparams, 16))
    return request.param, protons, jparams, jpsi, m, x


@pytest.mark.parametrize('mode,eps', FORMS)
def test_h_matches_jax(system, mode, eps):
    """Hψ (B, 1) of the port against JAX's ``h_fn`` with the same
    parameters, walkers, mode and eps: max error 1e-5 of max|Hψ| for the
    analytic forms, 1e-3 for the finite difference (f32 cancellation over
    ε² = 1e-2).  On Li the finite difference leaves the third coordinate
    out (``n_dims=2``), in both packages."""
    name, protons, jparams, jpsi, m, x = system
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=1, eps=eps,
                      laplacian_mode=mode)
    h = construct_hamiltonian_function(m.psi, protons=protons,
                                       n_space_dimensions=1, eps=eps,
                                       laplacian_mode=mode)
    want = np.asarray(jax.jit(jh)(jparams, x))
    with torch.no_grad():
        got = h(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], 1)
    scale = np.abs(want).max()
    tol = 1e-3 if eps else 1e-5
    assert np.abs(got - want).max() <= tol * scale
    if eps and name == 'Li':
        # the quirk is real: the analytic Laplacian sums all three
        with torch.no_grad():
            full = construct_hamiltonian_function(
                m.psi, protons=protons, n_space_dimensions=1,
                laplacian_mode='fwd_batched')(torch.as_tensor(x)).numpy()
        assert np.abs(got - full).max() > 10 * tol * scale


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_laplacian_forms_against_float64():
    """The flagship 100k checkpoint at 2,048 ancestral walkers: each f32
    form's Hψ against the float64 evaluation of the same model (the f32
    constants computed in float64), as a share of max|Hψ|.  Every analytic
    form within half of chip_smoke.LAP_FORMS_RTOL (so two forms agree to
    it), the finite difference within half of LAP_FD_RTOL of its float64
    value.  Prints the errors."""
    smoke = _chip_smoke()
    with open(ROOT / 'results' / 'r5_flagship_fwd_batched_100k'
              / 'checkpoints', 'rb') as f:
        params = params_from_jax(pickle.load(f)['params'])
    m = get_waveflow_model(2, **FLAGSHIP, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params)
    protons = system_catalogue[1]['He'][0]
    x = m.sample(2048, generator=torch.Generator().manual_seed(7))

    def h(mode, eps, xx):
        return construct_hamiltonian_function(
            m.psi, protons=protons, n_space_dimensions=1, eps=eps,
            laplacian_mode=mode)(xx)[:, 0].double()

    with torch.no_grad():
        f32 = {(mode, eps): h(mode, eps, x) for mode, eps in FORMS}
        m.double()
        try:
            exact = h('fwd_batched', 0.0, x.double())
            exact_fd = h('fwd', 0.1, x.double())
        finally:
            m.float()
    scale = exact.abs().max().item()
    for (mode, eps), v in f32.items():
        ref, limit = ((exact_fd, smoke.LAP_FD_RTOL) if eps
                      else (exact, smoke.LAP_FORMS_RTOL))
        err = (v - ref).abs().max().item() / scale
        print(f"{mode} eps={eps}: f32 against float64 {err:.3e} of "
              f"max|Hpsi| {scale:.4f} (limit {limit / 2:.1e})")
        assert err <= limit / 2, (mode, eps)
    gap = (exact_fd - exact).abs().max().item() / scale
    print(f"finite difference against the analytic form, float64: {gap:.3e}")
