"""Parity of the port's exact poly-density sampler
(ops/poly_eval.py::sample_squared_amplitude_poly) and of the model's
``sampling_backend='poly'`` with the JAX package, on the CPU, with the
uniforms given explicitly; and the float64 quantile check that
``chip_smoke.py``'s poly-sample phase runs."""

import importlib.util
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.ops import get_tables as jget_tables
from waveflow_tpu.ops import make_poly_evaluator as jmake_poly_evaluator
from waveflow_tpu.ops.poly_eval import (
    sample_squared_amplitude_poly as jsample_poly)
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.ops import sample_squared_amplitude_poly

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=8, n_i_internal_knots=8, i_spline_reg=0.1,
             n_flow_layers=1, box_size=10.0, n_spline_base_mesh_points=400)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FLAGSHIP = dict(base_spline_degree=6, i_spline_degree=6,
                n_prior_internal_knots=23, n_i_internal_knots=23,
                i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)


def _uniforms(rng, n):
    u = rng.uniform(0, 1, n).astype(np.float32)
    u[:4] = [0.0, 1e-7, 1e-4, 3e-4]
    u[4:8] = [np.float32(1 - 1e-7), 1 - 1e-6, 1 - 1e-4, 1 - 3e-4]
    return u


@pytest.fixture(scope='module')
def flagship():
    """The flagship 100k checkpoint's OB evaluator, its conditional prior
    coefficients (c_1 at 300 random points), uniforms with both tails,
    and both packages' draws; plus 300 random unit-norm rows."""
    with open(ROOT / 'results' / 'r5_flagship_fwd_batched_100k'
              / 'checkpoints', 'rb') as f:
        params = params_from_jax(pickle.load(f)['params'])
    m = get_waveflow_model(2, **FLAGSHIP, generator=torch.Generator(),
                           device='cpu')
    m.load_state_dict(params)
    jev = jmake_poly_evaluator(jget_tables('B', 6, 23, n_mesh=2000),
                               use_ob=True)
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(0, 1, (300, 2)).astype(np.float32))
    with torch.no_grad():
        c = m.ob_coeffs(pts)[:, 1].numpy()
    random_rows = rng.normal(size=c.shape).astype(np.float32)
    random_rows /= np.linalg.norm(random_rows, axis=-1, keepdims=True)
    u = _uniforms(rng, 300)
    out = {}
    for name, rows in (('flagship', c), ('random', random_rows)):
        ref = np.asarray(jsample_poly(jev, jnp.asarray(rows), jnp.asarray(u)))
        got = sample_squared_amplitude_poly(
            m.fwd_ob, torch.as_tensor(rows), torch.as_tensor(u)).numpy()
        out[name] = (torch.as_tensor(rows), got, ref)
    return m.fwd_ob, torch.as_tensor(u), out


def test_poly_sampler_matches_jax(flagship):
    """The flagship's conditional prior rows, same uniforms (tails
    included): every draw in [0, 1]; the port's and JAX's draws agree to
    5e-6 of probability (the float64 CDF of the polynomial density at
    each; 2.3e-6 measured, most of it JAX's own error) and in x to a
    median of 1e-6 — in x alone they can part by
    ~1e-3 where the density is near zero (a node, or the u → 0 / 1 tails
    at the boxes' zero boundaries)."""
    ev, u, out = flagship
    smoke = _chip_smoke()
    c, got, ref = out['flagship']
    assert ((got >= 0) & (got <= 1)).all()
    assert np.median(np.abs(got - ref)) <= 1e-6
    zero = torch.zeros_like(u)
    F_t = smoke.poly_quantile_err(torch, ev, c, zero, torch.as_tensor(got))
    F_j = smoke.poly_quantile_err(torch, ev, c, zero, torch.as_tensor(ref))
    assert (F_t - F_j).abs().max().item() <= 5e-6


def test_poly_sampler_inverts_the_float64_cdf(flagship):
    """chip_smoke.poly_quantile_err on the flagship's rows: |F64(x) − u| of
    the port's draws and of JAX's within chip_smoke.POLY_QUANTILE_TOL (the
    poly-sample phase's gate); the float64 path (the same code on float64
    tensors) within 1e-12.  On random unit-norm rows the f32 Hilbert-form
    cell masses of both packages are ill-conditioned (monomial local
    polynomials with large cancelling coefficients): there the error
    reaches ~4e-4 in either, and the packages still agree to 5e-4 of
    probability."""
    ev, u, out = flagship
    smoke = _chip_smoke()
    c, got, ref = out['flagship']
    tol = smoke.POLY_QUANTILE_TOL
    for x in (got, ref):
        err = smoke.poly_quantile_err(torch, ev, c, u, torch.as_tensor(x))
        assert err.max().item() <= tol, err.max().item()
    x64 = sample_squared_amplitude_poly(ev, c.double(), u.double())
    assert smoke.poly_quantile_err(torch, ev, c, u, x64).max().item() <= 1e-12
    c, got, ref = out['random']
    zero = torch.zeros_like(u)
    F_t = smoke.poly_quantile_err(torch, ev, c, zero, torch.as_tensor(got))
    F_j = smoke.poly_quantile_err(torch, ev, c, zero, torch.as_tensor(ref))
    assert (F_t - F_j).abs().max().item() <= 5e-4


@pytest.mark.parametrize('eval_backend', ['poly', 'poly_pallas'])
def test_model_sample_poly_matches_jax(eval_backend):
    """Waveflow.sample with sampling_backend='poly' under either poly eval
    backend, fed the uniforms JAX's ``sample`` draws from its key (one
    split per column), against JAX's walkers: atol 1e-4 in box
    coordinates (L = 10), median 1e-5; they differ from the table
    sampler's draws on the same uniforms."""
    B = 64
    jparams, _, _, jsample = jget_waveflow_model(
        2, **SMALL, sampling_backend='poly')(jax.random.PRNGKey(3), 2)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.jit(jsample, static_argnums=2)(key, jparams, B))
    cols, rng = [], key
    for _ in range(2):
        rng, split = jax.random.split(rng)
        cols.append(np.asarray(jax.random.uniform(split, (B,))))
    u = torch.as_tensor(np.stack(cols))                      # (D, B)

    models = {}
    for backend in ('poly', 'table'):
        m = get_waveflow_model(2, **SMALL, eval_backend=eval_backend,
                               sampling_backend=backend,
                               generator=torch.Generator().manual_seed(0),
                               device='cpu')
        m.load_state_dict(params_from_jax(jax.device_get(jparams)))
        models[backend] = m
    got = models['poly'].sample(B, u=u).numpy()
    diff = np.abs(got - ref)
    assert diff.max() <= 1e-4, diff.max()
    assert np.median(diff) <= 1e-5, np.median(diff)
    table = models['table'].sample(B, u=u).numpy()
    assert np.abs(table - got).max() > 1e-4
    g = torch.Generator().manual_seed(1)
    assert models['poly'].sample(B, generator=g).shape == (B, 2)
