"""Parity of the PyTorch port's flow, model and Hamiltonian with the JAX
package on the committed He-1d flagship checkpoint
(results/r5_flagship_fwd_batched_100k), on the CPU.

Weights cross over through waveflow_tpu_torch.convert; inputs are drawn
with numpy or by the JAX model and handed to both packages.
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.bijections import IMADE as JIMADE
from waveflow_tpu.bijections import masked_conditioner as jmasked_conditioner
from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu_torch.bijections import IMADE, masked_conditioner
from waveflow_tpu_torch.convert import load_jax_checkpoint, params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.physics import construct_hamiltonian_function

torch.set_num_threads(2)

CHECKPOINT = (Path(__file__).resolve().parents[1] / 'results'
              / 'r5_flagship_fwd_batched_100k' / 'checkpoints')
FLAGSHIP = dict(base_spline_degree=6, i_spline_degree=6,
                n_prior_internal_knots=23, n_i_internal_knots=23,
                i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)
B = 32


@pytest.fixture(scope='module')
def flagship():
    with open(CHECKPOINT, 'rb') as f:
        jparams = pickle.load(f)['params']
    init = jget_waveflow_model(2, **FLAGSHIP)
    _, jpsi, jlog_pdf, jsample = init(jax.random.PRNGKey(0), 2)
    models = {}
    for backend in ('poly', 'poly_pallas'):
        m = get_waveflow_model(2, **FLAGSHIP, eval_backend=backend,
                               generator=torch.Generator().manual_seed(0),
                               device='cpu')
        m.load_state_dict(params_from_jax(
            load_jax_checkpoint(CHECKPOINT)['params']))
        models[backend] = m
    # in-distribution walkers from the JAX model's own ancestral sampler
    x = np.array(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(3), jparams, B))
    return dict(jparams=jparams, jpsi=jpsi, jlog_pdf=jlog_pdf,
                jsample=jsample, models=models, x=x)


def test_checkpoint_loads_exactly(flagship):
    """convert.params_from_jax lands every leaf, dense (fan_in, fan_out)
    layout and the (2,29)/(2,28) zero-params included, bit for bit."""
    m = flagship['models']['poly']
    p = flagship['jparams']
    sd = m.state_dict()
    np.testing.assert_array_equal(
        sd['transform.layers.1.conditioner.mlp.W.2'].numpy(), p[0][1][0][2][0])
    np.testing.assert_array_equal(
        sd['transform.layers.5.conditioner.zero_params'].numpy(), p[0][5][1])
    np.testing.assert_array_equal(sd['conditioner.mlp.b.0'].numpy(),
                                  p[1][0][0][1])
    assert sd['conditioner.zero_params'].shape == (2, 28)
    leaves = jax.tree_util.tree_leaves(p)
    assert len(sd) == len(leaves) == 28
    assert sum(v.numel() for v in sd.values()) == sum(a.size for a in leaves)


@pytest.mark.parametrize('backend', ['poly', 'poly_pallas'])
def test_psi_and_log_pdf(flagship, backend):
    """(d) ψ and log|ψ|² of the checkpoint at batch 32: ψ rtol 1e-4."""
    x = flagship['x']
    ref_psi = np.asarray(flagship['jpsi'](flagship['jparams'], x))
    ref_lp = np.asarray(flagship['jlog_pdf'](flagship['jparams'], x))
    m = flagship['models'][backend]
    with torch.no_grad():
        psi = m.psi(torch.as_tensor(x)).numpy()
        lp = m.log_pdf(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(psi, ref_psi, rtol=1e-4)
    np.testing.assert_allclose(lp, ref_lp, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('layer', [1, 3, 5])
def test_imade_forward_and_inverse(flagship, layer):
    """(d) One IMADE layer of the checkpoint: forward value and log-det
    (rtol 1e-5) and the inverse (table inverse + one poly Newton step,
    atol 1e-5)."""
    jinit = JIMADE(jmasked_conditioner(), spline_degree=6, n_internal_knots=23,
                   spline_regularization=0.05, eval_backend='poly')
    _, jdirect, jinverse = jinit(jax.random.PRNGKey(0), 2)
    jp = flagship['jparams'][0][layer]
    t = IMADE(masked_conditioner(), 2, spline_degree=6, n_internal_knots=23,
              spline_regularization=0.05, device='cpu')
    prefix = f'transform.layers.{layer}.'
    t.load_state_dict({k[len(prefix):]: v for k, v in params_from_jax(
        flagship['jparams']).items() if k.startswith(prefix)})
    u = np.random.default_rng(layer).uniform(0.02, 0.98, (B, 2)
                                             ).astype(np.float32)
    y_ref, ld_ref = jdirect(jp, jnp.asarray(u))
    with torch.no_grad():
        y, ld = t(torch.as_tensor(u))
        x_back, _ = t.inverse(y)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), rtol=1e-5,
                               atol=1e-5)
    x_ref, _ = jinverse(jp, y_ref)
    np.testing.assert_allclose(x_back.numpy(), np.asarray(x_ref), atol=1e-5)
    np.testing.assert_allclose(x_back.numpy(), u, atol=1e-4)


def test_sample_with_jax_uniforms(flagship):
    """(e) The port's ancestral sampler fed the uniforms of JAX's key
    schedule (one split + uniform per column, models/waveflow.py:127-130)
    reproduces JAX's walkers: atol 5e-4 in box units."""
    rng = jax.random.PRNGKey(3)
    us = []
    for _ in range(2):
        rng, split = jax.random.split(rng)
        us.append(np.asarray(jax.random.uniform(split, (B,))))
    got = flagship['models']['poly_pallas'].sample(
        B, u=torch.as_tensor(np.stack(us))).numpy()
    np.testing.assert_allclose(got, flagship['x'], atol=5e-4)


def test_local_energy(flagship):
    """(f) E_L = Hψ/ψ by the batch-level nested-jvp Laplacian, against the
    JAX fwd_batched Hamiltonian: rtol/atol 2e-4 (test_pallas_jet.py:80)."""
    protons = system_catalogue[1]['He'][0]
    jh = jconstruct_h(flagship['jpsi'], protons=protons, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    x = flagship['x']
    ref = np.asarray(jax.jit(lambda p, xx: jh(p, xx)[:, 0] / flagship['jpsi'](
        p, xx))(flagship['jparams'], x))
    m = flagship['models']['poly_pallas']
    h = construct_hamiltonian_function(m.psi, protons=protons,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    with torch.no_grad():
        xt = torch.as_tensor(x)
        e_loc = (h(xt)[:, 0] / m.psi(xt)).numpy()
    np.testing.assert_allclose(e_loc, ref, rtol=2e-4, atol=2e-4)
