"""Parity of the port's frozen-parameter Metropolis evaluation with the JAX
package, on the CPU: the host-side block statistics on the same block
arrays, and a whole evaluation of the flagship checkpoint by each package."""

import pickle
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu.vmc import evaluate as jevaluate
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.vmc import (
    VMCConfig, VMCTrainer, block_statistics, evaluate_energy, evaluate_trainer)

torch.set_num_threads(2)

CHECKPOINT = (Path(__file__).resolve().parents[1] / 'results'
              / 'r5_flagship_fwd_batched_100k' / 'checkpoints')
FLAGSHIP = dict(base_spline_degree=6, i_spline_degree=6,
                n_prior_internal_knots=23, n_i_internal_knots=23,
                i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)


def _blocks(n_blocks, seed):
    """float64 block arrays shaped like an evaluation's: means, medians,
    clipped means, accept rates, the clip ladder (n_blocks, 4)."""
    rng = np.random.default_rng(seed)
    means = -1.8157 + 1e-3 * rng.standard_t(3, size=n_blocks)
    medians = -1.8159 + 2e-4 * rng.normal(size=n_blocks)
    cmeans = -1.8158 + 1e-4 * rng.normal(size=n_blocks)
    rates = 0.5 + 0.01 * rng.normal(size=n_blocks)
    lads = (cmeans[:, None] + np.array([0.0, 1e-4, 1.5e-4, 1.7e-4])
            + 3e-5 * rng.normal(size=(n_blocks, 4)))
    return means, medians, cmeans, rates, lads


@pytest.mark.parametrize('n_blocks', [16, 7, 5])
@pytest.mark.parametrize('ladder', [False, True])
def test_block_statistics_match_jax(monkeypatch, n_blocks, ladder):
    """The JAX evaluate_energy's post-processing, fed the same float64 block
    arrays (its two jitted device loops stubbed to return them), against
    ``block_statistics``: every field to 1e-12 — mean, stderr, median of
    medians, clipped mean and stderr, accept rate, 2×/4× block doubling
    (NaN where too few blocks), the ladder's means, stderrs and fit."""
    means, medians, cmeans, rates, lads = _blocks(n_blocks, n_blocks)
    B = 32

    def fake_jit(fn):
        if fn.__name__ == 'warmup':
            return lambda state, rng: state
        return lambda state, rng: (state, means, medians, cmeans, rates,
                                   lads if ladder else np.zeros((n_blocks, 0)))

    monkeypatch.setattr(jevaluate, 'jax', types.SimpleNamespace(
        jit=fake_jit, random=jax.random, lax=jax.lax))
    want = jevaluate.evaluate_energy(
        None, None, lambda p, x: jnp.zeros(x.shape[0]), None, 10.0,
        np.zeros((B, 2), np.float32), jax.random.PRNGKey(0),
        n_blocks=n_blocks, sort_fermions=False, clip_ladder=ladder)
    got = block_statistics(means, medians, cmeans, rates,
                           lads if ladder else None, n_walkers=B)
    assert got._fields == want._fields
    for f in want._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=f)
    assert got.n_samples == n_blocks * B
    if ladder:
        assert len(got.clip_ladder_means) == 4
        assert np.isfinite(got.e_clip_extrapolated)


def test_evaluation_matches_jax():
    """evaluate_energy of each package on the flagship checkpoint, from the
    same 256 ancestral walkers, 20 warmup sweeps and 16 blocks × 5 sweeps
    (step 0.4, '1d' sort), each on its own random stream: the raw and the
    clipped means within 5 combined stderr, √(σ_port² + σ_jax²); accept
    rates within 0.05."""
    with open(CHECKPOINT, 'rb') as f:
        jparams = pickle.load(f)['params']
    _, jpsi, jlog_pdf, _ = jget_waveflow_model(2, **FLAGSHIP)(
        jax.random.PRNGKey(0), 2)
    protons = system_catalogue[1]['He'][0]
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    m = get_waveflow_model(2, **FLAGSHIP, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jparams))
    h = construct_hamiltonian_function(m.psi, protons=protons,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    gen = torch.Generator().manual_seed(7)
    x0 = m.sample(256, generator=gen)
    kw = dict(n_blocks=16, sweeps_per_block=5, n_warmup_sweeps=20)
    got = evaluate_energy(m.psi, h, m.log_pdf, 10.0, x0, gen, **kw)
    want = jevaluate.evaluate_energy(jpsi, jh, jlog_pdf, jparams, 10.0,
                                     x0.numpy(), jax.random.PRNGKey(7), **kw)
    for mean, err in (('e_mean', 'e_stderr'),
                      ('e_clipped', 'e_clipped_stderr')):
        sigma = np.hypot(getattr(got, err), getattr(want, err))
        assert abs(getattr(got, mean) - getattr(want, mean)) <= 5 * sigma, (
            mean, getattr(got, mean), getattr(want, mean), sigma)
    assert abs(got.accept_rate - want.accept_rate) <= 0.05
    assert got.n_samples == want.n_samples == 16 * 256
    assert got.block_means.shape == (16,)


def test_evaluate_trainer_small():
    """evaluate_trainer on a small trainer: 4,096 walkers by default, the
    '1d' sector for two electrons, finite block statistics; the same seed
    gives the same numbers."""
    t = VMCTrainer(VMCConfig(num_knots=8, spline_degree=4, n_flow_layers=1,
                             n_spline_base_mesh_points=400, device='cpu'))
    kw = dict(n_blocks=4, sweeps_per_block=2, n_warmup_sweeps=2)
    a = evaluate_trainer(t, **kw)
    b = evaluate_trainer(t, **kw)
    assert a.n_samples == 4 * 4096
    assert np.isfinite([a.e_mean, a.e_stderr, a.e_clipped, a.e_median]).all()
    assert 0.0 < a.accept_rate < 1.0
    assert a.e_mean == b.e_mean and a.e_clipped == b.e_clipped
