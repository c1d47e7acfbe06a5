"""The port's sharded probprog drivers (parallel/probprog.py) against the
JAX package's tests/test_probprog_sharded.py, on the CPU: HMC and NUTS
chains and SMC particles over a 2-rank gloo group
(tests/_torch_dist_worker.py, mode 'probprog', one group for the four
gates), with JAX's moment tolerances; the SMC reference is the port's
single-process sampler on the same population."""

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from waveflow_tpu_torch.vmc import make_smc_sampler

torch.set_num_threads(2)

WORLD = 2
POST_VAR = 1.0 / (1.0 / 9.0 + 1.0 / 0.25)
POST_MEAN = POST_VAR * (2.0 / 0.25)


def log_prior(x):
    return -0.5 * (x ** 2).sum(-1) / 9.0


def log_like(x):
    return -0.5 * (((x - 2.0) / 0.5) ** 2).sum(-1)


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(0)
    return dict(
        hmc_pos=(rng.normal(size=(64, 3)) * 0.1).astype(np.float32),
        nuts_pos=(rng.normal(size=(32, 2)) * 0.1).astype(np.float32),
        smc_particles=(rng.normal(size=(4096, 2)) * 3.0).astype(np.float32),
        posterior_data=rng.uniform(0.1, 0.9, (32, 2)).astype(np.float32))


@pytest.fixture(scope='module')
def world2(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp('probprog')
    np.savez(out / 'inputs.npz', **inputs)
    secs = worker.spawn('probprog', WORLD, out)
    print(f"2-rank gloo group: {secs:.1f} s wall")
    return [dict(np.load(out / f'probprog_{r}.npz')) for r in range(WORLD)]


def test_sharded_hmc_gaussian_moments(world2):
    """64 chains over 2 ranks, 200 warm-up + 300 steps: moments of the
    last 200 within 0.12 (JAX's gate), one adapted step size on both
    ranks, moved from its initial 0.2."""
    r0, r1 = world2
    assert r0['hmc_trace'].shape == (300, 64, 3)
    assert r0['hmc_step'] == r1['hmc_step']
    samples = r0['hmc_trace'][100:].reshape(-1, 3)
    print(f"HMC: mean {samples.mean(0)}, std {samples.std(0)}, step size "
          f"{float(r0['hmc_step']):.5f}")
    np.testing.assert_allclose(samples.mean(0), 0.0, atol=0.12)
    np.testing.assert_allclose(samples.std(0), 1.0, atol=0.12)
    eps = float(r0['hmc_step'])
    assert np.isfinite(eps) and eps > 0 and abs(eps - 0.2) > 1e-4


def test_sharded_nuts_gaussian_moments(world2):
    """32 chains over 2 ranks, depth 5, 100 + 200 steps: moments of the
    last 150 within 0.15 (JAX's gate); both ranks share the step size."""
    r0, r1 = world2
    assert r0['nuts_step'] == r1['nuts_step']
    samples = r0['nuts_trace'][50:].reshape(-1, 2)
    print(f"NUTS: mean {samples.mean(0)}, std {samples.std(0)}")
    np.testing.assert_allclose(samples.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(samples.std(0), 1.0, atol=0.15)


def test_sharded_smc_matches_single_process_moments(inputs, world2):
    """Tempered SMC from N(0, 3²) to the N(2, 0.5²) likelihood, 4,096
    particles over 2 ranks with the cross-rank resample: the weighted mean
    within 0.1 of the exact posterior mean, as the single-process sampler's
    (JAX's gate); the ESS finite and the collective resample fired."""
    r0, _ = world2
    init, run = make_smc_sampler(log_prior, log_like, n_temps=12,
                                 n_mcmc_moves=5, mcmc_step_size=0.4,
                                 ess_threshold=0.7)
    st, _ = run(init(torch.as_tensor(inputs['smc_particles'])),
                torch.Generator().manual_seed(5))
    for label, parts, lw in (
            ('world 2', r0['smc_particles'], r0['smc_log_weights']),
            ('one process', st.particles.numpy(), st.log_weights.numpy())):
        w = np.exp(lw - lw.max())
        mean = (w[:, None] * parts).sum(0) / w.sum()
        print(f"SMC {label}: weighted mean {mean} (exact {POST_MEAN:.4f})")
        np.testing.assert_allclose(mean, POST_MEAN, atol=0.1)
    assert np.isfinite(r0['smc_ess']).all()
    assert (r0['smc_ess'] < 0.7).any()


def test_sharded_parameter_posterior_hmc(world2):
    """JAX's test_sharded_parameter_posterior_hmc: HMC over an MFlow's
    parameters, 8 chains over 2 ranks, 5 + 5 steps: finite log
    densities and a trace of (5, 8, D)."""
    r0, _ = world2
    assert np.isfinite(r0['posterior_log_prob']).all()
    assert r0['posterior_log_prob'].shape == (8,)
    shape = tuple(r0['posterior_trace_shape'])
    assert shape[:2] == (5, 8) and shape[2] > 1000
