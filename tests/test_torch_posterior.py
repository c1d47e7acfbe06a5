"""Parity of the port's Bayesian posterior over flow parameters
(vmc/hmc.py::make_parameter_posterior) with the JAX package, on the CPU:
the example MFlow's flat θ, log density and gradient against JAX's, NUTS
on it replayed from JAX's key tree (tests/_probprog_replay.py), JAX's
posterior tests on the port, and the port's documented departure for a
NaN energy (ROADMAP Queue 3).

On CPU tensors K4 runs its plain version; tests/test_torch_probprog.py
holds its vmap rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from waveflow_tpu.benchmark.density import \
    get_benchmark_model as jget_benchmark_model
from waveflow_tpu.vmc import hmc as jhmc
from waveflow_tpu.vmc import nuts as jnuts
from waveflow_tpu_torch.benchmark.density import get_benchmark_model
from waveflow_tpu_torch.convert import mflow_params_from_jax
from waveflow_tpu_torch.vmc import hmc, nuts

from _probprog_replay import (
    MODEL_RTOL, close, record_jax_tree_sizes, replay_nuts, t)

torch.set_num_threads(2)

# the posterior example's MFlow (examples/parameter_posterior.py)
EXAMPLE_MFLOW = dict(spline_reg=0.1, n_flow_layers=1, spline_degree=3,
                     n_knots=6, n_mesh_points=800, prior_spline_degree=3,
                     prior_n_knots=6)


@pytest.fixture
def jax_tree_sizes(monkeypatch):
    return record_jax_tree_sizes(monkeypatch)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def normal(seed, shape):
    return torch.randn(shape, generator=gen(seed))


@pytest.fixture(scope='module')
def example_mflow():
    """The posterior example's MFlow initialised by JAX, in both packages."""
    init = jget_benchmark_model('MFlow', **EXAMPLE_MFLOW)
    jparams, jlog_pdf, _ = init(jax.random.PRNGKey(0), 2)
    m = get_benchmark_model('MFlow', **EXAMPLE_MFLOW, device='cpu')
    m.load_state_dict(mflow_params_from_jax(jax.device_get(jparams)))
    data = np.random.default_rng(2).uniform(0.1, 0.9, (40, 2)) \
        .astype(np.float32)
    return jparams, jlog_pdf, m, data


def test_parameter_posterior_matches_jax(example_mflow):
    """D = 10,816 as JAX prints it, the same flat θ, and log_prob and its
    gradient for a batch of θ within MODEL_RTOL of JAX's."""
    jparams, jlog_pdf, m, data = example_mflow
    jlp, _, jflat0 = jhmc.make_parameter_posterior(
        jlog_pdf, jnp.asarray(data), jparams, prior_scale=2.0)
    lp, unravel, flat0 = hmc.make_parameter_posterior(m, t(data),
                                                      prior_scale=2.0)
    assert flat0.shape == jflat0.shape == (10816,)
    assert torch.equal(flat0, t(jflat0))
    names = dict(m.named_parameters())
    assert set(unravel(flat0)) == set(names)
    for n, v in unravel(flat0).items():
        assert torch.equal(v, names[n].detach())

    theta = np.asarray(jflat0)[None] + 0.05 * np.random.default_rng(3) \
        .normal(size=(4, 10816)).astype(np.float32)
    jval = jlp(jnp.asarray(theta))
    jgrad = jax.vmap(jax.grad(lambda th: jlp(th[None])[0]))(jnp.asarray(theta))
    val, grad = hmc.value_and_grad(lp, t(theta))
    close(val, jval, MODEL_RTOL, 'log_prob')
    close(grad, jgrad, MODEL_RTOL, 'grad')


def test_nuts_replays_jax_on_the_mflow_posterior(example_mflow,
                                                 jax_tree_sizes):
    """The posterior over the example MFlow's 10,816 parameters at the
    example's step size: the same tree depth and proposal on every chain.
    The acceptance statistic exp(ΔH) is not replayable to MODEL_RTOL here:
    H sums ~10⁴ f32 terms of magnitude ~1 (½‖r‖², ‖θ‖²) in another order
    in each framework, ~1e-2 apart (JAX reads α = 0.991-0.998 where the
    port reads 0.9999-1.0 at ε = 2e-3); the step size moves by 20/11 of
    the statistic's difference in the first warm-up step, so the
    dual-averaging fields are held to 2e-2."""
    jparams, jlog_pdf, m, data = example_mflow
    jlp, _, jflat0 = jhmc.make_parameter_posterior(
        jlog_pdf, jnp.asarray(data[:20]), jparams, prior_scale=2.0)
    lp, _, _ = hmc.make_parameter_posterior(m, t(data[:20]), prior_scale=2.0)
    pos = np.asarray(jflat0)[None] + 0.01 * np.random.default_rng(4) \
        .normal(size=(3, 10816)).astype(np.float32)
    depths = replay_nuts(jlp, lp, pos, 4, 2e-3, 2, 0, MODEL_RTOL,
                         jax_tree_sizes, da_rtol=2e-2)
    assert depths.min() >= 2


def test_example_posterior_dimension():
    """The example's MFlow built by the port: D = 10,816, as JAX prints."""
    m = get_benchmark_model('MFlow', **EXAMPLE_MFLOW, device='cpu',
                            generator=gen(0))
    _, unravel, flat0 = hmc.make_parameter_posterior(m, torch.rand(8, 2))
    assert flat0.shape == (10816,)
    assert sum(v.numel() for v in unravel(flat0).values()) == 10816


# ---- JAX's posterior tests (tests/test_samplers.py), on the port ------------

class Location(nn.Module):
    """The tiny Gaussian 'flow' of JAX's posterior tests: log p(x) of
    N(μ, 1) up to its constant."""

    def __init__(self):
        super().__init__()
        self.mu = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return -0.5 * (x[:, 0] - self.mu) ** 2


@pytest.mark.parametrize('sampler', ['hmc', 'nuts'])
def test_parameter_posterior_mean(sampler):
    """HMC / NUTS over the location parameter: the posterior mean
    approaches the sample mean."""
    data = normal(0, (200, 1)) + 1.5
    log_prob, _, flat0 = hmc.make_parameter_posterior(Location(), data,
                                                      prior_scale=10.0)
    chains = flat0[None] + normal(1, (16, 1))
    if sampler == 'hmc':
        init_fn, _, run_fn = hmc.make_hmc_sampler(log_prob, n_leapfrog=8)
        n_steps, n_warmup, burn = 300, 200, 100
    else:
        init_fn, _, run_fn = nuts.make_nuts_sampler(log_prob,
                                                    max_tree_depth=5)
        n_steps, n_warmup, burn = 200, 100, 50
    state = init_fn(chains, step_size=0.05)
    state, trace = run_fn(state, gen(2), n_steps, n_warmup=n_warmup)
    assert abs(float(trace[burn:].mean()) - float(data.mean())) < 0.1


# ---- a NaN energy (documented departure, ROADMAP Queue 3) -------------------

def test_nan_energy_is_a_divergence():
    """A target that is NaN outside |x| < 3, warmed up from a step size that
    leaves it: JAX's acceptance statistic turns NaN and with it the shared
    step size, for good; the port counts the NaN energy as a divergence
    (NUTS) or a rejection (HMC) with statistic 0, and adapts."""
    def jlp(x):
        return jnp.where(jnp.abs(x).max(-1) < 3, -0.5 * (x ** 2).sum(-1),
                         jnp.nan)

    def lp(x):
        return torch.where(x.abs().amax(-1) < 3, -0.5 * (x ** 2).sum(-1),
                           torch.nan)

    pos = 0.1 * normal(0, (32, 2))
    for jmake, make, kw in ((jhmc.make_hmc_sampler, hmc.make_hmc_sampler,
                             dict(n_leapfrog=8)),
                            (jnuts.make_nuts_sampler, nuts.make_nuts_sampler,
                             dict(max_tree_depth=4))):
        jinit, _, jrun = jmake(jlp, **kw)
        js, _ = jrun(jinit(jnp.asarray(pos.numpy()), step_size=2.0),
                     jax.random.PRNGKey(1), 1, n_warmup=20)
        assert np.isnan(float(js.step_size))
        init, _, run = make(lp, **kw)
        state, trace = run(init(pos, step_size=2.0), gen(1), 50,
                           n_warmup=30)
        assert 0.0 < float(state.step_size) < 3.0
        assert torch.isfinite(trace).all()
        assert (trace[-1] != pos).any(-1).float().mean() > 0.5
