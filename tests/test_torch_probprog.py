"""Parity of the port's probprog samplers (vmc/hmc.py, vmc/nuts.py,
vmc/smc.py, make_parameter_posterior) with the JAX package, on the CPU.

The JAX samplers draw from their keys; the port's steps take their random
numbers as tensors.  Each replay test splits JAX's keys exactly as the JAX
step does and hands the resulting normals and uniforms to the port's step,
one step at a time from the JAX state, so the two transitions see the same
draws (tests/_probprog_replay.py).  The posterior over an MFlow's
parameters is tests/test_torch_posterior.py.

The K4 vmap rule (ops/spline_eval.py) is checked on the CPU's plain path
against a loop over chains, with the kernel entry points wrapped to
refuse functorch-wrapped tensors and count calls: the counts are the
launches the card makes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.vmc import smc as jsmc
from waveflow_tpu_torch.benchmark.density import get_benchmark_model
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.ops import spline_eval as se
from waveflow_tpu_torch.vmc import hmc, nuts, smc

from _probprog_replay import (
    GAUSS_RTOL, MODEL_RTOL, close, close_state, record_jax_tree_sizes,
    replay_hmc, replay_nuts, smc_draws, t)

torch.set_num_threads(2)

# the posterior example's MFlow (examples/parameter_posterior.py)
EXAMPLE_MFLOW = dict(spline_reg=0.1, n_flow_layers=1, spline_degree=3,
                     n_knots=6, n_mesh_points=800, prior_spline_degree=3,
                     prior_n_knots=6)
# the tiny Waveflow of tests/test_samplers.py
TINY_WAVEFLOW = dict(base_spline_degree=4, i_spline_degree=4,
                     n_prior_internal_knots=8, n_i_internal_knots=8,
                     i_spline_reg=0.1, n_flow_layers=1, box_size=5.0,
                     n_spline_base_mesh_points=400)


@pytest.fixture
def jax_tree_sizes(monkeypatch):
    return record_jax_tree_sizes(monkeypatch)


# ---- the K4 vmap rule -------------------------------------------------------

@pytest.fixture
def k4_calls(monkeypatch):
    """Wrap K4's two entry points: refuse functorch-wrapped tensors (a ctypes
    kernel cannot read them) and count the calls, launches on the card."""
    calls = {'fwd': 0, 'bwd': 0}

    def plain(args):
        for a in args:
            if isinstance(a, torch.Tensor):
                assert not torch._C._functorch.is_functorch_wrapped_tensor(a)

    def fwd(*args):
        plain(args)
        calls['fwd'] += 1
        return orig_fwd(*args)

    def bwd(*args):
        plain(args)
        calls['bwd'] += 1
        return orig_bwd(*args)

    orig_fwd, orig_bwd = se.spline_eval, se.spline_eval_bwd
    monkeypatch.setattr(se, 'spline_eval', fwd)
    monkeypatch.setattr(se, 'spline_eval_bwd', bwd)
    return calls


def test_k4_vmap_rule_against_a_loop_over_chains(k4_calls):
    """The evaluator under vmap over chains, its gradient by autograd of the
    vmapped sum and by vmap(grad), each one call of the forward and one of
    the backward, equal to a loop of per-chain calls (the rows are the same
    rows: exactly equal on the plain path).  Coefficients batched, x
    batched or shared (the unbatched operand is expanded)."""
    m = get_benchmark_model('MFlow', **EXAMPLE_MFLOW, device='cpu',
                            generator=torch.Generator().manual_seed(0))
    ev = m.ev
    rng = np.random.default_rng(0)
    C, N, D = 3, 50, 2
    coeffs = t(rng.uniform(0, 1, (C, N, D, ev.n_bases)).astype(np.float32))
    xs = t(rng.uniform(-0.05, 1.05, (C, N, D)).astype(np.float32))
    for d in (0, 1):
        for x_dim in (0, None):
            x = xs if x_dim == 0 else xs[0]
            f = torch.func.vmap(lambda c, y: ev(c, y, d), (0, x_dim))
            k4_calls.update(fwd=0, bwd=0)
            out = f(coeffs, x)
            assert k4_calls == {'fwd': 1, 'bwd': 0}
            loop = torch.stack([ev(coeffs[c], xs[c] if x_dim == 0 else x, d)
                                for c in range(C)])
            assert torch.equal(out, loop)

            # autograd.grad of the vmapped sum, both operands
            cr = coeffs.clone().requires_grad_()
            xr = x.clone().requires_grad_()
            k4_calls.update(fwd=0, bwd=0)
            gc, gx = torch.autograd.grad(f(cr, xr).square().sum(), (cr, xr))
            assert k4_calls == {'fwd': 1, 'bwd': 1}
            lc = [torch.autograd.grad(
                ev(cr[c], xr[c] if x_dim == 0 else xr, d).square().sum(),
                (cr, xr)) for c in range(C)]
            assert torch.equal(gc, sum(g[0] for g in lc))
            torch.testing.assert_close(gx, sum(g[1] for g in lc),
                                       rtol=1e-6, atol=1e-6)

            # vmap(grad): the backward receives batched tensors
            def single(c, y):
                return ev(c, y, d).square().sum()
            k4_calls.update(fwd=0, bwd=0)
            gc, gx = torch.func.vmap(torch.func.grad(single, (0, 1)),
                                     (0, x_dim))(coeffs, x)
            assert k4_calls == {'fwd': 1, 'bwd': 1}
            for c in range(C):
                rc, rx = torch.func.grad(single, (0, 1))(
                    coeffs[c], xs[c] if x_dim == 0 else x)
                assert torch.equal(gc[c], rc) and torch.equal(gx[c], rx)


# ---- HMC --------------------------------------------------------------------

def test_hmc_replays_jax_on_a_gaussian():
    scales = np.asarray([0.5, 2.0], np.float32)
    pos = np.random.default_rng(0).normal(size=(32, 2)).astype(np.float32)
    replay_hmc(lambda x: -0.5 * ((x / scales) ** 2).sum(-1),
               lambda x: -0.5 * ((x / t(scales)) ** 2).sum(-1),
               pos, 8, 0.6, 4, 3, GAUSS_RTOL)


@pytest.fixture(scope='module')
def tiny_waveflow():
    """The tiny Waveflow of tests/test_samplers.py in both packages, and 64
    JAX ancestral draws."""
    init = jget_waveflow_model(2, **TINY_WAVEFLOW, xu_coord_type='mean')
    jparams, _, jlog_pdf, jsample = init(jax.random.PRNGKey(0), 2)
    m = get_waveflow_model(2, **TINY_WAVEFLOW, xu_coord_type='mean',
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    anc = np.asarray(jsample(jax.random.PRNGKey(1), jparams, 64))
    return jparams, jlog_pdf, m, anc


def test_hmc_replays_jax_on_the_tiny_waveflow(tiny_waveflow):
    """JAX's test_hmc_stationary_on_waveflow target: the sorted-sector
    density, clipped into the open box."""
    jparams, jlog_pdf, m, anc = tiny_waveflow

    def jlp(x):
        return jlog_pdf(jparams, jnp.sort(jnp.clip(x, -4.999, 4.999), -1))

    def tlp(x):
        return m.log_pdf(torch.sort(torch.clamp(x, -4.999, 4.999), -1).values)

    replay_hmc(jlp, tlp, anc[:32], 8, 0.3, 3, 2, MODEL_RTOL)


# ---- NUTS -------------------------------------------------------------------

def test_nuts_replays_jax_on_an_anisotropic_gaussian(jax_tree_sizes):
    """Depth 5, scale ratio 10: the same tree depth, leaf count and proposal
    on every chain, and the same dual-averaging state."""
    scales = np.asarray([0.3, 3.0], np.float32)
    pos = np.random.default_rng(1).normal(size=(16, 2)).astype(np.float32)
    depths = replay_nuts(lambda x: -0.5 * ((x / scales) ** 2).sum(-1),
                         lambda x: -0.5 * ((x / t(scales)) ** 2).sum(-1),
                         pos, 5, 0.25, 3, 2, GAUSS_RTOL, jax_tree_sizes)
    # the trees stopped at several depths, the top one included
    assert len(np.unique(depths)) >= 3 and depths.max() == 5


# ---- SMC --------------------------------------------------------------------

def test_smc_replays_jax():
    """The bimodal target of JAX's test_smc_bimodal_target at 256
    particles: particles, weights, log-likelihoods and the ESS trace."""
    def jprior(x):
        return -0.5 * (x ** 2).sum(-1) / 9.0

    def jlike(x):
        return jnp.logaddexp(-0.5 * ((x - 2.0) ** 2).sum(-1) / 0.1,
                             -0.5 * ((x + 2.0) ** 2).sum(-1) / 0.1)

    def prior(x):
        return -0.5 * (x ** 2).sum(-1) / 9.0

    def like(x):
        return torch.logaddexp(-0.5 * ((x - 2.0) ** 2).sum(-1) / 0.1,
                               -0.5 * ((x + 2.0) ** 2).sum(-1) / 0.1)

    n_temps, n_moves, N = 12, 3, 256
    jinit, jrun = jsmc.make_smc_sampler(jprior, jlike, n_temps=n_temps,
                                        n_mcmc_moves=n_moves,
                                        mcmc_step_size=0.3)
    init, run = smc.make_smc_sampler(prior, like, n_temps=n_temps,
                                     n_mcmc_moves=n_moves, mcmc_step_size=0.3)
    parts = 3 * np.random.default_rng(5).normal(size=(N, 1)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(6)
    js, jess = jax.jit(jrun)(jinit(jnp.asarray(parts)), key)
    state, ess = run(init(t(parts)),
                     draws=smc_draws(key, n_temps, n_moves, N, 1))
    close(ess, jess, GAUSS_RTOL, 'ess')
    close_state(state, js, GAUSS_RTOL)
    # both branches of the resample mask were taken
    assert 0 < (np.asarray(jess) < 0.5).sum() < n_temps


def test_systematic_resample_clamps_as_jax_gathers():
    """An f32 CDF that ends below the last position: JAX's searchsorted
    gives n there and its gather clamps to n − 1; the port clamps the
    index.  Offsets u > 0.9999 from JAX keys, 4,096 particles.  Elsewhere
    the indices agree except where a position lies within f32 rounding
    (2e-6, ~30 ulp of 1) of the CDF: the two frameworks sum the CDF in
    another order (torch's CPU cumsum in float64)."""
    n = 4096
    keys = jax.random.split(jax.random.PRNGKey(7), 200000)
    us = np.asarray(jax.vmap(jax.random.uniform)(keys))
    picks = np.flatnonzero(us > 0.9999)[:20]
    rng = np.random.default_rng(8)
    parts = rng.normal(size=(n, 3)).astype(np.float32)
    jres = jax.jit(jsmc.systematic_resample, static_argnums=2)
    reached = 0
    for i in picks:
        lw = rng.normal(size=n).astype(np.float32)
        jidx = np.asarray(jres(keys[i], jnp.asarray(lw), n))
        reached += int(jidx.max() == n)
        idx = smc.systematic_resample(t(us[i]), t(lw), n).numpy()
        jclamped = np.minimum(jidx, n - 1)
        assert (idx[jidx == n] == n - 1).all()
        w = np.exp(lw.astype(np.float64) - lw.max())
        cdf = np.cumsum(w / w.sum())
        pos = (np.float64(us[i]) + np.arange(n)) / n
        off = np.flatnonzero(idx != jclamped)
        edge = cdf[np.minimum(idx, jclamped)[off]]
        assert np.abs(edge - pos[off]).max(initial=0.0) < 2e-6
        same = idx == jclamped
        np.testing.assert_array_equal(
            parts[idx][same], np.asarray(jnp.asarray(parts)[jidx])[same])
    assert reached >= 3


# ---- the samplers refuse an unbound chain axis ----------------------------

def test_axis_name_is_not_ported():
    """A chain axis with no process group behind it raises at
    construction (the bound axes: tests/test_torch_probprog_sharded.py)."""
    lp = lambda x: -0.5 * (x ** 2).sum(-1)
    for make in (lambda: hmc.make_hmc_sampler(lp, axis_name='unbound'),
                 lambda: nuts.make_nuts_sampler(lp, axis_name='unbound'),
                 lambda: smc.make_smc_sampler(lp, lp, axis_name='unbound')):
        with pytest.raises(ValueError, match='no process group'):
            make()


# ---- JAX's statistical tests (tests/test_samplers.py), on the port ----------
# Same targets, chain counts, step counts and tolerances; the draws come
# from the port's generators.

def gen(seed):
    return torch.Generator().manual_seed(seed)


def normal(seed, shape, scale=1.0):
    return scale * torch.randn(shape, generator=gen(seed))


def test_hmc_standard_normal():
    log_prob = lambda x: -0.5 * (x ** 2).sum(-1)
    init_fn, _, run_fn = hmc.make_hmc_sampler(log_prob, n_leapfrog=8)
    state = init_fn(normal(0, (128, 3), 0.1), step_size=0.2)
    state, trace = run_fn(state, gen(1), 400, n_warmup=200)
    samples = trace[100:].reshape(-1, 3)
    assert abs(samples.mean()) < 0.05
    assert abs(samples.std() - 1.0) < 0.07


def test_hmc_anisotropic_gaussian_covariance():
    scales = torch.tensor([0.5, 2.0])
    log_prob = lambda x: -0.5 * ((x / scales) ** 2).sum(-1)
    init_fn, _, run_fn = hmc.make_hmc_sampler(log_prob, n_leapfrog=16)
    state = init_fn(normal(0, (128, 2), 0.1), step_size=0.1)
    state, trace = run_fn(state, gen(1), 500, n_warmup=300)
    samples = trace[150:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.std(0), scales.numpy(), rtol=0.12)


@pytest.mark.parametrize('sampler', ['hmc', 'nuts'])
def test_warmup_anchor_follows_init_step_size(sampler):
    """μ = log(10 ε₀) from the caller's step size: warm-ups from ε₀ = 0.1
    and 1.0 adapt to the same step within a factor of 2."""
    log_prob = lambda x: -0.5 * (x ** 2).sum(-1)
    if sampler == 'hmc':
        init_fn, _, run_fn = hmc.make_hmc_sampler(log_prob, n_leapfrog=8)
        pos, n_warmup = normal(0, (128, 3), 0.1), 400
    else:
        init_fn, _, run_fn = nuts.make_nuts_sampler(log_prob,
                                                    max_tree_depth=5)
        pos, n_warmup = normal(0, (64, 2), 0.1), 200
    adapted = []
    for eps0 in (0.1, 1.0):
        state = init_fn(pos, step_size=eps0)
        assert abs(float(state.mu) - np.log(10.0 * eps0)) < 1e-6
        state, _ = run_fn(state, gen(1), 1, n_warmup=n_warmup)
        adapted.append(float(state.step_size))
    assert 0.5 < adapted[1] / adapted[0] < 2.0, adapted


def test_smc_bimodal_target():
    """Prior N(0, 3²); the likelihood puts the mass at ±2."""
    log_prior = lambda x: -0.5 * (x ** 2).sum(-1) / 9.0
    log_like = lambda x: torch.logaddexp(
        -0.5 * ((x - 2.0) ** 2).sum(-1) / 0.1,
        -0.5 * ((x + 2.0) ** 2).sum(-1) / 0.1)
    init_fn, run_fn = smc.make_smc_sampler(log_prior, log_like, n_temps=30,
                                           n_mcmc_moves=8, mcmc_step_size=0.3)
    state, _ = run_fn(init_fn(normal(0, (512, 1), 3.0)), gen(1))
    samples = state.particles.ravel().numpy()
    assert 0.25 < (samples > 0).mean() < 0.75
    assert np.abs(np.abs(samples) - 2.0).mean() < 0.5


def test_nuts_standard_normal():
    log_prob = lambda x: -0.5 * (x ** 2).sum(-1)
    init_fn, _, run_fn = nuts.make_nuts_sampler(log_prob, max_tree_depth=6)
    state = init_fn(normal(0, (64, 3), 0.1), step_size=0.2)
    state, trace = run_fn(state, gen(1), 300, 100)
    s = trace[100:].reshape(-1, 3)
    assert abs(s.mean()) < 0.05
    assert abs(s.std() - 1.0) < 0.05


def test_nuts_anisotropic_adapts_trajectory():
    """Scale ratio 10: NUTS adapts the trajectory length per draw and
    recovers both scales."""
    scales = torch.tensor([0.3, 3.0])
    log_prob = lambda x: -0.5 * ((x / scales) ** 2).sum(-1)
    init_fn, _, run_fn = nuts.make_nuts_sampler(log_prob, max_tree_depth=7)
    state = init_fn(normal(2, (64, 2), 0.1), step_size=0.1)
    state, trace = run_fn(state, gen(3), 400, 150)
    s = trace[100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.std(0), scales.numpy(), rtol=0.15)
    assert np.isfinite(float(state.step_size))


def test_nuts_stationary_on_waveflow_2d():
    """NUTS over walkers of the 2D 'independent' Waveflow (gradients of
    log|ψ|² through the whole flow): warm-started at ancestral draws, the
    pooled moments stay at the ancestral ones."""
    m = get_waveflow_model(2, **TINY_WAVEFLOW, xu_coord_type='independent',
                           device='cpu', generator=gen(0))
    anc = m.sample(4096, generator=gen(1))

    def log_prob(x):
        wall = 1e3 * (torch.clamp(x.abs() - 5.0, min=0.0) ** 2).sum(-1)
        return m.log_pdf(x) - wall

    init_fn, _, run_fn = nuts.make_nuts_sampler(log_prob, max_tree_depth=5)
    state = init_fn(anc[:256], step_size=0.3)
    state, trace = run_fn(state, gen(3), 200, 80)
    mc = trace[60:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(mc.mean(0), anc.mean(0).numpy(), atol=0.25)
    np.testing.assert_allclose(mc.std(0), anc.std(0).numpy(), atol=0.25)
