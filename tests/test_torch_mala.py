"""Parity of the port's MALA sampler and MALA training window with the JAX
package, on the CPU (the JAX draws handed to the port explicitly); the
committed MALA run results/he1d_mala_s3 carried across and resumed bit for
bit; and the first check with three electrons: Li's ψ, log|ψ|² and E_L
from results/r5_li_metro_refresh100_s3 against JAX's, and the 'auto'
walker refresh at n = 3."""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu.vmc import mala as jmala
from waveflow_tpu_torch.convert import (
    adam_state_from_jax, load_jax_checkpoint, params_from_jax)
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, make_train_step
from waveflow_tpu_torch.vmc.mala import (
    MALAState, make_mala_sampler, make_mala_train_window)

torch.set_num_threads(2)

RESULTS = Path(__file__).resolve().parents[1] / 'results'
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=8, n_i_internal_knots=8, i_spline_reg=0.1,
             n_flow_layers=1, box_size=10.0, n_spline_base_mesh_points=400)
FLAGSHIP = dict(base_spline_degree=6, i_spline_degree=6,
                n_prior_internal_knots=23, n_i_internal_knots=23,
                i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)
SMALL_TRAINER = dict(num_knots=8, spline_degree=4, n_flow_layers=1,
                     n_spline_base_mesh_points=400, device='cpu')
BOX = 10.0


@pytest.fixture(scope='module')
def small():
    """(JAX params, psi, log_pdf; port model) of a small He model."""
    jparams, jpsi, jlog_pdf, _ = jget_waveflow_model(2, **SMALL)(
        jax.random.PRNGKey(3), 2)
    m = get_waveflow_model(2, **SMALL, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return jparams, jpsi, jlog_pdf, m


def _to_torch(state):
    return MALAState(*(torch.as_tensor(np.array(f)) for f in state))


def _draws(key, B, D):
    """The noise and uniforms the JAX step draws from ``key``."""
    k_prop, k_acc = jax.random.split(key)
    return (torch.as_tensor(np.array(jax.random.normal(k_prop, (B, D)))),
            torch.as_tensor(np.array(jax.random.uniform(k_acc, (B,)))))


def _toy(xp):
    """A Gaussian log-density whose value and gradient are NaN outside the
    box (sqrt of a negative), in either package."""
    def log_pdf(*args):
        x = args[-1]
        return (-0.5 * (x ** 2).sum(-1) / 9.0
                + 0.0 * xp.sqrt(BOX - xp.abs(x)).sum(-1))
    return log_pdf


@pytest.mark.parametrize('case', ['model', 'nan'])
def test_step_matches_jax(small, case):
    """One MALA sweep from the same state with JAX's own draws: the same
    accept mask; positions, drift and log_prob to 1e-5 (the model's log_pdf
    parity, test_torch_model.py, is 1e-4; the drift is its x-gradient
    through the sort); step size and running rate rtol 1e-6.  Case 'nan':
    walkers at the box's edge and a step of 2 send proposals outside, where
    the toy log-density and its drift are NaN — the NaN ratio rejects, and
    no NaN reaches the kept state."""
    jparams, _, jlog_pdf, m = small
    if case == 'model':
        B, step_size = 128, 0.5
        x = np.sort(np.random.default_rng(5).normal(size=(B, 2)) * 1.5, -1)
        jlp = lambda p, xx: jlog_pdf(p, jnp.sort(xx, axis=-1))
        tlp = lambda xx: m.log_pdf(torch.sort(xx, dim=-1).values)
    else:
        B, step_size = 64, 2.0
        x = np.random.default_rng(6).uniform(7.5, 9.9, size=(B, 2))
        x[::2] *= -1
        jlp, tlp = _toy(jnp), _toy(torch)
    x = x.astype(np.float32)
    jinit, jstep, _ = jmala.make_mala_sampler(jlp, bounds=(-BOX, BOX))
    state = jax.jit(jinit)(jparams, jnp.asarray(x), step_size)
    key = jax.random.PRNGKey(11)
    new = jax.jit(jstep)(jparams, state, key)
    noise, u = _draws(key, B, 2)
    jaccept = np.any(np.asarray(new.positions) != x, axis=-1)
    assert 0.05 < jaccept.mean() < 0.95

    _, step_fn, _ = make_mala_sampler(tlp, bounds=(-BOX, BOX))
    got = step_fn(_to_torch(state), noise=noise, u=u)
    accept = (got.positions != torch.as_tensor(x)).any(-1).numpy()
    np.testing.assert_array_equal(accept, jaccept)
    for f in ('positions', 'log_prob', 'grad'):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(new, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    for f in ('step_size', 'accept_rate'):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(new, f)), rtol=1e-6,
                                   err_msg=f)
    if case == 'nan':
        prop = torch.as_tensor(x) + 0.5 * step_size ** 2 * torch.as_tensor(
            np.array(state.grad)) + step_size * noise
        outside = (prop.abs() > BOX).any(-1)
        assert outside.any() and not accept[outside.numpy()].any()
    assert all(torch.isfinite(f).all() for f in got)


def test_run_fn_freezes_the_kernel_after_warmup():
    """run_fn: ``n_warmup`` adaptive sweeps, then recorded sweeps at the
    adapted, frozen step size; the trace keeps sweeps 0, thin, 2·thin, ...
    (the reference's trace[::thin]); with no warmup the step adapts."""
    init_fn, _, run_fn = make_mala_sampler(lambda x: -0.5 * (x ** 2).sum(-1))
    gen = torch.Generator().manual_seed(0)
    state = init_fn(torch.randn((64, 2), generator=gen), step_size=3.0)
    warm, _ = run_fn(state, 1, generator=gen, n_warmup=5)
    assert warm.step_size != state.step_size
    final, trace = run_fn(warm, 7, generator=gen, thin=3, n_warmup=0)
    assert trace.shape == (3, 64, 2) and final.step_size != warm.step_size
    frozen, trace = run_fn(warm, 7, generator=gen, thin=3, n_warmup=2)
    assert trace.shape == (3, 64, 2)
    again, _ = run_fn(frozen, 4, generator=gen, n_warmup=1)
    assert again.step_size != frozen.step_size


def test_window_matches_jax(small):
    """One epoch of the MALA training window (2 sweeps on log_pdf(sort(x)),
    one clipped-score + clip + adam update on the sorted walkers, the
    log_prob AND drift refresh) from the same walkers — unsorted, as the
    full-space chain keeps them — parameters and Adam moments, with JAX's
    draws, Adam at count 50: loss rtol 1e-4, positions 1e-5, the parameter
    update as one vector to a relative L2 error of 1e-3, the refreshed
    log_prob 1e-5 (test_torch_metropolis.py's window tolerances) and the
    refreshed drift rtol / atol 1e-4 (the model's log_pdf parity: after an
    update the parameters differ at 1e-5 relative)."""
    jparams, jpsi, jlog_pdf, m = small
    B, n_sweeps, lr = 64, 2, 1e-4
    protons = system_catalogue[1]['He'][0]
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    opt = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0),
                                    optax.adam(lr)))
    opt_state = opt.init(jparams)
    # Adam past its sign-like first step: random moments at count 50, zero
    # for the parameters off the path (as in every JAX checkpoint)
    n = opt_state[1][0].mu.shape[0]
    rng = np.random.default_rng(4)
    mu = (rng.normal(size=n) * 1e-2).astype(np.float32)
    nu = (mu ** 2 + rng.uniform(size=n) * 1e-4).astype(np.float32)
    at = 0
    for name, leaf in params_from_jax(jax.device_get(jparams)).items():
        if name.endswith('zero_params'):
            mu[at:at + leaf.numel()] = nu[at:at + leaf.numel()] = 0.0
        at += leaf.numel()
    adam = opt_state[1][0]._replace(count=jnp.asarray(50, jnp.int32),
                                    mu=jnp.asarray(mu), nu=jnp.asarray(nu))
    opt_state = (opt_state[0], (adam, opt_state[1][1]))
    jinit, jwindow = jmala.make_mala_train_window(
        jpsi, jh, jlog_pdf, opt, 1, BOX, n_sweeps=n_sweeps, target_accept=0.5)
    x = (np.random.default_rng(6).normal(size=(B, 2)) * 1.5).astype(np.float32)
    mstate = jax.jit(jinit)(jparams, jnp.asarray(x), 0.5)
    key = jax.random.PRNGKey(8)
    new_params, _, _, _, losses, new_m = jax.jit(jwindow)(
        jparams, opt_state, key, jnp.zeros(()), mstate)
    _, k = jax.random.split(key)
    draws = [_draws(kk, B, 2) for kk in jax.random.split(k, n_sweeps)]
    noise = torch.stack([d[0] for d in draws])[None]
    u = torch.stack([d[1] for d in draws])[None]

    h = construct_hamiltonian_function(m.psi, protons=protons,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    step = make_train_step(m.psi, h, m.parameters(), lr, grad_clip=10.0)
    moments = adam_state_from_jax(jax.device_get(opt_state),
                                  jax.device_get(jparams),
                                  m.named_parameters())
    for name, p in m.named_parameters():
        step.optimizer.state[p] = moments[name]
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    init_fn, run_window = make_mala_train_window(
        step, m.log_pdf, BOX, n_sweeps=n_sweeps, target_accept=0.5)
    t_state = init_fn(torch.as_tensor(x), step_size=0.5)
    np.testing.assert_allclose(t_state.grad.numpy(), np.asarray(mstate.grad),
                               rtol=1e-5, atol=1e-5)
    t_losses, t_base, t_rates, t_m = run_window(
        _to_torch(mstate), 1, torch.zeros(()), noise=noise, u=u)
    assert t_losses.shape == (1,) and t_rates.shape == (1,)
    assert torch.equal(t_base, t_losses.mean())      # the next baseline
    assert t_losses[0].item() == pytest.approx(float(losses[0]), rel=1e-4)
    np.testing.assert_allclose(t_m.positions.numpy(),
                               np.asarray(new_m.positions), rtol=1e-5,
                               atol=1e-5)
    assert not np.array_equal(np.sort(x, -1), t_m.positions.numpy())
    ref = params_from_jax(jax.device_get(new_params))
    named = dict(m.named_parameters())
    d_t = torch.cat([(named[k].detach() - before[k]).ravel() for k in ref])
    d_j = torch.cat([(ref[k] - before[k]).ravel() for k in ref])
    assert d_j.norm() > 0
    assert ((d_t - d_j).norm() / d_j.norm()).item() <= 1e-3
    for f, tol in (('log_prob', 1e-5), ('grad', 1e-4)):
        np.testing.assert_allclose(getattr(t_m, f).numpy(),
                                   np.asarray(getattr(new_m, f)), rtol=tol,
                                   atol=tol, err_msg=f)


def test_he1d_mala_s3_loads_and_resumes_bitwise(tmp_path):
    """results/he1d_mala_s3 — a 5-field MALAState at epoch 100,000 and flat
    Adam moments at count 100,000 — lands in a sampler='mala' trainer bit
    for bit.  Cut to 32 walkers and written by the port, it resumes bitwise:
    2 windows of 2 epochs straight against 1 window, save / load, 1 more —
    losses, parameters, Adam state, walkers (all five fields) and the
    generator equal."""
    ck = load_jax_checkpoint(RESULTS / 'he1d_mala_s3' / 'checkpoints')
    kw = dict(sampler='mala', mcmc_sweeps=1, window=2, log_every=2,
              device='cpu')
    t = VMCTrainer(VMCConfig(**kw))
    assert t.load_checkpoint(str(RESULTS / 'he1d_mala_s3'))
    assert isinstance(t.mcmc_state, MALAState) and t.epoch == 100_000
    for got, want in zip(t.mcmc_state, ck['mcmc_state']):
        np.testing.assert_array_equal(got.numpy(), want)
    moments = adam_state_from_jax(ck['opt_state'], ck['params'],
                                  t.model.named_parameters())
    for name, p in t.model.named_parameters():
        assert t.step.optimizer.state[p]['step'].item() == 100_000
        assert torch.equal(t.step.optimizer.state[p]['exp_avg'],
                           moments[name]['exp_avg'])
    t.mcmc_state = MALAState(*(f[:32] if f.ndim else f for f in t.mcmc_state))
    t.save_checkpoint(str(tmp_path / 'cut'))

    def loaded(d):
        u = VMCTrainer(VMCConfig(save_dir=str(d), **kw))
        assert u.load_checkpoint(str(tmp_path / 'cut'))
        return u

    straight = loaded(tmp_path / 'a')
    losses = straight.train(4, verbose=False)
    first = loaded(tmp_path / 'b')
    first.train(2, verbose=False)
    second = VMCTrainer(VMCConfig(save_dir=str(tmp_path / 'b'), **kw))
    resumed = second.train(2, restart=True, verbose=False)
    assert second.epoch == straight.epoch == 100_004
    assert resumed == losses and np.isfinite(losses[-4:]).all()
    assert isinstance(second.mcmc_state, MALAState)
    for a, b in zip(straight.mcmc_state, second.mcmc_state):
        assert torch.equal(a, b)
    for a, b in zip(straight.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    sa = straight.step.optimizer.state_dict()['state']
    sb = second.step.optimizer.state_dict()['state']
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert torch.equal(straight.generator.get_state(),
                       second.generator.get_state())


def test_li_matches_jax():
    """Three electrons: results/r5_li_metro_refresh100_s3 (40,434
    parameters: the 'mean' map at n = 3 with its two constrained gap
    dimensions) on 32 walkers from the JAX model's own sampler — ψ rtol
    1e-4, log|ψ|² rtol / atol 1e-4, and E_L through the three-coordinate
    Laplacian rtol / atol 2e-4 (test_torch_model.py's tolerances)."""
    with open(RESULTS / 'r5_li_metro_refresh100_s3' / 'checkpoints',
              'rb') as f:
        jparams = pickle.load(f)['params']
    _, jpsi, jlog_pdf, jsample = jget_waveflow_model(3, **FLAGSHIP)(
        jax.random.PRNGKey(0), 3)
    protons = system_catalogue[1]['Li'][0]
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    x = np.array(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(3), jparams, 32))
    assert x.shape == (32, 3) and (np.diff(x, axis=-1) >= 0).all()
    want = jax.jit(lambda p, xx: (jpsi(p, xx), jlog_pdf(p, xx),
                                  jh(p, xx)[:, 0] / jpsi(p, xx)))(jparams, x)
    m = get_waveflow_model(3, **FLAGSHIP, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    sd = params_from_jax(jax.device_get(jparams))
    assert sum(v.numel() for v in sd.values()) == 40_434
    m.load_state_dict(sd)
    assert m.constrained.tolist() == [True, True, False]
    h = construct_hamiltonian_function(m.psi, protons=protons,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    with torch.no_grad():
        xt = torch.as_tensor(x)
        psi, lp = m.psi(xt), m.log_pdf(xt)
        e_loc = h(xt)[:, 0] / psi
    np.testing.assert_allclose(psi.numpy(), np.asarray(want[0]), rtol=1e-4)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want[1]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(e_loc.numpy(), np.asarray(want[2]), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize('system,sampler,refreshes', [
    ('Li', 'metropolis', 2), ('Li', 'mala', 2), ('He', 'metropolis', 0)])
def test_auto_refresh_follows_the_electron_count(system, sampler, refreshes):
    """mcmc_refresh_every='auto': one exact ancestral walker refresh per
    window for >= 3 electrons (Li, either MCMC sampler; the adapted step
    size kept), none for He — 3 windows give 2 refreshes after the warm
    start."""
    t = VMCTrainer(VMCConfig(system_name=system, sampler=sampler,
                             batch_size=16, window=2, **SMALL_TRAINER))
    calls = []
    init = t._init_mcmc_state
    t._init_mcmc_state = lambda step_size=None: calls.append(step_size) or \
        init(step_size)
    assert np.isfinite(t.train(6, verbose=False)).all()
    assert calls[0] is None and len(calls) == 1 + refreshes
    assert all(s is not None for s in calls[1:])
    assert t.mcmc_state.positions.shape == (16, t.input_dim)
