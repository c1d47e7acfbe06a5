"""Parity of the port's Metropolis sampler and Metropolis training window
with the JAX package, on the CPU: the same state, and the proposal noise and
accept uniforms that the JAX package draws from its own key, passed to the
port explicitly."""

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
from waveflow_tpu.vmc import metropolis as jmetropolis
from waveflow_tpu_torch.convert import adam_state_from_jax, params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.vmc import make_train_step
from waveflow_tpu_torch.vmc.metropolis import (
    MetropolisState, make_mcmc_train_window, make_metropolis_sampler,
    sector_projection)

torch.set_num_threads(2)

CHECKPOINT = (Path(__file__).resolve().parents[1] / 'results'
              / 'r5_flagship_fwd_batched_100k' / 'checkpoints')
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=8, n_i_internal_knots=8, i_spline_reg=0.1,
             n_flow_layers=1, box_size=10.0, n_spline_base_mesh_points=400)
FLAGSHIP = dict(base_spline_degree=6, i_spline_degree=6,
                n_prior_internal_knots=23, n_i_internal_knots=23,
                i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)
BOX = 10.0


def _models(which):
    """(JAX params, JAX psi, JAX log_pdf, port model)."""
    kw = SMALL if which == 'small' else FLAGSHIP
    jparams, jpsi, jlog_pdf, _ = jget_waveflow_model(2, **kw)(
        jax.random.PRNGKey(3), 2)
    if which == 'flagship':
        with open(CHECKPOINT, 'rb') as f:
            jparams = pickle.load(f)['params']
    m = get_waveflow_model(2, **kw, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return jparams, jpsi, jlog_pdf, m


def _state_to_torch(state):
    return MetropolisState(*(torch.as_tensor(np.array(f)) for f in state))


@pytest.mark.parametrize('mode', [True, '1d', 'paired2d'])
def test_sector_projection_matches_jax(mode):
    """The same walkers projected by both packages: equal to the bit."""
    x = np.random.default_rng(0).normal(size=(64, 6)).astype(np.float32)
    x[3, 2] = x[3, 0]                                   # a tie in x
    want = np.asarray(jmetropolis.sector_projection(mode)(jnp.asarray(x)))
    got = sector_projection(mode)(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert sector_projection(False) is None and sector_projection(None) is None


def _walkers(B, seed):
    """Sorted walkers near the nucleus, where |ψ|² of the flagship lies."""
    x = np.random.default_rng(seed).normal(size=(B, 2)) * 1.5
    return np.sort(x, axis=-1).astype(np.float32)


@pytest.mark.parametrize('which,B', [('small', 128), ('flagship', 64)])
def test_step_matches_jax(which, B):
    """One sweep from the same state with JAX's own draws.

    Driven by the port's model: the same accept mask, positions (1e-6),
    step size and running accept rate (rtol 1e-6); the new log_prob holds to
    the models' log_pdf parity (rtol / atol 1e-4, test_torch_model.py: the
    two packages' f32 arithmetic differs at ~1e-5).  Driven by the JAX
    log_pdf itself, the port's sweep gives JAX's state to 1e-6 in every
    field but log_prob, which holds to 1e-5 relative: the JAX log_pdf
    compiled alone and compiled inside the JAX step already differ by
    2.2e-6 (XLA fuses them differently).  The sampler adds no difference
    of its own."""
    jparams, _, jlog_pdf, m = _models(which)
    jinit, jstep, _ = jmetropolis.make_metropolis_sampler(
        jlog_pdf, bounds=(-BOX, BOX),
        proposal_map=jmetropolis.sector_projection(True))
    state = jinit(jparams, jnp.asarray(_walkers(B, 5)), step_size=0.5)
    key = jax.random.PRNGKey(11)
    new = jax.jit(jstep)(jparams, state, key)
    # the draws jstep made from its key
    k_prop, k_acc = jax.random.split(key)
    noise = torch.as_tensor(np.array(jax.random.normal(k_prop, (B, 2))))
    u = torch.as_tensor(np.array(jax.random.uniform(k_acc, (B,))))
    lp0 = np.asarray(state.log_prob)
    jaccept = np.asarray(new.log_prob) != lp0
    assert 0.1 < jaccept.mean() < 0.95

    jlp = jax.jit(jlog_pdf)

    def jax_log_pdf(x):
        return torch.as_tensor(np.array(jlp(jparams, x.numpy())))

    for log_pdf, lp_tol in ((m.log_pdf, 1e-4), (jax_log_pdf, 1e-5)):
        _, step_fn, _ = make_metropolis_sampler(
            log_pdf, bounds=(-BOX, BOX), proposal_map=sector_projection(True))
        got = step_fn(_state_to_torch(state), noise=noise, u=u)
        np.testing.assert_array_equal(got.log_prob.numpy() != lp0, jaccept)
        np.testing.assert_allclose(got.positions.numpy(),
                                   np.asarray(new.positions), rtol=1e-6,
                                   atol=1e-6)
        for f in ('step_size', 'accept_rate'):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(new, f)),
                                       rtol=1e-6, err_msg=f)
        np.testing.assert_allclose(got.log_prob.numpy(),
                                   np.asarray(new.log_prob), rtol=lp_tol,
                                   atol=lp_tol)


def test_box_bound_rejects():
    """A proposal outside [-L, L] gets log-prob −inf and no move, even with
    a uniform that accepts any finite ratio."""
    m = _models('small')[-1]
    x = np.array([[9.9, 9.95], [-2.0, 1.0], [-9.97, 3.0]], np.float32)
    noise = np.array([[0.0, 0.5], [0.3, 0.0], [-0.5, 0.0]], np.float32)
    u = np.full((3,), 1e-30, np.float32)
    init_fn, step_fn, _ = make_metropolis_sampler(
        m.log_pdf, bounds=(-BOX, BOX), proposal_map=sector_projection(True))
    state = init_fn(torch.as_tensor(x), step_size=1.0)
    got = step_fn(state, noise=torch.as_tensor(noise), u=torch.as_tensor(u))
    assert torch.equal(got.positions[[0, 2]], state.positions[[0, 2]])
    assert torch.equal(got.log_prob[[0, 2]], state.log_prob[[0, 2]])
    assert got.positions[1, 0].item() == pytest.approx(-1.7)   # inside: moves
    assert got.accept_rate.item() == pytest.approx(0.9 * 0.5 + 0.1 / 3)


def test_unported_arguments_raise():
    """A walker axis with no process group behind it raises at
    construction (tests/test_torch_parallel.py drives the bound ones)."""
    with pytest.raises(ValueError, match='no process group'):
        make_metropolis_sampler(lambda x: x.sum(-1), axis_name='unbound')
    with pytest.raises(ValueError, match='no process group'):
        make_mcmc_train_window(None, lambda x: x.sum(-1), BOX,
                               pmean_axis=('hosts', 'unbound'))


def test_train_window_matches_jax():
    """One epoch of the Metropolis training window (2 sweeps, one clipped-
    score + clip + adam update, the log_prob refresh) from the same walkers,
    parameters and Adam moments (random, count 50, carried across by
    ``adam_state_from_jax``) with JAX's draws: loss rtol 1e-4, the updates
    of the parameters as one vector to a relative L2 error of 1e-3, the
    parameters themselves rtol 1e-5, the refreshed log_prob rtol 1e-5."""
    jparams, jpsi, jlog_pdf, m = _models('small')
    B, n_sweeps, lr = 64, 2, 1e-4
    protons = system_catalogue[1]['He'][0]
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    opt = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0),
                                    optax.adam(lr)))
    opt_state = opt.init(jparams)
    n = opt_state[1][0].mu.shape[0]
    rng = np.random.default_rng(4)
    mu = (rng.normal(size=n) * 1e-2).astype(np.float32)
    nu = (mu ** 2 + rng.uniform(size=n) * 1e-4).astype(np.float32)
    # parameters off the path (the zero_params: no torch gradient, a zero
    # JAX gradient) keep zero moments, as in every JAX checkpoint: Adam then
    # leaves them in place in both packages
    at = 0
    for name, leaf in params_from_jax(jax.device_get(jparams)).items():
        if name.endswith('zero_params'):
            mu[at:at + leaf.numel()] = nu[at:at + leaf.numel()] = 0.0
        at += leaf.numel()
    adam = opt_state[1][0]._replace(count=jnp.asarray(50, jnp.int32),
                                    mu=jnp.asarray(mu), nu=jnp.asarray(nu))
    opt_state = (opt_state[0], (adam, opt_state[1][1]))
    jinit, jwindow = jmetropolis.make_mcmc_train_window(
        jpsi, jh, jlog_pdf, opt, 1, BOX, n_sweeps=n_sweeps)
    mstate = jinit(jparams, jnp.asarray(_walkers(B, 6)), step_size=0.5)
    key = jax.random.PRNGKey(8)
    new_params, _, _, _, losses, new_m = jax.jit(jwindow)(
        jparams, opt_state, key, jnp.zeros(()), mstate)
    # the draws of the window's single epoch
    _, k = jax.random.split(key)
    noise, u = [], []
    for kk in jax.random.split(k, n_sweeps):
        k_prop, k_acc = jax.random.split(kk)
        noise.append(np.asarray(jax.random.normal(k_prop, (B, 2))))
        u.append(np.asarray(jax.random.uniform(k_acc, (B,))))

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
    _, run_window = make_mcmc_train_window(step, m.log_pdf, BOX,
                                           n_sweeps=n_sweeps)
    t_losses, t_base, t_rates, t_m = run_window(
        _state_to_torch(mstate), 1, torch.zeros(()),
        noise=torch.as_tensor(np.stack(noise)[None]),
        u=torch.as_tensor(np.stack(u)[None]))
    assert t_losses.shape == (1,) and t_rates.shape == (1,)
    assert torch.equal(t_base, t_losses.mean())      # the next baseline
    assert t_losses[0].item() == pytest.approx(float(losses[0]), rel=1e-4)
    np.testing.assert_allclose(t_m.positions.numpy(),
                               np.asarray(new_m.positions), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_m.step_size.numpy(), np.asarray(new_m.step_size),
                               rtol=1e-6)
    ref = params_from_jax(jax.device_get(new_params))
    named = dict(m.named_parameters())
    d_t = torch.cat([(named[k].detach() - before[k]).ravel() for k in ref])
    d_j = torch.cat([(ref[k] - before[k]).ravel() for k in ref])
    assert d_j.norm() > 0
    assert ((d_t - d_j).norm() / d_j.norm()).item() <= 1e-3
    for k in ref:
        np.testing.assert_allclose(named[k].detach().numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(t_m.log_prob.numpy(), np.asarray(new_m.log_prob),
                               rtol=1e-5, atol=1e-5)


def test_trainer_divergence_restores_walkers():
    """sampler='metropolis': a window with a non-finite loss restores the
    parameters, the Adam state and the walkers of the last snapshot, and is
    not counted; training then goes on from those walkers."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    t = VMCTrainer(VMCConfig(batch_size=16, window=2, num_knots=8,
                             n_flow_layers=1, spline_degree=4,
                             n_spline_base_mesh_points=400,
                             sampler='metropolis', device='cpu'))
    good = [p.detach().clone() for p in t.model.parameters()]
    real_window, calls = t.mcmc_window, []

    def diverging(mstate, n_epochs, baseline, generator=None):
        calls.append(mstate)
        losses, base, rates, new = real_window(mstate, n_epochs, baseline,
                                               generator)
        if len(calls) == 1:
            with torch.no_grad():
                next(t.model.parameters()).fill_(float('nan'))
            losses = losses * float('nan')
        return losses, base, rates, new

    t.mcmc_window = diverging
    t.train(2, verbose=False)
    walkers = t.mcmc_state
    assert walkers is calls[0]                 # the snapshot's walkers
    assert t.epoch == 0 and t.losses == [] and t.accept_rates == []
    assert all(torch.equal(a, b) for a, b in zip(good, t.model.parameters()))
    losses = t.train(2, verbose=False)
    assert calls[1] is walkers and t.epoch == 2
    assert np.isfinite(losses).all() and len(t.accept_rates) == 2
