"""Parity of the trainer menu under the table eval backend with the JAX
package, on the CPU: one SR step, one SPRING step (its per-walker score
matrix and δ), one MALA sweep, one Metropolis sweep and the 'reference'
gradient under 'hvp', each with ``eval_backend='table'`` in both packages.

A small random He model (degree 3, 6 knots, 1 flow layer, 200-point mesh,
the trainer tests' ``TRAIN_SMALL``) made by JAX from a key; the same
parameters cross by ``convert.py``.  The batch and every draw come from
numpy with a seed, and both packages get the same ones: the JAX samplers'
``jax.random.normal`` / ``uniform`` are replaced by those draws while
their step is traced.  Each JAX function is compiled once."""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu.vmc import estimators as jest
from waveflow_tpu.vmc import mala as jmala
from waveflow_tpu.vmc import metropolis as jmetropolis
from waveflow_tpu.vmc import sr as jsr
from waveflow_tpu.vmc.estimators import PSI_EPS as JPSI_EPS
from waveflow_tpu_torch.convert import params_from_jax, ravel_order
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.vmc import make_loss_fn
from waveflow_tpu_torch.vmc.mala import MALAState, make_mala_sampler
from waveflow_tpu_torch.vmc.metropolis import (
    MetropolisState, make_metropolis_sampler, sector_projection)
from waveflow_tpu_torch.vmc.sr import (
    make_score_fn, make_spring_train_step, make_sr_train_step)

torch.set_num_threads(2)

PROTONS = system_catalogue[1]['He'][0]
# TRAIN_SMALL of tests/test_torch_table_backend.py as model arguments
SMALL = dict(base_spline_degree=3, i_spline_degree=3,
             n_prior_internal_knots=6, n_i_internal_knots=6,
             i_spline_reg=0.05, n_flow_layers=1, box_size=10.0,
             n_spline_base_mesh_points=200, eval_backend='table')
BOX = 10.0
B = 8


def _walkers(seed):
    """B sorted walkers near the nucleus, from numpy."""
    x = np.random.default_rng(seed).normal(size=(B, 2)) * 1.5
    return np.sort(x, axis=-1).astype(np.float32)


def _draws(seed):
    """(noise (B, 2), uniforms (B,)) from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 2)).astype(np.float32),
            rng.uniform(size=B).astype(np.float32))


@contextlib.contextmanager
def _jax_draws(noise, u):
    """Within the block the JAX samplers draw ``noise`` and ``u``: their
    step reads ``jax.random.normal`` / ``uniform`` while it is traced."""
    with mock.patch.object(jax.random, 'normal',
                           lambda key, shape, *a, **k: jnp.asarray(noise)), \
            mock.patch.object(jax.random, 'uniform',
                              lambda key, shape, *a, **k: jnp.asarray(u)):
        yield


@pytest.fixture(scope='module')
def pair():
    """(JAX params, psi, log_pdf, 'fwd_batched' h; the port's 'table'
    model and h) of one small random He model."""
    jparams, jpsi, jlog_pdf, _ = jget_waveflow_model(2, **SMALL)(
        jax.random.PRNGKey(3), 2)
    jparams = jax.device_get(jparams)
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    m = get_waveflow_model(2, **SMALL,
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jparams))
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    return jparams, jpsi, jlog_pdf, jh, m, h


@contextlib.contextmanager
def _restored(m):
    before = {k: v.detach().clone() for k, v in m.state_dict().items()}
    try:
        yield before
    finally:
        m.load_state_dict(before)


def _update(m, before, names):
    named = dict(m.named_parameters())
    return torch.cat([(named[k].detach() - before[k]).ravel() for k in names])


def _rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm()).item()


def test_sr_step_matches_jax_under_table(pair):
    """One SR step (lr 0.05, 20 CG iterations, trust region 0.3) on a
    fixed batch against JAX's.  Its pieces first: the per-walker jvp of
    log|ψ| in the parameters (SR's jvp, which meets the first layer's x
    untraced) and the vjps of the ones and of that jvp (the vjp of a jvp)
    within 5e-5 of JAX's largest entry (measured ~1e-5, as under 'poly').
    Then the step at damping 1: loss rtol 1e-5, δ (the parameter update)
    as one vector to a relative L2 error of 2e-3 and every updated
    parameter within 2e-3 of δ's largest entry.  At 8 walkers the
    curvature has rank 7, and the default damping 1e-3 leaves CG a
    condition number that turns those 1e-5 into ~1e-2 in δ, under 'poly'
    as under 'table'; damping 1 bounds it."""
    jparams, jpsi, _, jh, m, h = pair
    x = _walkers(5)
    flat0, unravel = ravel_pytree(jparams)
    v = np.random.default_rng(12).normal(size=flat0.shape).astype(np.float32)

    def jf(flat):
        return jnp.log(jnp.abs(jpsi(unravel(flat), jnp.asarray(x)))
                       + JPSI_EPS)

    @jax.jit
    def jpieces(flat, vv):
        ov = jax.jvp(jf, (flat,), (vv,))[1]
        _, vjp_fn = jax.vjp(jf, flat)
        return ov, vjp_fn(jnp.ones(B))[0], vjp_fn(ov)[0]

    named = dict(m.named_parameters())
    names = ravel_order(list(named))

    def f(flat):
        p = {n: t.view(named[n].shape) for n, t in zip(
            names, flat.split([named[n].numel() for n in names]))}
        return torch.log(torch.abs(torch.func.functional_call(
            m, p, (torch.as_tensor(x),))) + JPSI_EPS)

    flat = torch.cat([named[n].detach().ravel() for n in names])
    ov = torch.func.jvp(f, (flat,), (torch.as_tensor(v),))[1]
    _, vjp_fn = torch.func.vjp(f, flat)
    for got, want in zip((ov, vjp_fn(torch.ones(B))[0], vjp_fn(ov)[0]),
                         jpieces(flat0, v)):
        want = np.asarray(want)
        assert np.abs(got.detach().numpy() - want).max() \
            <= 5e-5 * np.abs(want).max()

    step = jsr.make_sr_train_step(jpsi, jh, 0.05, damping=1.0, cg_iters=20,
                                  max_update_norm=0.3)
    new, _, jloss = jax.jit(step)(jparams, (), jnp.asarray(x), jnp.zeros(()))
    ref = params_from_jax(jax.device_get(new))
    with _restored(m) as before:
        t_step = make_sr_train_step(m, h, 0.05, damping=1.0, cg_iters=20,
                                    max_update_norm=0.3)
        loss = t_step(torch.as_tensor(x), torch.zeros(()))
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        d_t = _update(m, before, ref)
        d_j = torch.cat([(ref[k] - before[k]).ravel() for k in ref])
        assert d_j.norm() > 0
        assert _rel_l2(d_t, d_j) <= 2e-3
        scale = d_j.abs().max().item()
        for k, want in ref.items():
            assert (named[k].detach() - want).abs().max().item() \
                <= 2e-3 * scale, k


def test_spring_step_matches_jax_under_table(pair):
    """One SPRING step from a fresh state (lr 0.05, momentum 0.9, trust
    region 0.3, the score-row clip active at step 0) on a fixed batch:
    the per-walker score matrix O = vmap(grad(log|ψ|)) (SPRING's
    vmap(grad) through the table chain's vmap fold) within 1e-5 of JAX's
    largest |O|; then the step at damping 1 (as the SR test: at 8 walkers
    the default 1e-3 turns O's f32 differences into ~1e-3 in δ, under
    'poly' as under 'table'): loss rtol 1e-5, the counters equal, δ and
    the parameter update, each as one vector, to a relative L2 error of
    1e-4 (measured 2.1e-5)."""
    jparams, jpsi, _, jh, m, h = pair
    x = _walkers(6)
    flat0, unravel = ravel_pytree(jparams)

    def jf(flat, xi):
        return jnp.log(jnp.abs(jpsi(unravel(flat), xi[None]))[0] + JPSI_EPS)

    want_O = np.asarray(jax.jit(jax.vmap(jax.grad(jf), in_axes=(None, 0)))(
        flat0, jnp.asarray(x)))
    flatten, scores = make_score_fn(m)
    O = scores(flatten(), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(O, want_O, rtol=0,
                               atol=1e-5 * np.abs(want_O).max())

    step = jsr.make_spring_train_step(jpsi, jh, 0.05, damping=1.0,
                                      momentum=0.9, max_update_norm=0.3)
    new, jstate, jloss = jax.jit(step)(jparams, step.init_state(jparams),
                                       jnp.asarray(x), jnp.zeros(()))
    ref = params_from_jax(jax.device_get(new))
    want_delta = torch.tensor(np.asarray(jstate['delta']))
    with _restored(m) as before:
        t_step = make_spring_train_step(m, h, 0.05, damping=1.0,
                                        momentum=0.9, max_update_norm=0.3)
        loss = t_step(torch.as_tensor(x), torch.zeros(()))
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        got = t_step.optimizer.state_dict()
        for k in ('step', 'skipped', 'fallbacks'):
            assert int(got[k]) == int(jstate[k]), k
        assert want_delta.norm() > 0
        assert _rel_l2(got['delta'], want_delta) <= 1e-4
        d_j = torch.cat([(ref[k] - before[k]).ravel() for k in ref])
        assert _rel_l2(_update(m, before, ref), d_j) <= 1e-4


def test_mala_step_matches_jax_under_table(pair):
    """One MALA sweep under 'table' from the same state with the same
    numpy draws (step size 0.8, the density of the sorted walkers, as the
    trainer's MALA window forms it): the initial and new log-prob and
    drift (the x-gradient of log|ψ|² through the slope tables) within 1e-5
    (relative to 1 or the field's largest entry), the same accept mask,
    positions within 1e-6, the proposal at the shared formula within
    1e-6, step size and running rate rtol 1e-6."""
    jparams, _, jlog_pdf, _, m, _ = pair
    x = _walkers(7)
    noise, u = _draws(8)
    jlp = lambda p, xx: jlog_pdf(p, jnp.sort(xx, axis=-1))
    jinit, jstep, _ = jmala.make_mala_sampler(jlp, bounds=(-BOX, BOX))
    state = jax.jit(jinit)(jparams, jnp.asarray(x), 0.8)
    with _jax_draws(noise, u):
        new = jax.jit(jstep)(jparams, state, jax.random.PRNGKey(0))

    init_fn, step_fn, _ = make_mala_sampler(
        lambda xx: m.log_pdf(torch.sort(xx, dim=-1).values),
        bounds=(-BOX, BOX))
    tstate = init_fn(torch.as_tensor(x), 0.8)

    def close(got, want, tol, what):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got.numpy() - want).max() <= tol * scale, what

    close(tstate.log_prob, state.log_prob, 1e-5, 'initial log_prob')
    close(tstate.grad, state.grad, 1e-5, 'initial drift')
    got = step_fn(MALAState(*(torch.as_tensor(np.array(f)) for f in state)),
                  noise=torch.as_tensor(noise), u=torch.as_tensor(u))
    jaccept = np.any(np.asarray(new.positions) != x, axis=-1)
    assert 0 < jaccept.mean() < 1
    np.testing.assert_array_equal(
        (got.positions != torch.as_tensor(x)).any(-1).numpy(), jaccept)
    close(got.positions, new.positions, 1e-6, 'positions')
    close(got.log_prob, new.log_prob, 1e-5, 'log_prob')
    close(got.grad, new.grad, 1e-5, 'drift')
    eps = np.asarray(state.step_size)
    proposal = x + 0.5 * eps ** 2 * np.asarray(state.grad) + eps * noise
    close(got.positions[torch.as_tensor(jaccept)],
          proposal[jaccept], 1e-6, 'proposal')
    for f in ('step_size', 'accept_rate'):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(new, f)), rtol=1e-6,
                                   err_msg=f)


def test_metropolis_step_matches_jax_under_table(pair):
    """One Metropolis sweep under 'table' (proposals sorted, step size
    0.8) from the same state with the same numpy draws: the same accept
    mask, positions within 1e-6, log_prob within 1e-5 of max(1, its
    largest entry), step size and running rate rtol 1e-6."""
    jparams, _, jlog_pdf, _, m, _ = pair
    x = _walkers(9)
    noise, u = _draws(10)
    jinit, jstep, _ = jmetropolis.make_metropolis_sampler(
        jlog_pdf, bounds=(-BOX, BOX),
        proposal_map=jmetropolis.sector_projection(True))
    state = jax.jit(jinit)(jparams, jnp.asarray(x), 0.8)
    with _jax_draws(noise, u):
        new = jax.jit(jstep)(jparams, state, jax.random.PRNGKey(0))
    _, step_fn, _ = make_metropolis_sampler(
        m.log_pdf, bounds=(-BOX, BOX), proposal_map=sector_projection(True))
    got = step_fn(MetropolisState(*(torch.as_tensor(np.array(f))
                                    for f in state)),
                  noise=torch.as_tensor(noise), u=torch.as_tensor(u))
    lp0 = np.asarray(state.log_prob)
    jaccept = np.asarray(new.log_prob) != lp0
    assert 0 < jaccept.mean() < 1
    np.testing.assert_array_equal(got.log_prob.numpy() != lp0, jaccept)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(new.positions), rtol=1e-6,
                               atol=1e-6)
    want = np.asarray(new.log_prob)
    assert np.abs(got.log_prob.numpy() - want).max() \
        <= 1e-5 * max(1.0, float(np.abs(want).max()))
    for f in ('step_size', 'accept_rate'):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(new, f)), rtol=1e-6,
                                   err_msg=f)


def test_reference_gradient_under_hvp_matches_jax(pair):
    """The 'reference' loss and its parameter gradient under 'hvp' (a
    grad level inside the Laplacian, then the loss's grad: the chain's
    grad-of-grad rules, _BWD.vjp and _BASIS.vjp), baseline −1.2, against
    JAX: loss rtol 1e-5, the gradient as one vector to a relative L2
    error of 1e-4 (the 'fwd_batched' and 'dense' tolerance of
    tests/test_torch_table_backend.py)."""
    jparams, jpsi, _, _, m, _ = pair
    x = _walkers(11)
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1,
                      laplacian_mode='hvp')
    jloss, jgrads = jax.jit(jax.value_and_grad(jest.make_loss_fn(
        jpsi, jh, estimator='reference')))(jparams, x, jnp.float32(-1.2))
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1,
                                       laplacian_mode='hvp')
    loss = make_loss_fn(m.psi, h, estimator='reference')(
        torch.as_tensor(x), torch.tensor(-1.2))
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    named = dict(m.named_parameters())
    for p in named.values():
        p.grad = None
    loss.backward()
    want = params_from_jax(jax.device_get(jgrads))
    names = ravel_order(list(want))
    got = torch.cat([(torch.zeros_like(named[k]) if named[k].grad is None
                      else named[k].grad).ravel() for k in names])
    ref = torch.cat([want[k].ravel() for k in names])
    for p in named.values():
        p.grad = None
    assert ref.norm() > 0
    assert _rel_l2(got, ref) <= 1e-4
