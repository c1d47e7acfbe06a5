"""Parity of the port's natural-gradient updates (vmc/sr.py) and of the
basis jet's vmap rule with the JAX package, on the CPU: the per-walker
score matrix, the conjugate-gradient solver, one SR step from
results/he1d_sr, one SPRING step from results/r4_spring100k, the Cholesky
retry ladder's counters, and every JAX optimizer-state form the trainer
loads."""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu.vmc import sr as jsr
from waveflow_tpu.vmc.estimators import PSI_EPS as JPSI_EPS
from waveflow_tpu_torch.convert import params_from_jax, ravel_order
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.ops import get_tables, make_poly_evaluator
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.utils import load_state
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
from waveflow_tpu_torch.vmc.sr import (
    cg, make_score_fn, make_spring_train_step, make_sr_train_step,
    make_sr_train_window)

torch.set_num_threads(2)

RESULTS = Path(__file__).resolve().parents[1] / 'results'
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=8, n_i_internal_knots=8, i_spline_reg=0.1,
             n_flow_layers=1, box_size=10.0, n_spline_base_mesh_points=400)
FLAGSHIP = dict(base_spline_degree=6, i_spline_degree=6,
                n_prior_internal_knots=23, n_i_internal_knots=23,
                i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)
PROTONS = system_catalogue[1]['He'][0]


def _pair(kw, run=None, seed=3, B=32):
    """(JAX params, psi, h_fn; port model, h_fn; walkers drawn by JAX)."""
    jparams, jpsi, _, jsample = jget_waveflow_model(2, **kw)(
        jax.random.PRNGKey(seed), 2)
    if run is not None:
        with open(RESULTS / run / 'checkpoints', 'rb') as f:
            jparams = pickle.load(f)['params']
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    m = get_waveflow_model(2, **kw, eval_backend='poly_pallas',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    x = np.array(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(5), jparams, B))
    return jparams, jpsi, jh, m, h, x


@pytest.fixture(scope='module')
def small():
    return _pair(SMALL, B=24)


def test_ravel_order_is_jax_ravel_pytree(small):
    """The port's flat parameter layout is JAX's ravel_pytree order: the
    flat vector of the JAX params, cut by ravel_order, lands every leaf."""
    jparams, _, _, m, _, _ = small
    flat, _ = ravel_pytree(jparams)
    flat = np.asarray(flat)
    named = dict(m.named_parameters())
    names = ravel_order(list(named))
    assert names == list(params_from_jax(jax.device_get(jparams)))
    at = 0
    for n in names:
        k = named[n].numel()
        np.testing.assert_array_equal(
            flat[at:at + k].reshape(named[n].shape), named[n].detach().numpy())
        at += k
    assert at == flat.size


def test_vmap_grad_of_basis_jet_equals_loop():
    """vmap(grad) through the jet's vmap rule equals a per-walker loop of
    grad (rtol 1e-6), one core call for the whole batch; nested forward
    derivatives under vmap equal the batched ones (the 'fwd' Laplacian's
    form): the jvp rule's forward-grad switch holds under vmap."""
    tabs = get_tables('I', 4, 8, n_mesh=400)
    ev = make_poly_evaluator(tabs, device='cpu')
    gen = torch.Generator().manual_seed(1)
    c = torch.rand((ev.n_bases,), generator=gen)
    x = torch.rand((17,), generator=gen) * 1.1 - 0.05

    def f(xi):
        return (c * ev.basis_jet(xi)[..., 0, :]).sum()

    calls, core = [], ev._core
    ev._core = lambda xx: calls.append(xx.shape) or core(xx)
    got = torch.func.vmap(torch.func.grad(f))(x)
    assert calls == [x.shape]                      # one core call, batched
    ev._core = core
    loop = torch.stack([torch.func.grad(f)(xi) for xi in x])
    np.testing.assert_allclose(got.numpy(), loop.numpy(), rtol=1e-6,
                               atol=1e-6)

    def d2(xi):
        def d1(y):
            return torch.func.jvp(f, (y,), (torch.ones_like(y),))[1]
        return torch.func.jvp(d1, (xi,), (torch.ones_like(xi),))[1]

    batched = ((c * ev.basis_jet(x)[..., 2, :]).sum(-1))
    np.testing.assert_allclose(torch.func.vmap(d2)(x).numpy(),
                               batched.numpy(), rtol=1e-5, atol=1e-4)


def test_score_matrix_matches_jax(small):
    """SPRING's per-walker score matrix O = vmap(grad(log|ψ|)) on the flat
    parameters: equal to a per-walker loop of grad and to JAX's
    vmap(grad) O, to 1e-5 of the largest |O|; its parameter jvp equals
    O · v (the SR matvec's first half)."""
    jparams, jpsi, _, m, _, x = small
    flat0, unravel = ravel_pytree(jparams)

    def jf(flat, xi):
        return jnp.log(jnp.abs(jpsi(unravel(flat), xi[None]))[0] + JPSI_EPS)

    want = np.asarray(jax.jit(jax.vmap(jax.grad(jf), in_axes=(None, 0)))(
        flat0, jnp.asarray(x)))
    flatten, scores = make_score_fn(m)
    flat = flatten()
    xt = torch.as_tensor(x)
    O = scores(flat, xt)
    scale = np.abs(want).max()
    np.testing.assert_allclose(O.numpy(), want, rtol=0, atol=1e-5 * scale)
    loop = torch.stack([scores(flat, xt[i:i + 1])[0] for i in range(8)])
    np.testing.assert_allclose(loop.numpy(), O[:8].numpy(), rtol=0,
                               atol=1e-5 * scale)
    v = torch.randn(flat.shape, generator=torch.Generator().manual_seed(2))
    named = dict(m.named_parameters())
    names = ravel_order(list(named))

    def log_abs_psi(f):
        p = {n: t.view(named[n].shape) for n, t in zip(
            names, f.split([named[n].numel() for n in names]))}
        return torch.log(torch.abs(torch.func.functional_call(
            m, p, (xt,))) + 1e-8)

    _, ov = torch.func.jvp(log_abs_psi, (flat,), (v,))
    ref = O @ v
    np.testing.assert_allclose(ov.numpy(), ref.numpy(), rtol=0,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize('maxiter,shift', [(4, 1e-3), (60, 1.0)])
def test_cg_matches_jax(maxiter, shift):
    """cg on a fixed SPD system over two leaves against
    jax.scipy.sparse.linalg.cg: an ill-conditioned system cut at maxiter,
    and a well-conditioned one that stops early at ‖r‖ ≤ 1e-5 ‖b‖ — the
    iterates past the stop are masked out.  rtol 1e-4."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(12, 12)).astype(np.float32)
    A = (M @ M.T / 12 + shift * np.eye(12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)

    def jmv(v):
        y = jnp.asarray(A) @ jnp.concatenate([v[0], v[1]])
        return (y[:5], y[5:])

    want, _ = jax.scipy.sparse.linalg.cg(jmv, (jnp.asarray(b[:5]),
                                               jnp.asarray(b[5:])),
                                         maxiter=maxiter)
    At = torch.as_tensor(A)

    def mv(v):
        y = At @ torch.cat(v)
        return [y[:5], y[5:]]

    got = cg(mv, [torch.as_tensor(b[:5]), torch.as_tensor(b[5:])], maxiter)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    if maxiter == 60:                 # converged: residual below the stop
        r = b - A @ torch.cat(got).numpy()
        assert np.linalg.norm(r) <= 2e-5 * np.linalg.norm(b)


@pytest.fixture(scope='module')
def flagship_sr():
    return _pair(FLAGSHIP, run='he1d_sr', B=32)


def test_sr_step_matches_jax(flagship_sr):
    """One SR step (lr 0.05, damping 1e-3, 20 CG iterations, trust region
    0.3) from results/he1d_sr on a fixed batch, against the JAX step: loss
    rtol 1e-4 and the parameter update as one vector to a relative L2 error
    of 2e-3, test_train_step_matches_jax's tolerances (20 CG iterations in
    f32 carry the models' ~1e-5 differences into the update)."""
    jparams, jpsi, jh, m, h, x = flagship_sr
    step = jsr.make_sr_train_step(jpsi, jh, 0.05, damping=1e-3, cg_iters=20,
                                  max_update_norm=0.3)
    new, _, jloss = jax.jit(step)(jparams, (), jnp.asarray(x), jnp.zeros(()))
    t_step = make_sr_train_step(m, h, 0.05, damping=1e-3, cg_iters=20,
                                max_update_norm=0.3)
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    loss = t_step(torch.as_tensor(x), torch.zeros(()))
    assert t_step.optimizer.state_dict() == ()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
    ref = params_from_jax(jax.device_get(new))
    named = dict(m.named_parameters())
    d_t = torch.cat([(named[k].detach() - before[k]).ravel() for k in ref])
    d_j = torch.cat([(ref[k] - before[k]).ravel() for k in ref])
    assert d_j.norm() > 0
    assert ((d_t - d_j).norm() / d_j.norm()).item() <= 2e-3


def _spring_state_to_torch(state):
    return {k: torch.tensor(np.asarray(v)) for k, v in state.items()}


def test_spring_step_matches_jax():
    """One SPRING step (lr 0.05, momentum 0.9, trust region 0.3) from
    results/r4_spring100k — its parameters and its state (delta, step
    100,000, fallbacks 1) — on a fixed batch, against the JAX step.

    Through the port's own model and Hamiltonian: loss rtol 1e-4, the
    counters equal, and the new delta and the parameter update, each as
    one vector, to a relative L2 error of 5e-2.  That
    last bound is loose for a reason the step itself has: at convergence ζ
    = ε − Ō(μ δ_prev) is a small residual of two near-equal terms, so the
    packages' f32 local energies (up to 1.6e-4 apart on one walker of this
    batch) move ζ by ~5% and δ by ~3%; either package's δ is within 1e-5 of
    a float64 solve from its own energies.  Driven by the JAX package's
    energies instead, the port's δ and parameter update hold to 2e-3 — the
    score matrix, the Gram solve and the momentum
    add no difference of their own.  The delta arrives in ravel order, so
    the momentum of the loaded state lands on the parameters it belongs
    to."""
    jparams, jpsi, jh, m, h, x = _pair(FLAGSHIP, run='r4_spring100k', B=32)
    jstate = load_state(RESULTS / 'r4_spring100k' / 'checkpoints')['opt_state']
    step = jsr.make_spring_train_step(jpsi, jh, 0.05, momentum=0.9,
                                      max_update_norm=0.3)
    new, new_state, jloss = jax.jit(step)(
        jparams, {k: jnp.asarray(v) for k, v in jstate.items()},
        jnp.asarray(x), jnp.zeros(()))
    ref = params_from_jax(jax.device_get(new))
    want_delta = torch.tensor(np.asarray(new_state['delta']))
    jh_jit = jax.jit(jh)

    def jax_energies(batch):
        return torch.tensor(np.asarray(jh_jit(jparams, batch.numpy())))

    start = params_from_jax(jax.device_get(jparams))
    for energies, delta_tol in ((h, 5e-2), (jax_energies, 2e-3)):
        m.load_state_dict(start)
        t_step = make_spring_train_step(m, energies, 0.05, momentum=0.9,
                                        max_update_norm=0.3)
        t_step.optimizer.load_state_dict(dict(jstate))
        loss = t_step(torch.as_tensor(x), torch.zeros(()))
        assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
        got = t_step.optimizer.state_dict()
        for k in ('step', 'skipped', 'fallbacks'):
            assert int(got[k]) == int(new_state[k]), k
        assert ((got['delta'] - want_delta).norm()
                / want_delta.norm()).item() <= delta_tol
        named = dict(m.named_parameters())
        d_t = torch.cat([(named[k].detach() - start[k]).ravel() for k in ref])
        d_j = torch.cat([(ref[k] - start[k]).ravel() for k in ref])
        assert ((d_t - d_j).norm() / d_j.norm()).item() <= delta_tol


def test_spring_failed_cholesky_counts_like_jax(small):
    """A negative damping makes the Gram matrix indefinite at 1×, 10× and
    100×: every Cholesky fails (NaN, as jax.scipy.linalg.solve gives), the
    step counts one fallback and one skipped solve, and the zeroed delta
    leaves the parameters where they were — in both packages, from a first
    step with the score-row clip active (step 0 < warmup)."""
    jparams, jpsi, jh, m, h, x = small
    step = jsr.make_spring_train_step(jpsi, jh, 0.05, damping=-1.0,
                                      momentum=0.9, max_update_norm=0.3)
    new, jstate, _ = jax.jit(step)(jparams, step.init_state(jparams),
                                   jnp.asarray(x), jnp.zeros(()))
    t_step = make_spring_train_step(m, h, 0.05, damping=-1.0, momentum=0.9,
                                    max_update_norm=0.3)
    before = [p.detach().clone() for p in m.parameters()]
    t_step(torch.as_tensor(x), torch.zeros(()))
    got = t_step.optimizer.state_dict()
    for k in ('step', 'skipped', 'fallbacks'):
        assert int(got[k]) == int(jstate[k]) == 1, k
    assert not got['delta'].any()
    assert all(torch.equal(a, b) for a, b in zip(before, m.parameters()))
    ref = params_from_jax(jax.device_get(new))
    for k, v in m.named_parameters():
        assert torch.equal(v.detach(), ref[k]), k


@pytest.mark.parametrize('run,optimizer', [
    ('r4_spring100k', 'spring'), ('he1d_spring', 'spring'),
    ('he1d_sr', 'sr'), ('he1d_metropolis_seed7', 'spring')])
def test_trainer_loads_every_jax_optimizer_form(run, optimizer):
    """The JAX trainer's optimizer states, as its load_checkpoint reads
    them: SPRING's dict (delta, step, skipped, fallbacks); the pre-round-4
    flat delta, migrated with step := epoch; SR's (); and an Adam state in
    a SPRING trainer, which raises ValueError."""
    t = VMCTrainer(VMCConfig(optimizer=optimizer, device='cpu'))
    path = RESULTS / run
    raw = load_state(path / 'checkpoints')
    if run == 'he1d_metropolis_seed7':
        with pytest.raises(ValueError, match="'spring'"):
            t.load_checkpoint(str(path))
        return
    assert t.load_checkpoint(str(path))
    state = t.step.optimizer.state_dict()
    if optimizer == 'sr':
        assert state == () and t.epoch == 20_000
        return
    delta = raw['opt_state']['delta'] if run == 'r4_spring100k' \
        else raw['opt_state']
    np.testing.assert_array_equal(state['delta'].numpy(), delta)
    want = ({k: int(v) for k, v in raw['opt_state'].items() if k != 'delta'}
            if run == 'r4_spring100k'
            else dict(step=raw['epoch'], skipped=0, fallbacks=0))
    assert {k: int(v) for k, v in state.items() if k != 'delta'} == want
    assert all(v.dtype == torch.int32 for k, v in state.items()
               if k != 'delta')


def test_sr_train_window(small):
    """make_sr_train_window: ``window`` epochs of exact draws and one SR
    update each; the losses stay on the device, finite, the next baseline
    is their mean (the one handed in is unused), and the parameters
    move."""
    _, _, _, m, h, _ = small
    gen = torch.Generator().manual_seed(9)
    run = make_sr_train_window(m, h, lambda n: m.sample(n, generator=gen),
                               0.05, 8, 2, cg_iters=3, max_update_norm=0.3)
    before = [p.detach().clone() for p in m.parameters()]
    losses, baseline = run(torch.tensor(0.5))
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    assert torch.equal(baseline, losses.mean())
    assert run.step.optimizer.state_dict() == ()
    assert any(not torch.equal(a, b) for a, b in zip(before, m.parameters()))


SMALL_TRAINER = dict(num_knots=8, spline_degree=4, n_flow_layers=1,
                     n_spline_base_mesh_points=400, batch_size=8, window=2,
                     log_every=2, learning_rate=0.05, device='cpu')


@pytest.mark.parametrize('optimizer,sampler', [('spring', 'mala'),
                                               ('sr', 'ancestral')])
def test_natural_gradient_resume_is_bitwise(tmp_path, optimizer, sampler):
    """4 epochs straight equal 2, save_checkpoint, a fresh trainer's
    load_checkpoint and 2 more, to the bit: losses, parameters, the
    optimizer state (SPRING's delta and counters; SR's ()) and walkers."""
    kw = dict(optimizer=optimizer, sampler=sampler, sr_cg_iters=3,
              **SMALL_TRAINER)
    straight = VMCTrainer(VMCConfig(**kw))
    losses = straight.train(4, verbose=False)
    VMCTrainer(VMCConfig(save_dir=str(tmp_path), **kw)).train(
        2, verbose=False)
    second = VMCTrainer(VMCConfig(save_dir=str(tmp_path), **kw))
    assert second.train(2, restart=True, verbose=False) == losses
    for a, b in zip(straight.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    sa = straight.step.optimizer.state_dict()
    sb = second.step.optimizer.state_dict()
    if optimizer == 'sr':
        assert sa == sb == ()
    else:
        assert sa.keys() == sb.keys() and int(sb['step']) == 4
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        for a, b in zip(straight.mcmc_state, second.mcmc_state):
            assert torch.equal(a, b)


def test_another_optimizers_checkpoint(tmp_path, capsys):
    """The port's own checkpoints across optimizers, as the JAX trainer
    reads its own: a SPRING checkpoint re-initialises an Adam trainer's
    moments with the JAX notice (the parameters load), and an Adam
    checkpoint fails a SPRING trainer with ValueError."""
    spring = VMCTrainer(VMCConfig(optimizer='spring', **SMALL_TRAINER))
    spring.train(2, verbose=False)
    spring.save_checkpoint(str(tmp_path / 'spring'))
    adam = VMCTrainer(VMCConfig(**SMALL_TRAINER))
    assert adam.load_checkpoint(str(tmp_path / 'spring'))
    assert "re-initializing adam moments" in capsys.readouterr().out
    assert len(adam.step.optimizer.state) == 0 and adam.epoch == 2
    for a, b in zip(spring.model.parameters(), adam.model.parameters()):
        assert torch.equal(a, b)
    adam.save_checkpoint(str(tmp_path / 'adam'))
    with pytest.raises(ValueError, match="'spring'"):
        VMCTrainer(VMCConfig(optimizer='spring', **SMALL_TRAINER)
                   ).load_checkpoint(str(tmp_path / 'adam'))
