"""The antisymmetrized Waveflow (waveflow_tpu_torch/models/antisym.py) and
the trainer's 'antisym' path, against the JAX package on the CPU.

The permutation table; ψ_A and log|ψ_A|² of 2 and 3 electrons in 2D with
the same parameters (carried by ``convert.py``); exact antisymmetry under
exchange and ψ_A ≠ 0 on x-coincidence (as tests/test_antisym.py); a Hψ
pass under 'fwd_batched'; one Metropolis adam epoch from the same walkers
and draws; the committed He-2d-2e antisym run loaded into a trainer and
evaluated at a small size; exact resume of an antisym trainer; its graph
path (a CPU stand-in of the CUDA graph) equal to eager to the bit; the
refresh rule; the warm-start draw; ``fidelity_2d_2e`` of ψ_A; the
sort-and-parity ``antisymmetrize``.  Small widths: 1 flow layer, 7 knots,
a 200-point mesh."""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waveflow_tpu.models import get_antisym_waveflow_model as jget_antisym
from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.models.antisym import (
    electron_permutation_table as jperm_table)
from waveflow_tpu.physics import (
    antisymmetrize as jantisymmetrize,
    construct_hamiltonian_function as jconstruct_h, exact_ground_state_2d_2e,
    system_catalogue)
from waveflow_tpu.utils import fidelity as jfidelity
from waveflow_tpu.vmc import metropolis as jmetropolis
from waveflow_tpu_torch.convert import (
    adam_state_from_jax, mcmc_state_from_jax, params_from_jax)
from waveflow_tpu_torch.models import (
    AntisymWaveflow, electron_permutation_table, get_antisym_waveflow_model,
    get_waveflow_model)
from waveflow_tpu_torch.physics import (
    antisymmetrize, construct_hamiltonian_function)
from waveflow_tpu_torch.utils import fidelity, load_state
from waveflow_tpu_torch.vmc import (
    VMCConfig, VMCTrainer, evaluate_trainer, graphs, make_train_step)
from waveflow_tpu_torch.vmc.metropolis import (
    MetropolisState, make_mcmc_train_window)

torch.set_num_threads(2)

RESULTS = Path(__file__).resolve().parents[1] / 'results'
L = 5.0
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=7, n_i_internal_knots=7, i_spline_reg=0.1,
             n_flow_layers=1, n_spline_base_mesh_points=200)
TRAINER_SMALL = dict(n_space_dimension=2, box_length=L, batch_size=8,
                     window=2, num_knots=7, spline_degree=4, n_flow_layers=1,
                     n_spline_base_mesh_points=200, ansatz='antisym',
                     sampler='metropolis', device='cpu')
HE_2D = system_catalogue[2]['He'][0]

_MODELS = {}


def _models(n_el):
    """(JAX params, jitted psi, jitted log_pdf, JAX psi, JAX log_pdf, port
    model) of ``n_el`` electrons in 2D with the same parameters."""
    if n_el not in _MODELS:
        jparams, jpsi, jlog_pdf, _ = jget_antisym(n_el, 2, box_size=L,
                                                  **SMALL)(
            jax.random.PRNGKey(3), 2 * n_el)
        m = get_antisym_waveflow_model(n_el, 2, box_size=L, **SMALL,
                                       device='cpu')
        m.load_state_dict(params_from_jax(jax.device_get(jparams)))
        _MODELS[n_el] = (jparams, jax.jit(jpsi), jax.jit(jlog_pdf), jpsi,
                         jlog_pdf, m)
    return _MODELS[n_el]


def _box(B, D, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9 * L, 0.9 * L, (B, D)).astype(np.float32)


def _exchange(x, n_el, perm):
    """Electrons of (B, 2 n_el) interleaved coordinates reordered by
    ``perm``."""
    return x.reshape(len(x), n_el, 2)[:, list(perm)].reshape(len(x), -1)


@pytest.mark.parametrize('n_el', [2, 3])
def test_permutation_table_matches_jax(n_el):
    perms, signs = electron_permutation_table(n_el)
    jp, js = jperm_table(n_el)
    np.testing.assert_array_equal(perms, jp)
    np.testing.assert_array_equal(signs, js)
    m = _models(n_el)[-1]
    assert torch.equal(m.perms, torch.as_tensor(jp, dtype=torch.int64))
    assert m.n_perm == len(js)


@pytest.mark.parametrize('n_el', [2, 3])
def test_psi_and_log_pdf_match_jax(n_el):
    """ψ_A (to 1e-5 of max|ψ_A|, relative 1e-5) and log(ψ_A² + 1e-26)
    (relative 1e-5) at 64 box points, the latter where |ψ_A| is above 1e-3
    of its largest value: near the node the signed sum cancels, and an
    absolute error of ψ_A becomes a large one of its log; the state dict is
    φ's."""
    jparams, jpsi, jlog_pdf, _, _, m = _models(n_el)
    x = _box(64, 2 * n_el, 1)
    with torch.no_grad():
        psi_t = m.psi(torch.as_tensor(x)).numpy()
        lp_t = m.log_pdf(torch.as_tensor(x)).numpy()
    psi_j = np.asarray(jpsi(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(psi_t, psi_j, rtol=1e-5,
                               atol=1e-5 * np.abs(psi_j).max())
    away = np.abs(psi_j) > 1e-3 * np.abs(psi_j).max()
    assert away.sum() > 48
    np.testing.assert_allclose(lp_t[away],
                               np.asarray(jlog_pdf(jparams, x))[away],
                               rtol=1e-5, atol=1e-5)
    phi = get_waveflow_model(2 * n_el, xu_coord_type='independent',
                             box_size=L, **SMALL, device='cpu')
    assert list(phi.state_dict()) == list(m.state_dict())
    assert isinstance(m, AntisymWaveflow) and m.phi.input_dim == 2 * n_el


@pytest.mark.parametrize('n_el,perm,sign', [
    (2, (1, 0), -1.0), (3, (1, 0, 2), -1.0), (3, (2, 0, 1), 1.0),
    (3, (0, 2, 1), -1.0)])
def test_exact_antisymmetry_under_exchange(n_el, perm, sign):
    """ψ_A(Px) = sign(P) ψ_A(x) (relative 1e-5); log_pdf unchanged."""
    m = _models(n_el)[-1]
    x = torch.as_tensor(_box(64, 2 * n_el, 2))
    xp = torch.as_tensor(_exchange(x.numpy(), n_el, perm))
    with torch.no_grad():
        v, vp = m.psi(x), m.psi(xp)
        lp, lpp = m.log_pdf(x), m.log_pdf(xp)
    assert v.abs().max() > 0
    np.testing.assert_allclose(vp.numpy(), sign * v.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(lpp.numpy(), lp.numpy(), rtol=1e-5, atol=1e-5)


def test_nonzero_on_x_coincidence():
    """ψ_A need not vanish at x_a = x_b when y_a ≠ y_b (what breaks the
    x-sector floor); at r_a = r_b it vanishes."""
    m = _models(2)[-1]
    y = np.linspace(-3.0, 3.0, 17)
    same_x = np.stack([np.full_like(y, 1.0), y, np.full_like(y, 1.0), -y], 1)
    coinc = np.stack([y, y, y, y], axis=1) * 0.4
    with torch.no_grad():
        vals = m.psi(torch.as_tensor(same_x, dtype=torch.float32))
        zero = m.psi(torch.as_tensor(coinc, dtype=torch.float32))
    assert vals.abs().max() > 1e-6
    np.testing.assert_allclose(zero.numpy(), 0.0, atol=1e-6)


def test_h_psi_fwd_batched_matches_jax():
    """Hψ_A of He-2d under 'fwd_batched' (the nested jvps run through the
    permutation gather and the signed sum) within 4e-4 of max|Hψ_A|."""
    jparams, _, _, jpsi, _, m = _models(2)
    x = _box(32, 4, 3)
    jh = jax.jit(jconstruct_h(jpsi, protons=HE_2D, n_space_dimensions=2,
                              laplacian_mode='fwd_batched'))
    h = construct_hamiltonian_function(m.psi, protons=HE_2D,
                                       n_space_dimensions=2,
                                       laplacian_mode='fwd_batched')
    ref = np.asarray(jh(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = h(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=4e-4 * np.abs(ref).max())


def warm_adam_state(opt_state, jparams, seed=4):
    """An optax ``flatten(chain(clip, adam))`` state with random moments at
    count 50 (Adam's first step is sign-like); the zero_params' moments stay
    zero, as in every JAX checkpoint."""
    n = opt_state[1][0].mu.shape[0]
    rng = np.random.default_rng(seed)
    mu = (rng.normal(size=n) * 1e-2).astype(np.float32)
    nu = (mu ** 2 + rng.uniform(size=n) * 1e-4).astype(np.float32)
    at = 0
    for name, leaf in params_from_jax(jax.device_get(jparams)).items():
        if name.endswith('zero_params'):
            mu[at:at + leaf.numel()] = nu[at:at + leaf.numel()] = 0.0
        at += leaf.numel()
    adam = opt_state[1][0]._replace(count=jnp.asarray(50, jnp.int32),
                                    mu=jnp.asarray(mu), nu=jnp.asarray(nu))
    return (opt_state[0], (adam, opt_state[1][1]))


def test_metropolis_adam_epoch_matches_jax():
    """One epoch of the Metropolis adam window on ψ_A (2 sweeps with no
    sector projection, one clipped-score + clip + adam update, the
    log_prob refresh) from the same walkers, parameters and Adam moments
    (random, count 50) with JAX's draws: loss rtol 1e-4, walkers 1e-6, the
    update as one vector to 1e-3, log_prob 1e-5."""
    jparams, _, _, jpsi, jlog_pdf, _ = _models(2)
    B, n_sweeps, lr = 32, 2, 1e-3
    jh = jconstruct_h(jpsi, protons=HE_2D, n_space_dimensions=2,
                      laplacian_mode='fwd_batched')
    opt = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0),
                                    optax.adam(lr)))
    opt_state = warm_adam_state(opt.init(jparams), jparams)
    jinit, jwindow = jmetropolis.make_mcmc_train_window(
        jpsi, jh, jlog_pdf, opt, 1, L, n_sweeps=n_sweeps,
        sort_proposals=False)
    mstate = jinit(jparams, jnp.asarray(_box(B, 4, 6)), step_size=0.5)
    key = jax.random.PRNGKey(8)
    new_params, _, _, _, losses, new_m = jax.jit(jwindow)(
        jparams, opt_state, key, jnp.zeros(()), mstate)
    _, k = jax.random.split(key)
    noise, u = [], []
    for kk in jax.random.split(k, n_sweeps):
        k_prop, k_acc = jax.random.split(kk)
        noise.append(np.asarray(jax.random.normal(k_prop, (B, 4))))
        u.append(np.asarray(jax.random.uniform(k_acc, (B,))))

    m = get_antisym_waveflow_model(2, 2, box_size=L, **SMALL, device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    h = construct_hamiltonian_function(m.psi, protons=HE_2D,
                                       n_space_dimensions=2,
                                       laplacian_mode='fwd_batched')
    step = make_train_step(m.psi, h, m.parameters(), lr, grad_clip=10.0)
    moments = adam_state_from_jax(jax.device_get(opt_state),
                                  jax.device_get(jparams),
                                  m.named_parameters())
    for name, p in m.named_parameters():
        step.optimizer.state[p] = moments[name]
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    _, run_window = make_mcmc_train_window(step, m.log_pdf, L,
                                           n_sweeps=n_sweeps,
                                           sort_proposals=False)
    t_losses, _, _, t_m = run_window(
        MetropolisState(*(torch.as_tensor(np.array(f)) for f in mstate)), 1,
        torch.zeros(()), noise=torch.as_tensor(np.stack(noise)[None]),
        u=torch.as_tensor(np.stack(u)[None]))
    assert t_losses[0].item() == pytest.approx(float(losses[0]), rel=1e-4)
    np.testing.assert_allclose(t_m.positions.numpy(),
                               np.asarray(new_m.positions), rtol=1e-6,
                               atol=1e-6)
    ref = params_from_jax(jax.device_get(new_params))
    named = dict(m.named_parameters())
    d_t = torch.cat([(named[k].detach() - before[k]).ravel() for k in ref])
    d_j = torch.cat([(ref[k] - before[k]).ravel() for k in ref])
    assert d_j.norm() > 0
    assert ((d_t - d_j).norm() / d_j.norm()).item() <= 1e-3
    np.testing.assert_allclose(t_m.log_prob.numpy(),
                               np.asarray(new_m.log_prob), rtol=1e-5,
                               atol=1e-5)


def test_committed_run_loads_and_evaluates():
    """results/r5_he2d2e_antisym (default widths, L = 5) into a port trainer:
    the JAX parameters, epoch and (256, 4) walkers; ψ_A at those walkers
    against JAX's (relative 1e-5); a small frozen-parameter evaluation
    (32 walkers, 2 blocks) gives finite energies near the committed
    −1.2607."""
    run = RESULTS / 'r5_he2d2e_antisym'
    t = VMCTrainer(VMCConfig(system_name='He', n_space_dimension=2,
                             box_length=L, ansatz='antisym',
                             sampler='metropolis', device='cpu'))
    assert t.load_checkpoint(str(run))
    with open(run / 'checkpoints', 'rb') as f:
        state = pickle.load(f)
    assert t.epoch == int(state['epoch'])
    assert t.mcmc_state.positions.shape == (256, 4)
    _, jpsi, _, _ = jget_antisym(2, 2, box_size=L, base_spline_degree=6,
                                 i_spline_degree=6, n_prior_internal_knots=23,
                                 n_i_internal_knots=23, i_spline_reg=0.05,
                                 n_flow_layers=3)(jax.random.PRNGKey(0), 4)
    x = t.mcmc_state.positions[:32]
    ref = np.asarray(jax.jit(jpsi)(state['params'], jnp.asarray(x.numpy())))
    with torch.no_grad():
        got = t.model.psi(x).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    ev = evaluate_trainer(t, n_blocks=2, sweeps_per_block=2,
                          n_warmup_sweeps=2, batch_size=32)
    assert np.isfinite([ev.e_mean, ev.e_clipped]).all()
    assert abs(ev.e_clipped + 1.2607) < 0.1


@pytest.mark.parametrize('n_fields', [4, 6])
def test_mcmc_state_from_jax_carries_2d_walkers(n_fields):
    """The committed He-2d (2 electrons) and box3-2d (3 electrons) antisym
    runs' Metropolis walkers: (256, 4) and (256, 6)."""
    run = 'r5_he2d2e_antisym' if n_fields == 4 else 'r5_box3_2d_antisym'
    fields = load_state(RESULTS / run / 'checkpoints')['mcmc_state']
    state = mcmc_state_from_jax(fields, 'cpu')
    assert isinstance(state, MetropolisState)
    assert state.positions.shape == (256, n_fields)
    np.testing.assert_array_equal(state.positions.numpy(),
                                  np.asarray(fields[0], np.float32))


def test_resume_is_bitwise(tmp_path):
    """An antisym Metropolis trainer: 4 windows straight equal 2 windows,
    save, a fresh trainer's load and 2 more, to the bit."""
    straight = VMCTrainer(VMCConfig(system_name='He', **TRAINER_SMALL))
    straight.train(8, verbose=False)
    first = VMCTrainer(VMCConfig(system_name='He', save_dir=str(tmp_path),
                                 **TRAINER_SMALL))
    first.train(4, verbose=False)
    second = VMCTrainer(VMCConfig(system_name='He', save_dir=str(tmp_path),
                                  **TRAINER_SMALL))
    second.train(4, restart=True, verbose=False)
    assert straight.losses == second.losses
    assert np.isfinite(second.losses).all()
    for a, b in zip(straight.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(straight.mcmc_state, second.mcmc_state):
        assert torch.equal(a, b)


class _Replayer:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class EagerGraph(graphs.EpochGraph):
    """``EpochGraph`` on the CPU: the warm-up epoch runs in place, the
    capture records the body without running it, a replay runs it."""

    def _warm_up(self):
        self.body()

    def _capture(self):
        return _Replayer(self.body), (0,) * 5


@pytest.mark.parametrize('system', ['He', 'box3'])
def test_graph_path_is_the_eager_trainer(system, monkeypatch):
    """Three windows of 2 epochs and one single epoch of an antisym
    Metropolis trainer on the graph path (a CPU stand-in whose replay runs
    the captured body) against ``graph=False``: losses, parameters, Adam
    state, generator, walkers and accept rates to the bit."""
    monkeypatch.setattr(graphs, 'EpochGraph', EagerGraph)
    monkeypatch.setattr(graphs, 'use_graph',
                        lambda graph, device: graph is not False)
    kw = dict(TRAINER_SMALL, interactions=system == 'He')
    eager = VMCTrainer(VMCConfig(system_name=system, **kw), graph=False)
    graphed = VMCTrainer(VMCConfig(system_name=system, **kw))
    assert graphed.graph and not eager.graph
    for t in (eager, graphed):
        t.train(7, verbose=False)
    assert eager.losses == graphed.losses and np.isfinite(eager.losses).all()
    assert eager.accept_rates == graphed.accept_rates
    for a, b in zip(eager.model.parameters(), graphed.model.parameters()):
        assert torch.equal(a, b)
    sa = eager.step.optimizer.state_dict()['state']
    sb = graphed.step.optimizer.state_dict()['state']
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    for a, b in zip(eager.mcmc_state, graphed.mcmc_state):
        assert torch.equal(a, b)
    assert torch.equal(eager.generator.get_state(),
                       graphed.generator.get_state())


@pytest.mark.parametrize('system,refresh,expected', [
    ('He', 'auto', None), ('box3', 'auto', None), ('box3', 2, ValueError),
    ('He', None, None)])
def test_refresh_rule(system, refresh, expected):
    """'auto' refreshes nothing under 'antisym', at 3 electrons too; an
    explicit refresh raises ValueError (no exact sampler), as in JAX
    (``trainer.py:708-721``); the sorted 3-electron 2D run keeps 'auto'."""
    t = VMCTrainer(VMCConfig(system_name=system, mcmc_refresh_every=refresh,
                             **TRAINER_SMALL))
    assert t.ansatz == 'antisym'
    if expected is ValueError:
        with pytest.raises(ValueError, match='exact ancestral sampler'):
            t.train(2, verbose=False)
    else:
        assert t._refresh_stride() is expected
    sorted3 = VMCTrainer(VMCConfig(system_name='box3', **dict(
        TRAINER_SMALL, ansatz='sorted')))
    assert (sorted3.xu_coord_type, sorted3._refresh_stride()) == (
        'paired2d', 1)


def test_sample_is_a_permuted_phi_draw():
    """The warm start: φ's draw under the same generator, each walker's
    electrons permuted by one table row; every draw from the generator."""
    m = _models(3)[-1]
    x = m.sample(64, generator=torch.Generator().manual_seed(5))
    again = m.sample(64, generator=torch.Generator().manual_seed(5))
    assert torch.equal(x, again) and x.shape == (64, 6)
    assert (x.abs() <= L).all()
    phi_x = m.phi.sample(64, generator=torch.Generator().manual_seed(5))
    xe, pe = x.reshape(64, 3, 2), phi_x.reshape(64, 3, 2)
    for b in range(64):
        rows = {tuple(r.tolist()) for r in xe[b]}
        assert rows == {tuple(r.tolist()) for r in pe[b]}


def test_fidelity_2d_2e_matches_jax():
    """``fidelity_2d_2e`` of ψ_A against the two-state He-2d ED subspace on
    an 8 × 8 grid, port against JAX, relative 1e-5."""
    jparams, _, _, jpsi, _, m = _models(2)
    _, ed, sites, x = exact_ground_state_2d_2e(HE_2D, L, n_grid=8,
                                               n_states=2)
    got = fidelity.fidelity_2d_2e(m.psi, ed, sites, x, block=600,
                                  device='cpu')
    ref = jfidelity.fidelity_2d_2e(jpsi, jparams, ed, sites, x, block=600)
    assert 0.0 < got < 1.0
    assert got == pytest.approx(ref, rel=1e-5)


def test_antisymmetrize_sort_and_parity_matches_jax():
    """``antisymmetrize`` (sort + parity) of a 'mean'-map ψ of 3 electrons
    in 1D against JAX's, at unsorted points: relative 1e-5; odd under a
    transposition."""
    jparams, jpsi, _, _ = jget_waveflow_model(3, box_size=L, **SMALL)(
        jax.random.PRNGKey(1), 3)
    m = get_waveflow_model(3, box_size=L, **SMALL, device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    x = _box(32, 3, 4)
    ref = np.asarray(jax.jit(jantisymmetrize(jpsi))(jparams, x))
    psi_a = antisymmetrize(m.psi)
    with torch.no_grad():
        got = psi_a(torch.as_tensor(x)).numpy()
        swapped = psi_a(torch.as_tensor(x[:, [1, 0, 2]])).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(swapped, -got, rtol=1e-6, atol=1e-7)
