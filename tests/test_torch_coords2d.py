"""Two space dimensions and every coordinate map in the port, against the
JAX package on the CPU.

The box maps ('mean', 'first', 'independent', 'paired2d'): forward,
inverse and log-det; the factory's constrained dimensions per map; ψ and
log_pdf of a 'paired2d' He-2d model and an 'independent' 2D model with the
same parameters (carried by ``convert.py``); a Hψ pass under
'fwd_batched'; the trainer's resolution of ansatz and coordinate map and
its MCMC sector mode; one Metropolis adam epoch of the 'paired2d' model
from the same walkers and draws; the four fidelity functions on small ED
grids.  Small widths: 1 flow layer, 7 knots, a 200-point mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waveflow_tpu.bijections import BoxTransformLayer
from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, exact_ground_state_2d_1e,
    exact_ground_state_2d_2e, exact_ground_state_2p, exact_ground_state_3p,
    system_catalogue)
from waveflow_tpu.utils import fidelity as jfidelity
from waveflow_tpu.vmc import VMCConfig as JVMCConfig
from waveflow_tpu.vmc import VMCTrainer as JVMCTrainer
from waveflow_tpu.vmc import metropolis as jmetropolis
from waveflow_tpu_torch.bijections import BoxTransform
from waveflow_tpu_torch.convert import adam_state_from_jax, params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.models.factory import constrained_dims
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.utils import fidelity
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, make_train_step
from waveflow_tpu_torch.vmc import trainer as trainer_module
from waveflow_tpu_torch.vmc.metropolis import (
    MetropolisState, make_mcmc_train_window, sector_mode)
from waveflow_tpu_torch.vmc.trainer import resolve_ansatz

torch.set_num_threads(2)

L = 5.0
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=7, n_i_internal_knots=7, i_spline_reg=0.1,
             n_flow_layers=1, box_size=L, n_spline_base_mesh_points=200)
TRAINER_SMALL = dict(box_length=L, batch_size=8, window=2, num_knots=7,
                     spline_degree=4, n_flow_layers=1,
                     n_spline_base_mesh_points=200)
HE_2D = system_catalogue[2]['He'][0]


def _box(B, D, seed, sort=None):
    """Box points in [-0.9 L, 0.9 L]; ``sort`` 'x' orders 2D electrons by
    x, '1d' sorts the coordinates."""
    x = np.random.default_rng(seed).uniform(-0.9 * L, 0.9 * L, (B, D))
    if sort == '1d':
        x = np.sort(x, axis=1)
    elif sort == 'x':
        xe = x.reshape(B, -1, 2)
        x = np.take_along_axis(xe, np.argsort(xe[:, :, 0], axis=1)[:, :, None],
                               axis=1).reshape(B, D)
    return x.astype(np.float32)


_MODELS = {}


def _models(D, xu):
    """(JAX params, jitted JAX psi, jitted log_pdf, JAX psi, port model)
    with the same parameters, built once per (D, map)."""
    if (D, xu) not in _MODELS:
        jparams, jpsi, jlog_pdf, _ = jget_waveflow_model(
            D, xu_coord_type=xu, **SMALL)(jax.random.PRNGKey(3), D)
        m = get_waveflow_model(D, xu_coord_type=xu, **SMALL,
                               generator=torch.Generator().manual_seed(0),
                               device='cpu')
        m.load_state_dict(params_from_jax(jax.device_get(jparams)))
        _MODELS[D, xu] = (jparams, jax.jit(jpsi), jax.jit(jlog_pdf), jpsi, m)
    return _MODELS[D, xu]


@pytest.mark.parametrize('xu,D,sort', [
    ('mean', 3, '1d'), ('first', 3, '1d'), ('independent', 4, None),
    ('paired2d', 4, 'x'), ('paired2d', 6, 'x')])
def test_box_maps_match_jax(xu, D, sort):
    """Forward (u and log-det) and inverse of each map against JAX's
    ``BoxTransformLayer``, relative 1e-6; the inverse closes the round
    trip; the inverse's log-det is zero."""
    _, direct, inverse = BoxTransformLayer(L, xu_coord_type=xu)(None, D)
    x = _box(64, D, 1, sort)
    u_j, ld_j = direct((), jnp.asarray(x))
    x_j, _ = inverse((), u_j)
    bt = BoxTransform(L, xu_coord_type=xu)
    u_t, ld_t = bt(torch.as_tensor(x))
    x_t, ld_inv = bt.inverse(torch.as_tensor(np.asarray(u_j)))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=1e-6)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-6,
                               atol=2e-6)
    np.testing.assert_allclose(x_t.numpy(), x, atol=2e-5)
    assert ld_inv.shape == (64,) and not ld_inv.any()


def test_box_map_unknown_name_raises():
    """JAX falls back to 'first' for any other name; the port refuses."""
    with pytest.raises(ValueError, match="xu_coord_type"):
        BoxTransform(L, xu_coord_type='sorted')


@pytest.mark.parametrize('xu,D,expected', [
    ('mean', 3, [0, 1]), ('first', 3, [1, 2]), ('independent', 4, []),
    ('paired2d', 4, [0]), ('paired2d', 6, [0, 1])])
def test_constrained_dims_per_map(xu, D, expected):
    """The dimensions that carry the left-edge zero boundary, as JAX's
    factory sets them (``factory.py:57-69``), in the index list and in the
    model's mask."""
    assert list(constrained_dims(D, xu)) == expected
    m = get_waveflow_model(D, xu_coord_type=xu, **SMALL, device='cpu')
    assert m.constrained.nonzero().ravel().tolist() == expected


@pytest.mark.parametrize('xu,D,sort', [('paired2d', 4, 'x'),
                                       ('independent', 4, None),
                                       ('independent', 2, None)])
def test_psi_and_log_pdf_match_jax(xu, D, sort):
    """ψ and log|ψ|² of the same parameters at 64 box points, relative
    1e-5 (to 1e-5 of max|ψ| for ψ)."""
    jparams, jpsi, jlog_pdf, _, m = _models(D, xu)
    x = _box(64, D, 2, sort)
    with torch.no_grad():
        psi_t = m.psi(torch.as_tensor(x)).numpy()
        lp_t = m.log_pdf(torch.as_tensor(x)).numpy()
    psi_j = np.asarray(jpsi(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(psi_t, psi_j, rtol=1e-5,
                               atol=1e-5 * np.abs(psi_j).max())
    np.testing.assert_allclose(lp_t, np.asarray(jlog_pdf(jparams, x)),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(psi_j).max() > 0


def test_h_psi_fwd_batched_matches_jax():
    """Hψ of the 'paired2d' He-2d model under 'fwd_batched' (nested jvps over
    4 coordinates, the 2D soft-Coulomb potential) within 4e-4 of
    max|Hψ|."""
    jparams, _, _, jpsi, m = _models(4, 'paired2d')
    x = _box(32, 4, 3, 'x')
    jh = jax.jit(jconstruct_h(jpsi, protons=HE_2D, n_space_dimensions=2,
                              laplacian_mode='fwd_batched'))
    h = construct_hamiltonian_function(m.psi, protons=HE_2D,
                                       n_space_dimensions=2,
                                       laplacian_mode='fwd_batched')
    ref = np.asarray(jh(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = h(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape == (32, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=4e-4 * np.abs(ref).max())


@pytest.mark.parametrize('system,dim,extra', [
    ('He', 2, dict(sampler='metropolis')),
    ('H', 2, dict()),
    ('He', 1, dict(xu_coord_type='first')),
    ('He', 2, dict(ansatz='antisym', sampler='metropolis')),
    ('box3', 2, dict(ansatz='antisym', sampler='mala')),
    ('H', 2, dict(ansatz='antisym')),
    ('He', 2, dict(ansatz='antisym'))])
def test_resolution_matches_jax(system, dim, extra):
    """The resolved ansatz and coordinate map of the JAX trainer, case by
    case (antisym -> 'independent'; 2D with several electrons ->
    'paired2d'; one electron -> 'independent'; 1D keeps the configured
    map; antisym with one electron stays 'sorted'); antisym with ancestral
    walkers raises ValueError in both."""
    kw = dict(system_name=system, n_space_dimension=dim, **TRAINER_SMALL,
              **extra)
    try:
        jt = JVMCTrainer(JVMCConfig(compilation_cache_dir=None, **kw))
    except ValueError as e:
        with pytest.raises(ValueError, match='ancestral'):
            VMCTrainer(VMCConfig(device='cpu', **kw))
        assert 'ancestral' in str(e)
        return
    t = VMCTrainer(VMCConfig(device='cpu', **kw))
    assert (t.ansatz, t.xu_coord_type) == (jt.ansatz, jt.xu_coord_type)
    assert t.model.input_dim == jt.input_dim
    n = int(t.n_particle)
    assert resolve_ansatz(t.config, n) == (t.ansatz, t.xu_coord_type)


@pytest.mark.parametrize('sampler', ['metropolis', 'mala'])
def test_mcmc_sector_mode_is_paired2d(sampler, monkeypatch):
    """A 'paired2d' trainer hands the MCMC windows the 'paired2d' sector
    projection (not the 1D coordinate sort), an 'independent' one none, a
    1D one the sort — as JAX does (``trainer.py:390-391``)."""
    seen = {}
    name = ('make_mala_train_window' if sampler == 'mala'
            else 'make_mcmc_train_window')
    real = getattr(trainer_module, name)

    def spy(*a, **kw):
        seen['mode'] = kw.get('sort_fermions', kw.get('sort_proposals'))
        return real(*a, **kw)
    monkeypatch.setattr(trainer_module, name, spy)
    t = VMCTrainer(VMCConfig(system_name='He', n_space_dimension=2,
                             sampler=sampler, device='cpu', **TRAINER_SMALL))
    assert t.xu_coord_type == 'paired2d' and seen['mode'] == 'paired2d'
    assert (sector_mode('paired2d'), sector_mode('independent'),
            sector_mode('mean')) == ('paired2d', False, True)


def test_paired2d_trainer_trains_and_refreshes_nothing():
    """He-2d (2 electrons) on the 'paired2d' map with Metropolis walkers: two
    windows, finite losses, walkers of 4 coordinates in the x-sorted
    sector; the 'auto' refresh stays off below 3 electrons."""
    t = VMCTrainer(VMCConfig(system_name='He', n_space_dimension=2,
                             sampler='metropolis', device='cpu',
                             **TRAINER_SMALL))
    assert t._refresh_stride() is None
    losses = t.train(4, verbose=False)
    assert len(losses) == 4 and np.isfinite(losses).all()
    pos = t.mcmc_state.positions.reshape(8, 2, 2)
    assert t.mcmc_state.positions.shape == (8, 4)
    assert (pos[:, 0, 0] <= pos[:, 1, 0]).all()


def warm_adam_state(opt_state, jparams, seed=4):
    """An optax ``flatten(chain(clip, adam))`` state with random moments at
    count 50 (Adam's first step is sign-like, so parity of an update holds
    only away from it); the moments of the parameters off the path (the
    zero_params) stay zero, as in every JAX checkpoint."""
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
    """One epoch of the Metropolis adam window on the 'paired2d' He-2d model
    (2 sweeps with the 'paired2d' projection, one clipped-score + clip +
    adam update, the log_prob refresh) from the same walkers, parameters
    and Adam moments with JAX's draws: loss rtol 1e-4, walkers 1e-6, the
    update as one vector to 1e-3, log_prob 1e-5."""
    jparams, _, _, jpsi, m = _models(4, 'paired2d')
    jlog_pdf = jget_waveflow_model(4, xu_coord_type='paired2d', **SMALL)(
        jax.random.PRNGKey(3), 4)[2]
    B, n_sweeps, lr = 32, 2, 1e-3
    jh = jconstruct_h(jpsi, protons=HE_2D, n_space_dimensions=2,
                      laplacian_mode='fwd_batched')
    opt = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0),
                                    optax.adam(lr)))
    opt_state = warm_adam_state(opt.init(jparams), jparams)
    jinit, jwindow = jmetropolis.make_mcmc_train_window(
        jpsi, jh, jlog_pdf, opt, 1, L, n_sweeps=n_sweeps,
        sort_proposals='paired2d')
    mstate = jinit(jparams, jnp.asarray(_box(B, 4, 6, 'x')), step_size=0.5)
    key = jax.random.PRNGKey(8)
    new_params, _, _, _, losses, new_m = jax.jit(jwindow)(
        jparams, opt_state, key, jnp.zeros(()), mstate)
    _, k = jax.random.split(key)
    noise, u = [], []
    for kk in jax.random.split(k, n_sweeps):
        k_prop, k_acc = jax.random.split(kk)
        noise.append(np.asarray(jax.random.normal(k_prop, (B, 4))))
        u.append(np.asarray(jax.random.uniform(k_acc, (B,))))

    m = get_waveflow_model(4, xu_coord_type='paired2d', **SMALL, device='cpu')
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
                                           sort_proposals='paired2d')
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


@pytest.mark.parametrize('kind', ['2p', '3p', '2d_1e', '2d_2e', '2d_2e_sub'])
def test_fidelity_matches_jax(kind):
    """Each fidelity function of the port against JAX's on a small ED grid,
    the same parameters, relative 1e-5; both lie in (0, 1)."""
    if kind == '2p':
        _, ed, x = exact_ground_state_2p([[0.0], [0.0]], L, n_grid=24)
        jparams, _, _, jpsi, m = _models(2, 'mean')
        args, fn, jfn = (ed, x), fidelity.fidelity_2p, jfidelity.fidelity_2p
    elif kind == '3p':
        _, ed, x = exact_ground_state_3p([[0.0]] * 3, L, n_grid=14)
        jparams, _, _, jpsi, m = _models(3, 'mean')
        args, fn, jfn = (ed, x), fidelity.fidelity_3p, jfidelity.fidelity_3p
    elif kind == '2d_1e':
        _, ed, x = exact_ground_state_2d_1e([[0.0, 0.0]], L, n_grid=24)
        jparams, _, _, jpsi, m = _models(2, 'independent')
        args, fn = (ed, x), fidelity.fidelity_2d_1e
        jfn = jfidelity.fidelity_2d_1e
    else:
        _, ed, sites, x = exact_ground_state_2d_2e(HE_2D, L, n_grid=8,
                                                   n_states=2)
        ed = ed if kind == '2d_2e_sub' else ed[:, 0]
        jparams, _, _, jpsi, m = _models(4, 'paired2d')
        args, fn = (ed, sites, x), fidelity.fidelity_2d_2e
        jfn = jfidelity.fidelity_2d_2e
    got = fn(m.psi, *args, block=300, device='cpu')
    ref = jfn(jpsi, jparams, *args, block=300)
    assert 0.0 < got < 1.0
    assert got == pytest.approx(ref, rel=1e-5)
