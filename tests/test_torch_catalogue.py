"""Parity of the port with the JAX package over the system catalogue that
examples/catalogue_sweep_torch.py trains (the 12 1D systems of
benchmarks/catalogue_sweep.py's SWEEP and the 2D one-electron H, He+ and
H2+ of SWEEP_2D), plus box4 and Be, on the CPU at a small size (one flow
layer, degree 3, 6 knots, a 300-point mesh):

  * ψ and log|ψ|², and Hψ ('fwd_batched', each system's protons and
    ``interactions``) of the 1D systems and the 2D He+ and H2+, on the
    same walkers (the model's ancestral draws from numpy uniforms),
    parameters crossed by ``convert.params_from_jax``;
  * K1's plain path at one electron (the only coordinate, and the two of
    a 2D electron) from explicit uniforms against JAX's sampler;
  * one 'clipped_score' + adam step per electron count (H, He_off_center,
    box3) from the same batch;
  * the trainer's resolution of every sweep entry (coordinate map,
    ansatz, ``interactions``, the MCMC refresh rule) against the JAX
    trainer's;
  * the script's row logic (median, stderr, oracle, deviation, gate) on a
    synthetic loss trace against JAX's ``median_energy_estimate`` and
    oracles.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.sparse.linalg import eigsh

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.ops import get_tables as jget_tables
from waveflow_tpu.ops import make_evaluator as jmake_evaluator
from waveflow_tpu.ops.sampling import (
    sample_squared_amplitude as jsample_squared_amplitude)
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu.physics import exact as jexact
from waveflow_tpu.utils import median_energy_estimate as jmedian_estimate
from waveflow_tpu.vmc.estimators import make_loss_fn as jmake_loss_fn
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.ops.sampling import sample_squared_amplitude
from waveflow_tpu_torch.physics import (
    construct_hamiltonian_function, get_potential)
from waveflow_tpu_torch.physics import exact
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, make_train_step

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _sweep_script():
    spec = importlib.util.spec_from_file_location(
        'catalogue_sweep_torch', ROOT / 'examples' / 'catalogue_sweep_torch.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SWEEP = _sweep_script()
SMALL = dict(base_spline_degree=3, i_spline_degree=3,
             n_prior_internal_knots=6, n_i_internal_knots=6,
             i_spline_reg=0.1, n_flow_layers=1, n_spline_base_mesh_points=300)
# the same widths as VMCConfig fields
SMALL_CONFIG = dict(spline_degree=3, num_knots=6, i_spline_reg=0.1,
                    n_flow_layers=1, n_spline_base_mesh_points=300)
B = 16
# (dims, system, box length, interactions): the 1D sweep's, box4 and Be,
# and the 2D He+ and H2+ (the 2D H: tests/test_torch_coords2d.py)
SYSTEMS = ([(1, name, L, extra.get('interactions', True))
            for name, L, extra in SWEEP.SWEEP]
           + [(1, 'box4', 5.0, False), (1, 'Be', 10.0, True)]
           + [(2, name, L, True) for name, L, _ in SWEEP.SWEEP_2D
              if name != 'H'])
SYSTEM_IDS = [f"{name}-{dims}d" for dims, name, _, _ in SYSTEMS]
ENTRIES = ([(1, *entry) for entry in SWEEP.SWEEP]
           + [(2, *entry) for entry in SWEEP.SWEEP_2D])
ENTRY_IDS = [f"{name}-{dims}d" for dims, name, _, _ in ENTRIES]


def _n_el(dims, name):
    return int(system_catalogue[dims][name][1])


_MODELS: dict = {}


def model_pair(dims: int, n_el: int, box_length: float):
    """(JAX params, jitted ψ, jitted log|ψ|², JAX psi, port model) of the
    Waveflow a system of ``n_el`` electrons in ``dims`` dimensions trains
    ('mean' map in 1D, 'independent' for one electron in 2D, as both
    trainers resolve them); one per shape, shared by the systems on it."""
    key = (dims, n_el, box_length)
    if key not in _MODELS:
        D = dims * n_el
        xu = 'mean' if dims == 1 else 'independent'
        jparams, jpsi, jlog_pdf, _ = jget_waveflow_model(
            D, box_size=box_length, xu_coord_type=xu, **SMALL)(
                jax.random.PRNGKey(7 + D), D)
        m = get_waveflow_model(D, box_size=box_length, xu_coord_type=xu,
                               **SMALL, generator=torch.Generator().manual_seed(0),
                               device='cpu')
        m.load_state_dict(params_from_jax(jax.device_get(jparams)))
        _MODELS[key] = (jparams, jax.jit(jpsi), jax.jit(jlog_pdf), jpsi, m)
    return _MODELS[key]


def walkers(dims: int, n_el: int, box_length: float, n: int = B,
            seed: int = 0) -> np.ndarray:
    """Walkers from |ψ|² of the system's model: its ancestral sampler fed
    numpy uniforms (one row per coordinate)."""
    m = model_pair(dims, n_el, box_length)[-1]
    u = np.random.default_rng(seed).uniform(0.0, 1.0, (dims * n_el, n))
    return m.sample(n, u=torch.as_tensor(u, dtype=torch.float32)).numpy()


_JAX_EVALS: dict = {}
_JAX_FNS: dict = {}


def jax_eval(dims: int, name: str, L: float, interactions: bool):
    """(walkers, JAX ψ, log|ψ|², Hψ ('fwd_batched') on them) of a system.
    ψ, log|ψ|² and Hψ are one jitted function per model, proton count and
    ``interactions``, the protons a traced argument: systems that differ
    in their protons' places alone share its compile."""
    key = (dims, name)
    if key not in _JAX_EVALS:
        n = _n_el(dims, name)
        protons = np.asarray(system_catalogue[dims][name][0], np.float32)
        jparams, _, _, jpsi, _ = model_pair(dims, n, L)
        fn_key = (dims, n, L, protons.shape, interactions)
        if fn_key not in _JAX_FNS:
            def evaluate(params, x, protons):
                jh = jconstruct_h(jpsi, protons=protons,
                                  n_space_dimensions=dims,
                                  laplacian_mode='fwd_batched',
                                  interactions=interactions)
                return jpsi(params, x), model_pair(dims, n, L)[2](
                    params, x), jh(params, x)
            _JAX_FNS[fn_key] = jax.jit(evaluate)
        x = walkers(dims, n, L)
        _JAX_EVALS[key] = (x, *(np.asarray(v) for v in _JAX_FNS[fn_key](
            jparams, x, protons)))
    return _JAX_EVALS[key]


@pytest.mark.parametrize('dims,name,L,interactions', SYSTEMS, ids=SYSTEM_IDS)
def test_psi_and_log_pdf(dims, name, L, interactions):
    """ψ and log|ψ|² of the port against JAX's with the same parameters
    and walkers: each within 1e-5 relative, with 1e-5 of the batch's
    largest magnitude as the floor near nodes."""
    m = model_pair(dims, _n_el(dims, name), L)[-1]
    x, want_psi, want_log, _ = jax_eval(dims, name, L, interactions)
    with torch.no_grad():
        got_psi = m.psi(torch.as_tensor(x)).numpy()
        got_log = m.log_pdf(torch.as_tensor(x)).numpy()
    for got, want in ((got_psi, want_psi), (got_log, want_log)):
        assert got.shape == want.shape == (B,)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('dims,name,L,interactions', SYSTEMS, ids=SYSTEM_IDS)
def test_h_matches_jax(dims, name, L, interactions):
    """Hψ ('fwd_batched') with the system's protons — none for the boxes
    and the interacting pair, shape (0,) — and ``interactions`` against
    JAX's ``h_fn``: max error 1e-5 of max|Hψ|, as
    tests/test_torch_hamiltonian.py."""
    protons = system_catalogue[dims][name][0]
    m = model_pair(dims, _n_el(dims, name), L)[-1]
    x, _, _, want = jax_eval(dims, name, L, interactions)
    h = construct_hamiltonian_function(m.psi, protons=protons,
                                       n_space_dimensions=dims,
                                       laplacian_mode='fwd_batched',
                                       interactions=interactions)
    with torch.no_grad():
        got = h(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (B, 1)
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# the one-electron models: 1D at L = 10 (H, He+, H2+) and 12 (H2+_wide),
# 2D at L = 5
ONE_ELECTRON = [(1, 10.0), (1, 12.0), (2, 5.0)]


@pytest.mark.parametrize('dims,L', ONE_ELECTRON,
                         ids=[f"{d}d-L{L:g}" for d, L in ONE_ELECTRON])
def test_k1_plain_path_at_one_electron(dims, L):
    """K1's plain path (``sample_squared_amplitude`` on a CPU tensor) at one
    electron: each column's OB coefficients from the port's model, 256
    explicit uniforms (the tails included), against JAX's sampler on the
    same coefficients and uniforms: within 1e-5 in x, and where u lies
    within 1e-4 of 1 (K1's and its plain path's right tail, ROADMAP) within
    1e-5 in probability, the float64 CDF of each draw against u."""
    jparams, _, _, _, m = model_pair(dims, 1, L)
    D = dims
    rng = np.random.default_rng(3)
    u = rng.uniform(0.0, 1.0, (D, 256)).astype(np.float32)
    u[:, :6] = np.array([0.0, 1e-7, 1e-4, 1 - 1e-4, 1 - 1e-6, 1 - 1e-7],
                        dtype=np.float32)
    tabs = jget_tables('B', SMALL['base_spline_degree'],
                       SMALL['n_prior_internal_knots'],
                       n_mesh=SMALL['n_spline_base_mesh_points'])
    jev = jmake_evaluator(tabs, use_ob=True)
    outputs = torch.zeros((256, D))
    table = m.ev_ob.table_t.double()
    for col in range(D):
        with torch.no_grad():
            c = m.ob_coeffs(outputs)[:, col]
        got = sample_squared_amplitude(m.ev_ob, c, torch.as_tensor(u[col]))
        want = np.asarray(jsample_squared_amplitude(
            jev, jnp.asarray(c.numpy()), jnp.asarray(u[col])))
        got = got.numpy()
        tail = u[col] > 1 - 1e-4
        np.testing.assert_allclose(got[~tail], want[~tail], atol=1e-5)
        for x in (got[tail], want[tail]):
            err = _cdf_err(table, c[tail].double(), x, u[col][tail])
            assert err.max() <= 1e-5
        outputs[:, col] = torch.as_tensor(got)


def _cdf_err(table_t, c, x, u):
    """|F(x) − u| in float64 for draws x of (c · T)², T piecewise linear on
    the mesh (chip_smoke.quantile_err's 'squared' form)."""
    psi = c @ table_t
    n_cells = psi.shape[-1] - 1
    h = 1.0 / n_cells
    p_l, d = psi[..., :-1], psi[..., 1:] - psi[..., :-1]
    m = h * (p_l * p_l + p_l * d + d * d / 3.0)
    cdf = torch.cat([torch.zeros_like(m[..., :1]), torch.cumsum(m, -1)], -1)
    xd = torch.as_tensor(x).double()
    j = torch.clamp(torch.floor(xd / h).long(), 0, n_cells - 1)
    s = xd / h - j

    def at(a):
        return torch.gather(a, -1, j[..., None])[..., 0]

    a, dd = at(p_l), at(d)
    in_cell = h * (a * a * s + a * dd * s * s + dd * dd * s ** 3 / 3.0)
    return ((at(cdf) + in_cell) / cdf[..., -1]
            - torch.as_tensor(u).double()).abs().numpy()


STEP_SYSTEMS = [entry for entry in ENTRIES
                if entry[0] == 1 and entry[1] in ('H', 'He_off_center', 'box3')]


@pytest.mark.parametrize('dims,name,L,extra', STEP_SYSTEMS,
                         ids=[e[1] for e in STEP_SYSTEMS])
def test_train_step_matches_jax(dims, name, L, extra):
    """One 'clipped_score' + global-norm clip + adam step at the sweep's
    learning rate, one system per electron count, from the same 64
    walkers, with tests/test_torch_vmc.py's tolerances: loss rtol 1e-4;
    the clipped gradient as one vector within 2e-3 relative L2; updated
    parameters rtol 1e-4 where |g| is above float noise, and |Δ| <= 2 lr
    everywhere (Adam's first step is sign-like)."""
    n = _n_el(dims, name)
    protons = system_catalogue[dims][name][0]
    interactions = extra.get('interactions', True)
    lr = extra.get('learning_rate', VMCConfig.learning_rate)
    jparams, _, _, jpsi, m = model_pair(dims, n, L)
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=dims,
                      laplacian_mode='fwd_batched', interactions=interactions)
    batch = walkers(dims, n, L, n=64, seed=2)
    opt = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0),
                                    optax.adam(lr)))
    loss, jgrads = jax.jit(jax.value_and_grad(jmake_loss_fn(jpsi, jh)))(
        jparams, batch, jnp.zeros(()))
    updates, _ = opt.update(jgrads, opt.init(jparams), jparams)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
    jgrads, _ = optax.clip_by_global_norm(10.0).update(jgrads, None)

    m = get_waveflow_model(dims * n, box_size=L, **SMALL,
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    h = construct_hamiltonian_function(m.psi, protons=protons,
                                       n_space_dimensions=dims,
                                       laplacian_mode='fwd_batched',
                                       interactions=interactions)
    step = make_train_step(m.psi, h, m.parameters(), lr, grad_clip=10.0)
    t_loss = step(torch.as_tensor(batch), torch.zeros(()))
    assert np.isfinite(float(loss))
    assert t_loss.item() == pytest.approx(float(loss), rel=1e-4)

    ref_g = params_from_jax(jax.device_get(jgrads))
    ref_p = params_from_jax(jax.device_get(new_params))
    g_max = max(v.abs().max().item() for v in ref_g.values())
    named = dict(m.named_parameters())
    g_t = torch.cat([torch.zeros_like(named[k]).ravel() if named[k].grad is None
                     else named[k].grad.ravel() for k in ref_g])
    g_j = torch.cat([v.ravel() for v in ref_g.values()])
    assert ((g_t - g_j).norm() / g_j.norm()).item() <= 2e-3
    for k in ref_p:
        defined = (ref_g[k].abs() > 1e-5 * g_max).numpy()
        got, want = named[k].detach().numpy(), ref_p[k].numpy()
        np.testing.assert_allclose(got[defined], want[defined], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
        assert np.abs(got - want).max() <= 2 * lr + 1e-7, k


def _jax_refresh_stride(jt, window: int):
    """The JAX trainer's walker refresh stride for MCMC walkers under
    mcmc_refresh_every='auto' (waveflow_tpu/vmc/trainer.py:706-722), from
    the fields its constructor resolved: one window for >= 3 electrons
    under the sorted ansatz, none otherwise."""
    every = (window if jt.ansatz == 'sorted' and int(jt.n_particle) >= 3
             else None)
    return max(1, round(every / window)) if every else None


@pytest.mark.parametrize('dims,name,L,extra', ENTRIES, ids=ENTRY_IDS)
def test_config_resolution_matches_jax(dims, name, L, extra, tmp_path):
    """Each sweep entry's config resolved by the port's trainer as by the
    JAX trainer (built, never run: nothing is compiled): the coordinate map
    ('mean' in 1D, 'independent' for the 2D electron), the ansatz, the
    model's width and ``interactions`` (the potential of the trainers'
    protons on the same walkers); the walker refresh, none for the sweep's
    ancestral walkers and under MCMC walkers the 'auto' rule's stride."""
    from waveflow_tpu.vmc import VMCConfig as JVMCConfig
    from waveflow_tpu.vmc import VMCTrainer as JVMCTrainer
    from waveflow_tpu.physics import get_potential as jget_potential
    common = dict(system_name=name, n_space_dimension=dims, box_length=L,
                  batch_size=8, **SMALL_CONFIG, **extra)
    jt = JVMCTrainer(JVMCConfig(save_dir=str(tmp_path),
                                compilation_cache_dir=None, **common))
    t = VMCTrainer(VMCConfig(device='cpu', **common))
    assert (t.xu_coord_type, t.ansatz, t.input_dim) == (
        jt.xu_coord_type, jt.ansatz, jt.input_dim)
    assert t.xu_coord_type == ('mean' if dims == 1 else 'independent')
    assert t._refresh_stride() is None
    mcmc = VMCTrainer(VMCConfig(device='cpu', sampler='metropolis', **common))
    assert mcmc._refresh_stride() == _jax_refresh_stride(jt, mcmc.config.window)
    assert t.config.interactions == jt.config.interactions == extra.get(
        'interactions', True)
    x = walkers(dims, _n_el(dims, name), L)
    want = np.asarray(jget_potential(
        jt.protons, n_space_dimensions=dims,
        interactions=jt.config.interactions)(x))
    got = get_potential(t.protons, n_space_dimensions=dims,
                        interactions=t.config.interactions)(
                            torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# small grids for the row test's oracles: the Richardson pair (its second
# also the single grid) per electron count, and the 2D grid
ROW_GRIDS = {(1, 1): (200, 300), (1, 2): (20, 28), (1, 3): (12, 14),
             (2, 1): (16, 20)}


@pytest.mark.parametrize('dims,name,L,extra', ENTRIES, ids=ENTRY_IDS)
def test_row_logic_matches_jax(dims, name, L, extra, monkeypatch):
    """The script's row (``make_row``) on a synthetic 40,000-epoch loss
    trace: the tail median and its blocked stderr equal JAX's
    ``median_energy_estimate`` (tail fraction 0.2); the oracle is JAX's
    Richardson ED for the interacting 1D systems (the single-grid ED
    beside it), the analytic free-fermion sum for the interactions=False
    boxes and the 2D grid ED for 2D — each equal to the JAX function's
    figure on the same small grids, ARPACK started from one vector in
    both; the deviation is median − exact; the gate is
    [−3 stderr, max(3 dev_jax, dev_jax + 3e-3)] with the JAX run's
    deviation from results/catalogue_sweep*_r5.json."""
    def fixed_start(H, **kw):
        return eigsh(H, v0=np.ones(H.shape[0]), **kw)

    for module in (exact, jexact):
        monkeypatch.setattr(module, 'eigsh', fixed_start)
    protons, n = system_catalogue[dims][name]
    n = int(n)
    grids = ROW_GRIDS[(dims, n)]
    rng = np.random.default_rng(n)
    t = np.arange(40_000)
    base = -1.0 + 0.3 * np.exp(-t / 4000.0)
    losses = (base + 0.02 * rng.standard_normal(t.size)
              + 0.5 * (rng.uniform(size=t.size) < 1e-3)).astype(np.float32)
    dev_jax = SWEEP.jax_deviations(dims)[name]
    row = SWEEP.make_row(name, dims, L,
                         losses, SWEEP.oracle(dims, name, L, extra, grids),
                         dev_jax)
    median, stderr = jmedian_estimate(losses, tail_fraction=0.2)
    interactions = extra.get('interactions', True)
    if dims == 2:
        want = jexact.exact_ground_state_2d_1e(protons, L, n_grid=grids[1])[0]
        oracle, single = '2D grid ED', None
    elif not interactions:
        want = jexact.exact_free_fermion_energy(n, L)
        oracle, single = 'analytic free-fermion', None
    else:
        want = jexact.richardson_ground_energy_1d(protons, n, L,
                                                  n_grids=grids)
        oracle = 'richardson grid ED'
        single = jexact.exact_ground_state_1d(protons, n, L, n_grid=grids[1])
    assert (row['system'], row['dims'], row['n_el']) == (name, dims, n)
    assert row['vmc_median'] == median and row['stderr'] == stderr
    assert 0 < stderr < 1e-2
    assert row['oracle'] == oracle and row['exact'] == want
    assert row['deviation'] == median - want
    assert row.get('exact_single_grid') == single
    lo, hi = -3 * stderr, max(3 * dev_jax, dev_jax + 3e-3)
    assert row['gate'] == [lo, hi] and row['deviation_jax'] == dev_jax
    assert row['in_gate'] == (lo <= median - want <= hi)
