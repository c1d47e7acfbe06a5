"""Parity of the port's table eval backend with the JAX package, on the CPU.

``SplineEvaluator.__call__`` and ``pair`` at every order with their
derivative chains (values, jvps, nested jvps, the two top-order
truncations, the lerp-slope rule of the coefficient tangents, vmap), the
inverse methods, and the 'table' Waveflow: ψ and log_pdf, Hψ under every
Laplacian form, one adam step and the 'reference' gradient, the flagship
100k checkpoint, the antisymmetrized Waveflow; the trainer under 'table'
with every Laplacian form, sampler, estimator and optimizer, and both VMC
entry scripts; and the float64 run behind chip_smoke.py's table-hpsi
bounds.  The same parameters cross by
``convert.py``; inputs are made with numpy from a seed."""

import contextlib
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.ops import get_tables as jget_tables
from waveflow_tpu.ops import make_evaluator as jmake_evaluator
from waveflow_tpu.ops.inverse import (
    batched_monotone_inverse as jmonotone_inverse,
    bisection_inverse as jbisection_inverse)
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu.vmc import estimators as jest
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.ops import (
    batched_monotone_inverse, bisection_inverse, get_tables, make_evaluator)
from waveflow_tpu_torch.ops.cuda_spline import lerp_basis, spline_eval_plain
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.vmc import (VMCConfig, VMCTrainer, make_loss_fn,
                                    make_train_step)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / 'results' / 'r5_flagship_fwd_batched_100k' / 'checkpoints'
PROTONS = system_catalogue[1]['He'][0]
# JAX's test_waveflow_poly_vs_table_backends: 2 layers, degree 4, 10 knots
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=10, n_i_internal_knots=10,
             i_spline_reg=0.1, n_flow_layers=2, box_size=10.0,
             n_spline_base_mesh_points=400)
FLAGSHIP = dict(base_spline_degree=6, i_spline_degree=6,
                n_prior_internal_knots=23, n_i_internal_knots=23,
                i_spline_reg=0.05, n_flow_layers=3, box_size=10.0)
FORMS = [('fwd_batched', 0.0), ('fwd', 0.0), ('hvp', 0.0), ('dense', 0.0),
         ('fwd', 0.1)]
N = 96


def _rel(got, want) -> float:
    """max|got − want| over max|want| (0 where both are zero, as a
    truncated order is)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 0.0 if err == 0 else float(err / np.abs(want).max())


@pytest.fixture(scope='module')
def evaluators():
    """The flagship's orthonormal-B tables (degree 6, 23 knots, 2000-point
    mesh) in both packages, and coefficients c(x) = c0 + W·x that depend
    on x, with x partly outside [0, 1] (the linear edge extension)."""
    ev = make_evaluator(get_tables('B', 6, 23, n_mesh=2000), use_ob=True,
                        device='cpu')
    jev = jmake_evaluator(jget_tables('B', 6, 23, n_mesh=2000), use_ob=True)
    rng = np.random.default_rng(0)
    c0 = rng.normal(size=(N, ev.n_bases)).astype(np.float32)
    W = (0.5 * rng.normal(size=(N, ev.n_bases))).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, size=N).astype(np.float32)
    return ev, jev, c0, W, x


def _jets(f, x, n, jvp, ones):
    """[f, f', ..., f^(n)] along x by nested forward mode."""
    out = [f]
    for _ in range(n):
        prev = out[-1]
        out.append(lambda xx, prev=prev: jvp(prev, (xx,), (ones,))[1])
    return [g(x) for g in out]


def _both(ev, jev, c0, W, x, fn, jfn, order):
    """x ↦ fn(c0 + W x, x) and its x-derivatives up to ``order`` in both
    packages: [(port, jax) per order]."""
    ct, Wt, xt = map(torch.as_tensor, (c0, W, x))

    def f(xx):
        return fn(ev, ct + Wt * xx[:, None], xx)

    def jf(xx):
        return jfn(jev, jnp.asarray(c0) + jnp.asarray(W) * xx[:, None], xx)

    got = _jets(f, xt, order, torch.func.jvp, torch.ones(N))
    want = _jets(jf, jnp.asarray(x), order, jax.jvp, jnp.ones(N))
    return [(g.detach().numpy(), np.asarray(w)) for g, w in zip(got, want)]


@pytest.mark.parametrize('d', [0, 1, 2, 3])
def test_call_chain_matches_jax(evaluators, d):
    """``ev(c(x), x, d)``, its first and second x-derivatives with c
    depending on x (each a jvp in both c and x), against JAX: value and
    both derivatives within 2e-6 of their max.  At d = 3 the x-term of the
    first tangent is truncated (order 4 is not tabulated), as in JAX."""
    ev, jev, c0, W, x = evaluators
    for got, want in _both(ev, jev, c0, W, x,
                           lambda e, c, xx: e(c, xx, d),
                           lambda e, c, xx: e(c, xx, d), 2):
        assert _rel(got, want) <= 2e-6


@pytest.mark.parametrize('d', [0, 1, 2])
def test_pair_chain_matches_jax(evaluators, d):
    """``ev.pair(c(x), x, d)`` (value and derivative) and its first three
    x-derivatives against JAX's pair chain, within 2e-6 of their max; at
    d = 2 the value still chains through the plain order-3 lerp and the
    derivative's x-term is dropped."""
    ev, jev, c0, W, x = evaluators
    for k in range(2):
        for got, want in _both(ev, jev, c0, W, x,
                               lambda e, c, xx: e.pair(c, xx, d)[k],
                               lambda e, c, xx: e.pair(c, xx, d)[k], 3):
            assert _rel(got, want) <= 2e-6


@pytest.mark.parametrize('d', [0, 1, 2])
def test_coefficient_tangents_take_the_lerp_slope(evaluators, d):
    """The second x-derivative of ev(c(x), x, d) with c' = W: JAX gives
    the W-term's x-derivative as the plain lerp's slope n_cells·ΔT_d,
    not the order-(d+1) table.  The port matches JAX within 2e-6 of its
    max, while the order-(d+1) rule (built here from the tables) misses
    by more than 1e-3 of it on the flagship tables."""
    ev, jev, c0, W, x = evaluators
    got, want = _both(ev, jev, c0, W, x, lambda e, c, xx: e(c, xx, d),
                      lambda e, c, xx: e(c, xx, d), 2)[2]
    assert _rel(got, want) <= 2e-6
    xt, Wt = torch.as_tensor(x), torch.as_tensor(W)
    ct = torch.as_tensor(c0) + Wt * xt[:, None]
    n_cells = ev.n_mesh - 1
    idx = torch.clamp(torch.floor(xt * n_cells), 0, n_cells - 1).long()
    slope = (ev.tables[d][idx + 1] - ev.tables[d][idx]) * n_cells
    # order d + 2 only where it is tabulated (the top order's x-term is 0)
    e = [(lerp_basis(ev.tables[k], xt) * c).sum(-1)
         if k < ev.n_derivatives else torch.zeros_like(xt)
         for k, c in ((d + 1, Wt), (d + 2, ct))]
    jax_rule = (slope * Wt).sum(-1) + e[0] + e[1]
    wrong_rule = 2 * e[0] + e[1]
    assert _rel(jax_rule.numpy(), want) <= 2e-6
    assert _rel(wrong_rule.numpy(), want) > 1e-3


def test_chain_under_vmap_equals_the_batch(evaluators):
    """The nested jvp per point under ``torch.func.vmap`` (the 'fwd'
    form's shape) against the same at batch level, and vmap(hessian) (the
    'dense' form's) against it: equal within 1e-6 of the max."""
    ev, _, c0, W, x = evaluators
    ct, Wt, xt = map(torch.as_tensor, (c0, W, x))

    def f(c, w, xx):
        return ev.pair(c + w * xx[..., None], xx, 0)[0] \
            * ev(c + w * xx[..., None], xx, 1)

    def d2(c, w, xx):
        one = torch.ones_like(xx)
        return torch.func.jvp(lambda y: torch.func.jvp(
            lambda z: f(c, w, z), (y,), (one,))[1], (xx,), (one,))[1]

    batch = d2(ct, Wt, xt)
    per = torch.func.vmap(d2)(ct[:, None], Wt[:, None], xt[:, None])[:, 0]
    hess = torch.func.vmap(torch.func.hessian(
        lambda c, w, xx: f(c[None], w[None], xx[None])[0], argnums=2))(
        ct, Wt, xt)
    scale = batch.abs().max()
    assert (per - batch).abs().max() <= 1e-6 * scale
    assert (hess - batch).abs().max() <= 1e-6 * scale


@pytest.fixture(scope='module')
def monotone():
    """An I-spline evaluator (degree 4, 12 knots, 2000-point mesh),
    positive weights (each row monotone) and targets y = f(x) at x drawn
    in [0, 1]."""
    ev = make_evaluator(get_tables('I', 4, 12, n_mesh=2000), device='cpu')
    jev = jmake_evaluator(jget_tables('I', 4, 12, n_mesh=2000))
    rng = np.random.default_rng(1)
    w = rng.uniform(0.05, 1.0, size=(64, ev.n_bases)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    x = rng.uniform(0.0, 1.0, size=64).astype(np.float32)
    y = ev(torch.as_tensor(w), torch.as_tensor(x)).numpy()
    return ev, jev, w, y


@pytest.mark.parametrize('method', ['exact', 'exact_dense', 'exact_bisect',
                                    'bisect'])
def test_inverse_methods_match_jax(monotone, method):
    """``batched_monotone_inverse(method=...)`` against JAX's: the exact
    forms within 1e-6, 'bisect' (30 bisections + 2 Newton steps on the
    evaluator) within 1e-6; every form solves f(x) = y to 2e-5."""
    ev, jev, w, y = monotone
    got = batched_monotone_inverse(ev, torch.as_tensor(w), torch.as_tensor(y),
                                   method=method).numpy()
    want = np.asarray(jmonotone_inverse(jev, jnp.asarray(w), jnp.asarray(y),
                                        method=method))
    assert np.abs(got - want).max() <= 1e-6
    back = ev(torch.as_tensor(w), torch.as_tensor(got)).numpy()
    assert np.abs(back - y).max() <= 2e-5


def test_bisection_inverse_matches_jax(monotone):
    """``bisection_inverse`` at other trip counts (20 bisections, 0 and 3
    Newton steps) against JAX's: within 1e-6; an unknown method raises."""
    ev, jev, w, y = monotone
    for n_newton in (0, 3):
        got = bisection_inverse(ev, torch.as_tensor(w), torch.as_tensor(y),
                                n_bisect=20, n_newton=n_newton).numpy()
        want = np.asarray(jbisection_inverse(
            jev, jnp.asarray(w), jnp.asarray(y), n_bisect=20,
            n_newton=n_newton))
        assert np.abs(got - want).max() <= 1e-6
    with pytest.raises(ValueError):
        batched_monotone_inverse(ev, torch.as_tensor(w), torch.as_tensor(y),
                                 method='newton')


@pytest.fixture(scope='module')
def table_pair():
    """(JAX params, psi, log_pdf; the port's 'table' model with the same
    parameters; 16 JAX walkers, sorted)."""
    jparams, jpsi, jlog_pdf, jsample = jget_waveflow_model(
        2, **SMALL, eval_backend='table')(jax.random.PRNGKey(3), 2)
    m = get_waveflow_model(2, **SMALL, eval_backend='table',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    x = np.sort(np.array(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(5), jparams, 16)), axis=-1)
    return jparams, jpsi, jlog_pdf, m, x


def test_small_waveflow_matches_jax_table(table_pair):
    """ψ and log_pdf of the 'table' Waveflow (2 layers, degree 4, 10
    knots) against JAX 'table': ψ within 1e-6 of max|ψ|, log_pdf within
    1e-5 absolute; IMADE's table inverse closes the round trip to 1e-5."""
    jparams, jpsi, jlog_pdf, m, x = table_pair
    xt = torch.as_tensor(x)
    with torch.no_grad():
        assert _rel(m.psi(xt).numpy(), jax.jit(jpsi)(jparams, x)) <= 1e-6
        lp = m.log_pdf(xt).numpy()
        u, _ = m.transform(xt)
        back, _ = m.transform.inverse(u)
    assert np.abs(lp - np.asarray(jax.jit(jlog_pdf)(jparams, x))).max() \
        <= 1e-5
    assert (back - xt).abs().max().item() <= 1e-5


@pytest.mark.parametrize('mode,eps', FORMS)
def test_h_matches_jax_table(table_pair, mode, eps):
    """Hψ of the 'table' model under every Laplacian form (and the finite
    difference) against JAX's on the same sorted walkers: within 1e-5 of
    max|Hψ| (1e-3 for the finite difference, f32 cancellation over ε²)."""
    jparams, jpsi, _, m, x = table_pair
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1, eps=eps,
                      laplacian_mode=mode)
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1, eps=eps,
                                       laplacian_mode=mode)
    with torch.no_grad():
        got = h(torch.as_tensor(x)).numpy()
    assert _rel(got, jax.jit(jh)(jparams, x)) <= (1e-3 if eps else 1e-5)


def _grads(m, loss):
    named = dict(m.named_parameters())
    for p in named.values():
        p.grad = None
    loss.backward()
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in named.items()}


def _flat_rel(got: dict, want: dict) -> float:
    g = torch.cat([got[k].ravel() for k in want])
    w = torch.cat([want[k].ravel() for k in want])
    return ((g - w).norm() / w.norm()).item()


def test_adam_step_and_reference_gradient_match_jax(table_pair):
    """Under 'table' on 'fwd_batched': one 'clipped_score' + clip 10 +
    adam 1e-4 step on the fixed batch (loss rtol 1e-5; parameters rtol
    1e-4 where |g| is above float noise, within 2 lr elsewhere — Adam's
    first step is sign-like), and the 'reference' loss's gradient under
    'fwd_batched' and 'dense' (relative global-norm error 1e-4)."""
    jparams, jpsi, _, m, x = table_pair
    lr = 1e-4
    for mode in ('fwd_batched', 'dense'):
        jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1,
                          laplacian_mode=mode)
        h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                           n_space_dimensions=1,
                                           laplacian_mode=mode)
        _, j_grads = jax.jit(jax.value_and_grad(jest.make_loss_fn(
            jpsi, jh, estimator='reference')))(jparams, x, jnp.float32(-1.2))
        loss = make_loss_fn(m.psi, h, estimator='reference')(
            torch.as_tensor(x), torch.tensor(-1.2))
        assert _flat_rel(_grads(m, loss),
                         params_from_jax(jax.device_get(j_grads))) <= 1e-4
    opt = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0),
                                    optax.adam(lr)))
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    new_params, _, j_loss = jax.jit(jest.make_train_step(jpsi, jh, opt))(
        jparams, opt.init(jparams), x, jnp.float32(0.0))
    _, j_grads = jax.jit(jax.value_and_grad(jest.make_loss_fn(jpsi, jh)))(
        jparams, x, jnp.float32(0.0))
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    try:
        step = make_train_step(m.psi, h, m.parameters(), lr, grad_clip=10.0)
        loss = step(torch.as_tensor(x), torch.zeros(()))
        assert loss.item() == pytest.approx(float(j_loss), rel=1e-5)
        ref_g = params_from_jax(jax.device_get(j_grads))
        g_max = max(v.abs().max().item() for v in ref_g.values())
        named = dict(m.named_parameters())
        for k, want in params_from_jax(jax.device_get(new_params)).items():
            defined = (ref_g[k].abs() > 1e-5 * g_max).numpy()
            got, want = named[k].detach().numpy(), want.numpy()
            np.testing.assert_allclose(got[defined], want[defined],
                                       rtol=1e-4, atol=1e-7, err_msg=k)
            assert np.abs(got - want).max() <= 2 * lr + 1e-7, k
    finally:
        m.load_state_dict(before)


def test_flagship_checkpoint_under_table_matches_jax():
    """The committed 100k flagship checkpoint under 'table' at 48 sorted
    walkers (drawn by JAX): ψ within 1e-6 of max|ψ| and Hψ
    ('fwd_batched') within 1e-5 of max|Hψ| against JAX 'table'."""
    with open(CHECKPOINT, 'rb') as f:
        jparams = pickle.load(f)['params']
    _, jpsi, _, jsample = jget_waveflow_model(
        2, **FLAGSHIP, eval_backend='table')(jax.random.PRNGKey(0), 2)
    x = np.sort(np.array(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(5), jparams, 48)), axis=-1)
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    m = get_waveflow_model(2, **FLAGSHIP, eval_backend='table',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jparams))
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    xt = torch.as_tensor(x)
    with torch.no_grad():
        assert _rel(m.psi(xt).numpy(), jax.jit(jpsi)(jparams, x)) <= 1e-6
        assert _rel(h(xt).numpy(), jax.jit(jh)(jparams, x)) <= 1e-5


def test_poly_sampling_under_table_still_raises():
    """JAX ignores sampling_backend='poly' under 'table' and draws from
    the table; the port refuses it, in the model and in the trainer."""
    with pytest.raises(NotImplementedError):
        get_waveflow_model(2, **SMALL, eval_backend='table',
                           sampling_backend='poly', device='cpu')
    with pytest.raises(NotImplementedError):
        VMCTrainer(VMCConfig(eval_backend='table', sampling_backend='poly',
                             device='cpu'))


TRAIN_SMALL = dict(spline_degree=3, num_knots=6, n_flow_layers=1,
                   n_spline_base_mesh_points=200, batch_size=8, window=1,
                   eval_backend='table', device='cpu')
# every optimizer and estimator the trainer accepts with each sampler
RECIPES = [dict(optimizer='adam'),
           dict(optimizer='adam', estimator='reference'),
           dict(optimizer='sr', learning_rate=0.05),
           dict(optimizer='spring', learning_rate=0.05)]


@pytest.mark.parametrize('sampler', ['ancestral', 'metropolis', 'mala'])
@pytest.mark.parametrize('mode', ['fwd_batched', 'fwd', 'hvp', 'dense'])
def test_trainer_runs_every_combination_under_table(mode, sampler):
    """One epoch of the trainer under 'table' for each optimizer and
    estimator with this Laplacian form and sampler: a finite loss."""
    for recipe in RECIPES:
        t = VMCTrainer(VMCConfig(**TRAIN_SMALL, laplacian_mode=mode,
                                 sampler=sampler, mcmc_sweeps=1, **recipe))
        losses = t.train(1, verbose=False)
        assert len(losses) == 1 and np.isfinite(losses).all(), recipe


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_table_against_poly_energies_float64():
    """The float64 run behind chip_smoke's table-hpsi gates, on the
    flagship 100k checkpoint, 'fwd_batched'.  (1) E_L = Hψ/ψ under 'table'
    against 'poly' at 1,024 ancestral walkers (seed 7) where |ψ| > 0.05
    max|ψ| (JAX's test_waveflow_poly_vs_table_backends criterion), in
    float64 and in f32: the max within half of TABLE_POLY_EL_BOUND, the mean
    within half of TABLE_POLY_EL_MEAN_BOUND.  (2) The f32 'table' Hψ at
    4,096 walkers (seed 11, as the phase draws them on the card) against
    the same in float64 (f64 arithmetic on the tables' f32 values), within
    2e-4 of max|Hψ|: the f32 rounding of the chain itself (the card's gate,
    TABLE_HPSI_RTOL, holds two f32 orderings of it to each other).  Prints
    the figures."""
    smoke = _chip_smoke()
    with open(CHECKPOINT, 'rb') as f:
        params = params_from_jax(pickle.load(f)['params'])
    models = {}
    for backend in ('table', 'poly'):
        models[backend] = get_waveflow_model(
            2, **FLAGSHIP, eval_backend=backend,
            generator=torch.Generator().manual_seed(0), device='cpu')
        models[backend].load_state_dict(params)
    x = models['poly'].sample(1024, generator=torch.Generator().manual_seed(7))
    h_table = {}
    for dtype in (torch.float32, torch.float64):
        e_loc, psi = {}, {}
        for backend, m in models.items():
            m.to(dtype)
            h = construct_hamiltonian_function(
                m.psi, protons=PROTONS, n_space_dimensions=1,
                laplacian_mode='fwd_batched')
            with torch.no_grad():
                xx = x.to(dtype)
                psi[backend] = m.psi(xx)
                e_loc[backend] = h(xx)[:, 0] / psi[backend]
            m.float()
        big = psi['poly'].abs() > 0.05 * psi['poly'].abs().max()
        d = (e_loc['table'] - e_loc['poly']).abs()[big]
        print(f"{dtype}: max |E_L table - E_L poly| {d.max().item():.4e}, "
              f"mean {d.mean().item():.4e} over {int(big.sum())} walkers")
        assert d.max().item() <= smoke.TABLE_POLY_EL_BOUND / 2
        assert d.mean().item() <= smoke.TABLE_POLY_EL_MEAN_BOUND / 2
    m = models['table']
    x = m.sample(4096, generator=torch.Generator().manual_seed(11))
    for dtype in (torch.float32, torch.float64):
        m.to(dtype)
        h = construct_hamiltonian_function(
            m.psi, protons=PROTONS, n_space_dimensions=1,
            laplacian_mode='fwd_batched')
        with torch.no_grad():
            h_table[dtype] = h(x.to(dtype))[:, 0].double()
        m.float()
    exact = h_table[torch.float64]
    err = ((h_table[torch.float32] - exact).abs().max()
           / exact.abs().max()).item()
    print(f"'table' Hpsi at 4096 walkers, f32 against float64: {err:.3e} of "
          f"max|Hpsi|")
    assert err <= 2e-4


# K4 faults planted in the wrappers the table chain calls, as a kernel with
# that fault would compute them
def _next_row(table, c, x, step):
    shift = 1.0 / (table.shape[0] - 1) if step else 0.0
    return spline_eval_plain(table, c, x + shift, step)


def _term(tables, slopes, c, x, d, step):
    return spline_eval_plain(slopes[d] if step else tables[d], c, x, step)


# each fault as the forward kernel, the pair entry and the jet entry (one
# term: tables, slopes, coefficients, x, order, step) would compute it
K4_FAULTS = {
    'step flag ignored': (
        lambda t, c, x, s=False: spline_eval_plain(t, c, x),
        lambda ta, tb, c, x, sa=False, sb=False: (
            spline_eval_plain(ta, c, x), spline_eval_plain(tb, c, x)),
        lambda T, S, c, x, d, st: spline_eval_plain(S[d] if st else T[d],
                                                    c, x)),
    'step mode reads the next row': (
        lambda t, c, x, s=False: _next_row(t, c, x, s),
        lambda ta, tb, c, x, sa=False, sb=False: (
            _next_row(ta, c, x, sa), _next_row(tb, c, x, sb)),
        lambda T, S, c, x, d, st: _next_row(S[d] if st else T[d], c, x,
                                            st)),
    # the jet's counterpart: every lerp above order 0 (a pair's second
    # output is always one) at fraction 0
    "pair's second output at fraction 0": (
        None,
        lambda ta, tb, c, x, sa=False, sb=False: (
            spline_eval_plain(ta, c, x, sa), spline_eval_plain(tb, c, x,
                                                                True)),
        lambda T, S, c, x, d, st: (spline_eval_plain(T[d], c, x, True)
                                   if d and not st
                                   else _term(T, S, c, x, d, st))),
}


@pytest.fixture(scope='module')
def flagship_hpsi():
    """The 100k checkpoint under 'table', 'fwd_batched', at 1,024 walkers
    (seed 11): (hamiltonian, walkers, Hψ)."""
    with open(CHECKPOINT, 'rb') as f:
        params = params_from_jax(pickle.load(f)['params'])
    m = get_waveflow_model(2, **FLAGSHIP, eval_backend='table',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params)
    x = m.sample(1024, generator=torch.Generator().manual_seed(11))
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    with torch.no_grad():
        return h, x, h(x)[:, 0]


@pytest.mark.parametrize('fault', list(K4_FAULTS))
def test_table_hpsi_gate_catches_planted_k4_faults(flagship_hpsi, fault,
                                                   monkeypatch):
    """chip_smoke's table-hpsi gate (the K4 chain's Hψ against the plain
    chain's, TABLE_HPSI_RTOL of max|Hψ|) fails a K4 that computes the
    step mode or the pair entry wrongly, on the per-call entries and on
    the jet entry that serves the 'fwd_batched' chain: each planted fault
    moves the f32 Hψ of the 100k checkpoint by more than 3x the gate,
    both ways."""
    import waveflow_tpu_torch.ops.spline_eval as se
    h, x, ref = flagship_hpsi
    one, pair, term = K4_FAULTS[fault]
    if one is not None:
        monkeypatch.setattr(se, 'spline_eval', one)
    monkeypatch.setattr(se, 'spline_eval_pair', pair)
    monkeypatch.setattr(
        se, 'spline_eval_jet',
        lambda T, S, records, comps, xx, terms: [
            term(T, S, comps[m], xx, d, st) for m, d, st in terms])
    for path in (se._per_call, contextlib.nullcontext):
        with torch.no_grad(), path():
            got = h(x)[:, 0]
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        print(f"{fault} ({path.__name__}): {err:.3e} of max|Hpsi|")
        assert err > 3 * _chip_smoke().TABLE_HPSI_RTOL


def test_antisym_waveflow_under_table_matches_jax():
    """The antisymmetrized Waveflow (He-2d, 2 electrons, L = 5) under
    'table' against JAX's: ψ_A at 32 box points within 1e-5 of max|ψ_A|,
    Hψ_A ('fwd_batched') within 1e-4 of max|Hψ_A| (the signed sum of two
    permuted copies cancels)."""
    from waveflow_tpu.models import get_antisym_waveflow_model as jget_antisym
    from waveflow_tpu_torch.models import get_antisym_waveflow_model
    kw = dict(base_spline_degree=3, i_spline_degree=3,
              n_prior_internal_knots=7, n_i_internal_knots=7,
              i_spline_reg=0.1, n_flow_layers=1,
              n_spline_base_mesh_points=300, eval_backend='table')
    jparams, jpsi, _, _ = jget_antisym(2, 2, box_size=5.0, **kw)(
        jax.random.PRNGKey(3), 4)
    m = get_antisym_waveflow_model(2, 2, box_size=5.0, **kw, device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    x = np.random.default_rng(1).uniform(-4.5, 4.5, (32, 4)).astype(
        np.float32)
    protons = system_catalogue[2]['He'][0]
    jh = jconstruct_h(jpsi, protons=protons, n_space_dimensions=2,
                      laplacian_mode='fwd_batched')
    h = construct_hamiltonian_function(m.psi, protons=protons,
                                       n_space_dimensions=2,
                                       laplacian_mode='fwd_batched')
    with torch.no_grad():
        assert _rel(m.psi(torch.as_tensor(x)).numpy(),
                    jax.jit(jpsi)(jparams, x)) <= 1e-5
        assert _rel(h(torch.as_tensor(x)).numpy(),
                    jax.jit(jh)(jparams, x)) <= 1e-4


def test_entry_scripts_run_under_table(tmp_path):
    """run_vqmc_torch.py --eval-backend table trains 2 Metropolis epochs on
    the CPU and evaluate_vqmc_torch.py --eval-backend table --mcmc-eval
    evaluates the run: finite losses and a finite blocked energy."""
    import os
    import subprocess
    import sys

    def run(*args):
        out = subprocess.run([sys.executable, *args], cwd=ROOT,
                             capture_output=True, text=True, timeout=300,
                             env={**os.environ, 'OMP_NUM_THREADS': '2'})
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    tiny = ['--num-knots', '6', '--spline-degree', '3', '--n-flow-layers',
            '1', '--eval-backend', 'table', '--device', 'cpu']
    run('examples/run_vqmc_torch.py', '--num-epochs', '2', '--window', '2',
        '--batch-size', '8', '--log-every', '2', '--sampler', 'metropolis',
        '--save-dir', str(tmp_path), *tiny)
    assert np.isfinite(np.load(tmp_path / 'loss.npy')).all()
    out = run('examples/evaluate_vqmc_torch.py', '--save-dir', str(tmp_path),
              '--mcmc-eval', '--eval-batch', '32', '--eval-blocks', '4',
              '--eval-sweeps-per-block', '2', *tiny)
    line = next(ln for ln in out.splitlines() if ln.startswith('<E_L>'))
    assert np.isfinite(float(line.split('=')[1].split()[0]))
