"""K4's jet entry and the table evaluator's jet dispatch, on the CPU.

Under jvp levels alone an evaluation site (``SplineEvaluator.__call__`` or
``pair``) evaluates every term its chain of rules asks for in one launch
of the jet entry (here its plain version) and serves the chain from it.
Held here: the term derivation against what the per-call chain asks, site
by site and under vmap; the jet's chain against the per-call chain to the
bit and against JAX's ``SplineEvaluator``; a small 'table' Waveflow's Hψ
under every Laplacian form, jet against per-call to the bit and against
JAX; the launches per Hψ pass and per train-256 epoch; the sites that keep
the per-call entries; the cell records against the value and slope
tables; and the step mode at a NaN x against JAX's derivative of its
lerp.  Inputs are made with numpy from a seed."""

import contextlib
import functools
import importlib.util
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.ops import get_tables as jget_tables
from waveflow_tpu.ops import make_evaluator as jmake_evaluator
from waveflow_tpu.ops.spline_eval import _lerp_cell_gather
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.ops import cuda_spline, get_tables, make_evaluator
from waveflow_tpu_torch.ops import spline_eval as se
from waveflow_tpu_torch.physics import construct_hamiltonian_function

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / 'results' / 'r5_flagship_fwd_batched_100k' / 'checkpoints'
PROTONS = system_catalogue[1]['He'][0]
N = 48
# the evaluation sites: (name, kinds) of __call__ at every order and pair
# at every pair order of a 4-order table
SITES = ([(f'call({d})', (('F', d),)) for d in range(4)]
         + [(f'pair({d})', (('G', d), ('F', d + 1))) for d in range(3)])


@functools.lru_cache(maxsize=1)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 0.0 if err == 0 else float(err / np.abs(want).max())


@pytest.fixture(scope='module')
def ispline():
    """The flagship's I-spline tables (degree 6, 23 knots, 2000-point mesh:
    29 bases, 4 orders — the IMADE site's) in both packages, and
    coefficients c(x) = c0 + W·x that move with x, x partly outside
    [0, 1]."""
    ev = make_evaluator(get_tables('I', 6, 23, n_mesh=2000), device='cpu')
    jev = jmake_evaluator(jget_tables('I', 6, 23, n_mesh=2000))
    rng = np.random.default_rng(3)
    c0 = rng.normal(size=(N, ev.n_bases)).astype(np.float32)
    W = (0.5 * rng.normal(size=(N, ev.n_bases))).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, size=N).astype(np.float32)
    return ev, jev, c0, W, x


class _Record:
    """Every call of K4's forward, pair and jet wrappers as the evaluator
    makes it: per-call requests as (coefficients, order, step) and jet
    launches as (terms, components), the calls passed on."""

    def __init__(self, ev, monkeypatch):
        self.requests, self.jets, self.launches = [], [], 0
        kind = {}
        for d in range(ev.n_derivatives):
            kind[ev.tables[d].data_ptr()] = (d, False)
            kind[ev.slopes[d].data_ptr()] = (d, True)
        one, pair, jet = se.spline_eval, se.spline_eval_pair, se.spline_eval_jet

        def rec_one(table, c, x, step=False):
            self.launches += 1
            self.requests.append((c, *kind[table.data_ptr()]))
            return one(table, c, x, step)

        def rec_pair(ta, tb, c, x, sa=False, sb=False):
            self.launches += 1
            self.requests += [(c, *kind[ta.data_ptr()]),
                              (c, *kind[tb.data_ptr()])]
            return pair(ta, tb, c, x, sa, sb)

        def rec_jet(tables, slopes, records, comps, x, terms):
            self.jets.append((tuple(terms), comps))
            return jet(tables, slopes, records, comps, x, terms)

        monkeypatch.setattr(se, 'spline_eval', rec_one)
        monkeypatch.setattr(se, 'spline_eval_pair', rec_pair)
        monkeypatch.setattr(se, 'spline_eval_jet', rec_jet)

    def clear(self):
        self.requests.clear()
        self.jets.clear()
        self.launches = 0


def _same_rows(a, b) -> bool:
    """Equal, or ``a`` the widened ``b``: equal along every leading row."""
    if a.shape == b.shape:
        return torch.equal(a, b)
    lead = a.ndim - b.ndim
    return (a.shape[lead:] == b.shape
            and torch.equal(a, b.expand(a.shape)))


def _expected(ev, kinds, n_levels):
    """(per-call launches, jet terms) of a site by ``se.site_jet``:
    components and terms in the chain's order."""
    requests, terms = se.site_jet(ev, kinds, n_levels)
    return len(requests), tuple(terms)


def _site_fn(ev, kinds, c0, W):
    if kinds[0][0] == 'F':
        return lambda xx: ev(c0 + W * xx[..., None], xx, kinds[0][1])
    return lambda xx: torch.stack(ev.pair(c0 + W * xx[..., None], xx,
                                          kinds[0][1]))


def _nested(f, n_levels, tangent):
    for _ in range(n_levels):
        f = (lambda g: lambda xx: torch.func.jvp(g, (xx,), (tangent(xx),))[1])(f)
    return f


@pytest.mark.parametrize('layout', ['batch', 'vmap rows', 'vmap tangents'])
@pytest.mark.parametrize('n_levels', [1, 2, 3])
@pytest.mark.parametrize('site,kinds', SITES)
def test_term_derivation_is_what_the_chain_asks(ispline, monkeypatch, site,
                                                kinds, n_levels, layout):
    """The derived set of one site under 1 and 2 nested jvps — at batch
    level, under vmap over rows (the 'fwd' form's shape) and under vmap
    over tangents with x shared (the 'fwd' form's directions) — is one jet
    launch whose terms are ``se.site_jet``'s distinct (component, order,
    mode), and it is exactly what the per-call chain asks: every per-call
    request is a term on the same coefficients and every term a request.
    The outputs equal the per-call chain's to the bit.  pair(0) under two
    levels: 9 per-call launches, 15 terms over 4 components.  Under three
    levels the set exceeds one launch and the site stays per call."""
    ev, _, c0, W, x = ispline
    c0, W, x = map(torch.as_tensor, (c0, W, x))
    rec = _Record(ev, monkeypatch)
    f = _site_fn(ev, kinds, c0, W)
    if layout == 'batch':
        run = _nested(f, n_levels, torch.ones_like)
        args = (x,)
    elif layout == 'vmap rows':
        run = torch.func.vmap(lambda cc, ww, xx: _nested(
            _site_fn(ev, kinds, cc, ww), n_levels, torch.ones_like)(xx))
        args = (c0[:, None], W[:, None], x[:, None])
    else:
        def run(v):
            return _nested(f, n_levels, lambda xx: v.expand_as(xx))(x)
        run = torch.func.vmap(run)
        args = (torch.tensor([1.0, -0.5]),)
    got = run(*args)
    jets, jet_requests = list(rec.jets), list(rec.requests)
    rec.clear()
    with se._per_call():
        want = run(*args)
    per_call = list(rec.requests)
    assert torch.equal(got, want)
    n_launches, terms = _expected(ev, kinds, n_levels)
    assert rec.launches == n_launches
    if n_levels == 3:
        assert jets == [] and len(jet_requests) == len(per_call)
        return
    assert jet_requests == [] and len(jets) == 1
    got_terms, comps = jets[0]
    assert got_terms == terms
    for m, d, step in got_terms:
        assert any(rd == d and rs == step and _same_rows(comps[m], c)
                   for c, rd, rs in per_call)
    for c, d, step in per_call:
        assert any(d == td and step == ts and _same_rows(comps[m], c)
                   for m, td, ts in got_terms)
    if site == 'pair(0)' and n_levels == 2:
        assert (n_launches, len(terms), len(comps)) == (9, 15, 4)
    if site == 'call(0)' and n_levels == 2:
        assert (n_launches, len(terms), len(comps)) == (9, 9, 4)


def _jets(f, x, n, jvp, ones):
    out = [f]
    for _ in range(n):
        prev = out[-1]
        out.append(lambda xx, prev=prev: jvp(prev, (xx,), (ones,))[1])
    return [g(x) for g in out]


@pytest.mark.parametrize('site,kinds,k', [
    (site, kinds, k) for site, kinds in SITES
    for k in range(len(kinds))])
def test_jet_chain_equals_per_call_and_jax(ispline, site, kinds, k):
    """The value, first and second x-derivative of the site's output k (c
    moving with x): the jet's chain equals the per-call chain to the bit,
    and both lie within 2e-6 of their max of JAX's chain
    (test_torch_table_backend.py's tolerance)."""
    ev, jev, c0, W, x = ispline
    ct, Wt, xt = map(torch.as_tensor, (c0, W, x))
    d = kinds[0][1]

    def f(xx):
        c = ct + Wt * xx[:, None]
        return ev(c, xx, d) if kinds[0][0] == 'F' else ev.pair(c, xx, d)[k]

    def jf(xx):
        c = jnp.asarray(c0) + jnp.asarray(W) * xx[:, None]
        return jev(c, xx, d) if kinds[0][0] == 'F' else jev.pair(c, xx, d)[k]

    got = _jets(f, xt, 2, torch.func.jvp, torch.ones(N))
    with se._per_call():
        per_call = _jets(f, xt, 2, torch.func.jvp, torch.ones(N))
    want = _jets(jf, jnp.asarray(x), 2, jax.jvp, jnp.ones(N))
    for g, p, w in zip(got, per_call, want):
        assert torch.equal(g, p)
        assert _rel(g.numpy(), np.asarray(w)) <= 2e-6


@pytest.fixture(scope='module')
def table_pair():
    """JAX's test_waveflow_poly_vs_table_backends model (2 layers, degree
    4, 10 knots) under 'table' in both packages, the same parameters, 16
    sorted JAX walkers."""
    small = dict(base_spline_degree=4, i_spline_degree=4,
                 n_prior_internal_knots=10, n_i_internal_knots=10,
                 i_spline_reg=0.1, n_flow_layers=2, box_size=10.0,
                 n_spline_base_mesh_points=400)
    jparams, jpsi, _, jsample = jget_waveflow_model(
        2, **small, eval_backend='table')(jax.random.PRNGKey(3), 2)
    m = get_waveflow_model(2, **small, eval_backend='table',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    x = np.sort(np.array(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(5), jparams, 16)), axis=-1)
    return jparams, jpsi, m, x


@pytest.mark.parametrize('mode,eps', [('fwd_batched', 0.0), ('fwd', 0.0),
                                      ('hvp', 0.0), ('dense', 0.0),
                                      ('fwd', 0.1)])
def test_h_jet_equals_per_call_and_jax(table_pair, mode, eps):
    """Hψ of the small 'table' Waveflow under every Laplacian form (and
    the finite difference): the jet's equals the per-call chain's to the
    bit, and JAX's within test_h_matches_jax_table's tolerance (1e-5 of
    max|Hψ|, 1e-3 for the finite difference)."""
    jparams, jpsi, m, x = table_pair
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1, eps=eps,
                                       laplacian_mode=mode)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        got = h(xt)
        with se._per_call():
            per_call = h(xt)
    assert torch.equal(got, per_call)
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1, eps=eps,
                      laplacian_mode=mode)
    assert _rel(got.numpy(), jax.jit(jh)(jparams, x)) <= (1e-3 if eps
                                                          else 1e-5)


@pytest.fixture(scope='module')
def flagship_cpu():
    """The 100k flagship checkpoint under 'table' on the CPU and 8 of its
    walkers (the launch counts do not depend on the batch)."""
    smoke = _chip_smoke()
    with open(CHECKPOINT, 'rb') as f:
        params = params_from_jax(pickle.load(f)['params'])
    m = smoke.flagship_model(torch, params, 'table', device='cpu')
    x = m.sample(8, generator=torch.Generator().manual_seed(11))
    return smoke, params, m, x


# K4 launches per Hψ pass of the flagship, by form: (forward, pair, jet,
# backward, backward jet) with the jet and the gathered backward, and on
# the per-call entries
PASS_LAUNCHES = {'fwd_batched': ((0, 0, 8, 0, 0), (18, 54, 0, 0, 0)),
                 'fwd': ((0, 0, 4, 0, 0), (9, 27, 0, 0, 0)),
                 'hvp': ((25, 12, 0, 1, 7), (25, 12, 0, 21, 0)),
                 'dense': ((25, 12, 0, 1, 7), (25, 12, 0, 21, 0))}


@pytest.mark.parametrize('mode', list(PASS_LAUNCHES))
def test_launches_per_hpsi_pass(flagship_cpu, mode):
    """K4 launches per Hψ pass of the flagship as chip_smoke.py counts
    them on the CPU: 'fwd_batched' 72 → 8 jet launches (4 sites × 2
    directions), 'fwd' 36 → 4; 'hvp' and 'dense' keep their 25 forward
    and 12 pair launches (grad levels keep the per-call forward entries)
    and gather the backward: 21 → 8 (the prior's one-kind backward on
    the backward kernel, 3 IMADE backwards and 4 tangents on the backward
    jet entry)."""
    smoke, _, m, x = flagship_cpu
    h = smoke.he_hamiltonian(m, mode)
    counts = []
    for path in (contextlib.nullcontext, se._per_call):
        with torch.no_grad(), path(), smoke.evaluations(plain=False) as run:
            h(x)
        counts.append(tuple(run.calls.values()))
    assert tuple(counts) == PASS_LAUNCHES[mode]


def test_launches_per_train_epoch(flagship_cpu):
    """One train-256 'table' epoch (ancestral, 'fwd_batched',
    'clipped_score'): 16 K4 launches — 8 jet for Hψ, and the score's ψ,
    differentiated in the parameters, on the per-call forward entries (1
    forward, 3 pair) with its backward gathered per site (the prior's on
    the backward kernel, the 3 IMADE sites' on the backward jet entry:
    4, where the per-call chain makes 7) — where the per-call chain makes
    83."""
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    smoke, params, _, _ = flagship_cpu
    t = VMCTrainer(VMCConfig(batch_size=8, window=1, log_every=1,
                             eval_backend='table', device='cpu'))
    t.model.load_state_dict(params)
    t.train(1, verbose=False)
    counts = []
    for path in (contextlib.nullcontext, se._per_call):
        with path(), smoke.evaluations(plain=False) as run:
            t.train(1, verbose=False)
        counts.append(run.calls)
    assert counts[0] == {'spline_eval': 1, 'spline_eval_pair': 3,
                         'spline_eval_jet': 8, 'spline_eval_bwd': 1,
                         'spline_eval_bwd_jet': 3}
    assert counts[1] == {'spline_eval': 19, 'spline_eval_pair': 57,
                         'spline_eval_jet': 0, 'spline_eval_bwd': 7,
                         'spline_eval_bwd_jet': 0}


def test_sites_that_keep_the_per_call_entries(ispline, monkeypatch):
    """A site under a grad level (jvp of grad, grad of jvp), with autograd
    tracking of its operands, or under a jvp level that traces one operand
    and not the other (SR's jvp in the parameters reaches the first
    layer's x untraced; the rule then evaluates on a zero tangent that
    autograd makes) makes no jet launch, and its values are the per-call
    chain's."""
    ev, _, c0, W, x = ispline
    ct, Wt, xt = map(torch.as_tensor, (c0, W, x))
    rec = _Record(ev, monkeypatch)

    def f(xx):
        return ev.pair(ct + Wt * xx[..., None], xx, 0)[0].sum()

    one = torch.ones(N)
    cases = {
        'jvp of grad': lambda: torch.func.jvp(torch.func.grad(f), (xt,),
                                              (one,))[1],
        'grad of jvp': lambda: torch.func.grad(
            lambda xx: torch.func.jvp(f, (xx,), (one,))[1])(xt),
        'autograd under jvp': lambda: torch.autograd.grad(
            torch.func.jvp(f, (xr,), (one,))[1], xr)[0],
        'jvp in the coefficients alone': lambda: torch.func.jvp(
            lambda cc: ev.pair(cc, xt, 0)[0], (ct,), (Wt,))[1],
        'jvp in x alone': lambda: torch.func.jvp(
            lambda xx: ev.pair(ct, xx, 0)[1], (xt,), (one,))[1],
    }
    for name, fn in cases.items():
        xr = xt.clone().requires_grad_()
        rec.clear()
        got = fn()
        assert rec.jets == [], name
        with se._per_call():
            xr = xt.clone().requires_grad_()
            want = fn()
        assert torch.equal(got, want), name


@pytest.mark.parametrize('kind,degree', [('I', 6), ('B', 6), ('M', 3)])
def test_cell_records_against_tables_and_slopes(kind, degree):
    """The jet entry's cell records: for each cell and order the table row
    and the f32 delta to the next, to the bit; the delta × n_cells in f32
    equals the evaluator's slope table to the bit; the padding to a
    multiple of 4 bases is zero (the OB tables' 28 bases need none, the
    I-splines' 29 take 3)."""
    ev = make_evaluator(get_tables(kind, degree, 23 if degree == 6 else 15,
                                   n_mesh=2000), use_ob=kind == 'B',
                        device='cpu')
    rec = ev.records
    n_cells, nb = ev.n_mesh - 1, ev.n_bases
    assert rec.shape == (n_cells, ev.n_derivatives, 2, -(-nb // 4) * 4)
    for d in range(ev.n_derivatives):
        T = ev.tables[d]
        assert torch.equal(rec[:, d, 0, :nb], T[:-1])
        assert torch.equal(rec[:, d, 1, :nb], T[1:] - T[:-1])
        assert torch.equal(rec[:, d, 1, :nb] * torch.tensor(
            float(n_cells), dtype=torch.float32), ev.slopes[d][:-1])
    assert not rec[..., nb:].any()


def test_step_mode_at_nan_x_against_jax(ispline):
    """The 'S' kind (the lerp's x-derivative, step mode on the slope
    table) at a NaN, an infinite and finite x against JAX's jax.jvp of its
    lerp (``raw_eval``'s ``_lerp_cell_gather``): NaN reads cell 0's slope,
    finite as in JAX, within 2e-6 of the max at every order; the plain
    step mode returns the row at the cell."""
    ev, jev, c0, _, x = ispline
    xs = x.copy()
    xs[:4] = [np.nan, np.inf, -np.inf, np.nan]
    for d in range(ev.n_derivatives):
        got = cuda_spline.spline_eval_plain(ev.slopes[d], torch.as_tensor(c0),
                                            torch.as_tensor(xs), step=True)
        cells = jev.cell_tables[d]

        def lerp(xx):
            return jnp.sum(_lerp_cell_gather(cells, xx) * jnp.asarray(c0),
                           axis=-1)

        want = jax.jvp(lerp, (jnp.asarray(xs),), (jnp.ones(N),))[1]
        assert torch.isfinite(got).all()
        assert _rel(got.numpy(), np.asarray(want)) <= 2e-6
    rows = cuda_spline.lerp_basis(ev.slopes[0], torch.as_tensor(xs), step=True)
    assert torch.equal(rows[0], ev.slopes[0][0])
    assert torch.equal(rows[1], ev.slopes[0][ev.n_mesh - 2])
