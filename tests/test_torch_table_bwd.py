"""K4's backward jet entry and the gathered backward of the table
evaluator's grad-level sites, on the CPU.

A grad-level evaluation site (``SplineEvaluator.pair`` or ``__call__``
under a grad level) evaluates its backward — every kind's g·B and g_x —
in one evaluation, and the tangent of that backward (its g·B terms, the
products g·t_x among them) in one more: one launch of the backward jet
entry each on the card, its plain version here.  Held here: the plain
entry against the per-call plain functions composed in the chain's order,
to the bit (1, 2 and 4 terms, lerp and step, NaN x) and against JAX's vjp
of ``pair``; the gathered score gradient, 'hvp' and 'dense' Hψ, SPRING's
``vmap(grad)`` score matrix and a third nested level, each equal to the
per-call chain (``spline_eval._per_call``) to the bit and to JAX's within
the tolerances of the tests that already hold them; the launches each
makes; and the pure plan.  Inputs are made with numpy from a seed; each
JAX function is compiled once."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from waveflow_tpu.models import get_waveflow_model as jget_waveflow_model
from waveflow_tpu.ops import get_tables as jget_tables
from waveflow_tpu.ops import make_evaluator as jmake_evaluator
from waveflow_tpu.physics import (
    construct_hamiltonian_function as jconstruct_h, system_catalogue)
from waveflow_tpu.vmc import estimators as jest
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.models import get_waveflow_model
from waveflow_tpu_torch.ops import cuda_spline, get_tables, make_evaluator
from waveflow_tpu_torch.ops import spline_eval as se
from waveflow_tpu_torch.ops.cuda_spline import (spline_eval_bwd_jet,
                                                spline_eval_bwd_jet_plain,
                                                spline_eval_bwd_plain)
from waveflow_tpu_torch.physics import construct_hamiltonian_function
from waveflow_tpu_torch.vmc import make_loss_fn
from waveflow_tpu_torch.vmc.sr import make_score_fn

torch.set_num_threads(2)

PROTONS = system_catalogue[1]['He'][0]
N = 40
# JAX's test_waveflow_poly_vs_table_backends: 2 layers, degree 4, 10 knots
SMALL = dict(base_spline_degree=4, i_spline_degree=4,
             n_prior_internal_knots=10, n_i_internal_knots=10,
             i_spline_reg=0.1, n_flow_layers=2, box_size=10.0,
             n_spline_base_mesh_points=400)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    return 0.0 if err == 0 else float(err / np.abs(want).max())


def _same(a, b) -> bool:
    """Equal element by element, NaN where NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


class _Count:
    """Within the block, the evaluator's backward launch points counted:
    the backward kernel's and the backward jet entry's."""

    def __init__(self, monkeypatch):
        self.calls = {'bwd': 0, 'bwd_jet': 0}
        bwd, bwd_jet = se.spline_eval_bwd, se.spline_eval_bwd_jet

        def count(name, fn):
            def call(*args, **kw):
                self.calls[name] += 1
                return fn(*args, **kw)
            return call

        monkeypatch.setattr(se, 'spline_eval_bwd', count('bwd', bwd))
        monkeypatch.setattr(se, 'spline_eval_bwd_jet',
                            count('bwd_jet', bwd_jet))

    def take(self) -> tuple:
        out = (self.calls['bwd'], self.calls['bwd_jet'])
        self.calls.update(bwd=0, bwd_jet=0)
        return out


@pytest.fixture(scope='module')
def ispline():
    """The flagship's I-spline tables (degree 6, 23 knots, 2000-point mesh:
    29 bases, 4 orders) in both packages; coefficients c0, W, weights and
    x partly outside [0, 1], NaN at two rows of ``x_nan``."""
    ev = make_evaluator(get_tables('I', 6, 23, n_mesh=2000), device='cpu')
    jev = jmake_evaluator(jget_tables('I', 6, 23, n_mesh=2000))
    rng = np.random.default_rng(7)
    c0 = rng.normal(size=(N, ev.n_bases)).astype(np.float32)
    W = (0.5 * rng.normal(size=(N, ev.n_bases))).astype(np.float32)
    vecs = rng.normal(size=(6, N)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, size=N).astype(np.float32)
    x_nan = x.copy()
    x_nan[[3, 17]] = np.nan
    return ev, jev, c0, W, vecs, x, x_nan


def _per_call(ev, comps, x, vecs, c_groups, x_terms):
    """The per-call plain chain of a launch: one backward per term (the
    product weights formed first), added in groups, then the groups; g_x
    term by term, then added."""
    def table(d, step):
        return ev.slopes[d] if step else ev.tables[d]

    g_c = None
    for group in c_groups:
        part = None
        for factors, d, step in group:
            w = vecs[factors[0]]
            if len(factors) == 2:
                w = w * vecs[factors[1]]
            gc, _ = spline_eval_bwd_plain(table(d, step), None, None, x, w,
                                          step)
            part = gc if part is None else part + gc
        g_c = part if g_c is None else g_c + part
    g_x = None
    for v, m, d, step in x_terms:
        if d is None:
            gx = torch.zeros_like(x)
        else:
            _, gx = spline_eval_bwd_plain(ev.tables[0], table(d, step),
                                          comps[m], x, vecs[v], False, step)
        g_x = gx if g_x is None else g_x + gx
    return g_c, g_x


# the launches the table backend makes (ops/spline_eval.py): an IMADE
# pair(0) site's backward (2 kinds, g_x from orders 1 and 2), the prior's
# one kind, its tangent (t_g·B^R + (g·t_x)·B^S per kind, 4 terms), a g·B
# sum alone, a step-mode term alone, and a kind without an x-derivative
FORMS = {
    'pair backward': ((((0,), 0, False),), (((1,), 1, False),)),
    'one kind': ((((0,), 0, False),),),
    'tangent, 4 terms': ((((0,), 0, False), ((1, 2), 0, True)),
                         (((3,), 1, False), ((4, 2), 1, True))),
    'step alone': ((((5,), 2, True),),),
    'two-factor alone': ((((1, 2), 3, True),),),
}
X_TERMS = {
    'pair backward': ((0, 0, 1, False), (1, 0, 2, False)),
    'one kind': ((0, 0, 1, False),),
    'tangent, 4 terms': (),
    'step alone': (),
    'two-factor alone': ((2, 1, 1, True), (5, 0, None, False)),
}


@pytest.mark.parametrize('form', list(FORMS))
@pytest.mark.parametrize('nan', [False, True])
def test_plain_entry_equals_the_per_call_composition(ispline, form, nan):
    """The backward jet entry's plain version (and its dispatcher on a CPU
    tensor) equals the per-call plain backward calls, products and sums
    in the chain's order, to the bit: 1, 2 and 4 terms, lerp and step, a
    product weight, a zero x term, at finite and NaN x (NaN where the
    per-call chain is, the step-mode terms finite there)."""
    ev, _, c0, W, vecs, x, x_nan = ispline
    comps = [torch.as_tensor(c0), torch.as_tensor(W)]
    xs = torch.as_tensor(x_nan if nan else x)
    vs = list(torch.as_tensor(vecs))
    c_groups, x_terms = FORMS[form], X_TERMS[form]
    got = spline_eval_bwd_jet_plain(ev.tables, ev.slopes, comps, xs, vs,
                                    c_groups, x_terms)
    via = spline_eval_bwd_jet(ev.tables, ev.slopes, None, comps, xs, vs,
                              c_groups, x_terms)
    want = _per_call(ev, comps, xs, vs, c_groups, x_terms)
    for g, v, w in zip(got, via, want):
        assert (g is None) == (w is None) == (v is None)
        if w is not None:
            assert _same(g, w) and _same(v, w)
    if form == 'step alone':
        assert torch.isfinite(got[0]).all()


def test_pair_backward_against_jax_vjp(ispline):
    """The 2-kind form (an IMADE pair(0) site's backward, as ``_BWD``
    gathers it) against JAX's vjp of ``pair(0)``: g_c and g_x within 2e-6
    of their max (test_torch_table_backend.py's chain tolerance)."""
    ev, jev, c0, _, vecs, x, _ = ispline
    g0, g1 = vecs[0], vecs[1]
    got = se._BWD.forward(
        (torch.as_tensor(c0), torch.as_tensor(x), torch.as_tensor(g0),
         torch.as_tensor(g1)),
        (ev, (('R', 0), ('R', 1)), (ev._succ(('G', 0)), ev._succ(('F', 1))),
         True, True))
    _, vjp = jax.vjp(lambda c, xx: jev.pair(c, xx, 0), jnp.asarray(c0),
                     jnp.asarray(x))
    want = vjp((jnp.asarray(g0), jnp.asarray(g1)))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= 2e-6


@pytest.fixture(scope='module')
def table_pair():
    """The small 'table' Waveflow (JAX's test_waveflow_poly_vs_table_backends
    model) in both packages, the same parameters, 16 sorted JAX walkers."""
    jparams, jpsi, _, jsample = jget_waveflow_model(
        2, **SMALL, eval_backend='table')(jax.random.PRNGKey(3), 2)
    m = get_waveflow_model(2, **SMALL, eval_backend='table',
                           generator=torch.Generator().manual_seed(0),
                           device='cpu')
    m.load_state_dict(params_from_jax(jax.device_get(jparams)))
    x = np.sort(np.array(jax.jit(jsample, static_argnums=2)(
        jax.random.PRNGKey(5), jparams, 16)), axis=-1)
    return jparams, jpsi, m, x


def _grads(m, loss) -> dict:
    named = dict(m.named_parameters())
    for p in named.values():
        p.grad = None
    loss.backward()
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in named.items()}


def test_score_gradient_gathered(table_pair, monkeypatch):
    """The 'clipped_score' loss's parameter gradient ('fwd_batched' Hψ, the
    score's ψ differentiated in the parameters): gathered equals per-call
    to the bit, within 1e-4 (relative global norm, the adam test's) of
    JAX's; the score's backward: 1 backward kernel launch (the prior's
    one kind) and 2 of the backward jet entry (one per IMADE site, both
    kinds), where the per-call chain makes 5 (one per kind)."""
    jparams, jpsi, m, x = table_pair
    count = _Count(monkeypatch)
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1,
                                       laplacian_mode='fwd_batched')
    grads, launches = [], []
    for path in (contextlib.nullcontext, se._per_call):
        with path():
            loss = make_loss_fn(m.psi, h)(torch.as_tensor(x),
                                          torch.tensor(-1.2))
            grads.append(_grads(m, loss))
        launches.append(count.take())
    assert launches == [(1, 2), (5, 0)]
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1,
                      laplacian_mode='fwd_batched')
    _, j_grads = jax.jit(jax.value_and_grad(jest.make_loss_fn(jpsi, jh)))(
        jparams, x, jnp.float32(-1.2))
    want = params_from_jax(jax.device_get(j_grads))
    g = torch.cat([grads[0][k].ravel() for k in want])
    w = torch.cat([want[k].ravel() for k in want])
    assert ((g - w).norm() / w.norm()).item() <= 1e-4


@pytest.mark.parametrize('mode', ['hvp', 'dense'])
def test_hpsi_gathered(table_pair, monkeypatch, mode):
    """Hψ under 'hvp' and 'dense' (a jvp over the grad in x): gathered
    equals per-call to the bit and lies within 1e-5 of max|Hψ| of JAX's
    (test_h_matches_jax_table's tolerance); backward launches per pass 1
    backward kernel (the prior's backward) + 2 × 2 + 1 backward jet (each
    IMADE site's backward and tangent, the prior's tangent), where the
    per-call chain makes 5 + 10."""
    jparams, jpsi, m, x = table_pair
    count = _Count(monkeypatch)
    h = construct_hamiltonian_function(m.psi, protons=PROTONS,
                                       n_space_dimensions=1,
                                       laplacian_mode=mode)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        got = h(xt)
        gathered = count.take()
        with se._per_call():
            per_call = h(xt)
    assert (gathered, count.take()) == ((1, 5), (15, 0))
    assert torch.equal(got, per_call)
    jh = jconstruct_h(jpsi, protons=PROTONS, n_space_dimensions=1,
                      laplacian_mode=mode)
    assert _rel(got.numpy(), jax.jit(jh)(jparams, x)) <= 1e-5


def test_spring_score_matrix_gathered(table_pair, monkeypatch):
    """SPRING's score matrix O = vmap(grad(log|ψ|)) under 'table' (the
    backward under ``_run``'s vmap fold): gathered equals per-call to the
    bit, within 1e-5 of max|O| of JAX's vmap(grad) (test_torch_sr.py's
    tolerance), one backward evaluation per site for all walkers."""
    jparams, jpsi, m, x = table_pair
    count = _Count(monkeypatch)
    flatten, scores = make_score_fn(m)
    flat, xt = flatten(), torch.as_tensor(x)
    O = scores(flat, xt)
    gathered = count.take()
    with se._per_call():
        O_pc = scores(flat, xt)
    assert (gathered, count.take()) == ((1, 2), (5, 0))
    assert torch.equal(O, O_pc)
    flat0, unravel = ravel_pytree(jparams)

    def jf(f, xi):
        return jnp.log(jnp.abs(jpsi(unravel(f), xi[None]))[0] + 1e-8)

    want = np.asarray(jax.jit(jax.vmap(jax.grad(jf), in_axes=(None, 0)))(
        flat0, jnp.asarray(x)))
    assert np.abs(O.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@functools.lru_cache(maxsize=1)
def _jax_third(n):
    """JAX's x-derivative of the x-gradient of Σ pair(0)[0] with c moving
    with x, under one more jvp: a jvp of a jvp of a grad, compiled once."""
    def third(jev, c0, W, x):
        def f(xx):
            return jnp.sum(jev.pair(c0 + W * xx[:, None], xx, 0)[0])

        d1 = lambda xx: jax.jvp(jax.grad(f), (xx,), (jnp.ones(n),))[1]
        return jax.jvp(d1, (x,), (jnp.ones(n),))[1]
    return jax.jit(third, static_argnums=0)


def test_levels_nest_over_the_gathered_backward(ispline, monkeypatch):
    """A jvp of a jvp of a grad at one pair(0) site (the coefficients
    moving with x): the gathered backward's tangent is itself
    differentiated (the multi-term basis evaluation's jvp rule, product
    weights among its terms), and the result equals the per-call chain's
    to the bit and JAX's within 2e-6 of its max."""
    ev, jev, c0, W, _, x, _ = ispline
    ct, Wt, xt = map(torch.as_tensor, (c0, W, x))
    one = torch.ones(N)

    def f(xx):
        return ev.pair(ct + Wt * xx[:, None], xx, 0)[0].sum()

    def d1(xx):
        return torch.func.jvp(torch.func.grad(f), (xx,), (one,))[1]

    def third():
        return torch.func.jvp(d1, (xt,), (one,))[1]

    count = _Count(monkeypatch)
    got = third()
    assert count.take()[1] > 0
    with se._per_call():
        want = third()
    assert count.take()[1] == 0
    assert torch.equal(got, want)
    ref = _jax_third(N)(jev, jnp.asarray(c0), jnp.asarray(W), jnp.asarray(x))
    assert _rel(got.numpy(), np.asarray(ref)) <= 2e-6


@pytest.mark.parametrize('N_rows', [1, 31, 512, 513, 8192, 40_001])
@pytest.mark.parametrize('n_bases', [7, 28, 29])
def test_bwd_jet_plan_covers(N_rows, n_bases):
    """The backward jet entry's plan: the forward kernel's lanes per row,
    blocks of BWD_BLOCK threads covering N with no block past it, shared
    memory for one block's rows of g_c (none without g_c terms), at least
    4 rows a block; the same arguments give the same plan."""
    p = cuda_spline.plan_bwd_jet(N_rows, n_bases, 4, 0, 5, 0)
    lanes = cuda_spline.lanes_per_row(n_bases)
    rows = cuda_spline.BWD_BLOCK // lanes
    assert (p.threads, p.group, p.regime) == (cuda_spline.BWD_BLOCK, lanes,
                                              'bwd_jet')
    assert p.smem_bytes == 4 * rows * n_bases and rows % 4 == 0
    assert (p.grid - 1) * rows < N_rows <= p.grid * rows
    assert cuda_spline.plan_bwd_jet(N_rows, n_bases, 0, 2, 2, 1).smem_bytes == 0
    assert cuda_spline.plan_bwd_jet(N_rows, n_bases, 4, 0, 5, 0) == p


def test_bwd_jet_plan_refuses_and_forces():
    """Beyond the kernel's limits the plan raises, naming what is over;
    a forced block size (measurements) is taken and covers the work."""
    for threads in cuda_spline.BWD_THREADS:
        p = cuda_spline.plan_bwd_jet(40_001, 29, 2, 2, 2, 1, threads)
        assert (p.threads, p.grid) == (threads,
                                       -(-40_001 // (threads // 8)))
    for args, what in (((512, 29, 5, 0, 5, 0), 'g_c terms'),
                       ((512, 29, 2, 3, 2, 1), 'g_x terms'),
                       ((512, 29, 2, 2, 7, 1), 'weight vectors'),
                       ((512, 29, 2, 2, 2, 3), 'components'),
                       ((512, 29, 0, 0, 2, 1), 'a g_c or a g_x term'),
                       ((512, 29, 0, 2, 2, 0), 'component'),
                       ((512, 29, 2, 0, 2, 0, 32), 'threads'),
                       ((512, 4096, 1, 0, 1, 0, 256), 'staging'),
                       ((0, 29, 2, 0, 2, 0), 'N'),
                       ((512, 0, 2, 0, 2, 0), 'N')):
        with pytest.raises(ValueError, match=what):
            cuda_spline.plan_bwd_jet(*args)


def test_bwd_jet_wrapper_refuses_a_cpu_tensor(ispline):
    """The kernel wrapper raises on a CPU tensor (no plain fallback inside
    it); only the dispatcher takes the plain version there."""
    ev, _, c0, _, vecs, x, _ = ispline
    with pytest.raises(ValueError, match='CUDA'):
        cuda_spline.spline_eval_bwd_jet_cuda(
            ev.records, [torch.as_tensor(c0)], torch.as_tensor(x),
            list(torch.as_tensor(vecs[:2])), FORMS['pair backward'],
            X_TERMS['pair backward'], ev.n_bases)
