"""Table-backed spline evaluation.

Port of waveflow_tpu/ops/spline_eval.py.  The tables serve the ancestral
samplers (``density_on_mesh``, and the transposed table that kernels K1 and
K2 read), the exact table inverse of the IMADE layers (``density_on_mesh``
/ ``at_nodes``), the boundary projector (``left`` / ``right``) and the
table-lerp evaluations ``__call__`` and ``pair``, which the density model's
M-spline prior and the 'table' eval backend of IMADE and the Waveflow use.

Derivatives follow the JAX custom-JVP chains exactly.  Every evaluation is
Σ_i c_i B_i(x) over one table, and what its x-derivative is names its
*kind* (a tuple (letter, d)):

  * 'F' (``__call__`` at order d): the order-(d+1) evaluation 'F', zero at
    the top tabulated order;
  * 'G' (the value of ``pair`` at order d): the next 'G' (JAX's
    ``pair(d+1)``), and at the top pair order the plain lerp 'R' of order
    d + 1;
  * 'R' (the plain lerp of T_d — JAX's undecorated ``raw_eval``): the
    lerp's own slope, kind 'S';
  * 'S' (the slope n_cells · (T_d[j+1] − T_d[j]) at the cell j of x,
    piecewise constant): zero.

The derivative in the coefficients of every kind is the same table's plain
lerp ('R', or 'S' for 'S'), so a second x-derivative of an evaluation whose
coefficients depend on x reads the slope of T_d, not the order-(d+1)
table.  And as in JAX, where a custom rule differentiates an evaluation,
the value it hands to the transforms below (the outer jvps and grads) is
the plain lerp ``raw_eval``: those differentiate it as kind 'R'.  A
``torch.autograd.Function`` applies one rule at every level of nested
transforms, so the three evaluations here — ``_EVAL`` (one or two kinds at
one x), ``_BWD`` (the backward of one or two kinds: Σ g·B(x) and Σ g·∂x)
and ``_BASIS`` (a sum of w·B(x) terms alone) — go through ``_run``, which
takes the innermost functorch transform itself: a level where an operand
is traced gets a single-level
Function whose forward evaluates the plain kinds one level down and whose
jvp and backward rules are the custom ones; a level where none is traced
is passed through; a vmap level folds its batch into the kernel's rows.
Below every transform the evaluation is a plain autograd Function with the
same rules.  So the rules nest to any order, as JAX's do (the VMC
Laplacian's forms, its parameter gradient, SR's vjp of a jvp, SPRING's
vmap(grad)).

On the card every evaluation is kernel K4 (csrc/spline_eval.cu): its
forward kernel (a slope table read in step mode), its pair entry for two
kinds, its jet entry, its backward kernel or its backward jet entry — no
plain PyTorch arithmetic of the kernel's body runs on a CUDA tensor.

The jet.  An evaluation site — one call of ``__call__`` or ``pair`` —
under jvp levels alone (any number of them, vmap levels among them, no
grad level on the interpreter stack and no autograd tracking of its
operands) asks the chain of rules for a fixed set of plain evaluations
at one x: 9 launches for an IMADE ``pair(0)`` under the Laplacian's two
jvp levels, 15 distinct values over 4 coefficient components (c and its
tangents c₁, c₂, c₁₂).  ``_jet`` derives that set before the chain runs
(it walks the operands down the interpreter stack with ``_run``'s own
steps, ``_vmap_down`` and ``_grad_down``, and ``_requests`` applies
``_succ`` and ``_lin`` as ``_EVAL.jvp`` and ``_at_level`` do),
evaluates it in ONE launch of K4's jet entry (kernel on the card, its
plain version on the CPU; the cell records are built at the first
launch on the card), and the chain then runs
unchanged, its evaluations served from that launch by ``_launch`` (keyed
by the bottom coefficient tensor, the order and the mode).  The rules and
their values are the per-call chain's: on the card every output equals
the per-call kernel's for the same term to the bit.  The set depends on
the site's kinds and on which operands each level traces, never on data,
so the site stays capturable in a CUDA graph.  A site with a grad level
anywhere (the score's ψ, the 'reference' estimator's Hψ, 'hvp', 'dense',
SR's vjp of a jvp, SPRING's vmap(grad), the posterior) keeps the
per-call forward entries: a backward rule runs after the site has
returned, so its evaluations cannot be known before it (``_jet`` reads
the stack's keys and returns before it lowers anything).  So does a site
under a jvp level that traces its coefficients and not x or the reverse
(SR's jvp in the parameters meets the first layer's x untraced): autograd
hands the rule a zero tangent of its own making, and the rule evaluates on
it; and a site whose set exceeds one jet launch (more than 16 terms, 4
components or 4 tabulated orders: three jvp levels).

The gathered backward.  A grad-level site's backward is gathered inside
the rules instead: ``_EVAL.vjp`` makes ONE ``_BWD`` evaluation of all the
site's kinds that have a gradient (g_c = Σ_k g_k·B^kc_k, g_x = Σ_k
g_k·E_kx_k, each sum in kind order), and ``_BWD.jvp`` ONE ``_BASIS``
evaluation of its tangent's g·B terms (t_g·B^kc + (g·t_x)·B^succ(kc) per
kind, the kinds added in order, the products g·t_x formed in the
evaluation): each one launch of K4's backward jet entry, equal to the
per-call launches and the sums between them to the bit.  Its g_x tangent
keeps its forward and pair launches, and the vjp rules (grad of grad)
stay per term.  A one-kind backward and a one-term basis keep K4's
backward kernel (the prior, the density path, the posterior: one launch,
as before), and a basis beyond one launch (more than 4 terms or 6
vectors: a third nested level) runs per term.  ``_per_call`` (tests and
chip_smoke.py) runs every site per call and every backward per kind and
term, for the A/B.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

# ``_run`` walks functorch's interpreter stack through torch internals that
# carry no promise across releases.  The torch versions it was checked on;
# tests/test_torch_table_backend.py holds every chain against JAX's and is
# the test to run on any other.
TESTED_TORCH = ('2.11', '2.13')
try:
    from torch._C._functorch import (TransformType, _add_batch_dim,
                                     _unwrap_batched, _unwrap_for_grad,
                                     _wrap_for_grad, get_interpreter_stack,
                                     is_batchedtensor,
                                     maybe_get_level, peek_interpreter_stack,
                                     unwrap_if_dead)
    from torch._functorch.pyfunctorch import \
        retrieve_current_functorch_interpreter
    from torch._functorch.utils import enable_single_level_autograd_function
    from torch.autograd.forward_ad import _set_fwd_grad_enabled
    from torch.autograd.function import _SingleLevelFunction
except ImportError as e:
    raise ImportError(
        f"the table evaluation needs torch's functorch internals ({e}); it "
        f"was checked on torch {' and '.join(TESTED_TORCH)}, this is "
        f"{torch.__version__}: see tests/test_torch_table_backend.py") from e
if '.'.join(torch.__version__.split('.')[:2]) not in TESTED_TORCH:
    warnings.warn(
        f"the table evaluation walks torch internals checked on torch "
        f"{' and '.join(TESTED_TORCH)}, not {torch.__version__}: run "
        "tests/test_torch_table_backend.py before trusting its derivatives",
        stacklevel=2)

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.ops import cuda_spline
from waveflow_tpu_torch.ops.cuda_spline import (cell_records, lerp_basis,
                                                spline_eval, spline_eval_bwd,
                                                spline_eval_bwd_jet,
                                                spline_eval_jet,
                                                spline_eval_pair, term_weight)
from waveflow_tpu_torch.ops.spline_tables import SplineTables


def _lin(kind):
    """The plain kind of the same table: the derivative in the coefficients
    of ``kind``, and what a custom rule hands to the transforms below."""
    return kind if kind[0] == 'S' else ('R', kind[1])


def _live(ev, kinds) -> tuple:
    """The kinds of the x-derivatives of ``kinds`` that are not zero."""
    return tuple(k for k in map(ev._succ, kinds) if k is not None)


def _add(a, b):
    return b if a is None else (a if b is None else a + b)


class _EVAL:
    """(Σ_i c_i B_i^k(x) for k in kinds): tensors (c, x), params (ev,
    kinds); one launch (K4's forward, or its pair entry for two kinds)."""

    @staticmethod
    def forward(t, p):
        ev, kinds = p
        return ev._launch(kinds, *t)

    @staticmethod
    def raw(p):
        ev, kinds = p
        return ev, tuple(_lin(k) for k in kinds)

    @staticmethod
    def jvp(t, dt, p):
        (c, x), (t_c, t_x), (ev, kinds) = t, dt, p
        outs = [None] * len(kinds)
        if t_c is not None:
            outs = list(_run(_EVAL, (t_c, x),
                             (ev, tuple(_lin(k) for k in kinds))))
        succ = [ev._succ(k) for k in kinds]
        live = _live(ev, kinds)
        if t_x is not None and live:
            vals = iter(_run(_EVAL, (c, x), (ev, live)))
            for i, k in enumerate(succ):
                if k is not None:
                    outs[i] = _add(outs[i], next(vals) * t_x)
        return tuple(torch.zeros_like(x) if o is None else o for o in outs)

    @staticmethod
    def vjp(t, grads, needs, p):
        (c, x), (ev, kinds) = t, p
        live = [(k, g) for k, g in zip(kinds, grads) if g is not None]
        if not live:
            return None, None
        if _jet_on:
            # the site's kinds in one backward evaluation (gathered)
            return _run(_BWD, (c, x, *(g for _, g in live)),
                        (ev, tuple(_lin(k) for k, _ in live),
                         tuple(ev._succ(k) for k, _ in live), needs[0],
                         needs[1]))
        g_c = g_x = None
        for k, g in live:
            gc, gx = _run(_BWD, (c, x, g),
                          (ev, (_lin(k),), (ev._succ(k),), needs[0],
                           needs[1]))
            g_c, g_x = _add(g_c, gc), _add(g_x, gx)
        return g_c, g_x


def _term(kind):
    """(order, step mode) of a kind: what the cell records hold of it."""
    return kind[1], kind[0] == 'S'


def _tangent_terms(ev, kcs, has_t_g, has_t_x) -> tuple:
    """The g·B terms of the tangent of a backward evaluation of the kinds
    ``kcs`` (``_BWD.jvp``): (slots, groups), ``slots`` naming the vector
    of each index — ('t_g', k), ('g', k) or 't_x' — and ``groups`` one per
    kind whose gradient or x is traced, t_g·B^kc then (g·t_x)·B^succ(kc)."""
    slots, groups = [], []

    def index(name):
        if name not in slots:
            slots.append(name)
        return slots.index(name)

    for j, kc in enumerate(kcs):
        group = []
        if has_t_g[j]:
            group.append(((index(('t_g', j)),), kc))
        if has_t_x and ev._succ(kc) is not None:
            i_tx = index('t_x')
            group.append(((index(('g', j)), i_tx), ev._succ(kc)))
        if group:
            groups.append(tuple(group))
    return slots, tuple(groups)


def _bwd_terms(kcs, kxs, need_c, need_x) -> tuple:
    """A backward evaluation of the kinds ``kcs`` as the backward jet
    entry's terms (``SplineEvaluator._launch_bwd``): (c_groups, x_terms),
    one group of one term g_k·B^kc_k per kind, and g_k·E_kx_k(c, x) on the
    coefficients, component 0, a kind without an x-derivative adding 0."""
    c_groups = (tuple((((j,), *_term(kc)),) for j, kc in enumerate(kcs))
                if need_c else ())
    x_terms = (tuple((j, 0, *((None, False) if kx is None else _term(kx)))
                     for j, kx in enumerate(kxs)) if need_x else ())
    return c_groups, x_terms


def site_bwd(ev, kinds) -> dict:
    """One grad-level site of ``ev`` (its kinds) as the gathered chain
    launches its backward, every gradient and x traced: {form: (slots,
    c_groups, x_terms)} for 'backward' (every kind's g·B and g_x, vectors
    g_k) and 'tangent' (its g·B terms under one jvp level that traces the
    gradients and x), in the backward jet entry's terms, the kinds in
    their order and orders and step modes in place of kinds."""
    kcs = tuple(_lin(k) for k in kinds)
    kxs = tuple(ev._succ(k) for k in kinds)
    c_groups, x_terms = _bwd_terms(kcs, kxs, True, True)
    slots, groups = _tangent_terms(ev, kcs, [True] * len(kinds), True)
    return {'backward': ([('g', j) for j in range(len(kinds))], c_groups,
                         x_terms),
            'tangent': (slots, tuple(tuple((f, *_term(k)) for f, k in g)
                                     for g in groups), ())}


def _basis_sum(ev, x, vecs, groups):
    """Σ over ``groups`` (each summed left to right, then the groups) of
    w·B^k(x), a term (factors, k) with w one of ``vecs`` or the product of
    two: one ``_BASIS`` evaluation where the gather is on and the terms fit
    one launch of K4's backward jet entry; else per term, the products and
    sums formed by torch, as the per-call chain forms them."""
    n_terms = sum(len(g) for g in groups)
    if _jet_on and n_terms > 1 and n_terms <= cuda_spline.BWD_C_TERMS \
            and len(vecs) <= cuda_spline.BWD_VECS:
        return _run(_BASIS, (x, *vecs), (ev, groups))[0]
    total = None
    for group in groups:
        part = None
        for factors, k in group:
            part = _add(part, _run(_BASIS, (x, term_weight(vecs, factors)),
                                   (ev, ((((0,), k),),)))[0])
        total = _add(total, part)
    return total


class _BWD:
    """The backward of an evaluation of one or two kinds at one x: tensors
    (c, x, g_1, ..., g_K), params (ev, kcs, kxs, need_c, need_x) ->
    (Σ_k g_k·B^kc_k(x) or None, Σ_k g_k·E_kx_k(c, x) or None), kx None for
    a zero x-derivative, each sum in kind order; one launch: K4's backward
    kernel for one kind, its backward jet entry for two."""

    @staticmethod
    def forward(t, p):
        c, x, *gs = t
        ev, kcs, kxs, need_c, need_x = p
        return ev._launch_bwd(kcs, kxs, c, x, gs, need_c, need_x)

    @staticmethod
    def raw(p):
        ev, kcs, kxs, need_c, need_x = p
        return (ev, kcs, tuple(None if k is None else _lin(k) for k in kxs),
                need_c, need_x)

    @staticmethod
    def jvp(t, dt, p):
        (c, x, *gs), (t_c, t_x, *t_gs) = t, dt
        ev, kcs, kxs, need_c, need_x = p
        tg_c = tg_x = None
        if need_c:
            # per kind t_g·B^kc + (g·t_x)·B^succ(kc), the kinds added in
            # order: one multi-term basis evaluation, the products g·t_x
            # formed in it
            slots, groups = _tangent_terms(
                ev, kcs, [t_g is not None for t_g in t_gs], t_x is not None)
            named = {'t_x': t_x}
            for j, (g, t_g) in enumerate(zip(gs, t_gs)):
                named[('g', j)], named[('t_g', j)] = g, t_g
            tg_c = (_basis_sum(ev, x, [named[a] for a in slots], groups)
                    if groups else x.new_zeros(x.shape + (ev.n_bases,)))
        if need_x:
            for g, t_g, kx in zip(gs, t_gs, kxs):
                # g · E_kx(c, x): the product rule around kx's own rule
                part = None
                if kx is not None:
                    if t_g is not None:
                        part = t_g * _run(_EVAL, (c, x), (ev, (kx,)))[0]
                    if t_c is not None or t_x is not None:
                        part = _add(part, g * _EVAL.jvp((c, x), (t_c, t_x),
                                                        (ev, (kx,)))[0])
                tg_x = _add(tg_x, torch.zeros_like(x) if part is None
                            else part)
        return tg_c, tg_x

    @staticmethod
    def vjp(t, grads, needs, p):
        (c, x, *gs), (gb_c, gb_x) = t, grads
        ev, kcs, kxs, need_c, need_x = p
        d_c = d_x = None
        d_gs = [None] * len(gs)
        for j, (g, kc, kx) in enumerate(zip(gs, kcs, kxs)):
            if gb_c is not None and need_c:
                if needs[2 + j]:
                    d_gs[j] = _run(_EVAL, (gb_c, x), (ev, (kc,)))[0]
                if needs[1] and ev._succ(kc) is not None:
                    d_x = _add(d_x, g * _run(_EVAL, (gb_c, x),
                                             (ev, (ev._succ(kc),)))[0])
            if gb_x is not None and need_x and kx is not None:
                if needs[2 + j]:
                    d_gs[j] = _add(d_gs[j], gb_x * _run(_EVAL, (c, x),
                                                        (ev, (kx,)))[0])
                if needs[0] or needs[1]:
                    dc, dx = _EVAL.vjp((c, x), (gb_x * g,), needs, (ev, (kx,)))
                    d_c, d_x = _add(d_c, dc), _add(d_x, dx)
        return (d_c, d_x, *d_gs)


class _BASIS:
    """Σ_groups Σ_terms w·B^k(x), (..., n_bases), for plain kinds k ('R'
    or 'S'): tensors (x, v_1, ..., v_V), params (ev, groups), a group a
    tuple of terms (factors, k), w = v_a for factors (a,) or v_a·v_b for
    (a, b); each group summed left to right, then the groups.  One launch:
    K4's backward kernel without its x output for one single-factor term,
    its backward jet entry otherwise."""

    @staticmethod
    def forward(t, p):
        x, *vecs = t
        ev, groups = p
        return (ev._launch_basis(groups, x, vecs),)

    @staticmethod
    def raw(p):
        return p

    @staticmethod
    def jvp(t, dt, p):
        (x, *vecs), (t_x, *t_vecs), (ev, groups) = t, dt, p
        total = None
        for group in groups:
            # each term's tangent t_w·B^k + (w·t_x)·B^succ(k) as a group of
            # its own, the terms of one group in one evaluation, the groups
            # added in order (the per-call chain's tree of sums)
            new_vecs, new_groups = [], []
            for factors, k in group:
                w, t_w = vecs[factors[0]], t_vecs[factors[0]]
                if len(factors) == 2:
                    b, t_b = vecs[factors[1]], t_vecs[factors[1]]
                    t_w = _add(None if t_w is None else t_w * b,
                               None if t_b is None else w * t_b)
                    w = w * b
                terms = []
                if t_w is not None:
                    new_vecs.append(t_w)
                    terms.append(((len(new_vecs) - 1,), k))
                if t_x is not None and ev._succ(k) is not None:
                    new_vecs += [w, t_x]
                    terms.append(((len(new_vecs) - 2, len(new_vecs) - 1),
                                  ev._succ(k)))
                if terms:
                    new_groups.append(tuple(terms))
            if new_groups:
                total = _add(total, _basis_sum(ev, x, new_vecs,
                                               tuple(new_groups)))
        return (x.new_zeros(x.shape + (ev.n_bases,)) if total is None
                else total,)

    @staticmethod
    def vjp(t, grads, needs, p):
        (x, *vecs), (gb,), (ev, groups) = t, grads, p
        d_x = None
        d_vecs = [None] * len(vecs)
        if gb is None:
            return (None, *d_vecs)
        for group in groups:
            for factors, k in group:
                if any(needs[1 + a] for a in factors):
                    d_w = _run(_EVAL, (gb, x), (ev, (k,)))[0]
                    if len(factors) == 1:
                        a, = factors
                        d_vecs[a] = _add(d_vecs[a], d_w)
                    else:
                        a, b = factors
                        if needs[1 + a]:
                            d_vecs[a] = _add(d_vecs[a], d_w * vecs[b])
                        if needs[1 + b]:
                            d_vecs[b] = _add(d_vecs[b], d_w * vecs[a])
                if needs[0] and ev._succ(k) is not None:
                    d_x = _add(d_x, term_weight(vecs, factors) * _run(
                        _EVAL, (gb, x), (ev, (ev._succ(k),)))[0])
        return (d_x, *d_vecs)


def _save(ctx, inputs):
    op, params, *tensors = inputs
    ctx.op, ctx.params = op, params
    ctx.save_for_backward(*tensors)
    ctx.save_for_forward(*tensors)


class _Plain(torch.autograd.Function):
    """An evaluation below every functorch transform (plain autograd)."""

    @staticmethod
    def forward(op, params, *tensors):
        return op.forward(tensors, params)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _save(ctx, inputs)

    @staticmethod
    def jvp(ctx, _op, _params, *tangents):
        with _set_fwd_grad_enabled(True):
            return ctx.op.jvp(ctx.saved_tensors, tangents, ctx.params)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ctx.op.vjp(
            ctx.saved_tensors, grads, ctx.needs_input_grad[2:], ctx.params))


def _at_level(op, params, tensors, interp):
    """The evaluation at a grad or jvp level where an operand is traced:
    a single-level Function whose forward is the plain evaluation one
    level down (JAX: the rule's primal is ``raw_eval``) and whose rules
    are the custom ones, their evaluations untraced at this level."""
    level = interp.level()
    modes = torch.is_grad_enabled(), torch._C._is_fwd_grad_enabled()

    def down(ts):
        return _grad_down(ts, level)

    def up(outs):
        # (wrapping needs this level's interpreter back on the stack)
        return tuple(None if o is None else _wrap_for_grad(o, level)
                     for o in outs)

    def forward(op_, params_, *ts):
        with _below(interp, modes):
            out = _run(op_, down(ts), op_.raw(params_))
        return up(out)

    def jvp(ctx, _op, _params, *tangents):
        with _below(interp, modes):
            out = ctx.op.jvp(down(ctx.saved_tensors), down(tangents),
                             ctx.params)
        return up(out)

    def backward(ctx, *grads):
        # evaluated on the interpreter stack as it is, with this level's
        # tracking taken off the operands: inside ``grad`` this level is
        # still the innermost grad level; after a ``vjp`` returned (jacrev
        # runs the backward under a vmap of its own) it has exited
        alive = any(i.key() == TransformType.Grad and i.level() == level
                    for i in get_interpreter_stack() or ())
        out = ctx.op.vjp(
            [_untraced(a, level, alive) for a in ctx.saved_tensors],
            [_untraced(a, level, alive) for a in grads],
            ctx.needs_input_grad[2:], ctx.params)
        return (None, None) + tuple(out)

    level_fn = type('SplineEvalAtLevel', (_SingleLevelFunction,), {
        'forward': staticmethod(forward),
        'setup_context': staticmethod(lambda ctx, i, o: _save(ctx, i)),
        'jvp': staticmethod(jvp), 'backward': staticmethod(backward)})
    with enable_single_level_autograd_function():
        return level_fn.apply(op, params, *tensors)


class _below:
    """One level below ``interp``, in the grad and forward-grad modes of
    the call (a Function's forward and rules run with both off)."""

    def __init__(self, interp, modes):
        self.stack = [torch.set_grad_enabled(modes[0]),
                      _set_fwd_grad_enabled(modes[1]), interp.lower()]

    def __enter__(self):
        for c in self.stack:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.stack):
            c.__exit__(*exc)


def _untraced(a, level, alive):
    """``a`` without the tracking of grad level ``level`` (levels below
    kept; a batched wrapper above it kept around it); where that level has
    exited, its wrapper's value."""
    if a is None:
        return None
    a = unwrap_if_dead(a)
    at = maybe_get_level(a)
    if not alive:
        return _unwrap_for_grad(a, level) if at == level else a
    if at == level:
        return _wrap_for_grad(_unwrap_for_grad(a, level), level)
    if at > level and is_batchedtensor(a):
        inner, dim = _unwrap_batched(a, at)
        return _add_batch_dim(_untraced(inner, level, alive), dim, at)
    return a


def _grad_down(tensors, level) -> list:
    """The operands of a grad or jvp level one level down."""
    return [None if a is None else _unwrap_for_grad(a, level)
            for a in tensors]


def _vmap_down(tensors, level, size) -> tuple:
    """(the operands of a vmap level one level down, whether any was
    batched): the batched ones with their batch in front and the others
    expanded along it, or all as they are where none is batched.  Called
    below the level, where the fold runs."""
    parts = [(None, None) if a is None else _unwrap_batched(a, level)
             for a in tensors]
    if all(d is None for _, d in parts):
        return [a for a, _ in parts], False
    return [None if a is None else
            a.movedim(d, 0) if d is not None else a.expand((size,) + a.shape)
            for a, d in parts], True


def _traced(a, level, key) -> bool:
    if a is None or maybe_get_level(a) != level:
        return False
    if key == TransformType.Grad:
        return a.requires_grad and torch.is_grad_enabled()
    return fwAD.unpack_dual(a).tangent is not None


def _run(op, tensors, params) -> tuple:
    """Evaluate ``op`` at the innermost functorch transform (module
    docstring), or as a plain autograd Function below every transform."""
    # a wrapper of a level that has exited (the saved operands of a vjp
    # run after its grad level, as jacrev runs it) stands for its value
    tensors = [None if a is None else unwrap_if_dead(a) for a in tensors]
    if peek_interpreter_stack() is None:
        return _Plain.apply(op, params, *tensors)
    interp = retrieve_current_functorch_interpreter()
    level, key = interp.level(), interp.key()
    if key == TransformType.Vmap:
        # fold the vmapped dimension into the rows: one launch per batch
        with interp.lower():
            inner, folded = _vmap_down(tensors, level, interp.batch_size())
            out = _run(op, inner, params)
        if not folded:
            return out
        return tuple(None if o is None else _add_batch_dim(o, 0, level)
                     for o in out)
    if key not in (TransformType.Grad, TransformType.Jvp):
        raise NotImplementedError(f"the spline evaluation under {key}")
    if any(_traced(a, level, key) for a in tensors):
        return _at_level(op, params, tensors, interp)
    inner = _grad_down(tensors, level)
    with interp.lower():
        out = _run(op, inner, params)
    return tuple(None if o is None else _wrap_for_grad(o, level)
                 for o in out)


# ---- the jet: one launch per evaluation site under jvp levels -------------

_jet_on = True


class _per_call:
    """Within the block every site goes through the per-call entries, as
    before the jet, and every backward per kind and term, as before the
    gather (the A/B of tests and chip_smoke.py)."""

    def __enter__(self):
        global _jet_on
        self.before, _jet_on = _jet_on, False

    def __exit__(self, *exc):
        global _jet_on
        _jet_on = self.before


def _requests(ev, kinds, levels, traced, comp=()):
    """The plain evaluations the chain of rules makes at one site, in its
    order, as (component, kinds) — one launch each on the per-call path.
    ``levels``: the jvp levels from the innermost down; ``traced(comp,
    level)``: whether that level traces the component (a tuple of the
    levels whose tangents it is) and x, which it traces together (a level
    that traces one of them hands the rule a zero tangent of the other,
    which it evaluates on: ``_jet`` leaves such a site to the per-call
    path).  A level that traces neither passes the kinds through
    (``_run``); one that traces both evaluates the plain kinds
    (``_at_level``'s primal, ``_EVAL.raw``), their coefficient tangent and
    the x-derivatives (``_EVAL.jvp``)."""
    if not levels:
        return [(comp, kinds)]
    level, rest = levels[0], levels[1:]
    if not traced(comp, level):
        return _requests(ev, kinds, rest, traced, comp)
    _, lin = _EVAL.raw((ev, kinds))
    out = (_requests(ev, lin, rest, traced, comp)
           + _requests(ev, lin, rest, traced, comp + (level,)))
    live = _live(ev, kinds)
    if live:
        out += _requests(ev, live, rest, traced, comp)
    return out


def _terms(requests, key) -> tuple:
    """The jet launch of a site's requests (``_requests``): its
    components, {key(comp): (index, comp)} in the chain's order; its
    terms, {(index, order, step mode): t} in order; and where each
    request's value lies, {(key(comp), order, step mode): (t, comp)}.
    Components of one key (the same bottom tensor) are one."""
    order, terms, where = {}, {}, {}
    for comp, kinds in requests:
        m = order.setdefault(key(comp), (len(order), comp))[0]
        for letter, d in kinds:
            t = terms.setdefault((m, d, letter == 'S'), len(terms))
            where[(key(comp), d, letter == 'S')] = (t, comp)
    return order, terms, where


def site_jet(ev, kinds, n_levels: int = 2) -> tuple:
    """One site of ``ev`` under ``n_levels`` nested jvps that trace the
    coefficients and x at every level (the Laplacian's shape): its
    per-call launches as (component index, kinds), and the jet's terms as
    (component index, order, step mode), as ``_jet`` derives them,
    components in the chain's order (the coefficients first)."""
    requests = _requests(ev, tuple(kinds),
                         tuple(range(n_levels, 0, -1)), lambda c, l: True)
    order, terms, _ = _terms(requests, lambda comp: comp)
    return [(order[comp][0], ks) for comp, ks in requests], list(terms)


def _widen(a, folds, levels, sizes):
    """``a`` folded at ``folds`` (a subsequence of the vmap levels
    ``levels``, innermost first; their batch dims in front, outermost
    first) with the other levels' dims put in place, expanded: the
    operand does not vary along them."""
    present = set(folds)
    for j, level in enumerate(levels):
        if level not in present:
            pos = sum(m in present for m in levels[j + 1:])
            a = a.unsqueeze(pos)
            shape = list(a.shape)
            shape[pos] = sizes[level]
            a = a.expand(shape)
            present.add(level)
    return a


def _key(a):
    return a.data_ptr(), tuple(a.shape), a.stride()


def _jet(ev, kinds, c, x):
    """The evaluations of one site under jvp levels alone, in one launch
    of K4's jet entry: {(key of a bottom coefficient tensor, order, step
    mode): value}; None where the jet does not apply (module docstring).

    The operands are walked down the interpreter stack as ``_run`` walks
    them (``_vmap_down``, ``_grad_down``), component by component (a
    component is the tuple of the jvp levels whose tangent it is, () the
    coefficients themselves), each beside its own x; the launch and the
    served values are made below every transform, where the chain's own
    evaluations run."""
    keys = [i.key() for i in get_interpreter_stack() or ()]
    if TransformType.Jvp not in keys or any(
            k not in (TransformType.Jvp, TransformType.Vmap) for k in keys):
        return None
    # component -> [its coefficients, its x], and the vmap levels it folds
    ops = {(): [unwrap_if_dead(c), unwrap_if_dead(x)]}
    folds = {(): ()}
    jvps, vmaps, sizes = [], [], {}
    lowered = []
    try:
        while peek_interpreter_stack() is not None:
            interp = retrieve_current_functorch_interpreter()
            level, key = interp.level(), interp.key()
            if key == TransformType.Jvp:
                jvps.append(level)
                for comp, (a, xa) in list(ops.items()):
                    traced = _traced(a, level, key)
                    if traced != _traced(xa, level, key):
                        # the rule would get a zero tangent for the other
                        # operand (autograd materialises it) and evaluate
                        # on it: coefficients no walk can know
                        return None
                    if traced:
                        ops[comp + (level,)] = _grad_down(
                            [fwAD.unpack_dual(a).tangent, xa], level)
                        folds[comp + (level,)] = folds[comp]
                    ops[comp] = _grad_down([a, xa], level)
                lowered.append(interp.lower())
                lowered[-1].__enter__()
            else:
                vmaps.append(level)
                sizes[level] = interp.batch_size()
                lowered.append(interp.lower())
                lowered[-1].__enter__()
                for comp, pair in list(ops.items()):
                    ops[comp], folded = _vmap_down(pair, level, sizes[level])
                    folds[comp] += (level,) if folded else ()
        if any(a.requires_grad or fwAD.unpack_dual(a).tangent is not None
               for pair in ops.values() for a in pair):
            return None
        order, terms, where = _terms(
            _requests(ev, kinds, tuple(jvps),
                      lambda comp, l: comp + (l,) in ops),
            lambda comp: _key(ops[comp][0]))
        if (len(order) > cuda_spline.JET_COMPONENTS
                or len(terms) > cuda_spline.JET_TERMS
                or ev.n_derivatives > cuda_spline.JET_ORDERS):
            return None
        vmaps = tuple(v for v in vmaps if any(v in f for f in folds.values()))
        x0 = _widen(ops[()][1], folds[()], vmaps, sizes)
        out = spline_eval_jet(
            ev.tables, ev.slopes, ev.records if x0.is_cuda else None,
            [_widen(ops[comp][0], folds[comp], vmaps, sizes)
             for _, comp in order.values()], x0, tuple(terms))
        # a component that a vmap level did not fold takes that level's
        # first row (it does not vary along it), as a tensor of its own:
        # forward AD keeps a rule output's tangent beside its storage, so a
        # view would cost a fill and a copy of the whole output
        served = {}
        for k, (t, comp) in where.items():
            index = tuple(slice(None) if v in folds[comp] else 0
                          for v in reversed(vmaps))
            served[k] = out[t][index].contiguous() if 0 in index else out[t]
        return served
    finally:
        for below in reversed(lowered):
            below.__exit__(None, None, None)


def _site(ev, kinds, c, x) -> tuple:
    """One evaluation site: the chain of rules, its evaluations served
    from one jet launch where the jet applies (module docstring)."""
    served = None
    if _jet_on and peek_interpreter_stack() is not None:
        served = _jet(ev, kinds, c, x)
    if served is None:
        return _run(_EVAL, (c, x), (ev, kinds))
    before, ev._served = ev._served, served
    try:
        return _run(_EVAL, (c, x), (ev, kinds))
    finally:
        ev._served = before


class SplineEvaluator:
    """Batched evaluator for one spline table family.

    tables: (n_derivatives, n_mesh, n_bases) float32 on ``device``.
    """

    def __init__(self, tables: np.ndarray, device=None):
        device = resolve_device(device)
        self.tables = torch.as_tensor(np.asarray(tables, np.float32),
                                      device=device)
        self.n_derivatives, self.n_mesh, self.n_bases = tables.shape
        self.left = self.tables[:, 0, :]            # (nd, n_bases)
        self.right = self.tables[:, -1, :]
        # (n_bases, n_mesh) value table: the density_on_mesh operand, and
        # the layout the fused sampler kernel reads (ops/cuda_sampler.py)
        self.table_t = self.tables[0].T.contiguous()
        # the slope tables of kind 'S': row j = n_cells · (T_d[j+1] − T_d[j])
        # (the f32 delta of JAX's cell tables, scaled as the derivative of
        # its fraction), the last row repeated so that the kernel reads a
        # table of the value tables' shape in step mode
        t32 = np.asarray(tables, np.float32)
        slopes = (t32[:, 1:] - t32[:, :-1]) * np.float32(self.n_mesh - 1)
        self.slopes = torch.as_tensor(
            np.concatenate([slopes, slopes[:, -1:]], axis=1), device=device)
        # the values of the site being evaluated by the jet (``_site``)
        self._served = None

    @functools.cached_property
    def records(self) -> torch.Tensor:
        """The jet entry's layout of the value and slope tables: per cell,
        each order's row and delta (``cell_records``).  Built at the first
        jet launch on the card, which a graph's eager first epoch makes."""
        return torch.as_tensor(cell_records(self.tables.cpu().numpy()),
                               device=self.tables.device)

    def _succ(self, kind):
        """The kind of the x-derivative of an evaluation of ``kind``, or
        None where it is zero (module docstring).

        Line by line against waveflow_tpu/ops/spline_eval.py: in
        ``_build_jvp_chain``, ``f_jvp``'s ``fns[d + 1](coeffs, x) * t_x``
        is 'F' d -> ('F', d + 1), none where d + 1 == n_deriv; in
        ``_build_pair_chain``, ``w_d1`` of ``fns[d + 1]`` is 'G' d ->
        ('G', d + 1) below the top pair order, and at it the value's
        tangent ``primal_out[1] * t_x`` reads ``raw_eval``, so 'G' d ->
        ('R', d + 1); ``w_d2`` (pair(d + 1)'s derivative, truncated at the
        top pair order) is ('F', d + 1) -> ('F', d + 2), as ``__call__``.
        Both rules' ``raw_eval(t_coeffs, x)`` is ``_lin``; 'R' -> 'S' ->
        zero is the transforms' own derivative of ``raw_eval``, a lerp."""
        letter, d = kind
        if letter == 'F':
            return ('F', d + 1) if d + 1 < self.n_derivatives else None
        if letter == 'G':
            return ('G', d + 1) if d + 2 < self.n_derivatives \
                else ('R', d + 1)
        if letter == 'R':
            return ('S', d)
        return None

    def _table(self, kind):
        """(table, step mode) of a kind."""
        letter, d = kind
        return (self.slopes[d], True) if letter == 'S' \
            else (self.tables[d], False)

    def _launch(self, kinds, coeffs, x) -> tuple:
        """The values of one or two kinds at x: one K4 launch on the card,
        or, inside a site evaluated by the jet, its values."""
        if self._served is not None:
            out = []
            for letter, d in kinds:
                key = (_key(coeffs), d, letter == 'S')
                if key not in self._served:
                    raise RuntimeError(
                        f"the chain of rules asked for kind {(letter, d)} on "
                        "coefficients the jet of this site did not evaluate")
                out.append(self._served[key])
            return tuple(out)
        if len(kinds) == 1:
            table, step = self._table(kinds[0])
            return (spline_eval(table, coeffs, x, step),)
        (ta, sa), (tb, sb) = (self._table(k) for k in kinds)
        return spline_eval_pair(ta, tb, coeffs, x, sa, sb)

    def _launch_bwd(self, kcs, kxs, coeffs, x, grads, need_coeffs, need_x):
        """(Σ_k g_k·B^kc_k(x), Σ_k g_k·E_kx_k(coeffs, x)), kx None for
        zero: one launch of K4's backward kernel on the card for one kind,
        of its backward jet entry for two."""
        if len(kcs) == 1:
            table, step = self._table(kcs[0])
            table_x, step_x = ((None, False) if kxs[0] is None
                               else self._table(kxs[0]))
            return spline_eval_bwd(table, table_x, coeffs, x, grads[0],
                                   need_coeffs, need_x, step, step_x)
        c_groups, x_terms = _bwd_terms(kcs, kxs, need_coeffs, need_x)
        if not (c_groups or x_terms):
            return None, None
        return spline_eval_bwd_jet(
            self.tables, self.slopes, self.records if x.is_cuda else None,
            [coeffs], x, list(grads), c_groups, x_terms)

    def _launch_basis(self, groups, x, vecs):
        """Σ over the groups of w·B^k(x) (``_BASIS``): one launch of K4's
        backward kernel without its x output for one single-factor term,
        of its backward jet entry otherwise."""
        if len(groups) == 1 and len(groups[0]) == 1 \
                and len(groups[0][0][0]) == 1:
            (((a,), k),), = groups
            table, step = self._table(k)
            return spline_eval_bwd(table, None, None, x, vecs[a], True, False,
                                   step)[0]
        c_groups = tuple(tuple((factors, *_term(k))
                               for factors, k in group) for group in groups)
        return spline_eval_bwd_jet(
            self.tables, self.slopes, self.records if x.is_cuda else None,
            [], x, list(vecs), c_groups, ())[0]

    def basis(self, x: torch.Tensor, d: int = 0) -> torch.Tensor:
        """Interpolated basis matrix T^{(d)} at x: (...,) -> (..., n_bases)."""
        return lerp_basis(self.tables[d], x)

    def __call__(self, coeffs: torch.Tensor, x: torch.Tensor,
                 d: int = 0) -> torch.Tensor:
        """sum_i coeffs[..., i] * T_i^{(d)}(x[...]) with derivative chaining.

        coeffs: (..., n_bases), x: (...,) -> (...,).  The cell index is
        clipped to the table, the in-cell fraction is not: outside [0, 1]
        the edge cell extends linearly.  On a CUDA tensor the evaluation
        is kernel K4 and its backward K4's backward kernel."""
        return _site(self, (('F', d),), coeffs, x)[0]

    def pair(self, coeffs: torch.Tensor, x: torch.Tensor, d: int = 0):
        """(Σ_i c_i T_i^{(d)}(x), Σ_i c_i T_i^{(d+1)}(x)) in one launch (K4's
        pair entry on the card), with JAX's pair chain: the value chains
        to pair(d + 1), and at the top pair order to the plain lerp of
        order d + 1; the derivative chains as ``__call__`` at d + 1."""
        if not 0 <= d < self.n_derivatives - 1:
            raise ValueError(f"pair order d must be in [0, "
                             f"{self.n_derivatives - 2}], got {d}")
        return _site(self, (('G', d), ('F', d + 1)), coeffs, x)

    def at_nodes(self, coeffs: torch.Tensor, idx: torch.Tensor,
                 d: int = 0) -> torch.Tensor:
        """Exact table values at mesh-node indices: sum_i c_i T_i^{(d)}[idx].

        coeffs: (..., n_bases), idx: (...,) int -> (...,)
        """
        return (self.tables[d][idx] * coeffs).sum(-1)

    def density_on_mesh(self, coeffs: torch.Tensor) -> torch.Tensor:
        """sum_i c_i T_i at every mesh point: (..., n_bases) -> (..., n_mesh).

        One f32 matmul; TF32 is off package-wide, so it is exact f32."""
        return coeffs @ self.table_t


def make_evaluator(tables: SplineTables, use_ob: bool = False,
                   device=None) -> SplineEvaluator:
    """Evaluator over ``tables``; ``use_ob`` selects the orthonormalized
    B-basis tables."""
    arr = tables.ob_tables if use_ob else tables.tables
    return SplineEvaluator(arr, device=device)
