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
one x), ``_BWD`` (the backward of one kind: g·B(x) and g·∂x) and ``_BASIS``
(g·B(x) alone) — go through ``_run``, which takes the innermost functorch
transform itself: a level where an operand is traced gets a single-level
Function whose forward evaluates the plain kinds one level down and whose
jvp and backward rules are the custom ones; a level where none is traced
is passed through; a vmap level folds its batch into the kernel's rows.
Below every transform the evaluation is a plain autograd Function with the
same rules.  So the rules nest to any order, as JAX's do (the VMC
Laplacian's forms, its parameter gradient, SR's vjp of a jvp, SPRING's
vmap(grad)).

On the card every evaluation is kernel K4 (csrc/spline_eval.cu): its
forward kernel (a slope table read in step mode), its pair entry for two
kinds, or its backward kernel — no plain PyTorch arithmetic of the
kernel's body runs on a CUDA tensor.
"""

from __future__ import annotations

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
from waveflow_tpu_torch.ops.cuda_spline import (lerp_basis, spline_eval,
                                                spline_eval_bwd,
                                                spline_eval_pair)
from waveflow_tpu_torch.ops.spline_tables import SplineTables


def _lin(kind):
    """The plain kind of the same table: the derivative in the coefficients
    of ``kind``, and what a custom rule hands to the transforms below."""
    return kind if kind[0] == 'S' else ('R', kind[1])


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
        live = tuple(k for k in succ if k is not None)
        if t_x is not None and live:
            vals = iter(_run(_EVAL, (c, x), (ev, live)))
            for i, k in enumerate(succ):
                if k is not None:
                    outs[i] = _add(outs[i], next(vals) * t_x)
        return tuple(torch.zeros_like(x) if o is None else o for o in outs)

    @staticmethod
    def vjp(t, grads, needs, p):
        (c, x), (ev, kinds) = t, p
        g_c = g_x = None
        for k, g in zip(kinds, grads):
            if g is None:
                continue
            gc, gx = _run(_BWD, (c, x, g),
                          (ev, _lin(k), ev._succ(k), needs[0], needs[1]))
            g_c, g_x = _add(g_c, gc), _add(g_x, gx)
        return g_c, g_x


class _BWD:
    """The backward of an evaluation: tensors (c, x, g), params (ev, kc,
    kx, need_c, need_x) -> (g·B^kc(x) or None, g·E_kx(c, x) or None), kx
    None for a zero x-derivative; one launch of K4's backward kernel."""

    @staticmethod
    def forward(t, p):
        c, x, g = t
        ev, kc, kx, need_c, need_x = p
        return ev._launch_bwd(kc, kx, c, x, g, need_c, need_x)

    @staticmethod
    def raw(p):
        ev, kc, kx, need_c, need_x = p
        return ev, kc, None if kx is None else _lin(kx), need_c, need_x

    @staticmethod
    def jvp(t, dt, p):
        (c, x, g), (t_c, t_x, t_g) = t, dt
        ev, kc, kx, need_c, need_x = p
        tg_c = tg_x = None
        if need_c:
            if t_g is not None:
                tg_c = _run(_BASIS, (t_g, x), (ev, kc))[0]
            if t_x is not None and ev._succ(kc) is not None:
                tg_c = _add(tg_c, _run(_BASIS, (g * t_x, x),
                                       (ev, ev._succ(kc)))[0])
            if tg_c is None:
                tg_c = x.new_zeros(x.shape + (ev.n_bases,))
        if need_x:
            if kx is not None:
                # g · E_kx(c, x): the product rule around kx's own rule
                if t_g is not None:
                    tg_x = t_g * _run(_EVAL, (c, x), (ev, (kx,)))[0]
                if t_c is not None or t_x is not None:
                    tg_x = _add(tg_x, g * _EVAL.jvp((c, x), (t_c, t_x),
                                                    (ev, (kx,)))[0])
            if tg_x is None:
                tg_x = torch.zeros_like(x)
        return tg_c, tg_x

    @staticmethod
    def vjp(t, grads, needs, p):
        (c, x, g), (gb_c, gb_x) = t, grads
        ev, kc, kx, need_c, need_x = p
        d_c = d_x = d_g = None
        if gb_c is not None and need_c:
            if needs[2]:
                d_g = _run(_EVAL, (gb_c, x), (ev, (kc,)))[0]
            if needs[1] and ev._succ(kc) is not None:
                d_x = g * _run(_EVAL, (gb_c, x),
                               (ev, (ev._succ(kc),)))[0]
        if gb_x is not None and need_x and kx is not None:
            if needs[2]:
                d_g = _add(d_g, gb_x * _run(_EVAL, (c, x),
                                            (ev, (kx,)))[0])
            if needs[0] or needs[1]:
                dc, dx = _EVAL.vjp((c, x), (gb_x * g,), needs, (ev, (kx,)))
                d_c, d_x = dc, _add(d_x, dx)
        return d_c, d_x, d_g


class _BASIS:
    """g · B^k(x), (..., n_bases), for a plain kind k ('R' or 'S'): tensors
    (g, x), params (ev, k); one launch of K4's backward kernel without
    its x output."""

    @staticmethod
    def forward(t, p):
        g, x = t
        ev, k = p
        return ev._launch_bwd(k, None, None, x, g, True, False)[:1]

    @staticmethod
    def raw(p):
        return p

    @staticmethod
    def jvp(t, dt, p):
        (g, x), (t_g, t_x), (ev, k) = t, dt, p
        out = None
        if t_g is not None:
            out = _run(_BASIS, (t_g, x), (ev, k))[0]
        if t_x is not None and ev._succ(k) is not None:
            out = _add(out, _run(_BASIS, (g * t_x, x),
                                 (ev, ev._succ(k)))[0])
        return (x.new_zeros(x.shape + (ev.n_bases,)) if out is None
                else out,)

    @staticmethod
    def vjp(t, grads, needs, p):
        (g, x), (gb,), (ev, k) = t, grads, p
        d_g = d_x = None
        if gb is None:
            return None, None
        if needs[0]:
            d_g = _run(_EVAL, (gb, x), (ev, (k,)))[0]
        if needs[1] and ev._succ(k) is not None:
            d_x = g * _run(_EVAL, (gb, x), (ev, (ev._succ(k),)))[0]
        return d_g, d_x


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
        return [None if a is None else _unwrap_for_grad(a, level)
                for a in ts]

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
        size = interp.batch_size()
        parts = [(None, None) if a is None else _unwrap_batched(a, level)
                 for a in tensors]
        with interp.lower():
            if all(d is None for _, d in parts):
                return _run(op, [a for a, _ in parts], params)
            out = _run(op, [None if a is None else
                            (a.movedim(d, 0) if d is not None
                             else a.expand((size,) + a.shape))
                            for a, d in parts], params)
        return tuple(None if o is None else _add_batch_dim(o, 0, level)
                     for o in out)
    if key not in (TransformType.Grad, TransformType.Jvp):
        raise NotImplementedError(f"the spline evaluation under {key}")
    if any(_traced(a, level, key) for a in tensors):
        return _at_level(op, params, tensors, interp)
    inner = [None if a is None else _unwrap_for_grad(a, level)
             for a in tensors]
    with interp.lower():
        out = _run(op, inner, params)
    return tuple(None if o is None else _wrap_for_grad(o, level)
                 for o in out)


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
        """The values of one or two kinds at x: one K4 launch on the card."""
        if len(kinds) == 1:
            table, step = self._table(kinds[0])
            return (spline_eval(table, coeffs, x, step),)
        (ta, sa), (tb, sb) = (self._table(k) for k in kinds)
        return spline_eval_pair(ta, tb, coeffs, x, sa, sb)

    def _launch_bwd(self, kc, kx, coeffs, x, grad, need_coeffs, need_x):
        """(g·B^kc(x), g·E_kx(coeffs, x)), kx None for zero: one launch of
        K4's backward kernel on the card."""
        table, step = self._table(kc)
        table_x, step_x = (None, False) if kx is None else self._table(kx)
        return spline_eval_bwd(table, table_x, coeffs, x, grad, need_coeffs,
                               need_x, step, step_x)

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
        return _run(_EVAL, (coeffs, x), (self, (('F', d),)))[0]

    def pair(self, coeffs: torch.Tensor, x: torch.Tensor, d: int = 0):
        """(Σ_i c_i T_i^{(d)}(x), Σ_i c_i T_i^{(d+1)}(x)) in one launch (K4's
        pair entry on the card), with JAX's pair chain: the value chains
        to pair(d + 1), and at the top pair order to the plain lerp of
        order d + 1; the derivative chains as ``__call__`` at d + 1."""
        if not 0 <= d < self.n_derivatives - 1:
            raise ValueError(f"pair order d must be in [0, "
                             f"{self.n_derivatives - 2}], got {d}")
        return _run(_EVAL, (coeffs, x), (self, (('G', d), ('F', d + 1))))

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
