"""Kernel K4: the table-lerp spline evaluation and its backward
(csrc/spline_eval.cu), and their plain versions.

Replaces waveflow_tpu/ops/pallas_spline.py::spline_eval_pallas
(``_spline_eval_kernel``).  The forward versions compute

    y[n] = Σ_i coeffs[n, i] · lerp(table[:, i], x[n])

with cell = clip(floor(x · n_cells), 0, n_cells − 1) and frac = x · n_cells −
cell left unclipped (linear extension of the edge cells outside [0, 1]); the
backward versions compute, from the gradient g of y,

    g_coeffs[n, i] = g[n] · lerp(T_d[:, i], x[n])
    g_x[n]         = g[n] · Σ_i coeffs[n, i] · lerp(T_{d+1}[:, i], x[n])

(the x-derivative of the order-d evaluation is the order-(d+1) evaluation,
zero where that order is not tabulated).  ``spline_eval_pair`` evaluates two
tables at one x in one launch (the kernel's pair entry), and every table may
be read in step mode (``step=True``: the row at the cell, the fraction
ignored), which over a slope table is the x-derivative of the plain lerp
(ops/spline_eval.py).  The JET entry (``spline_eval_jet``) evaluates up to
16 terms at one x in one launch, each term a coefficient component (up to
4) against the lerp of one tabulated order or its step-mode slope, from
per-evaluator cell records (``cell_records``): the forward-mode chain of
one evaluation site in one launch.  The BACKWARD JET entry
(``spline_eval_bwd_jet``) evaluates a grad-level site's backward in one
launch from the same records:

    g_c[n, :] = Σ_t w_t[n] · B^t(x[n])        (up to 4 terms, in groups)
    g_x[n]    = Σ_u v_u[n] · Σ_i C_u[n, i] · B^u_i(x[n])      (up to 2)

each weight one of up to 6 vectors (N,) or the product of two, B the lerp
of one tabulated order or its step-mode slope: all kinds of a site at
once, and a tangent's g·B terms with the product g·t_x formed in the
kernel.  ``spline_eval``, ``spline_eval_pair``, ``spline_eval_jet``,
``spline_eval_bwd`` and ``spline_eval_bwd_jet`` run the CUDA kernels on a
CUDA tensor — one launch each, the backward too is a kernel on the card —
and the plain gather-lerp on a CPU tensor, never a plain version on the
card.
``onehot_matmul_eval`` is
the gather-free formulation the TPU kernel uses (the JAX package's function
of the same name); tests and chip_smoke.py hold the kernel against it, the
port never calls it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from waveflow_tpu_torch.ops import cuda_build

# kernel launches since the last reset (chip_smoke.py)
launches = 0          # the forward kernel
launches_pair = 0     # the forward kernel's pair entry (two tables)
launches_bwd = 0      # the backward kernel
launches_jet = 0      # the jet entry (the terms of one evaluation site)
launches_bwd_jet = 0  # the backward jet entry (a grad-level site's backward)

# the kernels' constants (csrc/spline_eval.cu checks a plan against its own)
THREADS = 256
CHUNK = 4                     # consecutive bases a lane takes per load
# the jet entry's limits: outputs, coefficient components and tabulated
# orders of one launch; the block sizes it takes, and its plan's: 64
# threads came out fastest, or within 2% of it, at each of N = 512, 8,192
# and 40,000 on both sites of the table backend (examples/
# kernel_sweep_torch.py --only spline_jet, PERF.md)
JET_TERMS = 16
JET_COMPONENTS = 4
JET_ORDERS = 4
JET_THREADS = (256, 128, 64, 32)
JET_BLOCK = 64
# the backward jet entry's limits: weight vectors, terms of g_c and of g_x,
# coefficient components of one launch; the block sizes it takes (at least
# 4 rows a block at up to 64 bases, so that every block's span of g_c
# starts 16-byte aligned), and its plan's: 128 threads came out fastest,
# or within 4% of it, at each of N = 512, 8,192 and 40,000 in the three
# forms the table backend launches (examples/kernel_sweep_torch.py --only
# spline_bwd_jet, PERF.md)
BWD_VECS = 6
BWD_C_TERMS = 4
BWD_X_TERMS = 2
BWD_COMPONENTS = 2
BWD_THREADS = (256, 128, 64)
BWD_BLOCK = 128
BWD_SMEM_MAX = 48 * 1024

# the C entry points of csrc/spline_eval.cu: (argtypes, restype)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    'spline_eval_launch': ([_PTR] * 4 + [_INT] * 6 + [_PTR], _INT),
    'spline_eval_pair_launch': ([_PTR] * 6 + [_INT] * 6 + [_PTR], _INT),
    'spline_eval_bwd_launch': ([_PTR] * 7 + [_INT] * 6 + [_PTR], _INT),
    'spline_eval_jet_launch': ([_PTR] * 8 + [_INT] * 8 + [_PTR], _INT),
    'spline_eval_bwd_jet_launch': ([_PTR] * 5 + [_INT, _PTR, _INT, _PTR, _INT]
                                   + [_PTR] * 2 + [_INT] * 7 + [_PTR], _INT),
    'spline_eval_error_string': ([_INT], ctypes.c_char_p)}


def lanes_per_row(n_bases: int) -> int:
    """The power of two (at most a warp) of lanes that share a row: one
    chunk of 4 bases per lane where that fits."""
    chunks = -(-n_bases // CHUNK)
    return min(32, 1 << (chunks - 1).bit_length())


@functools.lru_cache(maxsize=256)
def plan(N: int, n_bases: int, backward: bool = False,
         lanes: int | None = None) -> cuda_build.LaunchPlan:
    """The launch of csrc/spline_eval.cu for N rows of n_bases coefficients,
    forward or backward: ``group`` lanes share a row (4 consecutive bases
    per lane and load), a 256-thread block covers 256 / lanes rows; no
    shared memory.  ``lanes`` forces the lanes per row (measurements
    only)."""
    if N < 1 or n_bases < 1:
        raise ValueError(f"spline_eval kernel needs N, n_bases >= 1, got "
                         f"N={N}, n_bases={n_bases}")
    if lanes is None:
        lanes = lanes_per_row(n_bases)
    if lanes < 1 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two up to 32, got {lanes}")
    per_block = THREADS // lanes
    return cuda_build.LaunchPlan(-(-N // per_block), THREADS, 0,
                                 'backward' if backward else 'forward', lanes)


@functools.lru_cache(maxsize=256)
def plan_jet(N: int, n_bases: int, n_terms: int, n_components: int,
             n_orders: int, threads: int | None = None
             ) -> cuda_build.LaunchPlan:
    """The jet entry's launch for N rows: the forward kernel's lanes per
    row and assignment of bases to lanes (so each term sums as the per-call
    entries do), in blocks of JET_BLOCK threads (a few rows each, so a few
    hundred rows still spread over many SMs).  ``threads``, one of
    JET_THREADS, forces the block (measurements only).  Raises beyond the
    kernel's limits: JET_TERMS outputs, JET_COMPONENTS components,
    JET_ORDERS tabulated orders."""
    if N < 1 or n_bases < 1:
        raise ValueError(f"the jet entry needs N, n_bases >= 1, got N={N}, "
                         f"n_bases={n_bases}")
    for what, n, limit in (('terms', n_terms, JET_TERMS),
                           ('components', n_components, JET_COMPONENTS),
                           ('orders', n_orders, JET_ORDERS)):
        if not 1 <= n <= limit:
            raise ValueError(f"the jet entry takes 1 to {limit} {what}, "
                             f"got {n}")
    lanes = lanes_per_row(n_bases)
    if threads is None:
        threads = JET_BLOCK
    elif threads not in JET_THREADS:
        raise ValueError(f"threads must be one of {JET_THREADS}, got "
                         f"{threads}")
    per_block = threads // lanes
    return cuda_build.LaunchPlan(-(-N // per_block), threads, 0, 'jet', lanes)


@functools.lru_cache(maxsize=256)
def plan_bwd_jet(N: int, n_bases: int, n_c_terms: int, n_x_terms: int,
                 n_vecs: int, n_components: int,
                 threads: int | None = None) -> cuda_build.LaunchPlan:
    """The backward jet entry's launch for N rows: the forward kernel's
    lanes per row (so each g_x term sums as the backward kernel does), in
    blocks of BWD_BLOCK threads, and the shared memory that stages a
    block's rows of g_c (none without g_c terms).  ``threads``, one of
    BWD_THREADS, forces the block (measurements only).  Raises beyond the
    kernel's limits: BWD_C_TERMS terms of g_c, BWD_X_TERMS of g_x,
    BWD_VECS weight vectors, BWD_COMPONENTS components, BWD_SMEM_MAX
    bytes of staging."""
    if N < 1 or n_bases < 1:
        raise ValueError(f"the backward jet entry needs N, n_bases >= 1, got "
                         f"N={N}, n_bases={n_bases}")
    for what, n, low, limit in (
            ('g_c terms', n_c_terms, 0, BWD_C_TERMS),
            ('g_x terms', n_x_terms, 0, BWD_X_TERMS),
            ('weight vectors', n_vecs, 1, BWD_VECS),
            ('components', n_components, 0, BWD_COMPONENTS)):
        if not low <= n <= limit:
            raise ValueError(f"the backward jet entry takes {low} to {limit} "
                             f"{what}, got {n}")
    if n_c_terms == 0 and n_x_terms == 0:
        raise ValueError("the backward jet entry needs a g_c or a g_x term")
    if n_x_terms and not n_components:
        raise ValueError("g_x terms need a coefficient component")
    lanes = lanes_per_row(n_bases)
    if threads is None:
        threads = BWD_BLOCK
    elif threads not in BWD_THREADS:
        raise ValueError(f"threads must be one of {BWD_THREADS}, got "
                         f"{threads}")
    rows = threads // lanes
    smem = 4 * rows * n_bases if n_c_terms else 0
    if smem > BWD_SMEM_MAX:
        raise ValueError(f"{rows} rows of {n_bases} bases take {smem} bytes "
                         f"of staging, over {BWD_SMEM_MAX}")
    return cuda_build.LaunchPlan(-(-N // rows), threads, smem, 'bwd_jet',
                                 lanes)


def cell_records(tables) -> np.ndarray:
    """The jet entry's table layout: (n_cells, n_orders, 2, n_pad) float32,
    for cell j and order d the row T_d[j] and the float32 delta
    T_d[j + 1] − T_d[j], each padded with zeros to n_pad, the next multiple
    of 4 bases.  A lerp is fmaf(delta, frac, row), the per-call kernel's
    arithmetic; the step-mode slope is delta · n_cells in float32, the
    evaluator's slope table to the bit."""
    t = np.asarray(tables, np.float32)
    n_orders, n_mesh, n_bases = t.shape
    n_pad = -(-n_bases // CHUNK) * CHUNK
    rec = np.zeros((n_mesh - 1, n_orders, 2, n_pad), np.float32)
    rec[:, :, 0, :n_bases] = t[:, :-1].transpose(1, 0, 2)
    rec[:, :, 1, :n_bases] = (t[:, 1:] - t[:, :-1]).transpose(1, 0, 2)
    return rec


def lerp_basis(table: torch.Tensor, x: torch.Tensor,
               step: bool = False) -> torch.Tensor:
    """Table rows interpolated at x: table (n_mesh, n_bases), x (...,) ->
    (..., n_bases); ``step``: the row at the cell, uninterpolated."""
    n_cells = table.shape[0] - 1
    pos = x * n_cells
    idx = torch.clamp(torch.floor(pos), 0, n_cells - 1)
    frac = pos - idx
    # a NaN x reads cell 0, as the kernel's clamp does
    idx = torch.nan_to_num(idx, nan=0.0).long()
    y_l = table[idx]
    if step:
        # the row at the cell, whatever x: over a slope table the lerp's
        # x-derivative, finite at a NaN or infinite x as the kernel's step
        # mode and JAX's derivative of its lerp are
        return y_l
    return y_l + (table[idx + 1] - y_l) * frac[..., None]


def spline_eval_plain(table: torch.Tensor, coeffs: torch.Tensor,
                      x: torch.Tensor, step: bool = False) -> torch.Tensor:
    """Plain PyTorch gather-lerp: coeffs (..., n_bases), x (...,) -> (...,)."""
    return (lerp_basis(table, x, step) * coeffs).sum(-1)


def spline_eval_bwd_plain(table_d: torch.Tensor,
                          table_d1: torch.Tensor | None,
                          coeffs: torch.Tensor | None, x: torch.Tensor,
                          grad: torch.Tensor, step_d: bool = False,
                          step_d1: bool = False) -> tuple:
    """Plain PyTorch backward of the order-d evaluation (gather-lerp):
    (g_coeffs (..., n_bases), g_x (...,)) from the gradient ``grad`` (...,)
    of its output; ``table_d1`` is the table of its x-derivative, None at
    the top tabulated order, where g_x is zero."""
    g_coeffs = grad[..., None] * lerp_basis(table_d, x, step_d)
    if table_d1 is None or coeffs is None:
        return g_coeffs, torch.zeros_like(x)
    return g_coeffs, grad * spline_eval_plain(table_d1, coeffs, x, step_d1)


def spline_eval_jet_plain(tables: torch.Tensor, slopes: torch.Tensor,
                          comps, x: torch.Tensor, terms) -> list:
    """Plain version of the jet entry, term by term: for each term (m, d,
    step) the gather-lerp of coefficient component ``comps[m]`` on the
    order-d table, or in step mode on its slope table -> n_terms tensors
    (...,)."""
    return [spline_eval_plain(slopes[d] if step else tables[d], comps[m], x,
                              step) for m, d, step in terms]


def _sum(a, b):
    return b if a is None else a + b


def term_weight(vecs, factors):
    """A backward jet term's weight: one of ``vecs``, or the product of
    two as the per-call chain forms it."""
    return vecs[factors[0]] if len(factors) == 1 \
        else vecs[factors[0]] * vecs[factors[1]]


def spline_eval_bwd_jet_plain(tables: torch.Tensor, slopes: torch.Tensor,
                              comps, x: torch.Tensor, vecs, c_groups,
                              x_terms) -> tuple:
    """Plain version of the backward jet entry, the per-call plain
    functions composed in the chain's order: ``c_groups`` a sequence of
    groups of terms (factors, order, step), factors one or two indices into
    ``vecs``; each group summed left to right, then the groups ->
    g_c (..., n_bases), None without groups.  ``x_terms`` a sequence of
    (vector, component, order or None, step), summed left to right ->
    g_x (...,), a term of order None adding zeros; None without terms."""
    g_c = None
    for group in c_groups:
        part = None
        for factors, d, step in group:
            table = slopes[d] if step else tables[d]
            part = _sum(part, spline_eval_bwd_plain(
                table, None, None, x, term_weight(vecs, factors), step)[0])
        g_c = _sum(g_c, part)
    g_x = None
    for v, m, d, step in x_terms:
        if d is None:
            term = torch.zeros_like(x)
        else:
            table = slopes[d] if step else tables[d]
            term = vecs[v] * spline_eval_plain(table, comps[m], x, step)
        g_x = _sum(g_x, term)
    return g_c, g_x


def onehot_matmul_eval(table: torch.Tensor, coeffs: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """The same function as a dense lerp-weight matrix W (two non-zeros per
    row) times the table: rowsum((W @ table) ∘ coeffs)."""
    n_mesh = table.shape[0]
    n_cells = n_mesh - 1
    pos = x * n_cells
    idx = torch.clamp(torch.floor(pos), 0, n_cells - 1)
    frac = pos - idx
    col = torch.arange(n_mesh, dtype=x.dtype, device=x.device)
    zero = x.new_zeros(())
    w = (torch.where(col == idx[..., None], 1.0 - frac[..., None], zero)
         + torch.where(col == idx[..., None] + 1.0, frac[..., None], zero))
    return ((w @ table) * coeffs).sum(-1)


def _check(table: torch.Tensor, coeffs: torch.Tensor | None,
           x: torch.Tensor, *same_as_x: torch.Tensor) -> None:
    """Raise unless the operands are what the kernels take: f32, on one
    CUDA device, table (n_mesh >= 2, n_bases), coeffs (..., n_bases), and x
    and ``same_as_x`` of the coefficients' batch shape (without
    coefficients, of x's).  Reads no device memory."""
    if not x.is_cuda:
        raise ValueError("the spline_eval kernels need their operands on "
                         "one CUDA device")
    if coeffs is None:
        coeffs = x.new_empty(()).expand(x.shape + (table.shape[-1],))
    for a in (table, coeffs, *same_as_x):
        if a.device != x.device:
            raise ValueError("the spline_eval kernels need their operands "
                             "on one CUDA device")
    for a in (table, coeffs, x, *same_as_x):
        if a.dtype != torch.float32:
            raise TypeError("the spline_eval kernels take float32 tensors")
    if (table.ndim != 2 or table.shape[0] < 2 or coeffs.ndim < 1
            or coeffs.shape[-1] != table.shape[1]
            or any(a.shape != coeffs.shape[:-1] for a in (x, *same_as_x))):
        raise ValueError(
            "expected table (n_mesh >= 2, n_bases), coeffs (..., n_bases) "
            f"and x (...,), got {tuple(table.shape)}, {tuple(coeffs.shape)} "
            f"and {[tuple(a.shape) for a in (x, *same_as_x)]}")


def _dense(a: torch.Tensor) -> torch.Tensor:
    return a if a.is_contiguous() else a.contiguous()


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.spline_eval_error_string(err).decode())


def spline_eval_cuda(table: torch.Tensor, coeffs: torch.Tensor,
                     x: torch.Tensor, step: bool = False,
                     lanes: int | None = None) -> torch.Tensor:
    """Launch the forward kernel: table (n_mesh, n_bases), coeffs
    (..., n_bases), x (...,), all f32 on the card -> (...,).  The leading
    dims are one batch to the kernel; nothing is reshaped or copied unless
    an operand is not contiguous."""
    global launches
    _check(table, coeffs, x)
    table, coeffs, x = _dense(table), _dense(coeffs), _dense(x)
    N = x.numel()
    out = torch.empty_like(x)
    if N == 0:
        return out
    n_mesh, n_bases = table.shape
    p = plan(N, n_bases, False, lanes)
    lib = cuda_build.bind('spline_eval', SIGNATURES)
    err = lib.spline_eval_launch(
        table.data_ptr(), coeffs.data_ptr(), x.data_ptr(), out.data_ptr(),
        N, n_mesh, n_bases, p.group, p.grid, int(step),
        cuda_build.current_stream(x.device.index))
    launches += 1
    _raise_on(err, lib, 'spline_eval')
    return out


def spline_eval_pair_cuda(table_a: torch.Tensor, table_b: torch.Tensor,
                          coeffs: torch.Tensor, x: torch.Tensor,
                          step_a: bool = False, step_b: bool = False,
                          lanes: int | None = None) -> tuple:
    """Launch the forward kernel's pair entry: two tables of one shape
    evaluated at x with the same coefficients, the cell located and the
    coefficients read once -> (y_a, y_b), each (...,)."""
    global launches_pair
    _check(table_a, coeffs, x)
    if table_b.shape != table_a.shape or table_b.device != x.device \
            or table_b.dtype != torch.float32:
        raise ValueError("the pair's two tables must match, got "
                         f"{tuple(table_a.shape)} and {tuple(table_b.shape)}")
    table_a, table_b = _dense(table_a), _dense(table_b)
    coeffs, x = _dense(coeffs), _dense(x)
    N = x.numel()
    out_a, out_b = torch.empty_like(x), torch.empty_like(x)
    if N == 0:
        return out_a, out_b
    n_mesh, n_bases = table_a.shape
    p = plan(N, n_bases, False, lanes)
    lib = cuda_build.bind('spline_eval', SIGNATURES)
    err = lib.spline_eval_pair_launch(
        table_a.data_ptr(), table_b.data_ptr(), coeffs.data_ptr(),
        x.data_ptr(), out_a.data_ptr(), out_b.data_ptr(), N, n_mesh,
        n_bases, p.group, p.grid, int(step_a) | 2 * int(step_b),
        cuda_build.current_stream(x.device.index))
    launches_pair += 1
    _raise_on(err, lib, 'spline_eval_pair')
    return out_a, out_b


def spline_eval_bwd_cuda(table_d: torch.Tensor, table_d1: torch.Tensor | None,
                         coeffs: torch.Tensor | None, x: torch.Tensor,
                         grad: torch.Tensor, need_coeffs: bool = True,
                         need_x: bool = True, step_d: bool = False,
                         step_d1: bool = False,
                         lanes: int | None = None) -> tuple:
    """Launch the backward kernel, once for both gradients: (g_coeffs
    (..., n_bases) or None, g_x (...,) or None) as ``need_coeffs`` and
    ``need_x`` say.  ``table_d1`` is the table of the x-derivative, None at
    the top tabulated order (g_x is then written as zeros); ``coeffs`` may
    be None when g_x is not asked for."""
    global launches_bwd
    _check(table_d, coeffs, x, grad)
    if need_x and table_d1 is not None and coeffs is None:
        raise ValueError("g_x needs the coefficients")
    if table_d1 is not None and (table_d1.shape != table_d.shape
                                 or table_d1.device != x.device
                                 or table_d1.dtype != torch.float32):
        raise ValueError("the order-(d+1) table must match the order-d "
                         f"table, got {tuple(table_d1.shape)}")
    if not (need_coeffs or need_x):
        return None, None
    table_d, x, grad = _dense(table_d), _dense(x), _dense(grad)
    if coeffs is not None:
        coeffs = _dense(coeffs)
    if table_d1 is not None:
        table_d1 = _dense(table_d1)
    N = x.numel()
    n_mesh, n_bases = table_d.shape
    # (two allocations: views of one buffer cost the host three times as much)
    g_coeffs = (x.new_empty(x.shape + (n_bases,)) if need_coeffs
                else None)
    g_x = torch.empty_like(x) if need_x else None
    if N == 0:
        return g_coeffs, g_x
    p = plan(N, n_bases, True, lanes)
    lib = cuda_build.bind('spline_eval', SIGNATURES)
    err = lib.spline_eval_bwd_launch(
        table_d.data_ptr(), None if table_d1 is None else table_d1.data_ptr(),
        None if coeffs is None else coeffs.data_ptr(), x.data_ptr(),
        grad.data_ptr(), g_coeffs.data_ptr() if need_coeffs else None,
        g_x.data_ptr() if need_x else None,
        N, n_mesh, n_bases, p.group, p.grid,
        int(step_d) | 2 * int(step_d1),
        cuda_build.current_stream(x.device.index))
    launches_bwd += 1
    _raise_on(err, lib, 'spline_eval_bwd')
    return g_coeffs, g_x


@functools.lru_cache(maxsize=64)
def _terms_array(terms: tuple):
    return (ctypes.c_int * (3 * len(terms)))(
        *(int(v) for term in terms for v in term))


def spline_eval_jet_cuda(records: torch.Tensor, comps, x: torch.Tensor,
                         terms, n_bases: int,
                         threads: int | None = None) -> list:
    """Launch the jet entry: ``records`` (n_cells, n_orders, 2, n_pad) from
    ``cell_records``, up to 4 coefficient components (..., n_bases) and x
    (...,) f32 on the card, ``terms`` a sequence of distinct (m, d, step)
    -> n_terms tensors (...,), each allocated as a per-call launch
    allocates its output: out[t] = Σ_i comps[m_t][..., i] · B_i(x), B the
    lerp of order d_t or, with step, its slope at the cell."""
    global launches_jet
    terms = tuple((int(m), int(d), bool(st)) for m, d, st in terms)
    if not x.is_cuda:
        raise ValueError("the spline_eval kernels need their operands on "
                         "one CUDA device")
    if records.ndim != 4 or records.shape[2] != 2 \
            or records.shape[3] != -(-n_bases // CHUNK) * CHUNK:
        raise ValueError(f"records {tuple(records.shape)} are not the cell "
                         f"records of {n_bases} bases")
    for a in (records, x, *comps):
        if a.device != x.device or a.dtype != torch.float32:
            raise ValueError("the jet entry takes float32 operands on one "
                             "CUDA device")
    if any(c.shape != x.shape + (n_bases,) for c in comps):
        raise ValueError(f"components {[tuple(c.shape) for c in comps]} do "
                         f"not match x {tuple(x.shape)} and {n_bases} bases")
    n_cells, n_orders = records.shape[:2]
    if len(set(terms)) != len(terms) or any(
            not (0 <= m < len(comps) and 0 <= d < n_orders)
            for m, d, _ in terms):
        raise ValueError(f"terms {terms} name a component or order that is "
                         "not there, or repeat")
    N = x.numel()
    out = [torch.empty_like(x) for _ in terms]
    if N == 0:
        return out
    p = plan_jet(N, n_bases, len(terms), len(comps), n_orders, threads)
    records, x = _dense(records), _dense(x)
    comps = [_dense(c) for c in comps]
    ptrs = [c.data_ptr() for c in comps] + [None] * (JET_COMPONENTS
                                                     - len(comps))
    lib = cuda_build.bind('spline_eval', SIGNATURES)
    err = lib.spline_eval_jet_launch(
        records.data_ptr(), *ptrs, x.data_ptr(),
        (ctypes.c_void_p * len(out))(*(o.data_ptr() for o in out)),
        _terms_array(terms), len(terms), N, n_cells, n_bases, n_orders,
        p.group, p.threads, p.grid, cuda_build.current_stream(x.device.index))
    launches_jet += 1
    _raise_on(err, lib, 'spline_eval_jet')
    return out


def _bwd_jet_arrays(c_groups, x_terms, n_vecs, n_comps):
    """The C entry's term arrays of a launch, checked: (c quintuples, x
    quadruples, n_c, n_x)."""
    c_terms = []
    for group in c_groups:
        if not group:
            raise ValueError("an empty group of g_c terms")
        for j, (factors, d, step) in enumerate(group):
            if len(factors) not in (1, 2) or not all(
                    0 <= a < n_vecs for a in factors):
                raise ValueError(f"a g_c term's factors {factors} are not one "
                                 f"or two of {n_vecs} vectors")
            b = factors[1] if len(factors) == 2 else -1
            c_terms.append((factors[0], b, int(d), int(bool(step)),
                            int(j == 0)))
    x_quads = []
    for v, m, d, step in x_terms:
        if not (0 <= v < n_vecs and (d is None or 0 <= m < n_comps)):
            raise ValueError(f"a g_x term ({v}, {m}) names a vector or "
                             "component that is not there")
        x_quads.append((v, m, -1 if d is None else int(d), int(bool(step))))
    return tuple(c_terms), tuple(x_quads)


@functools.lru_cache(maxsize=64)
def _bwd_jet_c_arrays(c_terms: tuple, x_quads: tuple):
    return ((ctypes.c_int * max(1, 5 * len(c_terms)))(
        *(v for q in c_terms for v in q)),
            (ctypes.c_int * max(1, 4 * len(x_quads)))(
        *(v for q in x_quads for v in q)))


def spline_eval_bwd_jet_cuda(records: torch.Tensor, comps, x: torch.Tensor,
                             vecs, c_groups, x_terms, n_bases: int,
                             threads: int | None = None) -> tuple:
    """Launch the backward jet entry: ``records`` (n_cells, n_orders, 2,
    n_pad) from ``cell_records``, up to 2 coefficient components (...,
    n_bases), x and up to 6 weight vectors (...,), f32 on the card;
    ``c_groups`` and ``x_terms`` as ``spline_eval_bwd_jet_plain`` takes
    them -> (g_c (..., n_bases) or None, g_x (...,) or None), each
    allocated as a per-call launch allocates it."""
    global launches_bwd_jet
    if not x.is_cuda:
        raise ValueError("the spline_eval kernels need their operands on "
                         "one CUDA device")
    if records.ndim != 4 or records.shape[2] != 2 \
            or records.shape[3] != -(-n_bases // CHUNK) * CHUNK:
        raise ValueError(f"records {tuple(records.shape)} are not the cell "
                         f"records of {n_bases} bases")
    for a in (records, x, *comps, *vecs):
        if a.device != x.device or a.dtype != torch.float32:
            raise ValueError("the backward jet entry takes float32 operands "
                             "on one CUDA device")
    if any(c.shape != x.shape + (n_bases,) for c in comps) \
            or any(v.shape != x.shape for v in vecs):
        raise ValueError(f"components {[tuple(c.shape) for c in comps]} and "
                         f"vectors {[tuple(v.shape) for v in vecs]} do not "
                         f"match x {tuple(x.shape)} and {n_bases} bases")
    n_cells, n_orders = records.shape[:2]
    c_terms, x_quads = _bwd_jet_arrays(c_groups, x_terms, len(vecs),
                                       len(comps))
    if any(not 0 <= q[2] < n_orders for q in c_terms) \
            or any(q[2] >= n_orders for q in x_quads):
        raise ValueError(f"a term names an order the records ({n_orders}) "
                         "do not hold")
    N = x.numel()
    g_c = x.new_empty(x.shape + (n_bases,)) if c_terms else None
    g_x = torch.empty_like(x) if x_quads else None
    p = plan_bwd_jet(max(N, 1), n_bases, len(c_terms), len(x_quads),
                     len(vecs), len(comps) if x_quads else 0, threads)
    if N == 0:
        return g_c, g_x
    records, x = _dense(records), _dense(x)
    comps = [_dense(c) for c in comps]
    vecs = [_dense(v) for v in vecs]
    cp = [c.data_ptr() for c in comps] + [None] * (BWD_COMPONENTS
                                                   - len(comps))
    c_arr, x_arr = _bwd_jet_c_arrays(c_terms, x_quads)
    lib = cuda_build.bind('spline_eval', SIGNATURES)
    err = lib.spline_eval_bwd_jet_launch(
        records.data_ptr(), *cp, x.data_ptr(),
        (ctypes.c_void_p * len(vecs))(*(v.data_ptr() for v in vecs)),
        len(vecs), c_arr, len(c_terms), x_arr, len(x_quads),
        None if g_c is None else g_c.data_ptr(),
        None if g_x is None else g_x.data_ptr(), N, n_cells, n_bases,
        n_orders, p.group, p.threads, p.grid,
        cuda_build.current_stream(x.device.index))
    launches_bwd_jet += 1
    _raise_on(err, lib, 'spline_eval_bwd_jet')
    return g_c, g_x


def _check_plain(coeffs: torch.Tensor, x: torch.Tensor) -> None:
    if x.shape != coeffs.shape[:-1]:
        raise ValueError(f"x {tuple(x.shape)} does not match the batch of "
                         f"coeffs {tuple(coeffs.shape)}")


def spline_eval(table: torch.Tensor, coeffs: torch.Tensor,
                x: torch.Tensor, step: bool = False) -> torch.Tensor:
    """K4 on a CUDA tensor, its plain gather-lerp on a CPU tensor: coeffs
    (..., n_bases), x (...,) -> (...,)."""
    if x.is_cuda:
        return spline_eval_cuda(table, coeffs, x, step)
    _check_plain(coeffs, x)
    return spline_eval_plain(table, coeffs, x, step)


def spline_eval_pair(table_a: torch.Tensor, table_b: torch.Tensor,
                     coeffs: torch.Tensor, x: torch.Tensor,
                     step_a: bool = False, step_b: bool = False) -> tuple:
    """K4's pair entry on a CUDA tensor, two plain gather-lerps on a CPU
    tensor: (y_a, y_b), each (...,)."""
    if x.is_cuda:
        return spline_eval_pair_cuda(table_a, table_b, coeffs, x, step_a,
                                     step_b)
    _check_plain(coeffs, x)
    return (spline_eval_plain(table_a, coeffs, x, step_a),
            spline_eval_plain(table_b, coeffs, x, step_b))


def spline_eval_bwd(table_d: torch.Tensor, table_d1: torch.Tensor | None,
                    coeffs: torch.Tensor | None, x: torch.Tensor,
                    grad: torch.Tensor, need_coeffs: bool = True,
                    need_x: bool = True, step_d: bool = False,
                    step_d1: bool = False) -> tuple:
    """K4's backward kernel on a CUDA tensor, its plain version on a CPU
    tensor: (g_coeffs or None, g_x or None)."""
    if x.is_cuda:
        return spline_eval_bwd_cuda(table_d, table_d1, coeffs, x, grad,
                                    need_coeffs, need_x, step_d, step_d1)
    g_coeffs, g_x = spline_eval_bwd_plain(table_d, table_d1, coeffs, x, grad,
                                          step_d, step_d1)
    return (g_coeffs if need_coeffs else None, g_x if need_x else None)


def spline_eval_jet(tables: torch.Tensor, slopes: torch.Tensor,
                    records: torch.Tensor, comps, x: torch.Tensor,
                    terms) -> list:
    """K4's jet entry on a CUDA tensor (from the cell records), its plain
    version on a CPU tensor (from the value and slope tables): n_terms
    tensors (...,)."""
    if x.is_cuda:
        return spline_eval_jet_cuda(records, comps, x, terms,
                                    tables.shape[-1])
    for c in comps:
        _check_plain(c, x)
    return spline_eval_jet_plain(tables, slopes, comps, x, terms)


def spline_eval_bwd_jet(tables: torch.Tensor, slopes: torch.Tensor,
                        records: torch.Tensor, comps, x: torch.Tensor, vecs,
                        c_groups, x_terms) -> tuple:
    """K4's backward jet entry on a CUDA tensor (from the cell records),
    its plain version on a CPU tensor (from the value and slope tables):
    (g_c or None, g_x or None)."""
    if x.is_cuda:
        return spline_eval_bwd_jet_cuda(records, comps, x, vecs, c_groups,
                                        x_terms, tables.shape[-1])
    for c in comps:
        _check_plain(c, x)
    return spline_eval_bwd_jet_plain(tables, slopes, comps, x, vecs,
                                     c_groups, x_terms)
