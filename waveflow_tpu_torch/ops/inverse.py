"""Exact inverse of the monotone table-interpolated spline.

Port of waveflow_tpu/ops/inverse.py, every method.  The runtime table
spline is piecewise linear in x over the mesh, so its inverse is
closed-form: locate the bracketing cell, solve the in-cell linear
equation.  Two exact forms give the same result:

* dense (``exact_table_inverse``): every mesh node at once, one
  (batch, n_bases) @ (n_bases, n_mesh) matmul and one compare-count —
  fewest kernels, wins at small batch;
* node bisection (``exact_node_bisect_inverse``): ceil(log2 n_cells)
  rounds of one row-gather + dot — no (batch, n_mesh) intermediate, wins
  once the batch makes the step bandwidth-bound.

``bisection_inverse`` ('bisect') needs the evaluator alone: a fixed number
of bisection steps and Newton steps on ``evaluator(coeffs, x)`` (kernel K4
on the card), no data-dependent trip count, so a CUDA graph can hold it.
"""

from __future__ import annotations

import math

import torch

from waveflow_tpu_torch.ops.spline_eval import SplineEvaluator

# above this many (batch x n_mesh) elements the node-bisection form is used:
# on CPU tensors the JAX package's crossover (measured on a TPU v5e); on
# CUDA tensors the crossover measured on an H100 at the IMADE inverse's
# shapes by examples/kernel_sweep_torch.py --only inverse (2000-point mesh:
# dense faster through 65,536 walkers, bisection from 131,072)
DENSE_INVERSE_MAX_ELEMENTS = 2 ** 23
DENSE_INVERSE_MAX_ELEMENTS_CUDA = 2 ** 27


def _in_cell_solve(j, g_l, g_r, y, n_cells):
    slope = g_r - g_l
    s = torch.clamp((y - g_l) / torch.where(slope.abs() < 1e-20,
                                            torch.ones_like(slope), slope),
                    0.0, 1.0)
    return (j + s) / n_cells


def exact_table_inverse(evaluator: SplineEvaluator, coeffs: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """Dense exact inverse: coeffs (..., n_bases), y (...,) -> x (...,)."""
    g = evaluator.density_on_mesh(coeffs)                  # (..., P) nondecr.
    P = g.shape[-1]
    j = (g <= y[..., None]).sum(-1)
    j = torch.clamp(j - 1, 0, P - 2)
    g_l = torch.gather(g, -1, j[..., None])[..., 0]
    g_r = torch.gather(g, -1, (j + 1)[..., None])[..., 0]
    return _in_cell_solve(j, g_l, g_r, y, P - 1)


def exact_node_bisect_inverse(evaluator: SplineEvaluator,
                              coeffs: torch.Tensor,
                              y: torch.Tensor) -> torch.Tensor:
    """Exact inverse via bisection on the mesh-node index (same result as
    exact_table_inverse without the (batch, n_mesh) intermediate)."""
    n_cells = evaluator.n_mesh - 1
    lo = torch.zeros(y.shape, dtype=torch.long, device=y.device)
    hi = torch.full(y.shape, n_cells, dtype=torch.long, device=y.device)
    for _ in range(int(math.ceil(math.log2(max(n_cells, 2))))):
        mid = (lo + hi) >> 1
        gt = evaluator.at_nodes(coeffs, mid) > y
        hi = torch.where(gt & (mid > lo), mid, hi)
        lo = torch.where(gt | (mid == lo), lo, mid)
    g_l = evaluator.at_nodes(coeffs, lo)
    g_r = evaluator.at_nodes(coeffs, lo + 1)
    return _in_cell_solve(lo, g_l, g_r, y, n_cells)


def bisection_inverse(evaluator: SplineEvaluator, coeffs: torch.Tensor,
                      y: torch.Tensor, n_bisect: int = 30,
                      n_newton: int = 2) -> torch.Tensor:
    """Fixed-iteration bisection + Newton polish (the evaluator-only
    method): ``n_bisect`` + 2 · ``n_newton`` evaluations."""
    lo, hi = torch.zeros_like(y), torch.ones_like(y)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        gt = evaluator(coeffs, mid) > y
        lo, hi = torch.where(gt, lo, mid), torch.where(gt, mid, hi)
    x = 0.5 * (lo + hi)
    for _ in range(n_newton):
        fx = evaluator(coeffs, x)
        dfx = evaluator(coeffs, x, d=1)
        x = torch.minimum(torch.maximum(
            x - (fx - y) / torch.clamp(dfx, min=1e-12), lo), hi)
    return x


INVERSE_METHODS = ('exact', 'exact_dense', 'exact_bisect', 'bisect')


def batched_monotone_inverse(evaluator: SplineEvaluator,
                             coeffs: torch.Tensor, y: torch.Tensor,
                             n_bisect: int = 30, n_newton: int = 2,
                             method: str = 'exact') -> torch.Tensor:
    """Solve f(x) = y for x in [0,1], f monotone increasing per sample.

    coeffs (..., n_bases), y (...,) -> x (...,).  ``method='exact'`` picks
    the dense form up to DENSE_INVERSE_MAX_ELEMENTS (batch x n_mesh)
    elements on the CPU, DENSE_INVERSE_MAX_ELEMENTS_CUDA on the card, node
    bisection above; 'exact_dense' and 'exact_bisect' force one form;
    'bisect' is ``bisection_inverse``."""
    if method not in INVERSE_METHODS:
        raise ValueError(f"unknown inverse method {method!r}; one of "
                         f"{INVERSE_METHODS}")
    if method == 'exact':
        limit = (DENSE_INVERSE_MAX_ELEMENTS_CUDA if y.is_cuda
                 else DENSE_INVERSE_MAX_ELEMENTS)
        method = ('exact_bisect' if y.numel() * evaluator.n_mesh > limit
                  else 'exact_dense')
    if method == 'exact_dense':
        return exact_table_inverse(evaluator, coeffs, y)
    if method == 'exact_bisect':
        return exact_node_bisect_inverse(evaluator, coeffs, y)
    return bisection_inverse(evaluator, coeffs, y, n_bisect=n_bisect,
                             n_newton=n_newton)
