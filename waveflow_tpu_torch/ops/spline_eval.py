"""Table-backed spline evaluation.

Port of waveflow_tpu/ops/spline_eval.py.  The tables serve the ancestral
samplers (``density_on_mesh``, and the transposed table that kernels K1 and
K2 read), the exact table inverse of the IMADE layers (``density_on_mesh``
/ ``at_nodes``), the boundary projector (``left`` / ``right``) and the
table-lerp evaluation ``__call__``, which the density model's M-spline
prior uses.  ``__call__`` differentiates as the JAX custom-JVP chain does:
the x-derivative of the order-d evaluation is the order-(d+1) table
evaluation, not the slope of the lerp.  On the card both directions are
kernel K4 (csrc/spline_eval.cu): one launch for the value, and one launch
of its fused backward kernel for both gradients — no plain PyTorch
arithmetic runs on a CUDA tensor — and so under ``torch.func.vmap`` too
(the parameter posterior's chains, vmc/hmc.py), where both directions
fold the vmapped dimension into the kernel's rows.  The fused ``pair``
chain serves only IMADE's ``eval_backend='table'`` and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.ops.cuda_spline import (lerp_basis, spline_eval,
                                                spline_eval_bwd)
from waveflow_tpu_torch.ops.spline_tables import SplineTables


def _batch_first(a: torch.Tensor, dim, size: int) -> torch.Tensor:
    """The vmapped dimension of ``a`` moved to the front, or ``a`` expanded
    to the batch when it is not batched."""
    if dim is None:
        return a.expand((size,) + a.shape)
    return a.movedim(dim, 0)


class _TableEval(torch.autograd.Function):
    """Σ_i coeffs_i T_i^{(d)}(x) by table lerp, with the derivative chain of
    the JAX evaluator: d/dx is the order-(d+1) evaluation (zero at the top
    tabulated order), d/dcoeffs the lerped basis.  First-order reverse
    mode, which is what likelihood training and the parameter posterior's
    gradients need.  On CUDA tensors the forward is one launch of K4 and
    the backward one launch of its backward kernel, whichever gradients
    are asked for.  Under ``torch.func.vmap`` (a batch of parameter
    vectors, vmc/hmc.py::make_parameter_posterior) the vmapped dimension
    folds into the rows: one launch for every chain, and the backward
    (``_TableEvalBwd``) folds the same way, so ``vmap(grad(...))`` too is
    one launch each way."""

    @staticmethod
    def forward(coeffs, x, tables, d):
        return spline_eval(tables[d], coeffs, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        coeffs, x, tables, d = inputs
        ctx.save_for_backward(coeffs, x)
        ctx.tables, ctx.d = tables, d

    @staticmethod
    def backward(ctx, grad):
        coeffs, x = ctx.saved_tensors
        g_coeffs, g_x = _TableEvalBwd.apply(
            coeffs, x, grad, ctx.tables, ctx.d, ctx.needs_input_grad[0],
            ctx.needs_input_grad[1])
        return g_coeffs, g_x, None, None

    @staticmethod
    def vmap(info, in_dims, coeffs, x, tables, d):
        n = info.batch_size
        out = _TableEval.apply(_batch_first(coeffs, in_dims[0], n),
                               _batch_first(x, in_dims[1], n), tables, d)
        return out, 0


class _TableEvalBwd(torch.autograd.Function):
    """The backward of ``_TableEval`` as a Function of its own, so that it
    too has a vmap rule: under ``vmap(grad(...))`` the grad level sits
    inside the vmap level and the backward receives batched tensors, which
    the kernel cannot take; the rule folds the vmapped dimension into the
    rows and launches the backward kernel once.  Not differentiable
    (first order only)."""

    @staticmethod
    def forward(coeffs, x, grad, tables, d, need_coeffs, need_x):
        table_d1 = tables[d + 1] if d + 1 < tables.shape[0] else None
        return spline_eval_bwd(tables[d], table_d1, coeffs, x, grad,
                               need_coeffs, need_x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g_coeffs, g_x):
        raise RuntimeError("the spline evaluation is differentiable once")

    @staticmethod
    def vmap(info, in_dims, coeffs, x, grad, tables, d, need_coeffs,
             need_x):
        n = info.batch_size
        out = _TableEvalBwd.apply(
            _batch_first(coeffs, in_dims[0], n),
            _batch_first(x, in_dims[1], n),
            _batch_first(grad, in_dims[2], n), tables, d, need_coeffs,
            need_x)
        return out, tuple(None if g is None else 0 for g in out)


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
        return _TableEval.apply(coeffs, x, self.tables, d)

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
