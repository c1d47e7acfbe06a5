"""Table-backed spline evaluation: the subset the main path uses.

Port of waveflow_tpu/ops/spline_eval.py.  On the main path the tables
serve the ancestral sampler (``density_on_mesh``, and the transposed
table that kernel K1 reads), the exact table inverse of the IMADE layers
(``density_on_mesh`` / ``at_nodes``) and the boundary projector
(``left`` / ``right``).  The table-lerp ``__call__`` / ``pair`` custom-JVP
chains serve only ``eval_backend='table'`` and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.ops.spline_tables import SplineTables


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
