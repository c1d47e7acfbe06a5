"""Boundary-condition projection and edge-bias removal for spline weights.

Port of waveflow_tpu/ops/boundary.py.  Per constraint (n, v), applied in
dict order:
  left:  w[n]      = (v - Σ_{j<n} w[j]      · T_j^{(n)}(0)) / T_n^{(n)}(0)
  right: w[-1-n]   = (v - Σ_{j<n} w[-1-j]   · T_{-1-j}^{(n)}(1)) / T_{-1-n}^{(n)}(1)
  I-spline right n=0 special case: requires v == 1 and zeroes the last
  weight.
Followed by sum-normalization (M/I) or L2-normalization (B).  The affine
constraint chain is folded at init (float64, probed on the identity basis)
into one (n_bases, n_bases) matmul plus an offset.
"""

from __future__ import annotations

import numpy as np
import torch

from waveflow_tpu_torch.ops.spline_eval import SplineEvaluator


def make_boundary_projector(evaluator: SplineEvaluator,
                            constraints_left: dict[int, float],
                            constraints_right: dict[int, float],
                            normalization: str = 'sum',
                            ispline_right_convention: bool = False):
    """Build a batched weights -> weights projection closure.

    normalization: 'sum' (M/I splines) or 'l2' (B splines).
    ispline_right_convention: apply the I-spline n=0 right-edge special case.
    """
    left = evaluator.left.double().cpu().numpy()     # (nd, n_bases)
    right = evaluator.right.double().cpu().numpy()
    device = evaluator.tables.device
    n_bases = left.shape[1]

    left_steps = []
    for n, v in constraints_left.items():
        coeff = np.zeros(n_bases, dtype=np.float64)
        coeff[:n] = left[n, :n]
        pivot = float(left[n, n])
        if pivot == 0.0:
            raise ValueError(f"left constraint order {n}: pivot basis value is 0")
        left_steps.append((int(n), float(v), coeff, pivot))

    right_steps = []
    for n, v in constraints_right.items():
        if ispline_right_convention and n == 0:
            if v != 1.0:
                raise ValueError(
                    "I-spline right-edge value constraint must be 1.0")
            right_steps.append(('zero_last', None, None, None))
            continue
        coeff = np.zeros(n_bases, dtype=np.float64)
        for j in range(n):
            coeff[n_bases - 1 - j] = right[n, n_bases - 1 - j]
        pivot = float(right[n, n_bases - 1 - n])
        if pivot == 0.0:
            raise ValueError(f"right constraint order {n}: pivot basis value is 0")
        right_steps.append((int(n), float(v), coeff, pivot))

    def _apply_steps(w: np.ndarray) -> np.ndarray:
        w = w.copy()
        for n, v, coeff, pivot in left_steps:
            w[n] = (v - np.dot(w, coeff)) / pivot
        for step in right_steps:
            if step[0] == 'zero_last':
                w[-1] = 0.0
                continue
            n, v, coeff, pivot = step
            w[n_bases - 1 - n] = (v - np.dot(w, coeff)) / pivot
        return w

    b_vec = _apply_steps(np.zeros(n_bases))
    A_mat = np.stack([_apply_steps(e) for e in np.eye(n_bases)]) - b_vec
    A_t = torch.as_tensor(A_mat.astype(np.float32), device=device)
    b_t = torch.as_tensor(b_vec.astype(np.float32), device=device)
    affine_b = bool(np.any(b_vec != 0.0))

    def project(weights: torch.Tensor) -> torch.Tensor:
        """weights: (..., n_bases) -> constrained + renormalized weights."""
        w = weights @ A_t.to(weights.dtype)
        if affine_b:
            w = w + b_t
        if normalization == 'sum':
            return w / w.sum(-1, keepdim=True)
        if normalization == 'l2':
            return w / torch.sqrt((w ** 2).sum(-1, keepdim=True))
        return w

    return project


def make_bias_remover(n_bases: int, degree: int, kind: str, device=None):
    """Edge-weight de-biasing as a static multiplier vector + sum-normalize
    (the I-spline variant leaves the very first/last weights untouched)."""
    mult = np.ones(n_bases, dtype=np.float32)
    k = degree
    if kind == 'M':
        for i in range(k):
            mult[i] *= (i + 1) / k
            mult[n_bases - 1 - i] *= (i + 1) / k
    elif kind == 'I':
        for i in range(k):
            mult[i + 1] *= (i + 1) / k
            mult[n_bases - 2 - i] *= (i + 1) / k
    else:
        raise ValueError(f"no bias-removal convention for kind {kind!r}")
    mult_t = torch.as_tensor(mult, device=device)

    def remove_bias(weights: torch.Tensor) -> torch.Tensor:
        w = weights * mult_t
        return w / w.sum(-1, keepdim=True)

    return remove_bias
