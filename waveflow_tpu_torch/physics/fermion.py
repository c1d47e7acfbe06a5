"""Fermionic coordinate handling: inversion counts, parity, gap maps.

Port of waveflow_tpu/physics/fermion.py (``inversion_count``, ``parity``,
``sort_and_parity``, ``antisymmetrize``, ``abs2rel``, ``rel2abs``).  The inversion count is one
O(n²) pairwise comparison per row, on the tensor's device.
"""

from __future__ import annotations

import torch


def inversion_count(x: torch.Tensor) -> torch.Tensor:
    """Inversions needed to sort each row ascending: pairs (i, j) with
    i < j and x_i > x_j.  (batch, n) -> (batch,) int32."""
    n = x.shape[-1]
    gt = x[..., :, None] > x[..., None, :]                  # (B, n, n)
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=x.device), diagonal=1)
    return (gt & upper).sum((-1, -2)).to(torch.int32)


def parity(x: torch.Tensor) -> torch.Tensor:
    """(-1)^inversions per row: (batch,) float32."""
    return torch.where(inversion_count(x) % 2 == 0, 1.0, -1.0)


def sort_and_parity(x: torch.Tensor):
    """Sorted coordinates and the sign of the sorting permutation."""
    return torch.sort(x, dim=-1).values, parity(x)


def antisymmetrize(psi_fn):
    """ψ defined on the sorted sector -> the full antisymmetric ψ:
    ψ_A(x) = sign(sort permutation) · ψ(sort(x)).  ``psi_fn(x)`` takes
    (batch, n) coordinates (the JAX form takes the parameters first)."""

    def psi_a(x: torch.Tensor) -> torch.Tensor:
        xs, sgn = sort_and_parity(x)
        return sgn * psi_fn(xs)

    return psi_a


def abs2rel(coords: torch.Tensor) -> torch.Tensor:
    """Sorted absolute -> gap coordinates."""
    return torch.diff(coords, dim=-1,
                      prepend=torch.zeros_like(coords[..., :1]))


def rel2abs(rel: torch.Tensor) -> torch.Tensor:
    """Gap -> absolute coordinates."""
    return torch.cumsum(rel, dim=-1)
