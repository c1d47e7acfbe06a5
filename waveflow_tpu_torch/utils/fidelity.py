"""Wavefunction fidelity: the discrete L2 overlap of a trained ψ with an
exact-diagonalization ground state.

Port of waveflow_tpu/utils/fidelity.py.  Energies are stationary in ψ at
the variational minimum, so energy agreement alone can hide wavefunction
errors; |⟨ψ_VMC|ψ_ED⟩| is the stricter check.  Overlaps are taken on the
ED grid in the sorted sector, with the sector multiplicity (n! images of
each ordered point) in the normalization, as physics/exact.py normalizes
(2 Σ ψ² h² = 1 for pairs, 6 Σ ψ² h³ = 1 for triples).

``psi`` is a callable on (B, D) float32 coordinates, such as
``trainer.model.psi``; it runs without gradients, in blocks of ``block``
points, on ``device`` (where the model lives; the card unless the caller
asks for the CPU).  The overlaps are numpy, operation for operation as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _overlap(psi_vmc: np.ndarray, psi_ed: np.ndarray, cell: float,
             multiplicity: float) -> float:
    pv = psi_vmc / np.sqrt(multiplicity * (psi_vmc ** 2).sum() * cell)
    pe = psi_ed / np.sqrt(multiplicity * (psi_ed ** 2).sum() * cell)
    return float(abs(multiplicity * (pv * pe).sum() * cell))


@torch.no_grad()
def evaluate_blocks(psi, coords: np.ndarray, block: int = 65536,
                    device='cuda') -> np.ndarray:
    """ψ at ``coords`` (N, D), ``block`` rows per call on ``device``: a
    float32 numpy array (N,)."""
    out = []
    for i in range(0, len(coords), block):
        x = torch.as_tensor(np.asarray(coords[i:i + block], np.float32),
                            device=device)
        out.append(psi(x).cpu().numpy())
    return np.concatenate(out)


def fidelity_2p(psi, psi_pairs: np.ndarray, x: np.ndarray,
                block: int = 65536, device='cuda') -> float:
    """|⟨ψ_VMC|ψ_ED⟩| for two 1D fermions; ``psi_pairs`` / ``x`` from
    ``physics.exact.exact_ground_state_2p``, ψ evaluated on the sorted
    pairs (x_i < x_j)."""
    n, h = len(x), x[1] - x[0]
    i, j = np.triu_indices(n, k=1)
    coords = np.stack([x[i], x[j]], -1)
    vals = evaluate_blocks(psi, coords, block, device)
    return _overlap(vals, psi_pairs, h * h, 2.0)


def fidelity_3p(psi, psi_triples: np.ndarray, x: np.ndarray,
                block: int = 65536, device='cuda') -> float:
    """|⟨ψ_VMC|ψ_ED⟩| for three 1D fermions; ``psi_triples`` / ``x`` from
    ``physics.exact.exact_ground_state_3p`` (ordered triples i < j < k)."""
    n, h = len(x), x[1] - x[0]
    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                          indexing='ij')
    mask = (i < j) & (j < k)
    coords = np.stack([x[i[mask]], x[j[mask]], x[k[mask]]], -1)
    vals = evaluate_blocks(psi, coords, block, device)
    return _overlap(vals, psi_triples, h ** 3, 6.0)


def fidelity_2d_2e(psi, psi_pairs: np.ndarray, sites: np.ndarray,
                   x: np.ndarray, block: int = 65536, device='cuda') -> float:
    """|⟨ψ_VMC|ψ_ED⟩| for two fermions in the 2D box; ``psi_pairs`` /
    ``sites`` / ``x`` from ``physics.exact.exact_ground_state_2d_2e`` (the
    antisymmetric site-pair basis a < b, normalized 2 Σ ψ² h⁴ = 1).

    Each pair is evaluated with its electrons ordered by x, in the
    interleaved layout (x1, y1, x2, y2), with the exchange sign where that
    order disagrees with the site order (a no-op for the lexicographic
    sites the ED produces).  ``psi_pairs`` (m,) is one ED state; (m, k) is
    an orthonormal basis of a (near-)degenerate ground subspace, and the
    subspace fidelity √(Σᵢ ⟨ψ|eᵢ⟩²) is returned — 2D He's lowest
    antisymmetric level is doubly degenerate (the square box's x↔y
    symmetry), so it needs k = 2."""
    n = len(x)
    h = x[1] - x[0]
    a, b = np.triu_indices(n * n, k=1)
    r1, r2 = sites[a], sites[b]                       # (m, 2) each
    swap = r1[:, 0] > r2[:, 0]
    lo = np.where(swap[:, None], r2, r1)
    hi = np.where(swap[:, None], r1, r2)
    coords = np.concatenate([lo, hi], axis=1)
    sign = np.where(swap, -1.0, 1.0)
    vals = sign * evaluate_blocks(psi, coords, block, device)
    psi_pairs = np.asarray(psi_pairs)
    if psi_pairs.ndim == 1:
        return _overlap(vals, psi_pairs, h ** 4, 2.0)
    return float(np.sqrt(sum(
        _overlap(vals, psi_pairs[:, i], h ** 4, 2.0) ** 2
        for i in range(psi_pairs.shape[1]))))


def fidelity_2d_1e(psi, psi_grid: np.ndarray, x: np.ndarray,
                   block: int = 65536, device='cuda') -> float:
    """|⟨ψ_VMC|ψ_ED⟩| for one electron in the 2D box; ``psi_grid`` / ``x``
    from ``physics.exact.exact_ground_state_2d_1e``."""
    h = x[1] - x[0]
    xx, yy = np.meshgrid(x, x, indexing='ij')
    coords = np.stack([xx, yy], -1).reshape(-1, 2)
    vals = evaluate_blocks(psi, coords, block, device)
    return _overlap(vals, psi_grid.ravel(), h * h, 1.0)
