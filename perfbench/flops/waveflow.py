"""Model FLOPs of the square-flow ψ, from the configuration's widths: the
multiply-adds the algorithm needs, counted once here and never by a
counter over the program, so that they stay the same whatever a later
change implements.  FLOPs = 2 × multiply-adds.

Per walker, one forward ψ (F):
  * each IMADE layer: its masked MLP (D·H + H·H + H·D·n_I, dense), the
    boundary projection (D·n_I²), the I-spline value and derivative
    polynomials (D · 2 · n_I · ncoef) and their weight dots (D · 2 · n_I);
  * the prior: its MLP (D·H + H·H + H·D·n_B), the projection and the basis
    change (2 · D · n_B²), the amplitude polynomial (D · n_B · ncoef) and its
    dot (D · n_B).
Per walker, one ancestral draw (S): for each of the D coordinates the
prior's MLP, projection and basis change, the amplitude on the n_mesh
points (n_B · n_mesh) and the cell masses and scan (4 n_mesh); then each
IMADE layer inverted coordinate by coordinate: its MLP, projection, the
I-spline on the mesh (n_I · n_mesh) and a Newton step (3 · n_I · ncoef).

A train epoch ('clipped_score', 'fwd_batched'): B (S + 3F + 4·D·F) + 5 P:
the score's forward and backward (3F), the Laplacian by nested
forward-mode derivatives, one coordinate at a time (each pass carrying the
primal and three tangents: 4F), and Adam with the clip (5 per parameter).
"""

from __future__ import annotations

from perfbench.kernels import shapes


def _mlp(s, n_out):
    D, H = s['D'], s['hidden']
    return D * H + H * H + H * D * n_out


def psi_forward(s) -> int:
    D, nI, nB, c = s['D'], s['n_I'], s['n_B'], s['ncoef']
    imade = _mlp(s, nI) + D * nI * nI + D * 2 * nI * c + D * 2 * nI
    prior = _mlp(s, nB) + 2 * D * nB * nB + D * nB * c + D * nB
    return s['layers'] * imade + prior


def draw(s) -> int:
    D, nI, nB, c, P = s['D'], s['n_I'], s['n_B'], s['ncoef'], s['n_mesh']
    prior = D * (_mlp(s, nB) + 2 * nB * nB + nB * P + 4 * P)
    inverse = s['layers'] * D * (_mlp(s, nI) + nI * nI + nI * P + 3 * nI * c)
    return prior + inverse


def n_params(s) -> int:
    D, H = s['D'], s['hidden']

    def conditioner(n_out):
        return (D * H + H) + (H * H + H) + (H * D * n_out + D * n_out) + D * n_out
    return s['layers'] * conditioner(s['n_I']) + conditioner(s['n_B'])


def train_epoch(cfg: dict, B: int) -> int:
    s = shapes(cfg)
    F = psi_forward(s)
    return 2 * (B * (draw(s) + 3 * F + 4 * s['D'] * F) + 5 * n_params(s))

