"""K3, the basis jet (csrc/basis_jet.cu, ``basis_jet_direct`` and
``basis_jet_staged``): at R sites, the spline basis and its derivatives of
orders 0-3 from the local polynomials: W(x) @ A_jet with A_jet of
(n_cells · ncoef) × (4 n_bases).

Per jet at R sites: bytes = 4 (R sites + A_jet + R × 4 n_bases outputs);
operations = 2 R (4 n_bases) ncoef (one multiply-add per output and
coefficient).  ψ at B walkers needs, at its B × D sites, one I-spline jet per
IMADE layer and one OB jet for the prior; the count is of the jets the
algorithm needs at distinct sites (a train epoch: one ψ site set, shared
by the score and the Laplacian), not of the program's launches."""

from __future__ import annotations

from perfbench.kernels import bound_s, shapes

NAME = r'\bbasis_jet_(direct|staged)<'


def jet(R: int, n_bases: int, n_cells: int, ncoef: int):
    """(bytes, operations) of one jet at R sites."""
    n_out = 4 * n_bases
    return 4 * (R + n_cells * ncoef * n_out + R * n_out), 2 * R * n_out * ncoef


def bound_per_site_set(cfg: dict, B: int, device_kind: str):
    """The least device seconds of ψ's jets at one set of B walkers."""
    s = shapes(cfg)
    R = B * s['D']
    total = 0.0
    for n_bases, count in ((s['n_I'], s['layers']), (s['n_B'], 1)):
        t = bound_s(*jet(R, n_bases, s['n_cells'], s['ncoef']), device_kind)
        if t is None:
            return None
        total += count * t
    return total
