"""Bytes and operations of the port's kernels, worked out from the
configuration's shapes (never read from the program), and their roofline
bound: the larger of bytes over the memory bandwidth and operations over
the f32 rate of peaks.json.  Each input byte is counted read once and each
output byte written once."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / 'peaks.json').read_text())


def peaks(device_kind: str):
    """The peaks of the card, or None for a card the table does not hold."""
    return PEAKS.get(device_kind)


def bound_s(n_bytes: float, n_ops: float, device_kind: str):
    p = peaks(device_kind)
    if p is None:
        return None
    return max(n_bytes / p['hbm_bytes_per_s'], n_ops / p['f32_flop_per_s'])


def shapes(cfg: dict) -> dict:
    """The widths the kernels see: coordinates, spline bases, cells,
    polynomial coefficients, mesh points."""
    degree, knots = cfg['spline_degree'], cfg['num_knots']
    n_b = knots + degree - 1                       # B-spline (and OB) bases
    return {'D': cfg['n_electrons'] * cfg['n_space_dimension'],
            'n_B': n_b, 'n_I': n_b + 1, 'n_cells': knots - 1,
            'ncoef': degree + 2, 'n_mesh': cfg['n_spline_base_mesh_points'],
            'layers': cfg['n_flow_layers'], 'hidden': cfg['hidden_dim']}
