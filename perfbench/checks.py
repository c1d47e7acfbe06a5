"""The numbers that decide ``correct``: the program's outputs against the
plain reference's (reference/), each a gap that its limit in
limits/<workload>.json bounds.

Training (the first steps of the very trainer the window then drives;
the reference steps at the program's walkers):
  * ``sample_dx``: the first step's walkers against the reference's draw
    from the same weights and uniforms, the widest |x − x_ref| as a share
    of the box (2L);
  * ``loss_gap``: the widest |loss − reference loss| over the steps, in
    units of that step's clip statistic (the reference's mean |E_L −
    median|); ``loss_gap_first``: the first step's alone;
  * ``grad_gap``: the first step's clipped gradient as Adam holds it after
    one step (its first moment over 1 − β₁), by the worst leaf:
    | ‖g‖ − ‖g_ref‖ | over the larger of the leaf's ‖g_ref‖ and the median
    leaf's; ``grad_gap_median``: the median leaf's;
  * ``change_gap``, ``change_gap_median``: the parameters' change after the
    steps, by the worst and the median leaf, the same way; leaves whose
    reference gradient is under a thousandth of the median leaf's (nought to
    rounding: they move under Adam by round-off alone) are left out.

limits/<workload>.json names the numbers a cell compares (PERF.md gives
each limit with the readings it was set from); the others are printed by
calibrate.py only.
"""

from __future__ import annotations

import numpy as np
import torch


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """| ‖prog‖ − ‖ref‖ | over the larger of the leaf's ‖ref‖ and the
    median leaf's, for each leaf of ``keys``."""
    floor = float(np.median([ref[k] for k in keys]))
    return [abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys]


def draw_gap(x: torch.Tensor, x_ref: torch.Tensor, box_length: float) -> float:
    return float((x.double() - x_ref.double()).abs().max()) / (2 * box_length)


def train_numbers(losses, grad1: dict, change: dict, ref_losses, ref_mads,
                  ref_grad1: dict, ref_change: dict) -> dict:
    g, g_ref = _norms(grad1), _norms(ref_grad1)
    floor = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * floor]
    g_gaps = _leaf_gaps(g, g_ref, list(g_ref))
    c_gaps = _leaf_gaps(_norms(change), _norms(ref_change), moved)
    return {'loss_gap': max(abs(a - b) / m
                            for a, b, m in zip(losses, ref_losses, ref_mads)),
            'loss_gap_first': abs(losses[0] - ref_losses[0]) / ref_mads[0],
            'grad_gap': max(g_gaps),
            'grad_gap_median': float(np.median(g_gaps)),
            'change_gap': max(c_gaps),
            'change_gap_median': float(np.median(c_gaps))}

