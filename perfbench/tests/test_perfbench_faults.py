"""A run with its timed path broken underneath must come out not correct:
the whole job (set-up, window, reference, comparison) on the CPU at a test
size, the card's look skipped, each fault the cell can have planted in the
program (perfbench/faults.py), and the cell's own limits applied."""

import pytest
import torch

from perfbench import faults, harness
from perfbench.tests.conftest import TRAIN_TINY, tiny_cell

CPU = torch.device('cpu')
CELLS = ('he1d-train-b256', 'he2d2e-train-b256')


def _verdict(manifest, workload, seed, fault=None):
    cell = tiny_cell(manifest, workload, **TRAIN_TINY)
    undo = faults.plant(fault) if fault else (lambda: None)
    try:
        out = cell.job().run(cell, seed, 0.3, False, CPU, 0.0)
    finally:
        undo()
    return harness.judge(out['numbers'], cell.limits)


@pytest.mark.parametrize('workload', CELLS)
def test_sound_is_correct(manifest, workload):
    correct, checks = _verdict(manifest, workload, 2 ** 35 + 1)
    assert correct, checks


@pytest.mark.parametrize('fault', faults.FAULTS)
@pytest.mark.parametrize('workload', CELLS)
def test_fault_is_not_correct(manifest, workload, fault):
    correct, checks = _verdict(manifest, workload, 2 ** 35 + 1, fault)
    assert not correct, checks
