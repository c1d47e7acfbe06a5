"""The control on the card: the program with its TF32 path switched on
(``matmul_precision='high'``), the nearest precision below the stated
float32 with TF32 off, must come out not correct under each cell's limits.
At a test's size: the configuration's widths with fewer knots and short
windows; the full-size readings are calibrate.py's
(PERF.md)."""

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import tiny_cell

pytestmark = pytest.mark.card


@pytest.mark.parametrize('workload,traffic', [
    ('he1d-train-b256', dict(batch_size=256, window=4)),
    ('he2d2e-train-b256', dict(batch_size=256, window=4)),
])
def test_control_is_not_correct(manifest, workload, traffic):
    cell = tiny_cell(manifest, workload, **traffic)
    cell.cfg = dict(cell.cfg, eval_backend='poly_pallas')
    device = torch.device('cuda', 0)
    verdicts = []
    for seed in (201, 202, 203):
        out = cell.job().run(cell, seed, 0.0, False, device, 0.0,
                             matmul_precision='high')
        verdicts.append(harness.judge(out['numbers'], cell.limits)[0])
    torch.set_float32_matmul_precision('highest')
    assert not any(verdicts)
