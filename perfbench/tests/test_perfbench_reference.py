"""The plain reference against the port at a CPU size: ψ, log|ψ|², Hψ, the
ancestral draw, and whole sound runs of the training job reading near
zero."""

import pytest
import torch

from perfbench import harness
from perfbench.reference.waveflow import Waveflow, parameter_layout
from perfbench.tests.conftest import TRAIN_TINY, tiny_cell

CPU = torch.device('cpu')


@pytest.mark.parametrize('workload', ['he1d-train-b256', 'he2d2e-train-b256'])
def test_psi_energy_and_draw(manifest, workload):
    from perfbench.jobs.train import build
    cell = tiny_cell(manifest, workload, **TRAIN_TINY)
    trainer, weights = build(cell, 3, CPU, harness.Spans())
    assert [n for n, _, _ in parameter_layout(cell.cfg)] == list(weights)
    ref = Waveflow(cell.cfg, CPU)
    params = {k: v.double() for k, v in weights.items()}
    u = torch.rand((ref.D, 64), generator=torch.Generator().manual_seed(4))
    x_ref = ref.sample(params, u)
    x = trainer.model.sample(64, u=u)
    assert (x.double() - x_ref).abs().max() < 1e-4 * cell.cfg['box_length']
    x = x_ref.float()
    psi_ref = ref.psi(params, x_ref)
    scale = psi_ref.abs().max()
    assert ((trainer.model.psi(x).double() - psi_ref).abs().max() / scale) < 1e-4
    assert (trainer.model.log_pdf(x).double() - ref.log_pdf(params, x_ref)).abs().max() < 1e-3
    h_ref, _ = ref.hpsi_and_psi(params, x_ref)
    h = trainer.h_fn(x)[:, 0].double()
    assert ((h - h_ref).abs().max() / h_ref.abs().max()) < 1e-3


@pytest.mark.parametrize('workload', ['he1d-train-b256', 'he2d2e-train-b256'])
def test_sound_train_run(manifest, workload):
    cell = tiny_cell(manifest, workload, **TRAIN_TINY)
    out = cell.job().run(cell, 2 ** 40 + 11, 0.5, False, CPU, 0.0)
    n = out['numbers']
    assert n['sample_dx'] < 1e-5
    assert n['loss_gap'] < 1e-4 and n['grad_gap'] < 1e-4
    assert n['change_gap_median'] < 1e-3
    assert out['metrics']['train_walkers_per_s'] > 0
    assert out['attempted'] >= 1 and out['failed'] == 0

