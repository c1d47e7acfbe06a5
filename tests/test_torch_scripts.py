"""The port's entry scripts run end to end on the CPU at a tiny size:
training with a restart, the evaluation with its Metropolis pass, and the
benchmark's JSON line."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ['--num-knots', '6', '--spline-degree', '3', '--n-flow-layers', '1']


def _run(script, *args):
    script = script if script.startswith('-') else str(ROOT / script)
    out = subprocess.run([sys.executable, script, *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, 'OMP_NUM_THREADS': '2'})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_run_restart_and_evaluate(tmp_path):
    """run_vqmc_torch.py: 2 windows of 2 epochs with Metropolis walkers,
    then --restart for 2 more (the trace continues to 8 epochs);
    evaluate_vqmc_torch.py --mcmc-eval on the run: trace estimates, the ED
    oracle and a finite blocked Metropolis energy."""
    train = ['examples/run_vqmc_torch.py', '--device', 'cpu',
             '--num-epochs', '4', '--window', '2', '--batch-size', '8',
             '--log-every', '2', '--sampler', 'metropolis',
             '--save-dir', str(tmp_path), *TINY]
    first = _run(*train)
    assert 'epoch 4 |' in first
    assert np.load(tmp_path / 'loss.npy').shape == (4,)
    second = _run(*train, '--restart')
    assert 'epoch 8 |' in second
    trace = np.load(tmp_path / 'loss.npy')
    assert trace.shape == (8,) and np.isfinite(trace).all()
    out = _run('examples/evaluate_vqmc_torch.py', '--save-dir', str(tmp_path),
               '--mcmc-eval', '--device', 'cpu', '--eval-batch', '32',
               '--eval-blocks', '4', '--eval-sweeps-per-block', '2', *TINY)
    assert 'exact (ED, one grid)' in out
    line = next(ln for ln in out.splitlines() if ln.startswith('<E_L>'))
    assert np.isfinite(float(line.split('=')[1].split()[0]))
    assert '128 samples' in line


def test_run_mala_with_spring(tmp_path):
    """run_vqmc_torch.py --sampler mala --optimizer spring: one window of 2
    epochs at lr 0.05; the checkpoint carries the 5-field MALA walkers and
    SPRING's state, with its step count."""
    from waveflow_tpu_torch.utils import load_state
    out = _run('examples/run_vqmc_torch.py', '--device', 'cpu',
               '--num-epochs', '2', '--window', '2', '--batch-size', '8',
               '--log-every', '2', '--sampler', 'mala', '--optimizer',
               'spring', '--learning-rate', '0.05', '--spring-momentum',
               '0.5', '--save-dir', str(tmp_path), *TINY)
    assert 'epoch 2 |' in out and 'accept' in out
    state = load_state(tmp_path / 'checkpoints')
    assert len(state['mcmc_state']) == 5
    assert int(state['optimizer']['step']) == 2
    assert np.isfinite(np.load(tmp_path / 'loss.npy')).all()


def test_run_reference_estimator(tmp_path):
    """run_vqmc_torch.py --estimator reference: 2 windows of 2 epochs and
    one single epoch (5 epochs), finite losses in the trace."""
    out = _run('examples/run_vqmc_torch.py', '--device', 'cpu',
               '--num-epochs', '5', '--window', '2', '--batch-size', '8',
               '--log-every', '2', '--estimator', 'reference',
               '--save-dir', str(tmp_path), *TINY)
    assert 'epoch 4 |' in out
    trace = np.load(tmp_path / 'loss.npy')
    assert trace.shape == (5,) and np.isfinite(trace).all()


def test_bench_prints_its_fields():
    """bench_torch.py at the flagship's widths, batch 8, one warmup window
    and one timed window of 2 epochs on the CPU for the main path and for
    the reference design: one JSON line with bench.py's fields,
    vs_baseline the positive ratio of the two times, the device named in
    unit."""
    out = _run('bench_torch.py', '--device', 'cpu', '--batch-size', '8',
               '--window', '2', '--n-windows', '1', '--n-ref-windows', '1')
    result = json.loads(out.strip().splitlines()[-1])
    assert set(result) == {'metric', 'value', 'unit', 'vs_baseline'}
    assert result['metric'] == 'vmc_walker_steps_per_sec'
    assert result['value'] > 0 and result['vs_baseline'] > 0
    assert result['unit'].endswith('; cpu)')


def test_run_and_evaluate_antisym_2d(tmp_path):
    """run_vqmc_torch.py --n-space-dimension 2 --ansatz antisym --sampler
    metropolis: He-2d, 2 windows of 2 epochs, walkers of 4 coordinates in
    the checkpoint; evaluate_vqmc_torch.py --mcmc-eval on it with the
    committed two-electron ED40 cache as the oracle and a finite blocked
    Metropolis energy."""
    from waveflow_tpu_torch.utils import load_state
    out = _run('examples/run_vqmc_torch.py', '--device', 'cpu',
               '--n-space-dimension', '2', '--box-length', '5',
               '--ansatz', 'antisym', '--sampler', 'metropolis',
               '--num-epochs', '4', '--window', '2', '--batch-size', '8',
               '--log-every', '2', '--save-dir', str(tmp_path), *TINY)
    assert 'epoch 4 |' in out and 'accept' in out
    state = load_state(tmp_path / 'checkpoints')
    assert state['mcmc_state'][0].shape == (8, 4)
    assert np.isfinite(np.load(tmp_path / 'loss.npy')).all()
    out = _run('examples/evaluate_vqmc_torch.py', '--save-dir', str(tmp_path),
               '--n-space-dimension', '2', '--box-length', '5',
               '--ansatz', 'antisym', '--mcmc-eval', '--device', 'cpu',
               '--eval-batch', '16', '--eval-blocks', '2',
               '--eval-sweeps-per-block', '2', *TINY)
    assert 'exact (2D ED, 40^2 grid (ed40_He_2d2e.npz, 2 state(s)))' in out
    line = next(ln for ln in out.splitlines() if ln.startswith('<E_L>'))
    assert np.isfinite(float(line.split('=')[1].split()[0]))


def test_evaluate_h_2d_with_its_oracle():
    """evaluate_vqmc_torch.py --n-space-dimension 2 on the committed 1-electron
    H-2d run (results/h_2d, default widths): the 2D grid-ED oracle on the
    120² grid the run was judged on (−0.430352) and the fidelity of ψ
    against its ground state, within 1e-4 of the JAX figure 0.999942
    (results/h_2d/fidelity.txt)."""
    out = _run('examples/evaluate_vqmc_torch.py', '--save-dir',
               str(ROOT / 'results' / 'h_2d'), '--system', 'H',
               '--n-space-dimension', '2', '--box-length', '5',
               '--ed-grid', '120', '--fidelity', '--device', 'cpu')
    assert 'exact (2D ED, 120^2 grid): -0.43035' in out
    line = next(ln for ln in out.splitlines() if ln.startswith('fidelity'))
    assert abs(float(line.split('=')[1].split()[0]) - 0.999942) <= 1e-4


def test_run_data_parallel(tmp_path):
    """run_vqmc_torch.py --data-parallel: alone, a world of one process
    (gloo on the CPU); under torchrun, 2 ranks of 4 walkers each, rank 0
    printing and writing the replicated checkpoint, each rank its shard."""
    args = ['examples/run_vqmc_torch.py', '--device', 'cpu', '--num-epochs',
            '2', '--window', '2', '--batch-size', '8', '--log-every', '2',
            '--sampler', 'metropolis', '--data-parallel', *TINY]
    out = _run(*args, '--save-dir', str(tmp_path / 'one'))
    assert 'epoch 2 |' in out
    assert not list((tmp_path / 'one').glob('checkpoints.shard*'))
    out = _run('-m', 'torch.distributed.run', '--standalone',
               '--nproc-per-node', '2', *args,
               '--save-dir', str(tmp_path / 'two'))
    assert out.count('epoch 2 |') == 1
    names = {p.name for p in (tmp_path / 'two').iterdir()}
    assert {'checkpoints', 'loss.npy', 'checkpoints.shard0',
            'checkpoints.shard1'} <= names
    assert np.isfinite(np.load(tmp_path / 'two' / 'loss.npy')).all()


def test_data_parallel_check_on_two_ranks():
    """examples/data_parallel_torch.py under torchrun, 2 gloo ranks at
    small widths: the sharded step against rank 0's single-process step and
    2 windows replicated to the bit pass, the JSON line says so."""
    out = _run('-m', 'torch.distributed.run', '--standalone',
               '--nproc-per-node', '2', 'examples/data_parallel_torch.py',
               '--device', 'cpu', '--tiny', '--per-rank', '8', '--window', '2')
    figures = json.loads(out.strip().splitlines()[-1])
    assert figures['world'] == 2 and figures['failed'] == []
    assert figures['replicated_to_the_bit'] and figures['step_cos'] > 0.999


def test_posterior_sharded():
    """parameter_posterior_torch.py --sharded over a world of one: HMC at
    a cut depth, the JSON line's figures finite."""
    out = _run('examples/parameter_posterior_torch.py', '--device', 'cpu',
               '--sampler', 'hmc', '--sharded', '--n-steps', '4',
               '--n-warmup', '4', '--n-test', '100')
    figures = json.loads(out.strip().splitlines()[-1])
    assert figures['ranks'] == 1 and figures['finite']
    assert np.isfinite(figures['bma_ll'])
