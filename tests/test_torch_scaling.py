"""The batch and MCMC scaling studies on the port
(examples/batch_sweep_torch.py, examples/mcmc_scale_torch.py) against the
JAX scripts' files (benchmarks/batch_sweep.py, benchmarks/mcmc_scale.py,
results/batch_sweep.json, results/mcmc_scale.json: their structure only,
never their TPU figures), the way back from the port's weights to the JAX
package (``convert.params_to_jax``) and the tail pass
(``vmc/evaluate.py::record_tail``) with examples/round5_quality_torch.py's
options around it, on the CPU:

  * the case lists and the rows' keys equal the JAX files';
  * a tiny run of each script (8 walkers, windows of 2) gives finite rows;
  * JAX → port → JAX is the identity to the bit on the committed flagship
    100k and H2-2d antisym checkpoints, and JAX's ψ on the returned tree
    equals the port's at walkers drawn from each model;
  * the tail pass continues the evaluation's chain, keeps the k largest
    local energies of its own pass, and at them the 'dense' and
    finite-difference forms agree with the pass's within chip_smoke.py's
    lap-forms limits;
  * ``--tail-k``, ``--eval-seeds``, ``--init-from`` and the trace chunks of
    the round-5 script.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.vmc import VMCConfig as JVMCConfig
from waveflow_tpu.vmc import VMCTrainer as JVMCTrainer
from waveflow_tpu_torch.convert import (load_jax_checkpoint, params_from_jax,
                                        params_to_jax)
from waveflow_tpu_torch.vmc import (VMCConfig, VMCTrainer, evaluate_trainer,
                                    record_tail)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP_RUN = ROOT / 'results' / 'r5_flagship_fwd_batched_100k'
H2_RUN = ROOT / 'results' / 'r5_h2_2d2e_antisym'
SMALL = dict(spline_degree=3, num_knots=6, n_flow_layers=1,
             n_spline_base_mesh_points=300)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SWEEP = _load('batch_sweep_torch', ROOT / 'examples' / 'batch_sweep_torch.py')
MCMC = _load('mcmc_scale_torch', ROOT / 'examples' / 'mcmc_scale_torch.py')
R5 = _load('round5_quality_torch', ROOT / 'examples' / 'round5_quality_torch.py')
SMOKE = _load('chip_smoke', ROOT / 'chip_smoke.py')
JAX_SWEEP = json.loads((ROOT / 'results' / 'batch_sweep.json').read_text())
JAX_MCMC = json.loads((ROOT / 'results' / 'mcmc_scale.json').read_text())


# ---- the case lists and the rows' keys ---------------------------------------

def test_batch_list_matches_jax():
    """Batches 256 .. 65,536 in the JAX file's order, windows of 100."""
    assert [b for b, _ in SWEEP.BATCHES] == [r['batch'] for r in JAX_SWEEP]
    assert [n for _, n in SWEEP.BATCHES] == [5, 5, 3, 2, 1]
    assert SWEEP.WINDOW == 100 and SWEEP.BACKENDS == ('poly', 'poly_pallas')


def test_mcmc_cases_match_jax():
    """The 20 (sampler, sweeps, batch) throughput cases and the six quality
    rows of the JAX file; windows of 100 (3 timed) up to batch 4,096, of 20
    (2 timed) above."""
    jax_cases = [(r['sampler'], r['sweeps'], r['batch'])
                 for r in JAX_MCMC['throughput']]
    assert len(MCMC.cases()) == 20 == len(jax_cases)
    assert set(MCMC.cases()) == set(jax_cases)
    assert [f'{s}_s{n}' for s, n in MCMC.QUALITY] == list(
        JAX_MCMC['quality_he1d_10k'])
    assert [MCMC.window_of(b) for b in MCMC.BATCHES] == [
        (100, 3), (100, 3), (20, 2), (20, 2)]


def test_batch_sweep_tiny_run(tmp_path, capsys):
    """The script end to end at 8 walkers, windows of 2, one timed window:
    rows with JAX's keys, finite, under both backends; a rerun runs no row
    again."""
    out = tmp_path / 'rows.json'
    argv = ['--device', 'cpu', '--batches', '8', '--window', '2',
            '--iters', '1', '--out', str(out)]
    assert SWEEP.main(argv) == 0
    rows = json.loads(out.read_text())
    assert [(r['backend'], r['batch']) for r in rows] == [
        ('poly', 8), ('poly_pallas', 8)]
    for row in rows:
        assert set(JAX_SWEEP[0]) <= set(row)
        assert row['finite'] and row['walkers_per_sec'] > 0
        assert row['device'] == 'cpu' and not row['graph']
    capsys.readouterr()
    assert SWEEP.main(argv) == 0
    assert capsys.readouterr().out == ''


@pytest.mark.parametrize('sampler,sweeps', [('metropolis', 3), ('mala', 1)])
def test_mcmc_throughput_tiny_run(sampler, sweeps):
    """One throughput case at 8 walkers, windows of 2: JAX's keys, finite."""
    row = MCMC.throughput_row(sampler, sweeps, 8, 2, 1, 'cpu')
    assert set(JAX_MCMC['throughput'][0]) <= set(row)
    assert row['finite'] and row['epochs_per_sec'] > 0


def test_mcmc_quality_tiny_run(tmp_path):
    """The quality part through the script at 8 walkers... of 4 epochs in
    windows of 2 for one row's recipe: JAX's keys, finite, JAX's median
    beside it and the difference."""
    row = MCMC.quality_row('metropolis', 1, 4, 'cpu', batch=8, window=2)
    assert set(JAX_MCMC['quality_he1d_10k']['metropolis_s1']) <= set(row)
    assert row['finite'] and row['epochs'] == 4
    assert MCMC.jax_quality('mala_s3') == {
        'median_last20pct': JAX_MCMC['quality_he1d_10k']['mala_s3'][
            'median_last20pct']}


# ---- params_to_jax ------------------------------------------------------------

def _same_tree(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a, b))


@pytest.mark.parametrize('run', [FLAGSHIP_RUN, H2_RUN], ids=['flagship', 'h2'])
def test_params_round_trip_to_the_bit(run):
    """JAX → port → JAX: the same containers, shapes, dtypes and bits."""
    tree = load_jax_checkpoint(run / 'checkpoints')['params']
    assert _same_tree(tree, params_to_jax(params_from_jax(tree)))


RUN_CONFIGS = {
    'flagship': (FLAGSHIP_RUN, dict(system_name='He', box_length=10.0)),
    'h2': (H2_RUN, dict(system_name='H2', n_space_dimension=2,
                        box_length=5.0, ansatz='antisym',
                        sampler='metropolis')),
}


@pytest.mark.parametrize('name', list(RUN_CONFIGS))
def test_jax_psi_on_the_returned_tree(name):
    """The committed run loaded into the port's trainer, its model handed
    back by ``params_to_jax`` to a JAX trainer of the same configuration:
    at 256 walkers drawn from the model (the port's ancestral draws; for
    the antisym ansatz its warm-start draws from |φ|²), not uniformly,
    JAX's ψ equals the port's within 1e-6 relative, both evaluated in
    float64 from the same float32 parameters (in float32 the two packages'
    orders of operations part by ~4e-6 of max|ψ|, the 1e-5 of the
    packages' parity tests)."""
    run, cfg = RUN_CONFIGS[name]
    t = VMCTrainer(VMCConfig(device='cpu', batch_size=256, **cfg))
    assert t.load_checkpoint(str(run))
    x = t.model.sample(256, generator=torch.Generator().manual_seed(3))
    tree = params_to_jax(t.model)
    with torch.no_grad():
        psi_port = t.model.double().psi(x.double()).numpy()
    t.model.float()
    jt = JVMCTrainer(JVMCConfig(save_dir=None, batch_size=256, **cfg))
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree)
        psi_jax = np.asarray(jax.jit(jt.psi)(
            params, jnp.asarray(x.numpy(), jnp.float64)))
    assert psi_jax.dtype == np.float64
    np.testing.assert_allclose(psi_jax, psi_port, rtol=1e-6,
                               atol=1e-6 * np.abs(psi_port).max())


def test_params_to_jax_layer_count():
    """From a state dict the factory's layout (BoxTransform, then IMADE and
    Reverse per flow layer) gives the module's layer count; a parameter
    past ``n_layers`` raises."""
    t = VMCTrainer(VMCConfig(device='cpu', batch_size=8, **SMALL))
    layers, _ = params_to_jax(t.model.state_dict())
    assert len(layers) == len(t.model.transform.layers) == 3
    assert layers[0] == () and layers[2] == ()
    with pytest.raises(ValueError):
        params_to_jax(t.model.state_dict(), n_layers=1)


# ---- the tail pass ------------------------------------------------------------

TAIL_CUT = dict(sweeps_per_block=3, n_warmup_sweeps=5, batch_size=64)


@pytest.fixture(scope='module')
def flagship_trainer():
    t = VMCTrainer(VMCConfig(device='cpu', batch_size=256))
    assert t.load_checkpoint(str(FLAGSHIP_RUN))
    return t


def test_tail_continues_the_evaluation_chain(flagship_trainer):
    """After ``evaluate_trainer`` at the same seed and cut, the pass's last
    skipped block has the evaluation's last raw block mean to the bit; at
    another seed it does not."""
    ev = evaluate_trainer(flagship_trainer, n_blocks=3, seed=5, **TAIL_CUT)
    tail = record_tail(flagship_trainer, k=4, n_blocks=1, skip_blocks=3,
                       seed=5, evaluation=ev, **TAIL_CUT)
    assert tail['same_chain']
    other = record_tail(flagship_trainer, k=4, n_blocks=1, skip_blocks=3,
                        seed=6, evaluation=ev, **TAIL_CUT)
    assert not other['same_chain']


def test_tail_keeps_the_largest_local_energies(flagship_trainer):
    """With k at the pass's whole size the rows are every E_L of the pass,
    largest first (their mean is the pass's raw mean); the k = 5 pass of the
    same chain keeps the first five of them."""
    kw = dict(n_blocks=2, skip_blocks=1, seed=9, **TAIL_CUT)
    whole = record_tail(flagship_trainer, k=128, **kw)
    top = record_tail(flagship_trainer, k=5, **kw)
    el = [r['el'] for r in whole['rows']]
    assert len(el) == 128 and el == sorted(el, reverse=True)
    assert np.mean(el) == pytest.approx(whole['el_mean'], rel=1e-6)
    assert [r['el'] for r in top['rows']] == el[:5]
    assert top['el_quantiles']['max'] == pytest.approx(el[0], rel=1e-6)


def test_tail_forms_agree_at_the_tail(flagship_trainer):
    """At the 16 largest local energies of a pass over 256 walkers, the
    'dense' Hψ lies within LAP_FORMS_RTOL and the finite difference (where
    its stencil stays in the box and the sorted sector) within LAP_FD_RTOL
    of max|Hψ| from the pass's own; the float64 local energy agrees with
    the f32 one to 1e-3, and every figure is finite."""
    tail = record_tail(flagship_trainer, k=16, n_blocks=1, skip_blocks=0,
                       seed=7, sweeps_per_block=5, n_warmup_sweeps=20,
                       batch_size=256)
    scale = tail['hpsi_scale']
    rows = tail['rows']
    assert all(np.isfinite([r[k] for k in ('el', 'el_dense', 'el_fd',
                                           'el_float64', 'log_abs_psi')]).all()
               for r in rows)
    assert max(abs(r['hpsi_dense'] - r['hpsi']) for r in rows) \
        <= SMOKE.LAP_FORMS_RTOL * scale
    inside = [r for r in rows if r['fd_inside']]
    assert inside
    assert max(abs(r['hpsi_fd'] - r['hpsi']) for r in inside) \
        <= SMOKE.LAP_FD_RTOL * scale
    assert max(abs(r['el_float64'] - r['el']) for r in rows) <= 1e-3
    for r in rows:
        x = np.asarray(r['x'])
        assert r['pair_distance'] == pytest.approx(x[1] - x[0], abs=1e-6)
        assert r['wall_distance'] == pytest.approx(
            min(x.min() + 10.0, 10.0 - x.max()), abs=1e-6)


# ---- the round-5 script's options --------------------------------------------

def _small_job(key: str):
    job = next(j for j in R5.plan() if j.key == key)
    return dataclasses.replace(job, cfg={**job.cfg, **SMALL, 'batch_size': 8,
                                         'window': 2},
                               eval_batch=16, eval_blocks=4)


@pytest.fixture
def short_eval(monkeypatch):
    monkeypatch.setitem(R5.EVAL_KW, 'sweeps_per_block', 2)
    monkeypatch.setitem(R5.EVAL_KW, 'n_warmup_sweeps', 2)


def test_tail_and_eval_seeds_on_a_row(tmp_path, short_eval, capsys):
    """A flagship row trained 4 epochs with ``--tail-k 3``: its ``tail`` is
    the pass on its own evaluation chain (seed 7); ``--eval-seeds 7,8`` on
    the saved row trains nothing, reproduces the row's evaluation at seed 7
    and adds seed 8, each with its tail."""
    job = _small_job('flagship_fwd_batched_100k')
    base = ['--device', 'cpu', '--out-dir', str(tmp_path)]
    _, args = R5.parse_args(base + ['--epochs', '4', '--tail-k', '3'])
    run = R5.Run(args)
    R5.stage_flagship([job], run)
    row = run.out['flagship_fwd_batched_100k']
    assert row['epochs'] == 4 and row['tail']['same_chain']
    assert len(row['tail']['rows']) == 3
    assert row['trace_chunks']['port']['chunks'] == [float(np.median(
        np.load(tmp_path / 'r5_flagship_fwd_batched_100k' / 'loss.npy')))]
    _, args = R5.parse_args(base + ['--eval-seeds', '7,8', '--tail-k', '3'])
    run = R5.Run(args)
    R5.stage_flagship([job], run)
    row = run.out['flagship_fwd_batched_100k']
    assert row['epochs'] == 4
    assert set(row['eval_seeds']) == {'7', '8'}
    assert row['eval_seeds']['7']['eval_mean'] == row['eval_mean']
    assert all(e['tail']['same_chain'] for e in row['eval_seeds'].values())


def test_init_from_a_checkpoint(tmp_path, short_eval, capsys):
    """``--init-from`` starts the row's trainer from a saved state (here a
    4-epoch row of the port's own): 2 more epochs end at epoch 6;
    ``--decay-epochs 0`` trains no decay."""
    job = _small_job('h2_2d2e_antisym')
    _, args = R5.parse_args(['--device', 'cpu', '--out-dir',
                             str(tmp_path / 'a'), '--epochs', '4',
                             '--decay-epochs', '0'])
    run = R5.Run(args)
    row, _ = R5.run_vmc(job, run)
    assert row['epochs'] == 4 and row['learning_rate'] == 3e-4
    _, args = R5.parse_args(['--device', 'cpu', '--out-dir',
                             str(tmp_path / 'b'), '--epochs', '2',
                             '--decay-epochs', '0', '--init-from',
                             str(tmp_path / 'a' / 'r5_h2_2d2e_antisym')])
    row, _ = R5.run_vmc(job, R5.Run(args))
    assert row['epochs'] == 6


def test_trace_chunks_of_the_committed_jax_traces(tmp_path):
    """JAX's committed traces read as the round-5 record quotes them:
    H2-2d −1.185894 over epochs 30,000-40,000 and −1.186634 over the last
    2,000; the flagship −1.815775 over the last 20%.  A port trace is cut
    into chunks of the given size."""
    h2 = R5.trace_chunks(tmp_path, 'h2_2d2e_antisym_seed4')
    assert h2['port'] is None
    assert h2['jax']['chunks'][3] == pytest.approx(-1.185894, abs=5e-7)
    assert h2['jax']['last_2000'] == pytest.approx(-1.186634, abs=5e-7)
    flag = R5.trace_chunks(tmp_path, 'flagship_fwd_batched_100k')
    assert flag['jax']['last_20pct'] == pytest.approx(-1.815775, abs=5e-7)
    losses = np.arange(25.0)
    np.save(tmp_path / 'loss.npy', losses)
    got = R5.trace_chunks(tmp_path, 'no_such_row', chunk=10)
    assert got['port']['chunks'] == [4.5, 14.5, 22.0] and got['jax'] is None
