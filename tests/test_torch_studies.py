"""The 2D two-electron frontier, its ED oracle and the SR/SPRING study on the
port (examples/frontier_2d2e_torch.py, oracle_2d2e_torch.py,
sr_study_torch.py) against the JAX scripts (benchmarks/frontier_2d2e.py,
oracle_2d2e.py, sr_study.py) and their committed files, on the CPU:

  * the job lists and constants equal the JAX scripts' own;
  * ``richardson`` equals JAX's; the oracle script at tiny grids equals
    JAX's ``exact_ground_state_2d_2e`` to 1e-10;
  * a tiny run of frontier (4 epochs, a two-block evaluation, the fidelity
    at a 6-point ED) and of the SR study (4 → 8 epochs) gives the JAX rows'
    keys, and a rerun runs nothing again;
  * the SR study split 4 + 4 epochs, the second half resumed from the
    checkpoint in a fresh trainer, equals one run of 8 to the bit, for
    SPRING with a trust region and for CG-SR;
  * the gates and the ``ungated`` / null paths on handmade rows.

Small widths throughout (degree 3, 6 knots, one layer, a 300-point mesh, 8
walkers, windows of 2): the scripts' configs are the JAX scripts' at full
width, and the tests narrow them.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from waveflow_tpu.physics import exact_ground_state_2d_2e as jax_ed_2d_2e
from waveflow_tpu_torch.vmc import VMCTrainer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(spline_degree=3, num_knots=6, n_flow_layers=1,
             n_spline_base_mesh_points=300, batch_size=8, window=2)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


sys.path.insert(0, str(ROOT / 'examples'))
ORACLE = _load('oracle_2d2e_torch', ROOT / 'examples' / 'oracle_2d2e_torch.py')
FRONTIER = _load('frontier_2d2e_torch',
                 ROOT / 'examples' / 'frontier_2d2e_torch.py')
SR = _load('sr_study_torch', ROOT / 'examples' / 'sr_study_torch.py')
R5 = FRONTIER.r5
JAX_ORACLE = _load('jax_oracle_2d2e', ROOT / 'benchmarks' / 'oracle_2d2e.py')
JAX_FRONTIER = _load('jax_frontier_2d2e',
                     ROOT / 'benchmarks' / 'frontier_2d2e.py')
JAX_SR = _load('jax_sr_study', ROOT / 'benchmarks' / 'sr_study.py')
JAX_FRONTIER_ROWS = json.loads((ROOT / 'results' /
                                'frontier_2d2e.json').read_text())
JAX_SR_ROWS = json.loads((ROOT / 'results' / 'sr_study.json').read_text())


# ---- the job lists and constants ---------------------------------------------

@pytest.mark.parametrize('port,jax,names', [
    (FRONTIER, JAX_FRONTIER, ('RUNS', 'EPOCHS', 'BOX_LENGTH')),
    (ORACLE, JAX_ORACLE, ('GRIDS', 'BOX_LENGTH')),
    (SR, JAX_SR, ('ANSATZE', 'OPTS', 'BUDGETS')),
], ids=['frontier', 'oracle', 'sr_study'])
def test_constants_match_jax(port, jax, names):
    for name in names:
        assert getattr(port, name) == getattr(jax, name), name


def test_sr_rows_match_the_committed_file():
    """The 18 rows in the JAX script's order, each in JAX's committed
    file; a row's config is the JAX script's, on the port's device."""
    assert SR.keys() == [f"{a}_{o}" for a in JAX_SR.ANSATZE
                         for o in JAX_SR.OPTS]
    assert set(SR.keys()) == set(JAX_SR_ROWS)
    args = SR.parse_args(['--device', 'cpu'])
    cfg = SR.config('big_sr_cg_0.05_tr', args)
    assert (cfg.system_name, cfg.box_length, cfg.batch_size, cfg.window,
            cfg.seed, cfg.log_every) == ('He', 10.0, 256, 100, 2, 100_000)
    assert (cfg.num_knots, cfg.n_flow_layers, cfg.optimizer, cfg.sr_cg_iters,
            cfg.learning_rate, cfg.sr_max_update_norm) == (
                31, 4, 'sr', 20, 0.05, 0.3)
    cfg = SR.config('flagship_spring_0.02_m0.99', args)
    assert (cfg.num_knots, cfg.spring_momentum, cfg.sr_max_update_norm) == (
        23, 0.99, None)


def test_frontier_config_resolves_paired2d():
    """The JAX script's config for both rows; the trainer resolves the
    sorted ansatz with two electrons in 2D to 'paired2d', as JAX's does."""
    args = FRONTIER.parse_args(['--device', 'cpu'])
    for name in FRONTIER.RUNS:
        cfg = FRONTIER.config(name, args)
        assert (cfg.n_space_dimension, cfg.box_length, cfg.batch_size,
                cfg.window, cfg.seed, cfg.learning_rate, cfg.log_every) == (
                    2, 5.0, 256, 100, 2, 3e-4, 20_000)
        t = VMCTrainer(dataclasses.replace(cfg, **SMALL, save_dir=None))
        assert (t.ansatz, t.xu_coord_type) == ('sorted', 'paired2d')


# ---- the oracle ----------------------------------------------------------------

@pytest.mark.parametrize('args', [(-1.26697, -1.26425, 24, 32),
                                  (-1.26425, -1.26297, 32, 40),
                                  (-1.3, -1.2, 6, 8)])
def test_richardson_matches_jax(args):
    assert ORACLE.richardson(*args) == JAX_ORACLE.richardson(*args)


@pytest.fixture(scope='module')
def tiny_oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp('oracle')
    assert ORACLE.main(['--grids', '6,8', '--out-dir', str(out)]) == 0
    return json.loads((out / 'oracle_2d_2e.json').read_text())


@pytest.mark.parametrize('name', ['He', 'H2'])
def test_oracle_at_tiny_grids_matches_jax(tiny_oracle, name):
    """The script's rows at grids 6 and 8 with the JAX file's keys; each
    energy JAX's ``exact_ground_state_2d_2e`` to 1e-10, the Richardson
    value JAX's formula on JAX's energies."""
    rec = tiny_oracle[f'{name}_2d_L5']
    committed = json.loads(ORACLE.JAX_ROWS.read_text())[f'{name}_2d_L5']
    assert set(rec) == set(committed)
    protons = np.asarray(rec['protons'])
    jax = {n: jax_ed_2d_2e(protons, 5.0, n_grid=n)[0] for n in (6, 8)}
    for n, e in jax.items():
        assert abs(rec['energies'][str(n)] - e) <= 1e-10
    assert abs(rec['richardson_32_40']
               - JAX_ORACLE.richardson(jax[6], jax[8], 6, 8)) <= 1e-10


def test_oracle_gate_on_handmade_rows():
    ref = {'energies': {'24': -1.0, '32': -1.1, '40': -1.2},
           'richardson_32_40': -1.3}
    rec = {'energies': {'24': -1.0, '32': -1.1 + 5e-7, '40': -1.2},
           'richardson_32_40': -1.3 - 9e-7}
    assert ORACLE.gate(rec, ref)['in_gate']
    rec['energies']['40'] = -1.2 + 2e-6
    got = ORACLE.gate(rec, ref)
    assert not got['in_gate'] and got['abs_diff']['40'] == pytest.approx(2e-6)
    assert ORACLE.gate({'energies': {'6': -1.0}}, ref) is None
    assert ORACLE.gate(rec, None) is None


# ---- frontier --------------------------------------------------------------------

@pytest.fixture
def small_frontier(monkeypatch):
    real = FRONTIER.config
    monkeypatch.setattr(FRONTIER, 'config', lambda name, args: dataclasses
                        .replace(real(name, args), **SMALL))
    monkeypatch.setattr(FRONTIER, 'EVAL_BLOCKS', 2)
    monkeypatch.setattr(FRONTIER, 'EVAL_BATCH', 16)
    monkeypatch.setitem(R5.EVAL_KW, 'sweeps_per_block', 2)
    monkeypatch.setitem(R5.EVAL_KW, 'n_warmup_sweeps', 2)


def test_frontier_tiny_run(tmp_path, small_frontier, capsys):
    """He at 4 epochs, a two-block evaluation and a 6-point ED: JAX's row
    keys (the fidelity's at the 6-point grid), the sector and the oracle
    named, JAX's row beside it without its TPU times, a gate without the
    fidelity (not at the 40-point ED); a rerun runs nothing again."""
    oracle = ROOT / 'results' / 'oracle_2d_2e.json'
    argv = ['--device', 'cpu', '--epochs', '4', '--fidelity-grid', '6',
            '--keys', 'He', '--oracle', str(oracle), '--out-dir',
            str(tmp_path)]
    assert FRONTIER.main(argv) == 0
    row = json.loads((tmp_path / 'frontier_2d2e.json').read_text())['He']
    want = {k.replace('ed40', 'ed6') for k in JAX_FRONTIER_ROWS['He']}
    assert want <= set(row)
    assert row['sector'] == 'paired2d' and row['oracle'] == str(oracle)
    assert row['exact_richardson'] == pytest.approx(-1.2606123970061156)
    assert row['deviation_eval'] == pytest.approx(
        row['eval_clipped'] - row['exact_richardson'])
    assert row['finite'] and row['epochs'] == 4
    assert len(row['fidelity_components_ed6']) == 2
    assert row['fidelity_subspace_ed6'] == pytest.approx(np.sqrt(np.sum(
        np.square(row['fidelity_components_ed6']))))
    assert set(row['launches']) == {'train', 'eval'}
    assert 'epochs_per_sec' not in row['jax']
    assert row['jax']['fidelity_subspace_ed40'] == 0.999014
    assert set(row['gate']['checks']) == {'finite', 'deviation'}
    assert row['trace_chunks']['jax']['chunks'][0] == pytest.approx(
        float(np.median(np.load(ROOT / 'results' / 'He_2d2e' /
                                'loss.npy')[:10_000])))
    capsys.readouterr()
    assert FRONTIER.main(argv) == 0
    assert 'oracle' not in capsys.readouterr().out


@pytest.mark.parametrize('name,figures,want', [
    ('He', dict(dev=0.00309, fid=0.9995), True),
    ('He', dict(dev=0.0100, fid=0.9995), False),
    ('He', dict(dev=0.0030, fid=0.9900), False),
    ('H2', dict(dev=0.0030, fid=0.9975), True),
    ('H2', dict(dev=-0.0024, fid=0.9999), False),
    ('H2', dict(dev=0.0007, fid=0.9960), False),
])
def test_frontier_gate_on_handmade_rows(name, figures, want):
    """The round-5 2D rule against JAX's committed rows: the deviation window
    max(2 |dev_jax|, 3e-3), the fidelity floor 1 − 10 (1 − JAX's), He's on
    its ground subspace."""
    key = 'fidelity_subspace_ed40' if name == 'He' else 'fidelity_ed40'
    row = {'finite': True, 'eval_clipped': -1.2, 'eval_clipped_stderr': 1e-4,
           'deviation_eval': figures['dev'], key: figures['fid'],
           'fidelity_ed40': 0.04 if name == 'He' else figures['fid']}
    got = FRONTIER.gate(name, row, FRONTIER.jax_row(name))
    assert got['in_gate'] is want
    assert got['checks']['fidelity']['field'] == key
    least = 1.0 - 10.0 * (1.0 - JAX_FRONTIER_ROWS[name][key])
    assert got['checks']['fidelity']['least'] == pytest.approx(least)


# ---- the SR study ---------------------------------------------------------------

def _small_sr(monkeypatch):
    real = SR.config
    monkeypatch.setattr(SR, 'config', lambda key, args: dataclasses.replace(
        real(key, args), **SMALL))


SR_ARGS = ['--device', 'cpu']


def test_sr_tiny_run(tmp_path, monkeypatch, capsys):
    """flagship_adam_3e-4 at 4 → 8 epochs: the JAX row's keys at these
    budgets, launches per budget, a rehearsal's gate; a rerun runs
    nothing again."""
    _small_sr(monkeypatch)
    argv = SR_ARGS + ['--budgets', '4,8', '--keys', 'flagship_adam_3e-4',
                      '--out-dir', str(tmp_path)]
    assert SR.main(argv) == 0
    row = json.loads((tmp_path / 'sr_study.json').read_text())[
        'flagship_adam_3e-4']
    for b in (4, 8):
        assert {f'median_at_{b}', f'steps_per_sec_at_{b}',
                f'launches_at_{b}', f'nonfinite_losses_at_{b}'} <= set(row)
        assert np.isfinite(row[f'median_at_{b}'])
    assert row['epochs_at_8'] == row['trace_len_at_8'] == 8
    assert row['gate'] == {'verdict': 'ungated', 'rehearsal': True}
    assert row['jax'] == {k: v for k, v in
                          JAX_SR_ROWS['flagship_adam_3e-4'].items()
                          if k.startswith('median_at_')}
    capsys.readouterr()
    assert SR.main(argv) == 0
    assert capsys.readouterr().out == ''


@pytest.mark.parametrize('key', ['flagship_spring_0.05_m0.9_tr',
                                 'flagship_sr_cg_0.05_tr'])
def test_sr_split_resume_is_one_run(tmp_path, monkeypatch, key):
    """4 epochs, then a fresh trainer resumed from the checkpoint for 4
    more, against one trainer's 8: the loss trace, the parameters and the
    optimizer state (SPRING's delta and counters; SR keeps none) equal to
    the bit."""
    _small_sr(monkeypatch)
    args = SR.parse_args(SR_ARGS + ['--out-dir', str(tmp_path / 'one')])
    one = VMCTrainer(dataclasses.replace(SR.config(key, args), save_dir=None))
    one.train(8, verbose=False)
    split = SR_ARGS + ['--keys', key, '--out-dir', str(tmp_path / 'split')]
    assert SR.main(split + ['--budgets', '4']) == 0
    assert SR.main(split + ['--budgets', '4,8']) == 0
    run_dir = tmp_path / 'split' / f'sr_study_{key}'
    resumed = VMCTrainer(dataclasses.replace(
        SR.config(key, SR.parse_args(split)), save_dir=None))
    assert resumed.load_checkpoint(str(run_dir))
    assert resumed.epoch == 8
    assert np.array_equal(np.load(run_dir / 'loss.npy'),
                          np.asarray(one.losses))
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    a, b = one.step.optimizer.state_dict(), resumed.step.optimizer.state_dict()
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    else:
        assert a == b == ()


@pytest.mark.parametrize('key,median,want', [
    ('flagship_spring_0.05_m0.9_tr', -1.8130, 'in_gate'),
    ('flagship_spring_0.05_m0.9_tr', -1.8090, 'outside_gate'),
    ('big_sr_cg_0.05_tr', -1.8070, 'in_gate'),
    ('big_sr_cg_0.05_tr', None, 'outside_gate'),
    ('flagship_adam_1e-4', -1.8110, 'in_gate'),
    ('big_adam_1e-4', -1.6000, 'ungated'),
    ('big_spring_0.02_m0.99', 12.0, 'ungated'),
    ('flagship_sr_cg_0.05', None, 'ungated'),
])
def test_sr_gate_on_handmade_rows(key, median, want):
    """Gated where JAX's 10,000-epoch median lies below −1.80 (|port −
    JAX| ≤ 5e-3; a null median is outside); the others ungated, diverged
    above −1.0 or with no finite median."""
    got = SR.gate({'median_at_10000': median}, SR.jax_row(key))
    assert got['verdict'] == want
    assert got['diverged'] is (median is None or median > -1.0)
    assert SR.gate({'median_at_2000': -1.8}, SR.jax_row(key)) is None


def test_sr_tail_median_writes_null():
    """The JAX script's tail (the last fifth, at least one loss); a
    non-finite median is None with the count of non-finite losses."""
    assert SR.tail_median([5.0, 1.0, 2.0, 3.0, 4.0, 6.0]) == (6.0, 0)
    assert SR.tail_median([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0,
                           10.0]) == (9.5, 0)
    assert SR.tail_median([1.0, np.inf, np.nan, 2.0, np.nan]) == (None, 3)
