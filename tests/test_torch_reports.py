"""The report scripts on the port (examples/evaluate_flagship_torch.py,
round4_quality_torch.py, outlier_study_torch.py) against the JAX scripts
(benchmarks/evaluate_flagship.py, round4_quality.py, outlier_study.py) and
their committed files, and the evaluation of non-finite parameters, on the
CPU:

  * the job lists and constants equal the JAX scripts' own; each round-4
    stage and the outlier study make the JAX scripts' calls (every trainer
    config, the epochs of each ``train``, the checkpoint each load reads,
    the evaluation's arguments) and rows with JAX's keys and figures, on
    recording stand-ins of the trainer;
  * at a NaN (or ±inf) x the port's ``PolySplineEvaluator.__call__``,
    ``value_and_derivative`` and ``basis_jet`` are NaN where JAX's are and
    equal elsewhere; the plain samplers (K1's and K2's functions) draw NaN
    for a walker with NaN coefficients, as JAX's do;
  * results/he1d_seed2 (every parameter NaN) evaluated on a two-block
    chain in both packages: no exception, non-finite energies in both;
  * results/r4_spring100k through evaluate_flagship_torch's row code on a
    short chain; a missed gate adds the tail pass;
  * a tiny run of a round-4 decay row and of an outlier median_abs row
    gives the JAX rows' keys, and a rerun runs nothing again;
  * the gates and the non-finite path on handmade rows.

Small widths throughout where a trainer trains (degree 3, 6 knots, one
layer, a 300-point mesh, 8 walkers, windows of 2): the scripts' configs are
the JAX scripts' at full width, and the tests narrow them.
"""

import dataclasses
import importlib.util
import json
import math
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu import ops as jops
from waveflow_tpu.ops import sampling as jsampling
from waveflow_tpu_torch import ops as tops
from waveflow_tpu_torch.ops import sampling as tsampling

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
EF = _load('evaluate_flagship_torch',
           ROOT / 'examples' / 'evaluate_flagship_torch.py')
R4 = _load('round4_quality_torch',
           ROOT / 'examples' / 'round4_quality_torch.py')
OUT = _load('outlier_study_torch',
            ROOT / 'examples' / 'outlier_study_torch.py')
JEF = _load('jax_evaluate_flagship',
            ROOT / 'benchmarks' / 'evaluate_flagship.py')
JR4 = _load('jax_round4_quality', ROOT / 'benchmarks' / 'round4_quality.py')
JOUT = _load('jax_outlier_study', ROOT / 'benchmarks' / 'outlier_study.py')
NAN_RUN = ROOT / 'results' / 'he1d_seed2'
SPRING_RUN = 'results/r4_spring100k'


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize('port,jax,names', [
    (EF, JEF, ('RUNS', 'EXACT')),
    (R4, JR4, ('SPRING', 'FLAG')),
    (OUT, JOUT, ('SYSTEMS', 'VARIANTS')),
], ids=['evaluate_flagship', 'round4_quality', 'outlier_study'])
def test_constants_match_jax(port, jax, names):
    for name in names:
        assert getattr(port, name) == getattr(jax, name), name


def test_round4_plan_and_rows_match_the_committed_file():
    """The plan's 16 keys are the committed rows', in the JAX script's
    order; every system has an oracle."""
    rows = json.loads(R4.JAX_ROWS.read_text())
    jobs = R4.plan()
    assert [j.key for j in jobs] == list(rows)
    assert R4.oracle_of(dict(system_name='He', box_length=10.0)) == -1.81604
    assert R4.oracle_of(dict(system_name='He', n_space_dimension=2,
                             box_length=5.0)) == pytest.approx(-1.260612,
                                                               abs=1e-6)
    assert list(json.loads(OUT.JAX_ROWS.read_text())) == OUT.keys()
    assert [f'results/{Path(d).name}' for d, _, _ in EF.RUNS] == list(
        json.loads(EF.JAX_ROWS.read_text()))


# ---- recording stand-ins of the trainer ----------------------------------

def _losses(n: int, start: int) -> list:
    return [float(-1.0 - 1e-4 * ((start + i) % 97)) for i in range(n)]


class _Recorder:
    """Records every trainer made, every ``train``, load and evaluation,
    in order; the trainers' traces are made from the epoch count."""

    def __init__(self):
        self.calls, self.saved = [], {}

    def trainer(self, config, fields, optimizer):
        rec = self

        class Trainer:
            def __init__(self):
                self.config = config
                self.losses, self.epoch = [], 0
                self.opt_state = ()
                self.device = torch.device('cpu')
                self.graph = False
                self.step = types.SimpleNamespace(optimizer=optimizer)
                rec.calls.append(('trainer', fields))

            def train(self, num_epochs=None, verbose=True):
                rec.calls.append(('train', num_epochs))
                self.losses = self.losses + _losses(num_epochs, self.epoch)
                self.epoch += num_epochs
                rec.saved[Path(self.config.save_dir).name] = (
                    list(self.losses), self.epoch)
                return self.losses

            def load_checkpoint(self, save_dir):
                name = Path(save_dir).name
                rec.calls.append(('load', name))
                self.losses, self.epoch = rec.saved[name]
                self.losses = list(self.losses)
                return True
        return Trainer()

    def evaluate(self, trainer, **kw):
        # None is evaluate_trainer's default batch
        self.calls.append(('evaluate', dict(sorted(
            (k, v) for k, v in kw.items() if v is not None))))
        return types.SimpleNamespace(
            e_mean=-1.8155, e_stderr=4.1e-5, e_clipped=-1.81577,
            e_clipped_stderr=2e-6, e_stderr_2x=4.2e-5, e_stderr_4x=4.4e-5,
            accept_rate=0.502)


def _fields(cfg) -> dict:
    d = {k: v for k, v in dataclasses.asdict(cfg).items()
         if k not in ('compilation_cache_dir', 'device')}
    d['save_dir'] = Path(d['save_dir']).name
    return d


class _PortOptimizer:
    def __init__(self, lr):
        self.param_groups = [{'lr': lr}]

    def state_dict(self):
        return {}


def _jax_round4(stage, monkeypatch, tmp_path):
    import waveflow_tpu.vmc as jvmc
    rec = _Recorder()
    monkeypatch.setattr(JR4, 'OUT', tmp_path / 'jax_rows.json')
    monkeypatch.setattr(jvmc, 'VMCTrainer', lambda cfg: rec.trainer(
        cfg, _fields(cfg), None))
    monkeypatch.setattr(jvmc, 'evaluate_trainer', rec.evaluate)
    out = {}
    getattr(JR4, f'stage_{stage}')(out)
    return rec.calls, out


def _port_round4(stage, monkeypatch, tmp_path):
    rec = _Recorder()
    monkeypatch.setattr(R4.r5, 'VMCTrainer', lambda cfg: rec.trainer(
        cfg, _fields(cfg), _PortOptimizer(cfg.learning_rate)))
    monkeypatch.setattr(R4.r5, 'evaluate_trainer', rec.evaluate)
    monkeypatch.setattr(R4, 'oracle_of', lambda cfg: -1.0)
    _, args = R4.parse_args(['--device', 'cpu', '--only', stage,
                             '--out-dir', str(tmp_path / 'port')])
    run = R4.Run(args)
    for job in R4.plan():
        if job.stage == stage:
            R4.run_job(job, run)
    return rec.calls, run.out


@pytest.mark.parametrize('stage', R4.STAGES)
def test_round4_stage_matches_jax(stage, monkeypatch, tmp_path, capsys):
    """Every call of the stage in both scripts, in order (each trainer's
    full config with its save directory by name, the epochs of each
    ``train``, each load's checkpoint, the evaluation's arguments), and
    every figure of JAX's rows that is not a time equal to the port's up
    to JAX's rounding."""
    jax_calls, jax_rows = _jax_round4(stage, monkeypatch, tmp_path)
    port_calls, port_rows = _port_round4(stage, monkeypatch, tmp_path)
    assert port_calls == jax_calls
    assert list(port_rows) == list(jax_rows)
    for key, row in jax_rows.items():
        for field, want in row.items():
            if field not in R4.TPU_FIELDS:
                assert port_rows[key][field] == pytest.approx(
                    want, abs=1e-6), (key, field)


def test_outlier_study_matches_jax(monkeypatch, tmp_path, capsys):
    """The outlier study's 12 rows in both scripts on the stand-ins: the
    same calls in order (the decay's second trainer differs from the first
    in ``learning_rate`` alone and loads its checkpoint) and the same
    figures."""
    import waveflow_tpu.vmc as jvmc
    exact = {'box2': 0.25, 'Laplacian_interactive_particles': 0.5}
    jrec, prec = _Recorder(), _Recorder()
    monkeypatch.setattr(JOUT, 'OUT', tmp_path / 'jax_rows.json')
    monkeypatch.setattr(JOUT, 'oracle', exact.get)
    monkeypatch.setattr(jvmc, 'VMCTrainer', lambda cfg: jrec.trainer(
        cfg, _fields(cfg), None))
    JOUT.main()
    monkeypatch.setattr(OUT, 'oracle', exact.get)
    monkeypatch.setattr(OUT, 'VMCTrainer', lambda cfg: prec.trainer(
        cfg, _fields(cfg), None))
    assert OUT.main(['--device', 'cpu', '--out-dir', str(tmp_path)]) == 0
    assert prec.calls == jrec.calls
    jax_rows = json.loads((tmp_path / 'jax_rows.json').read_text())
    port_rows = json.loads((tmp_path / OUT.OUT_NAME).read_text())
    assert list(port_rows) == list(jax_rows) == OUT.keys()
    for key, row in jax_rows.items():
        for field in ('vmc_median', 'exact', 'deviation'):
            assert port_rows[key][field] == pytest.approx(row[field],
                                                          abs=1e-5)


# ---- the repair: non-finite positions and parameters ---------------------

@pytest.fixture(scope='module')
def poly_pair():
    return (jops.make_poly_evaluator(jops.get_tables('I', 4, 12, n_mesh=400)),
            tops.make_poly_evaluator(tops.get_tables('I', 4, 12, n_mesh=400),
                                     device='cpu'))


X_NAN = np.array([0.3, np.nan, 0.7, np.inf, -np.inf, 1.02, -0.01, np.nan,
                  0.5], np.float32)


def _same_non_finite(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=rtol)


@pytest.mark.parametrize('what', ['call_d0', 'call_d1', 'call_d2',
                                  'value_and_derivative', 'basis_jet'])
def test_poly_at_nan_x_matches_jax(poly_pair, what):
    """NaN where JAX is NaN (and ±inf where it is), equal elsewhere: the
    port's gather reads cell 0 for a NaN x (the cast of a NaN index raised
    before), and the NaN reaches the output through s, as in JAX."""
    jev, tev = poly_pair
    c = np.random.default_rng(0).uniform(0, 1, (X_NAN.size, jev.n_bases)
                                         ).astype(np.float32)
    jc, jx, tc, tx = jnp.asarray(c), jnp.asarray(X_NAN), _t(c), _t(X_NAN)
    if what.startswith('call'):
        d = int(what[-1])
        pairs = [(tev(tc, tx, d), jev(jc, jx, d))]
    elif what == 'value_and_derivative':
        pairs = zip(tev.value_and_derivative(tc, tx),
                    jev.value_and_derivative(jc, jx))
    else:
        pairs = [(tev.basis_jet(tx), jev.basis_jet(jx))]
    for got, want in pairs:
        _same_non_finite(got.detach().numpy(), want, rtol=2e-4)
        assert np.isnan(np.asarray(want)).any()


@pytest.mark.parametrize('kind', ['squared', 'linear'])
def test_plain_samplers_at_nan_coefficients_match_jax(kind):
    """K1's and K2's functions (the plain versions the kernels are held to
    on the card) draw NaN for a walker with NaN coefficients, as JAX's XLA
    samplers do, and the same draws elsewhere (atol 6e-5)."""
    table = ('B', 6, 23, 2000) if kind == 'squared' else ('M', 4, 12, 1000)
    jev = jops.make_evaluator(jops.get_tables(*table[:3], n_mesh=table[3]),
                              use_ob=kind == 'squared')
    tev = tops.make_evaluator(tops.get_tables(*table[:3], n_mesh=table[3]),
                              use_ob=kind == 'squared', device='cpu')
    rng = np.random.default_rng(5)
    c = rng.uniform(0.1, 1, (40, jev.n_bases)).astype(np.float32)
    c[::5] = np.nan
    u = rng.uniform(0, 1 - 1e-4, 40).astype(np.float32)
    fn = 'sample_squared_amplitude' if kind == 'squared' \
        else 'sample_linear_density'
    want = np.asarray(getattr(jsampling, fn)(jev, jnp.asarray(c),
                                             jnp.asarray(u), impl='xla'))
    got = getattr(tsampling, fn)(tev, _t(c), _t(u)).detach().numpy()
    assert np.isnan(want[::5]).all()
    _same_non_finite(got, want, rtol=6e-5)


def test_nan_run_evaluates_to_nan_in_both_packages():
    """results/he1d_seed2, every parameter NaN, on a two-block chain: the
    JAX package and the port both run to the end with non-finite raw and
    clipped energies (the accept rates are not compared)."""
    import waveflow_tpu.vmc as jvmc
    jt = jvmc.VMCTrainer(jvmc.VMCConfig(system_name='He', box_length=10.0,
                                        batch_size=256,
                                        save_dir=str(NAN_RUN)))
    assert jt.load_checkpoint(str(NAN_RUN))
    jev = jvmc.evaluate_trainer(jt, **EF.TINY_EVAL)
    trainer = EF.load_run(EF.config('He', NAN_RUN, {}, 'cpu'))
    assert all(torch.isnan(p).all() for p in trainer.model.parameters())
    ev, launches, _ = EF.evaluate(trainer, **EF.TINY_EVAL)
    for e in (jev, ev):
        assert not math.isfinite(e.e_mean) and not math.isfinite(e.e_clipped)
        assert 0.0 <= e.accept_rate <= 1.0
    assert launches == {'sampler': 0, 'basis_jet': 0}


# ---- evaluate_flagship_torch ---------------------------------------------

def _ef_args(tmp_path, **kw):
    argv = ['--device', 'cpu', '--out-dir', str(tmp_path), '--tiny-eval']
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return EF.parse_args(argv)


def test_flagship_row_of_a_committed_run(tmp_path, monkeypatch):
    """results/r4_spring100k through the script's row code on a short
    chain: JAX's fields, finite, JAX's row beside (no TPU time), the
    combined σ of both means, the launches and the device; against a
    handmade JAX row far away the gate misses and the tail pass is added."""
    monkeypatch.setattr(EF, 'oracle', EF.EXACT.get)
    args = _ef_args(tmp_path, tail_k=2)
    row = EF.run_row(SPRING_RUN, 'He', {}, args, {'device': 'cpu'})
    jax_keys = set(json.loads(EF.JAX_ROWS.read_text())[SPRING_RUN])
    assert jax_keys <= set(row)
    assert row['finite'] and row['n_samples'] == 2 * 64
    assert row['jax'] == {k: v for k, v in json.loads(
        EF.JAX_ROWS.read_text())[SPRING_RUN].items() if k != 'wall_s'}
    assert row['gate']['kind'] == 'combined sigma'
    assert 'tail' not in row or not row['gate']['in_gate']
    far = dict(row['jax'], e_mean=-1.7, e_clipped=-1.7)
    monkeypatch.setattr(EF, 'jax_row', lambda save_dir: far)
    row = EF.run_row(SPRING_RUN, 'He', {}, args, {'device': 'cpu'})
    assert row['gate']['in_gate'] is False
    assert row['tail']['k'] == 2 and len(row['tail']['rows']) == 2


def test_flagship_script_on_the_nan_run_and_rerun(tmp_path, monkeypatch,
                                                   capsys):
    """The script on results/he1d_seed2: a non-finite row, in gate with
    JAX's non-finite row, written to the out file; a rerun loads nothing."""
    monkeypatch.setattr(EF, 'oracle', EF.EXACT.get)
    argv = ['--device', 'cpu', '--out-dir', str(tmp_path), '--runs',
            'he1d_seed2', '--tiny-eval']
    assert EF.main(argv) == 0
    row = json.loads((tmp_path / EF.OUT_NAME).read_text())[
        'results/he1d_seed2']
    assert not row['finite'] and math.isnan(row['e_mean'])
    assert row['gate'] == dict(kind='non-finite in JAX', port_finite=False,
                               in_gate=True)
    monkeypatch.setattr(EF, 'load_run', lambda *a: pytest.fail('reran'))
    assert EF.main(argv) == 0
    assert EF.main(argv[:4] + ['--runs', 'no_such_run']) == 2


@pytest.mark.parametrize('port,ref,want', [
    ((-1.8156, 1e-4, -1.81580, 1e-5), (-1.8155, 1e-4, -1.81581, 1e-5), True),
    ((-1.8156, 1e-4, -1.81500, 1e-5), (-1.8155, 1e-4, -1.81581, 1e-5), False),
    ((-1.8100, 1e-4, -1.81580, 1e-5), (-1.8155, 1e-4, -1.81581, 1e-5), False),
    ((math.nan,) * 4, (-1.8155, 1e-4, -1.81581, 1e-5), False),
    ((math.nan,) * 4, (math.nan,) * 4, True),
    ((-1.8156, 1e-4, -1.81580, 1e-5), (math.nan,) * 4, False),
], ids=['in', 'clipped_out', 'raw_out', 'port_nan', 'both_nan',
        'jax_nan_port_finite'])
def test_flagship_gate(port, ref, want):
    keys = ('e_mean', 'e_stderr', 'e_clipped', 'e_clipped_stderr')
    got = EF.gate(dict(zip(keys, port)), dict(zip(keys, ref)))
    assert got['in_gate'] is want
    assert EF.gate(dict(zip(keys, port)), None) is None


# ---- round4_quality_torch and outlier_study_torch, tiny runs -------------

def test_round4_tiny_decay_row_and_rerun(tmp_path, monkeypatch, capsys):
    """li_lr3e-4_decay at small widths: 4 epochs, then the decay's second
    trainer at lr 3e-5 for 2 from the first's checkpoint, a tiny
    evaluation; the row carries the JAX row's keys and is not gated (a
    rehearsal); a rerun trains nothing."""
    real = R4.plan
    monkeypatch.setattr(R4, 'plan', lambda: [
        dataclasses.replace(j, cfg=dict(j.cfg, **SMALL)) for j in real()])
    argv = ['--device', 'cpu', '--keys', 'li_lr3e-4_decay', '--epochs', '4',
            '--decay-epochs', '2', '--tiny-eval', '--out-dir', str(tmp_path)]
    monkeypatch.setattr(R4.r5, 'EVAL_KW', dict(R4.r5.EVAL_KW))
    assert R4.main(argv) == 0
    row = json.loads((tmp_path / R4.OUT_NAME).read_text())['li_lr3e-4_decay']
    jax_keys = set(json.loads(R4.JAX_ROWS.read_text())['li_lr3e-4_decay'])
    assert jax_keys <= set(row)
    assert row['epochs'] == 6 and row['learning_rate'] == 3e-5
    assert row['exact'] == EF.EXACT['Li'] and row['finite']
    assert row['gate'] == dict(rehearsal=True, in_gate=None)
    assert (tmp_path / 'r4q_li_lr3e-4_decay' / 'checkpoints').exists()
    assert len(row['trace_chunks']['port']['chunks']) == 1
    assert len(row['trace_chunks']['jax']['chunks']) == 6
    monkeypatch.setattr(R4.r5, 'VMCTrainer', lambda cfg: pytest.fail('reran'))
    assert R4.main(argv) == 0
    # a saved row evaluated again from its checkpoint, with the tail pass
    assert R4.main(argv + ['--eval-seeds', '7', '--tail-k', '2']) == 0
    row = json.loads((tmp_path / R4.OUT_NAME).read_text())['li_lr3e-4_decay']
    assert list(row['eval_seeds']) == ['7'] and row['tail']['k'] == 2
    assert row['eval_seeds']['7']['eval_mean'] == row['eval_mean']


def test_outlier_tiny_median_abs_row_and_rerun(tmp_path, monkeypatch,
                                               capsys):
    """box2__median_abs_lr3e-4_40k at small widths for 4 epochs: the JAX
    row's keys, clip_stat 'median_abs', a finite median of the last fifth;
    a rerun trains nothing."""
    real = OUT.config
    monkeypatch.setattr(OUT, 'config', lambda key, args: dataclasses.replace(
        real(key, args), **{k: v for k, v in SMALL.items()
                            if k != 'n_flow_layers'}))
    key = 'box2__median_abs_lr3e-4_40k'
    argv = ['--device', 'cpu', '--keys', key, '--epochs', '4', '--out-dir',
            str(tmp_path)]
    assert OUT.main(argv) == 0
    row = json.loads((tmp_path / OUT.OUT_NAME).read_text())[key]
    assert set(json.loads(OUT.JAX_ROWS.read_text())[key]) <= set(row)
    assert row['clip_stat'] == 'median_abs' and row['trace_len'] == 4
    assert math.isfinite(row['vmc_median']) and row['nonfinite_losses'] == 0
    assert row['exact'] == pytest.approx(math.pi ** 2 * 5 / 200, rel=1e-12)
    monkeypatch.setattr(OUT, 'VMCTrainer', lambda cfg: pytest.fail('reran'))
    assert OUT.main(argv) == 0


@pytest.mark.parametrize('key,clipped,skipped,want', [
    ('li_spring_20k', -3.3745, 0, True),
    ('li_spring_20k', -3.3600, 0, False),
    ('spring100k', -1.81580, 0, True),
    ('spring100k', -1.81560, 0, False),
    ('spring100k', -1.81580, 2, False),
])
def test_round4_gate(key, clipped, skipped, want):
    """deviation on every row; done on the SPRING flagship rows."""
    ref = json.loads(R4.JAX_ROWS.read_text())[key]
    exact = EF.EXACT['Li' if key.startswith('li') else 'He']
    row = dict(finite=True, eval_clipped=clipped, spring_skipped=skipped,
               deviation_eval=clipped - exact,
               deviation_eval_jax=ref['eval_clipped'] - exact)
    assert R4.gate(key, row, ref)['in_gate'] is want
    assert R4.gate(key, row, None) is None


@pytest.mark.parametrize('median,want', [(0.2500, True), (0.2600, False),
                                         (math.nan, False)])
def test_outlier_gate(median, want):
    ref = json.loads(OUT.JAX_ROWS.read_text())['box2__median_abs_lr3e-4_40k']
    exact = 0.24674
    row = dict(deviation=median - exact, exact=exact)
    assert OUT.gate(row, ref)['in_gate'] is want
    assert OUT.gate(row, None) is None
