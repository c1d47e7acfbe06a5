"""The round-5 quality studies on the port (examples/round5_quality_torch.py)
against the JAX script (benchmarks/round5_quality.py), on the CPU:

  * a trainer resumed from the port's own checkpoint at another learning
    rate trains at its own rate, as the JAX trainer does (optax keeps no
    hyperparameter in its state): one adam step each side at lr 3e-4, a
    save, a reload at lr 3e-5 and a second step, parameters crossed by
    ``convert.params_from_jax``;
  * every stage's calls — trainers and their configs, training epochs,
    checkpoint loads, evaluations, EDs, fidelities, timed windows — equal
    the JAX script's, both scripts run on stand-ins that record them (so
    nothing trains and nothing is written under results/); the rows they
    build from the same stand-in figures agree (trace median, deviations,
    the x-sector floor); the flagship row's config equals JAX's
    ``VMCConfig`` for it;
  * the gates on fixed numbers;
  * one decay row rehearsed end to end at a small width;
  * the ``ng_spring_65k`` row names the device's memory and no TPU figure.
"""

import dataclasses
import importlib.util
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.vmc import VMCConfig as JVMCConfig
from waveflow_tpu.vmc import VMCTrainer as JVMCTrainer
from waveflow_tpu.vmc.estimators import make_loss_fn as jmake_loss_fn
from waveflow_tpu_torch.convert import params_from_jax
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


R5 = _load('round5_quality_torch', ROOT / 'examples' / 'round5_quality_torch.py')
SMALL = dict(spline_degree=3, num_knots=6, n_flow_layers=1,
             n_spline_base_mesh_points=300)
JAX_STAGES = ('antisym', 'li_refresh', 'box4', 'ng_scale', 'antisym2d_free')


# ---- the learning rate after a reload ---------------------------------------

def test_resumed_adam_takes_its_own_learning_rate(tmp_path):
    """He-1d, degree 3, 6 knots, one layer, 8 walkers: the JAX trainer and
    the port's from the same parameters each take one adam step at lr 3e-4
    on one explicit batch and save; a trainer at lr 3e-5 reloads each
    side's own checkpoint (the port's through its own state dict) and
    takes one step on a second batch.  The parameters agree as in
    tests/test_torch_catalogue.py::test_train_step_matches_jax (rtol 1e-4,
    atol 1e-7 where both steps' |g| are above float noise; |Δ| within 2 lr
    per step everywhere), and the reloaded Adam reads lr 3e-5."""
    lrs = (3e-4, 3e-5)
    common = dict(system_name='He', batch_size=8, **SMALL)
    jdir, tdir = tmp_path / 'jax', tmp_path / 'torch'
    jt = JVMCTrainer(JVMCConfig(learning_rate=lrs[0], save_dir=str(jdir),
                                compilation_cache_dir=None, **common))
    t = VMCTrainer(VMCConfig(learning_rate=lrs[0], save_dir=str(tdir),
                             device='cpu', **common))
    t.model.load_state_dict(params_from_jax(jax.device_get(jt.params)))
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(2):
        u = torch.as_tensor(rng.uniform(0.0, 1.0, (2, 8)),
                            dtype=torch.float32)
        with torch.no_grad():
            batches.append(t.model.sample(8, u=u))
    grad = jax.jit(jax.grad(jmake_loss_fn(jt.psi, jt.h_fn)))
    zero = jnp.zeros(())

    jgrads = [grad(jt.params, jnp.asarray(batches[0].numpy()), zero)]
    jt.params, jt.opt_state, _ = jt.step_jit(
        jt.params, jt.opt_state, jnp.asarray(batches[0].numpy()), zero)
    jt.epoch = 1
    jt.save_checkpoint(str(jdir))
    t.step(batches[0], torch.zeros(()))
    t.epoch = 1
    t.save_checkpoint(str(tdir))

    jt2 = JVMCTrainer(JVMCConfig(learning_rate=lrs[1], save_dir=str(jdir),
                                 compilation_cache_dir=None, **common))
    assert jt2.load_checkpoint(str(jdir))
    jgrads.append(grad(jt2.params, jnp.asarray(batches[1].numpy()), zero))
    new_params, _, jloss = jt2.step_jit(
        jt2.params, jt2.opt_state, jnp.asarray(batches[1].numpy()), zero)
    t2 = VMCTrainer(VMCConfig(learning_rate=lrs[1], save_dir=str(tdir),
                              device='cpu', **common))
    assert t2.step.optimizer.param_groups[0]['lr'] == lrs[1]
    assert t2.load_checkpoint(str(tdir)) and t2.epoch == 1
    loss = t2.step(batches[1], torch.zeros(()))
    assert t2.step.optimizer.param_groups[0]['lr'] == lrs[1]
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)

    ref = params_from_jax(jax.device_get(new_params))
    grads = [params_from_jax(jax.device_get(g)) for g in jgrads]
    g_max = [max(v.abs().max().item() for v in g.values()) for g in grads]
    named = dict(t2.model.named_parameters())
    for k in ref:
        defined = np.logical_and.reduce(
            [(g[k].abs() > 1e-5 * m).numpy() for g, m in zip(grads, g_max)])
        got, want = named[k].detach().numpy(), ref[k].numpy()
        np.testing.assert_allclose(got[defined], want[defined], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
        assert np.abs(got - want).max() <= 2 * sum(lrs) + 1e-7, k


# ---- the job lists, run on recording stand-ins ------------------------------

def _losses(n: int, start: int) -> list:
    """A deterministic loss trace for epochs start .. start + n."""
    e = np.arange(start, start + n)
    return list(-1.0 + 0.3 * np.exp(-e / 4000.0) + 1e-3 * np.sin(e))


class _Recorder:
    """The calls a script makes, in order, and the loss traces its
    trainers 'saved' (by save-directory name) for the next to load."""

    def __init__(self):
        self.calls = []
        self.saved = {}

    def trainer(self, config, fields, own_optimizer):
        rec = self

        class Trainer:
            def __init__(self):
                self.config = config
                self.losses, self.epoch = [], 0
                self.psi = self.params = None
                self.opt_state = ()
                self.model = types.SimpleNamespace(psi=None)
                self.device = 'cpu'
                self.step = types.SimpleNamespace(optimizer=own_optimizer)
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
        self.calls.append(('evaluate', dict(sorted(kw.items()))))
        return types.SimpleNamespace(
            e_mean=-1.2604, e_stderr=5.1e-5, e_clipped=-1.26073,
            e_clipped_stderr=3.1e-5, e_stderr_2x=4.8e-5, e_stderr_4x=5.2e-5,
            accept_rate=0.499)

    def ed(self, name, n_states, *rest):
        self.calls.append(('ed', name, n_states))
        return (np.zeros(n_states), np.ones((10, n_states)),
                np.zeros((4, 2)), np.linspace(-1.0, 1.0, 2))

    def fidelity(self, *args, **kw):
        psi = next(a for a in args if isinstance(a, np.ndarray))
        self.calls.append(('fidelity', psi.shape))
        return 0.99993

    def timed_train(self, trainer, budget_s, window):
        self.calls.append(('timed_train', budget_s, window))
        trainer.train(num_epochs=window)
        return 3 * window, 180.0


def _fields(cfg) -> dict:
    """A config's fields for the comparison: the save directory by its
    name; JAX's compilation cache and the port's device left out."""
    d = {k: v for k, v in dataclasses.asdict(cfg).items()
         if k not in ('compilation_cache_dir', 'device')}
    d['save_dir'] = Path(d['save_dir']).name
    return d


class _JaxOptimizer:
    pass


def run_jax_stage(stage: str, monkeypatch, tmp_path):
    """(calls, rows) of the JAX script's stage on the stand-ins."""
    import waveflow_tpu.utils.fidelity as jfidelity
    import waveflow_tpu.vmc as jvmc
    jr5 = _load('round5_quality', ROOT / 'benchmarks' / 'round5_quality.py')
    rec = _Recorder()
    monkeypatch.setattr(jr5, 'OUT', tmp_path / 'jax_rows.json')
    monkeypatch.setattr(jr5, '_save', lambda out: None)
    monkeypatch.setattr(jr5, '_ed_2d2e', rec.ed)
    monkeypatch.setattr(jr5, '_timed_train', rec.timed_train)
    monkeypatch.setattr(jvmc, 'VMCTrainer', lambda cfg: rec.trainer(
        cfg, _fields(cfg), _JaxOptimizer()))
    monkeypatch.setattr(jvmc, 'evaluate_trainer', rec.evaluate)
    monkeypatch.setattr(jfidelity, 'fidelity_2d_2e', rec.fidelity)
    out = {}
    getattr(jr5, f'stage_{stage}')(out)
    return rec.calls, out


class _PortOptimizer:
    """The stand-in trainer's optimizer: no SPRING counters, Adam's lr."""

    def __init__(self, lr):
        self.param_groups = [{'lr': lr}]

    def state_dict(self):
        return {}


def run_port_stage(stage: str, monkeypatch, tmp_path):
    """(calls, rows) of the port script's stage on the stand-ins, every job
    of the plan at its defaults."""
    rec = _Recorder()
    monkeypatch.setattr(R5, 'VMCTrainer', lambda cfg: rec.trainer(
        cfg, _fields(cfg), _PortOptimizer(cfg.learning_rate)))
    monkeypatch.setattr(R5, 'evaluate_trainer', rec.evaluate)
    monkeypatch.setattr(R5, 'fidelity_2d_2e', rec.fidelity)
    monkeypatch.setattr(R5, 'ed_2d2e', rec.ed)
    monkeypatch.setattr(R5, '_timed_train', rec.timed_train)
    _, args = R5.parse_args(['--device', 'cpu',
                             '--out-dir', str(tmp_path / 'port')])
    run = R5.Run(args)
    R5.STAGE_FNS[stage]([j for j in R5.plan() if j.stage == stage], run)
    return rec.calls, run.out


@pytest.mark.parametrize('stage', JAX_STAGES)
def test_stage_calls_match_jax(stage, monkeypatch, tmp_path, capsys):
    """Every call of the stage in both scripts, in order: each trainer's
    full config (every VMCConfig field, the save directory by name), the
    epochs of each ``train`` call, the checkpoint each load reads (the
    decay's second trainer differs from the first in ``learning_rate``
    alone), the evaluation's arguments, the ED (system, states) and the
    fidelity's ED state shape, the timed windows' budget and window; and
    the same rows."""
    jax_calls, jax_rows = run_jax_stage(stage, monkeypatch, tmp_path)
    port_calls, port_rows = run_port_stage(stage, monkeypatch, tmp_path)
    assert port_calls == jax_calls
    assert list(port_rows) == list(jax_rows)
    for key, row in jax_rows.items():
        missing = set(row) - set(port_rows[key]) - {'infeasible'}
        assert not missing, (key, missing)


@pytest.mark.parametrize('stage', JAX_STAGES)
def test_row_logic_matches_jax(stage, monkeypatch, tmp_path, capsys):
    """The rows both scripts build from the same stand-in traces and
    evaluations: every figure of JAX's row that is not a time (trace
    median over the last 20%, the evaluation's fields, the oracles, the
    deviations, below_floor and its σ, the fidelity, the references, the
    ng budget and epochs) equal to the port's up to JAX's rounding."""
    _, jax_rows = run_jax_stage(stage, monkeypatch, tmp_path)
    _, port_rows = run_port_stage(stage, monkeypatch, tmp_path)
    times = set(R5.TPU_FIELDS)
    for key, row in jax_rows.items():
        got = port_rows[key]
        for field, want in row.items():
            if field in times:
                continue
            if isinstance(want, (bool, str, dict)):
                assert got[field] == want, (key, field)
            else:
                tol = 5e-3 if field == 'below_floor_sigma' else 1e-6
                assert got[field] == pytest.approx(want, abs=tol), (key,
                                                                    field)


def test_trace_median_matches_jax():
    """``_trace_median`` (the last 20% of the trace) equals JAX's on
    traces of several lengths."""
    jr5 = _load('round5_quality', ROOT / 'benchmarks' / 'round5_quality.py')
    rng = np.random.default_rng(4)
    for n in (7, 100, 1001, 40_000):
        losses = rng.standard_normal(n).astype(np.float32)
        assert R5._trace_median(losses) == jr5._trace_median(losses)


def test_flagship_config_matches_jax(tmp_path):
    """The flagship row's resolved config — VMCConfig(system_name='He',
    box_length=10.0, batch_size=256, window=100, seed=2), every other field
    at its default — equals JAX's VMCConfig for the same recipe (the
    committed run's system_info.json: He, L = 10, batch 256, window 100),
    field for field but the save directory, the logging stride, JAX's
    compilation cache and the port's device."""
    import json
    job = next(j for j in R5.plan() if j.stage == 'flagship')
    assert (job.key, job.epochs, job.decay) == (
        'flagship_fwd_batched_100k', 100_000, None)
    _, args = R5.parse_args(['--device', 'cpu', '--out-dir', str(tmp_path)])
    got = dataclasses.asdict(R5.Run(args).config(job, job.key))
    want = dataclasses.asdict(JVMCConfig(**job.cfg))
    skip = {'save_dir', 'log_every', 'compilation_cache_dir', 'device'}
    assert {k: v for k, v in got.items() if k not in skip} == {
        k: v for k, v in want.items() if k not in skip}
    info = json.loads((ROOT / 'results' / 'r5_flagship_fwd_batched_100k'
                       / 'system_info.json').read_text())
    for k in ('system_name', 'box_length', 'window', 'batch_size',
              'n_space_dimension'):
        assert got[k] == info[k], k


# ---- the gates --------------------------------------------------------------

def _job(key):
    return next(j for j in R5.plan() if j.key == key)


GATE_CASES = [
    # (key, row figures, JAX's figures, in gate)
    ('flagship_fwd_batched_100k', dict(eval_clipped=-1.81585), {}, True),
    ('flagship_fwd_batched_100k', dict(eval_clipped=-1.81565), {}, False),
    ('flagship_fwd_batched_100k', dict(eval_clipped=-1.81605), {}, False),
    # He-2d: floor, deviation within max(2 |dev_jax|, 3e-3), fidelity
    ('he2d2e_antisym', dict(eval_clipped=-1.2605, deviation_eval=1.1e-4,
                            fidelity_ed40=0.9996),
     dict(deviation_eval=-0.00012, fidelity_ed40=0.999935), True),
    ('he2d2e_antisym', dict(eval_clipped=-1.2605, deviation_eval=0.0029,
                            fidelity_ed40=0.9996),
     dict(deviation_eval=-0.00012, fidelity_ed40=0.999935), False),
    ('he2d2e_antisym', dict(eval_clipped=-1.2605, deviation_eval=1.1e-4,
                            fidelity_ed40=0.9993),
     dict(deviation_eval=-0.00012, fidelity_ed40=0.999935), False),
    ('he2d2e_antisym', dict(eval_clipped=-1.25885, deviation_eval=1e-3,
                            fidelity_ed40=0.9996),
     dict(deviation_eval=-0.00012, fidelity_ed40=0.999935), False),
    ('h2_2d2e_antisym', dict(eval_clipped=-1.186, deviation_eval=-0.0032,
                             fidelity_ed40=0.9999),
     dict(deviation_eval=-0.000205, fidelity_ed40=0.999954), True),
    ('h2_2d2e_antisym', dict(eval_clipped=-1.186, deviation_eval=-0.0033,
                             fidelity_ed40=0.9999),
     dict(deviation_eval=-0.000205, fidelity_ed40=0.999954), False),
    ('box2_2d_antisym', dict(eval_clipped=0.3452, deviation_eval=0.0027),
     dict(deviation_eval=-0.000222), True),
    ('box2_2d_antisym', dict(eval_clipped=0.3452, deviation_eval=0.0028),
     dict(deviation_eval=-0.000222), False),
    # box4: the catalogue gate [-3 stderr, max(3 dev_jax, dev_jax + 3e-3)]
    ('box4_free', dict(eval_clipped=1.49, deviation_eval=0.0188),
     dict(deviation_eval=0.006299), True),
    ('box4_free', dict(eval_clipped=1.49, deviation_eval=0.0190),
     dict(deviation_eval=0.006299), False),
    ('box4_free', dict(eval_clipped=1.48, deviation_eval=-0.0004),
     dict(deviation_eval=0.006299), False),
]


@pytest.mark.parametrize('key,figures,jax_figures,want', GATE_CASES)
def test_gate_on_fixed_numbers(key, figures, jax_figures, want):
    """Each gate of the required rows on numbers either side of its
    limits (clipped stderr 1e-4 throughout; finite rows), and a non-finite
    row outside every gate."""
    row = dict(eval_clipped_stderr=1e-4, finite=True, **figures)
    verdict = R5.gate(_job(key), row, jax_figures)
    assert verdict['in_gate'] is want
    row['finite'] = False
    assert R5.gate(_job(key), row, jax_figures)['in_gate'] is False


def test_ng_gate_and_ungated_rows():
    """An ng row is in its gate when it finished with finite figures, out
    with a failure; the rows without a gate (the big ansatz, Li, Be) get
    None and carry their combined σ only."""
    ng = _job('ng_sr_65k')
    assert R5.gate(ng, dict(finite=True), None)['in_gate'] is True
    assert R5.gate(ng, dict(finite=True, failed='OOM'), None)[
        'in_gate'] is False
    for key in ('he2d2e_antisym_big', 'li_metro_refresh100_s3',
                'be4_interacting'):
        assert R5.gate(_job(key), dict(finite=True), None) is None
    assert R5.combined_sigma(1.0, 3.0, 0.0, 4.0) == pytest.approx(0.2)
    assert R5.combined_sigma(1.0, None, 0.0, 4.0) is None


# ---- a CPU rehearsal of one decay row ---------------------------------------

def test_cpu_rehearsal_of_a_decay_row(tmp_path, capsys):
    """box2_2d_antisym end to end at degree 3, 6 knots, one layer, 8
    walkers, windows of 2: 6 epochs at lr 3e-4, the resumed trainer 4 more
    at 3e-5, an evaluation of 4 blocks of 2 sweeps at 16 walkers: every
    loss finite, the resumed Adam at the decay's rate, epochs 6 + 4, the
    row with every key of JAX's row, JAX's row beside it without its TPU
    times, and the row kept in the out-dir's file."""
    import json
    job = _job('box2_2d_antisym')
    job = dataclasses.replace(job, cfg={**job.cfg, **SMALL, 'batch_size': 8,
                                        'window': 2},
                              eval_batch=16, eval_blocks=4)
    _, args = R5.parse_args(['--device', 'cpu', '--out-dir', str(tmp_path),
                             '--epochs', '6', '--decay-epochs', '4'])
    run = R5.Run(args)
    kw = dict(R5.EVAL_KW)
    try:
        R5.EVAL_KW.update(sweeps_per_block=2, n_warmup_sweeps=2)
        R5.stage_antisym2d_free([job], run)
    finally:
        R5.EVAL_KW.update(kw)
    row = run.out['box2_2d_antisym']
    losses = np.load(tmp_path / 'r5_box2_2d_antisym' / 'loss.npy')
    assert losses.shape == (10,) and np.isfinite(losses).all()
    assert row['finite'] and row['learning_rate'] == 3e-5
    assert row['epochs'] == 10
    jax_rows = json.loads((ROOT / 'results' / 'round5_quality.json')
                          .read_text())
    assert set(jax_rows['box2_2d_antisym']) <= set(row)
    assert row['jax'] == {k: v for k, v in jax_rows['box2_2d_antisym'].items()
                          if k not in ('epochs_per_sec', 'wall_s')}
    assert row['gate']['in_gate'] in (True, False)
    assert row['deviation_eval'] == row['eval_clipped'] - row['exact_analytic']
    kept = json.loads((tmp_path / R5.OUT_NAME).read_text())
    assert kept['box2_2d_antisym']['epochs'] == 10
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{')]
    assert [p['key'] for p in printed] == ['box2_2d_antisym']


def test_spring_65k_row_names_the_device_memory(tmp_path, monkeypatch,
                                                capsys):
    """The SPRING run the grid leaves out: its row gives the Gram's bytes
    (65,536² × 4) beside the device's memory as
    torch.cuda.get_device_properties reads it (stood in here), and no TPU
    figure: no 'v5e', 'TPU' or 'HBM' in it, JAX's verdict left out."""
    monkeypatch.setattr(R5, 'device_info', lambda device: {
        'device': 'NVIDIA H100 80GB HBM3', 'card':
        'NVIDIA H100 80GB HBM3, 700.00 W', 'memory_bytes': 85_520_809_984})
    _, args = R5.parse_args(['--out-dir', str(tmp_path)])
    run = R5.Run(args)
    R5.stage_ng_scale([_job('ng_spring_65k')], run)
    row = run.out['ng_spring_65k']
    assert row['gram_bytes'] == 65536 ** 2 * 4
    assert row['device_memory_bytes'] == 85_520_809_984
    assert row['gram_share_of_device_memory'] == pytest.approx(
        65536 ** 2 * 4 / 85_520_809_984)
    text = str({k: v for k, v in row.items()
                if k not in ('device', 'card')})
    for word in ('v5e', 'TPU', 'HBM', 'infeasible'):
        assert word not in text, word
    assert math.isfinite(row['gram_share_of_device_memory'])


def test_ed_reads_the_committed_files(tmp_path):
    """The antisym stage's ED: the committed 40-point states, He's doubly
    degenerate pair (1,279,200 × 2) and H2's one, read without writing
    anything to the out-dir."""
    for name, n_states in (('He', 2), ('H2', 1)):
        evals, psi, sites, x = R5.ed_2d2e(name, n_states, tmp_path)
        assert psi.shape == (40 ** 2 * (40 ** 2 - 1) // 2, n_states)
        assert evals.shape == (n_states,) and sites.shape == (1600, 2)
        assert x.shape == (40,)
    assert list(tmp_path.iterdir()) == []
