"""The port's windows as CUDA graphs (waveflow_tpu_torch/vmc/graphs.py), on
the CPU.

A CUDA graph needs the card, so these tests run the graph path's own code —
the static buffers, the copies in and out, the warm-up epoch, the
trainer's capture life cycle — with a stand-in whose capture records the
body and whose replay runs it eagerly (``EagerGraph``), and hold it to the
eager windows to the bit: the ancestral adam window (both estimators, a
non-zero baseline), the Metropolis and MALA windows, SR and SPRING with
each kind of walker, and the frozen-parameter evaluation.  Also:
``graph=True`` on the CPU raises; the launch bookkeeping adds the captured
counts once per replay (a stand-in for the CUDA graph object); every
(optimizer, sampler) pair is graphed; SPRING's state is written in place;
a recovery after non-finite losses and a checkpoint load capture again;
Adam's state in its capturable form from a JAX checkpoint and through the
port's own."""

import contextlib
import copy
import gc
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.vmc import VMCConfig as JVMCConfig
from waveflow_tpu.vmc import VMCTrainer as JVMCTrainer
from waveflow_tpu_torch import ops
from waveflow_tpu_torch.convert import (
    adam_state_from_jax, load_jax_checkpoint, params_from_jax)
from waveflow_tpu_torch.ops import cuda_jet, cuda_sampler, cuda_spline
from waveflow_tpu_torch.utils.checkpoint import load_state, save_state
from waveflow_tpu_torch.vmc import (
    VMCConfig, VMCTrainer, evaluate_energy, graphs, run_window,
)
from waveflow_tpu_torch.vmc.estimators import TrainWindow
from waveflow_tpu_torch.vmc.evaluate import evaluation_windows
from waveflow_tpu_torch.vmc.mala import MALATrainWindow, make_mala_train_window
from waveflow_tpu_torch.vmc.metropolis import (
    MCMCTrainWindow, make_mcmc_train_window)
from waveflow_tpu_torch.vmc.trainer import graph_windows

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JAX_RUN = ROOT / 'results' / 'he1d_metropolis_seed7'
FLAGSHIP_DIR = ROOT / 'results' / 'r5_flagship_fwd_batched_100k'
SMALL = dict(batch_size=8, num_knots=8, n_flow_layers=1, spline_degree=4,
             n_spline_base_mesh_points=400, device='cpu')


class _Replayer:
    """A captured body: replay runs it eagerly."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class EagerGraph(graphs.EpochGraph):
    """``EpochGraph`` on the CPU: the warm-up epoch runs in place, the
    capture records the body without running it (as a CUDA capture does)
    and counts, and each replay runs the body."""
    captures = 0

    def _warm_up(self):
        self.body()

    def _capture(self):
        EagerGraph.captures += 1
        return _Replayer(self.body), (0,) * len(ops.read_launches())


def _stand_in(monkeypatch):
    monkeypatch.setattr(graphs, 'EpochGraph', EagerGraph)
    monkeypatch.setattr(graphs, 'use_graph',
                        lambda graph, device: graph is not False)
    EagerGraph.captures = 0


@pytest.fixture
def eager_graphs(monkeypatch):
    """The graph path of every window, on the CPU, through ``EagerGraph``."""
    _stand_in(monkeypatch)


def _optimizer_tensors(t):
    """The optimizer state's tensors by name: Adam's per parameter,
    SPRING's delta and counters, none for SR."""
    state = t.step.optimizer.state_dict()
    if state == ():
        return {}
    if 'state' in state:
        return {(i, k): v for i, st in state['state'].items()
                for k, v in st.items()}
    return dict(state)


def _assert_same_training(a, b):
    assert a.losses == b.losses and np.isfinite(a.losses).all()
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)
    sa, sb = _optimizer_tensors(a), _optimizer_tensors(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.baseline, b.baseline)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize('estimator', ['clipped_score', 'reference'])
def test_run_window_graph_path_is_the_eager_window(estimator, eager_graphs):
    """Two windows of 4, the first at a baseline of -1.8, the second at the
    first's mean: ``TrainWindow`` (the static epoch, one warm-up epoch, the
    capture kept across the windows, the baseline copied into its buffer,
    replays) gives the eager ``run_window``'s losses, baselines,
    parameters, Adam state and generator to the bit."""
    runs = []
    for graph in (False, True):
        t = VMCTrainer(VMCConfig(estimator=estimator, **SMALL), graph=False)
        window = (TrainWindow(t.step, t.sample, 8, 'cpu', (t.generator,))
                  if graph else
                  lambda n, b: run_window(t.step, t.sample, 8, n, b))
        baseline, losses = torch.tensor(-1.8), []
        for _ in range(2):
            got, baseline = window(4, baseline)
            assert torch.equal(baseline, got.mean())
            losses.append(got)
        t.losses, t.baseline = torch.cat(losses).tolist(), baseline
        runs.append(t)
    _assert_same_training(*runs)
    assert EagerGraph.captures == 1


@pytest.mark.parametrize('kind', [
    dict(), dict(estimator='reference'), dict(sampler='metropolis'),
    dict(sampler='metropolis', mcmc_refresh_every=2), dict(sampler='mala'),
    dict(optimizer='sr', sr_cg_iters=3), dict(optimizer='spring'),
    dict(optimizer='spring', sampler='metropolis'),
    dict(optimizer='sr', sampler='mala', sr_cg_iters=3)])
def test_trainer_graph_path_is_the_eager_trainer(kind, eager_graphs):
    """Three windows of 2 epochs and one single epoch: the trainer on its
    graph path (one capture kept across windows; a refreshed or carried
    Metropolis or MALA state and the previous window's baseline copied into
    the static buffers) against ``graph=False``, for adam, SR and SPRING:
    losses, parameters, optimizer state (Adam's moments, SPRING's delta and
    counters), baseline, generator, walkers and accept rates to the bit."""
    cfg = VMCConfig(window=2, **SMALL, **kind)
    eager = VMCTrainer(cfg, graph=False)
    graphed = VMCTrainer(cfg)
    assert graphed.graph and not eager.graph
    for t in (eager, graphed):
        t.train(7, verbose=False)
    _assert_same_training(eager, graphed)
    assert EagerGraph.captures == 1
    if 'sampler' in kind:
        assert eager.accept_rates == graphed.accept_rates
        for x, y in zip(eager.mcmc_state, graphed.mcmc_state):
            assert torch.equal(x, y)


def test_mcmc_window_returns_copies(eager_graphs):
    """The graphed Metropolis window hands back copies of its static
    walkers, so a state the caller keeps (the trainer's snapshot) is not
    written by the next window."""
    t = VMCTrainer(VMCConfig(window=2, sampler='metropolis', **SMALL))
    m0 = t._init_mcmc_state()
    _, _, _, m1 = t.mcmc_window(m0, 2, torch.zeros(()), t.generator)
    kept = [f.clone() for f in m1]
    t.mcmc_window(m1, 2, torch.zeros(()), t.generator)
    assert all(torch.equal(a, b) for a, b in zip(kept, m1))


@pytest.mark.parametrize('ladder', [False, True])
def test_evaluate_energy_graph_path_is_the_eager_evaluation(ladder,
                                                             eager_graphs):
    """The two graphs of ``evaluate_energy`` (a warmup sweep replayed, a
    block of frozen sweeps + E_L + its row replayed) against the eager
    evaluation from the same walkers and seed: every field to the bit."""
    t = VMCTrainer(VMCConfig(**SMALL))
    x0 = t.model.sample(16, generator=torch.Generator().manual_seed(3))
    out = []
    for graph in (False, True):
        out.append(evaluate_energy(
            t.model.psi, t.h_fn, t.model.log_pdf, 10.0, x0,
            torch.Generator().manual_seed(5), n_blocks=4,
            sweeps_per_block=3, n_warmup_sweeps=5, clip_ladder=ladder,
            graph=graph))
    a, b = out
    np.testing.assert_array_equal(a.block_means, b.block_means)
    for field in a._fields:
        if field != 'block_means':
            assert np.array_equal(getattr(a, field), getattr(b, field),
                                  equal_nan=True), field
    assert EagerGraph.captures == 2


def _window_call(what):
    """A window function called with graph=True on the CPU."""
    t = VMCTrainer(VMCConfig(window=2, sampler='metropolis', **SMALL))
    if what == 'evaluation_windows':
        return evaluation_windows(t.model.psi, t.h_fn, t.model.log_pdf, 10.0,
                                  t.sample(8), graph=True)
    if what == 'TrainWindow':
        return TrainWindow(t.step, t.sample, 8, 'cpu')
    if what == 'mcmc_window':
        _, window = make_mcmc_train_window(t.step, t.model.log_pdf, 10.0,
                                           n_sweeps=1, graph=True)
        return window(t._init_mcmc_state(), 2, torch.zeros(()), t.generator)
    if what == 'mala_window':
        init, window = make_mala_train_window(t.step, t.model.log_pdf, 10.0,
                                              n_sweeps=1, graph=True)
        return window(init(t.sample(8)), 2, torch.zeros(()), t.generator)
    if what == 'evaluate_energy':
        return evaluate_energy(t.model.psi, t.h_fn, t.model.log_pdf, 10.0,
                               t.sample(8), n_blocks=2, sweeps_per_block=1,
                               n_warmup_sweeps=1, graph=True)
    return VMCTrainer(VMCConfig(**SMALL), graph=True)


@pytest.mark.parametrize('what', ['evaluation_windows', 'TrainWindow',
                                  'mcmc_window', 'mala_window',
                                  'evaluate_energy', 'VMCTrainer'])
def test_graph_true_on_the_cpu_raises(what):
    with pytest.raises(ValueError, match='graph=True needs a CUDA device'):
        _window_call(what)


class _FakeCudaGraph:
    def __init__(self):
        self.replays, self.generators = 0, []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.replays += 1


class _CountingGraph(graphs.EpochGraph):
    """``EpochGraph`` with only the card's parts stood in for: the warm-up
    runs in place and the capture runs the body under no stream."""

    def new_graph(self):
        return _FakeCudaGraph()

    def capturing(self, graph):
        return contextlib.nullcontext()

    def _warm_up(self):
        self.body()


def test_launch_bookkeeping_adds_the_captured_counts_per_replay(monkeypatch):
    """An epoch whose body launches K3 12 times, K1 twice, K4's forward
    and backward kernels once each, its pair entry 3 times, its jet entry
    8 times and its backward jet entry 3 times: the warm-up epoch counts as
    it runs, the capture counts nothing (its count is put back), and each
    replay adds the capture's count once; the graph holds the registered
    generator."""
    for m, a in ops.LAUNCH_COUNTERS:
        monkeypatch.setattr(m, a, 0)

    def body():
        cuda_jet.launches += 12
        cuda_sampler.launches += 2
        cuda_spline.launches += 1
        cuda_spline.launches_bwd += 1
        cuda_spline.launches_pair += 3
        cuda_spline.launches_jet += 8
        cuda_spline.launches_bwd_jet += 3

    gen = torch.Generator()
    epoch = _CountingGraph(body, generators=(gen,))
    epoch()
    assert ops.read_launches() == (12, 2, 0, 1, 1, 3, 8, 3)
    assert epoch.launches == (12, 2, 0, 1, 1, 3, 8, 3)
    for n in range(1, 5):
        epoch()
        assert epoch.graph.replays == n
        assert ops.read_launches() == (12 * (n + 1), 2 * (n + 1), 0,
                                          n + 1, n + 1, 3 * (n + 1),
                                          8 * (n + 1), 3 * (n + 1))
    assert epoch.graph.generators == [gen]
    epoch.reset()
    epoch()
    assert epoch.graph.replays == 0
    assert ops.read_launches() == (72, 12, 0, 6, 6, 18, 48, 18)


@pytest.mark.parametrize('sampler', ['ancestral', 'metropolis', 'mala'])
@pytest.mark.parametrize('optimizer', ['adam', 'sr', 'spring'])
def test_graphed_pairs(optimizer, sampler, monkeypatch):
    """Every (optimizer, sampler) pair is graphed: ``graph_windows`` says
    yes on a CUDA device by default, never on the CPU, and no to
    graph=False; the trainer on the graph path (the stand-in) holds one
    graphed window of its sampler's kind, and ``graph=False`` none (its
    MCMC window runs eagerly)."""
    assert graph_windows('cuda') is True
    assert graph_windows('cpu') is False
    assert graph_windows('cuda', False) is False
    _stand_in(monkeypatch)
    cfg = VMCConfig(optimizer=optimizer, sampler=sampler, **SMALL)
    kind = {'ancestral': TrainWindow, 'metropolis': MCMCTrainWindow,
            'mala': MALATrainWindow}[sampler]
    t = VMCTrainer(cfg)
    assert t.graph and [type(w) for w in t._graphed] == [kind]
    assert t._graphed[0] is (t.train_window if sampler == 'ancestral'
                             else t.mcmc_window)
    eager = VMCTrainer(cfg, graph=False)
    assert not eager.graph and not hasattr(eager, 'train_window')
    assert all(w.graph is False for w in eager._graphed)


def test_spring_state_is_written_in_place(eager_graphs):
    """SPRING's delta and counters are the tensors the captured epoch was
    recorded on: held from before the first window, they advance with every
    epoch — the warm-up epoch and the replays — across windows (a step that
    rebound ``step.optimizer.state`` to new tensors would leave them at
    zero), and ``load_state_dict`` copies a saved state into them without
    sharing the saved tensors."""
    t = VMCTrainer(VMCConfig(window=2, optimizer='spring', **SMALL))
    held = dict(t.step.optimizer.state_dict())
    ptrs = {k: v.data_ptr() for k, v in held.items()}
    deltas = []
    for n in (2, 4):
        t.train(2, verbose=False)
        assert int(held['step']) == n
        assert int(held['skipped']) == int(held['fallbacks']) == 0
        deltas.append(held['delta'].clone())
    assert EagerGraph.captures == 1
    assert deltas[0].abs().sum() > 0 and not torch.equal(*deltas)
    state = t.step.optimizer.state_dict()
    assert all(state[k] is held[k] for k in held)
    assert {k: v.data_ptr() for k, v in state.items()} == ptrs
    saved = copy.deepcopy(state)
    t.train(2, verbose=False)
    assert int(held['step']) == 6 and int(saved['step']) == 4
    t.step.optimizer.load_state_dict(saved)
    assert int(held['step']) == 4 and torch.equal(held['delta'], deltas[1])
    t.train(2, verbose=False)
    assert int(saved['step']) == 4 and torch.equal(saved['delta'], deltas[1])


def _nan_second_window(window):
    """``window`` whose second call returns non-finite losses."""
    calls = []

    def wrapped(*args):
        calls.append(args)
        losses, base = window(*args)
        return (losses * float('nan') if len(calls) == 2 else losses), base
    return wrapped, calls


def test_recovery_captures_again(eager_graphs, monkeypatch):
    """A window with a non-finite loss restores the optimizer's state by
    ``load_state_dict``, which swaps its tensors: the graph is dropped and
    the next window captures again (2 captures in all), and the run equals
    the eager one's to the bit."""
    from waveflow_tpu_torch.vmc import trainer as trainer_module
    runs = []
    for graph in (False, None):
        t = VMCTrainer(VMCConfig(window=2, **SMALL), graph=graph)
        if t.graph:
            t.train_window, calls = _nan_second_window(t.train_window)
        else:
            wrapped, calls = _nan_second_window(trainer_module.run_window)
            monkeypatch.setattr(trainer_module, 'run_window', wrapped)
        t.train(6, verbose=False)
        assert len(calls) == 3 and len(t.losses) == 4
        runs.append(t)
    _assert_same_training(*runs)
    assert EagerGraph.captures == 2


def test_load_checkpoint_captures_again(tmp_path, eager_graphs):
    """A checkpoint load replaces the optimizer's state tensors: the
    trainer drops its capture and the next window captures again."""
    cfg = VMCConfig(window=2, save_dir=str(tmp_path), **SMALL)
    t = VMCTrainer(cfg)
    t.train(2, verbose=False)
    assert EagerGraph.captures == 1
    t.load_checkpoint(str(tmp_path))
    assert t.train_window.epochs.graph is None
    t.train(2, verbose=False)
    assert EagerGraph.captures == 2


@pytest.mark.parametrize('capturable', [False, True])
def test_adam_state_from_jax_capturable(capturable):
    """The JAX run's flat Adam moments in either form: ``step`` a float32
    tensor equal to the JAX count — on the parameter's device in the
    capturable form — and the same moments."""
    ck = load_jax_checkpoint(JAX_RUN / 'checkpoints')
    t = VMCTrainer(VMCConfig(sampler='metropolis', **SMALL | dict(
        num_knots=23, n_flow_layers=3, spline_degree=6,
        n_spline_base_mesh_points=2000, batch_size=256)))
    named = list(t.model.named_parameters())
    plain = adam_state_from_jax(ck['opt_state'], ck['params'], named)
    got = adam_state_from_jax(ck['opt_state'], ck['params'], named,
                              capturable=capturable)
    count = float(ck['epoch'])
    for name, p in named:
        step = got[name]['step']
        assert step.dtype == torch.float32 and step.ndim == 0
        assert step.device == p.device
        assert step.item() == count
        for k in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(got[name][k], plain[name][k])


def test_capturable_state_survives_the_checkpoint_round_trip(tmp_path):
    """A checkpoint whose Adam state is in the capturable form (as the
    card writes it: the groups marked capturable, float32 step counts)
    resumes on the CPU — the device decides the form — and continues the
    run to the bit."""
    kw = dict(window=2, **SMALL)
    straight = VMCTrainer(VMCConfig(**kw))
    straight.train(4, verbose=False)
    first = VMCTrainer(VMCConfig(**kw))
    first.train(2, verbose=False)
    first.save_checkpoint(str(tmp_path))
    state = load_state(tmp_path / 'checkpoints')
    for g in state['optimizer']['param_groups']:
        g['capturable'] = True
    for s in state['optimizer']['state'].values():
        assert s['step'].dtype == np.float32
    save_state(tmp_path / 'checkpoints', state)
    second = VMCTrainer(VMCConfig(**kw))
    assert second.load_checkpoint(str(tmp_path))
    groups = second.step.optimizer.param_groups
    assert all(g['capturable'] is False for g in groups)
    second.train(2, verbose=False)
    assert second.losses == straight.losses
    for a, b in zip(straight.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)


def test_graph_window_from_a_jax_checkpoint_matches_jax(eager_graphs):
    """The committed 100k JAX checkpoint with its Adam moments, through the
    graph path: ``TrainWindow`` (the stand-in) over the trainer's step (the
    main path, 'clipped_score'), two epochs on two fixed batches of 64,
    against the JAX trainer's ``step_jit`` on the same batches from the
    same checkpoint — the losses rtol 1e-4 and the parameters rtol 1e-4,
    atol 1e-7 (the tolerances of
    test_torch_checkpoint.py::test_jax_checkpoint_one_step_matches_jax)."""
    t = VMCTrainer(VMCConfig(eval_backend='poly_pallas', device='cpu'))
    assert t.graph and t.load_checkpoint(str(FLAGSHIP_DIR))
    batches = [t.model.sample(64, generator=torch.Generator().manual_seed(s))
               for s in (5, 6)]
    feed = iter(batches)
    window = TrainWindow(t.step, lambda n: next(feed), 64, 'cpu')
    losses, _ = window(2, torch.zeros(()))
    assert EagerGraph.captures == 1

    jt = JVMCTrainer(JVMCConfig(compilation_cache_dir=None))
    assert jt.load_checkpoint(str(FLAGSHIP_DIR))
    params, opt_state, jlosses = jt.params, jt.opt_state, []
    for batch in batches:
        params, opt_state, loss = jt.step_jit(
            params, opt_state, jnp.asarray(batch.numpy()), jnp.zeros(()))
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-4)
    ref = params_from_jax(jax.device_get(params))
    named = dict(t.model.named_parameters())
    for k in ref:
        np.testing.assert_allclose(named[k].detach().numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_capture_collects_first_and_holds_the_collector_off():
    """Garbage from earlier windows is collected before the capture, and
    the cyclic collector stays off during it (a graph destroyed inside a
    capture invalidates it), then is on again, also after a body that
    raises."""
    seen = []
    epoch = _CountingGraph(lambda: seen.append(gc.isenabled()))
    assert gc.isenabled()
    epoch()
    assert seen == [True, False] and gc.isenabled()

    def fails():
        if len(seen) == 3:
            raise RuntimeError('capture failed')
        seen.append(gc.isenabled())
    with pytest.raises(RuntimeError, match='capture failed'):
        _CountingGraph(fails)()
    assert gc.isenabled()
