"""The density trainer's epochs and the HMC, NUTS and SMC runs as CUDA
graphs (benchmark/density.py, vmc/hmc.py, vmc/nuts.py, vmc/smc.py over
vmc/graphs.py), on the CPU.

As in test_torch_graphs.py, the graph path runs its own code — the static
state written in place, the slots, the warm-up call, the captures kept
across calls — through a stand-in whose capture records the body and
whose replay runs it eagerly, and is held to the eager path to the bit:
``train_density_model`` (MFlow and Flow, 2 blocks of 3 epochs), HMC's
``run_fn`` (warm-up, the step-size switch, kept steps, a second call on
the same captures), NUTS's (the same, with trees that stop by U-turn, by
divergence and by a NaN density, and trees that reach max_tree_depth; a
Gaussian and the posterior) and SMC's (3 temperatures, resampling).  Also:
``graph=True`` on the CPU raises; explicit SMC draws stay eager; sharded
runs under gloo are eager; a sampler holds one set of captures; a
graphed ``model=`` continuation is refused while a kept loss holds the
parameters' autograd graph; the example's ``Counted`` figures, kept on the
device, equal the eager run's."""

import importlib.util
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_graphs import EagerGraph, _stand_in
from waveflow_tpu_torch.benchmark import datasets, density
from waveflow_tpu_torch.parallel import (
    destroy_walker_mesh, make_sharded_chain_sampler, make_sharded_smc,
    make_walker_mesh)
from waveflow_tpu_torch.vmc import graphs, hmc, nuts, smc

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(spline_reg=0.05, n_flow_layers=2, spline_degree=4, n_knots=8,
             n_mesh_points=300)
POSTERIOR_MODEL = dict(spline_reg=0.1, n_flow_layers=1, spline_degree=3,
                       n_knots=4, n_mesh_points=200, prior_spline_degree=3,
                       prior_n_knots=4)


@pytest.fixture
def eager_graphs(monkeypatch):
    _stand_in(monkeypatch)


def _example():
    path = ROOT / 'examples' / 'parameter_posterior_torch.py'
    spec = importlib.util.spec_from_file_location('parameter_posterior_torch',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _posterior():
    """(log_prob (C, D) -> (C,), flat0) of a small MFlow on 32 points."""
    model = density.get_benchmark_model(
        'MFlow', **POSTERIOR_MODEL, generator=torch.Generator().manual_seed(3),
        device='cpu')
    X = torch.as_tensor(datasets.get_dataset('circles', 32))
    log_prob, _, flat0 = hmc.make_parameter_posterior(model, X,
                                                      prior_scale=2.0)
    return log_prob, flat0


def _train(model_name, graph):
    X = datasets.get_dataset('circles', 128)
    X_test = datasets.get_dataset('circles', 32, seed=7)
    return density.train_density_model(
        X, model_name=model_name, num_epochs=6, log_every=3,
        learning_rate=1e-3, n_model_sample=100, verbose=False,
        X_test=X_test, device='cpu', generator=torch.Generator().manual_seed(0),
        graph=graph, **SMALL)


@pytest.mark.parametrize('model_name', ['MFlow', 'Flow'])
def test_density_graph_path_is_the_eager_trainer(model_name, eager_graphs):
    """Two blocks of 3 epochs, each followed by its metric checkpoint: the
    graphed epoch (one capture, kept across the blocks) gives the eager
    trainer's losses, metrics, parameters and best snapshot to the bit."""
    eager_model, eager = _train(model_name, False)
    assert EagerGraph.captures == 0
    graph_model, graphed = _train(model_name, None)
    assert EagerGraph.captures == 1
    assert len(graphed['losses']) == 6 and np.isfinite(graphed['losses']).all()
    for key in ('losses', 'kl', 'hellinger', 'reconstruction', 'test_ll',
                'best_test_ll', 'best_epoch'):
        assert eager[key] == graphed[key], key
    for k, v in eager_model.state_dict().items():
        assert torch.equal(v, graph_model.state_dict()[k]), k
    for k, v in eager['best_params'].items():
        assert torch.equal(v, graphed['best_params'][k]), k


def test_hmc_graph_run_is_the_eager_run(eager_graphs):
    """HMC on a small MFlow's parameter posterior, 3 chains: 2 warm-up
    steps, the switch to exp(log ε̄), 2 kept steps, then a second call of
    3 kept steps on the same captures: every state field, the traces, the
    accept statistics and the generator equal the eager run's to the bit;
    the returned states are copies the next call does not write."""
    log_prob, flat0 = _posterior()
    init_fn, _, run_fn = hmc.make_hmc_sampler(log_prob, n_leapfrog=3)
    chains = flat0[None] + 0.01 * torch.randn(
        (3, flat0.numel()), generator=torch.Generator().manual_seed(1))
    runs = []
    for graph in (False, None):
        gen = torch.Generator().manual_seed(2)
        state = init_fn(chains, step_size=1e-3)
        first = run_fn(state, gen, 2, n_warmup=2, return_info=True,
                       graph=graph)
        kept = [f.clone() for f in first[0]]
        second = run_fn(first[0], gen, 3, return_info=True, graph=graph)
        assert all(torch.equal(a, b) for a, b in zip(kept, first[0]))
        runs.append((first, second, gen.get_state()))
    assert EagerGraph.captures == 2
    for (a_state, a_trace, a_info), (b_state, b_trace, b_info) in zip(
            runs[0][:2], runs[1][:2]):
        for field, x, y in zip(hmc.HMCState._fields, a_state, b_state):
            assert torch.equal(x, y), field
        assert torch.equal(a_trace, b_trace)
        assert torch.equal(a_info['accept'], b_info['accept'])
    assert torch.equal(runs[0][2], runs[1][2])
    # the step size moved in the warm-up and was switched after it
    assert runs[1][0][0].step_size != 1e-3


SCALES = torch.tensor([0.5, 1.0, 2.0])


def _gaussian(x):
    return -0.5 * ((x / SCALES) ** 2).sum(-1)


class _NaNOutside:
    """A Gaussian that is NaN outside |x| < 1.5, counting its NaN rows."""

    def __init__(self):
        self.nan_rows = 0

    def __call__(self, x):
        out = torch.where(x.abs().amax(-1) < 1.5, -0.5 * (x ** 2).sum(-1),
                          torch.nan)
        self.nan_rows += int(torch.isnan(out).sum())
        return out


def _nuts_case(case):
    """(log_prob, chains, max_tree_depth, step size) of a NUTS twin."""
    x0 = torch.randn((4, 3), generator=torch.Generator().manual_seed(0))
    if case == 'mflow':
        log_prob, flat0 = _posterior()
        return log_prob, flat0[None] + 0.01 * torch.randn(
            (3, flat0.numel()), generator=torch.Generator().manual_seed(1)), \
            3, 1e-3
    if case == 'nan':
        return _NaNOutside(), 0.1 * x0, 4, 0.5
    return _gaussian, x0, *{'u_turn': (4, 0.3), 'divergence': (4, 10.0),
                            'max_depth': (3, 0.01)}[case]


@pytest.mark.parametrize('case', ['u_turn', 'divergence', 'nan', 'max_depth',
                                  'mflow'])
def test_nuts_graph_run_is_the_eager_run(case, eager_graphs):
    """NUTS's ``run_fn``: 2 warm-up steps, the switch to exp(log ε̄), 2 kept
    steps, then a second call of 2 kept steps on the same captures (six:
    the step's start, a subtree's start, a leaf, a merge, the warm-up and
    the kept end): every state field, the traces, the tree depths, leaf
    counts, accept statistics, the host reads and body calls per step, and
    the generator equal the eager run's to the bit.  The cases: trees that
    stop by U-turn on an anisotropic Gaussian, by divergence (ε = 10), at
    a NaN density, trees that reach max_tree_depth (ε = 0.01), and the
    small MFlow posterior."""
    log_prob, chains, depth, eps = _nuts_case(case)
    init_fn, _, run_fn = nuts.make_nuts_sampler(log_prob,
                                                max_tree_depth=depth)
    runs = []
    for graph in (False, None):
        gen = torch.Generator().manual_seed(2)
        first = run_fn(init_fn(chains, step_size=eps), gen, 2, n_warmup=2,
                       return_info=True, graph=graph)
        assert EagerGraph.captures == (0 if graph is False else 6)
        kept = [f.clone() for f in first[0]]
        second = run_fn(first[0], gen, 2, return_info=True, graph=graph)
        assert all(torch.equal(a, b) for a, b in zip(kept, first[0]))
        runs.append((first, second, gen.get_state()))
    assert EagerGraph.captures == 6
    for (a_state, a_trace, a_info), (b_state, b_trace, b_info) in zip(
            runs[0][:2], runs[1][:2]):
        for field, x, y in zip(nuts.NUTSState._fields, a_state, b_state):
            assert torch.equal(x, y), field
        assert torch.equal(a_trace, b_trace)
        assert a_info.keys() == b_info.keys()
        for k in a_info:
            assert torch.equal(a_info[k], b_info[k]), k
    assert torch.equal(runs[0][2], runs[1][2])
    info = runs[1][0][2]
    # one gradient per leaf; a step of d doublings is 2 + 2d + n calls
    doublings = info['depth'].max(1).values
    assert torch.equal(info['calls'], 2 + 2 * doublings + info['leaves'])
    if case == 'u_turn':
        assert (info['depth'] < depth).any() and (info['depth'] > 1).any()
    elif case == 'divergence':
        assert (info['depth'][0] == 1).all() and info['accept'][0] == 0
    elif case == 'nan':
        assert log_prob.nan_rows > 0
    elif case == 'max_depth':
        assert (info['depth'] == depth).any()
    assert runs[1][0][0].step_size != eps


def test_smc_graph_run_is_the_eager_run(eager_graphs):
    """Tempered SMC over the same posterior, 16 particles, 3 temperatures
    with an ESS threshold that resamples: state, ESS trace, acceptances and
    generator to the bit, twice on one capture."""
    log_prob, flat0 = _posterior()

    def log_prior(th):
        return -0.5 * (th ** 2).sum(-1) / 4.0

    def log_like(th):
        return log_prob(th) - log_prior(th)

    init_fn, run_fn = smc.make_smc_sampler(log_prior, log_like, n_temps=3,
                                           n_mcmc_moves=2,
                                           mcmc_step_size=1e-3,
                                           ess_threshold=0.9)
    particles = flat0[None] + 0.3 * torch.randn(
        (16, flat0.numel()), generator=torch.Generator().manual_seed(1))
    runs = []
    for graph in (False, None):
        gen = torch.Generator().manual_seed(4)
        out = []
        state = init_fn(particles)
        for _ in range(2):
            state, ess, acc = run_fn(state, gen, return_accept=True,
                                     graph=graph)
            out.append((state, ess, acc))
        runs.append((out, gen.get_state()))
    assert EagerGraph.captures == 1
    for (a_state, a_ess, a_acc), (b_state, b_ess, b_acc) in zip(
            runs[0][0], runs[1][0]):
        for field, x, y in zip(smc.SMCState._fields, a_state, b_state):
            assert torch.equal(x, y), field
        assert torch.equal(a_ess, b_ess) and torch.equal(a_acc, b_acc)
    assert (runs[1][0][0][1] < 0.9).any()
    assert torch.equal(runs[0][1], runs[1][1])


def _graph_true_call(what):
    if what == 'density':
        return _train('Flow', True)
    log_prob, flat0 = _posterior()
    if what == 'hmc':
        init_fn, _, run_fn = hmc.make_hmc_sampler(log_prob, n_leapfrog=2)
        return run_fn(init_fn(flat0[None]), torch.Generator(), 1, graph=True)
    if what == 'nuts':
        init_fn, _, run_fn = nuts.make_nuts_sampler(log_prob,
                                                    max_tree_depth=2)
        return run_fn(init_fn(flat0[None]), torch.Generator(), 1, graph=True)
    init_fn, run_fn = smc.make_smc_sampler(
        lambda th: -0.5 * (th ** 2).sum(-1), log_prob, n_temps=2)
    return run_fn(init_fn(flat0[None].repeat(4, 1)), torch.Generator(),
                  graph=True)


@pytest.mark.parametrize('what', ['density', 'hmc', 'nuts', 'smc'])
def test_graph_true_on_the_cpu_raises(what):
    with pytest.raises(ValueError, match='graph=True needs a CUDA device'):
        _graph_true_call(what)


def test_eager_only_paths():
    """SMC fed explicit draws is eager (graph=True raises, None runs)."""
    def target(x):
        return -0.5 * (x ** 2).sum(-1)
    init_fn, run_fn = smc.make_smc_sampler(target, target, n_temps=1,
                                           n_mcmc_moves=1)
    d = [smc.draw(torch.Generator(), 1, 4, 3, 'cpu')]
    with pytest.raises(ValueError, match='explicit draws is eager'):
        run_fn(init_fn(torch.zeros(4, 3)), draws=d, graph=True)
    state, ess = run_fn(init_fn(torch.zeros(4, 3)), draws=d)
    assert ess.shape == (1,) and torch.isfinite(state.particles).all()


@pytest.fixture
def gloo_world1():
    mesh = make_walker_mesh(device='cpu')
    yield mesh
    destroy_walker_mesh()


def test_sharded_runs_under_gloo_are_eager(gloo_world1, eager_graphs):
    """gloo's collectives cannot be captured: over a gloo world of one the
    sharded HMC, NUTS and SMC runs resolve graph=None to eager (no capture,
    even with every device taken for a CUDA one) and raise for True."""
    def target(x):
        return -0.5 * (x ** 2).sum(-1)
    assert gloo_world1.backend == 'gloo'
    x0 = torch.randn((4, 3), generator=torch.Generator().manual_seed(0))
    for maker in (hmc.make_hmc_sampler, nuts.make_nuts_sampler):
        init, make_run = make_sharded_chain_sampler(maker, target,
                                                    gloo_world1)
        state, trace = make_run(2, 1)(init(x0), torch.Generator())
        assert trace.shape == (2, 4, 3) and torch.isfinite(trace).all()
        with pytest.raises(NotImplementedError, match='gloo'):
            make_run(2, 1, graph=True)
    init, run = make_sharded_smc(target, target, gloo_world1, n_temps=2,
                                 n_mcmc_moves=1)
    state, ess = run(init(x0), torch.Generator(), torch.Generator())
    assert ess.shape == (2,) and torch.isfinite(state.particles).all()
    with pytest.raises(NotImplementedError, match='gloo'):
        run(init(x0), torch.Generator(), torch.Generator(), graph=True)
    assert EagerGraph.captures == 0


class HeldGraph(EagerGraph):
    """``EagerGraph`` that keeps a weak reference to every window."""
    windows = weakref.WeakSet()

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        HeldGraph.windows.add(self)


@pytest.mark.parametrize('sampler', ['hmc', 'nuts', 'smc'])
def test_a_sampler_holds_one_set_of_captures(sampler, eager_graphs,
                                             monkeypatch):
    """A sampler keeps the captures of its last graphed run, for the next
    call at the same shape and generator: calls with a second generator,
    and back, leave one set alive (HMC's warm-up and kept steps, NUTS's six
    bodies, SMC's temperature), not one per generator."""
    monkeypatch.setattr(graphs, 'EpochGraph', HeldGraph)

    def target(x):
        return -0.5 * (x ** 2).sum(-1)
    x0 = torch.randn((4, 3), generator=torch.Generator().manual_seed(0))
    if sampler == 'hmc':
        init_fn, _, run_fn = hmc.make_hmc_sampler(target, n_leapfrog=2)

        def call(gen):
            return run_fn(init_fn(x0), gen, 1, n_warmup=1)
        per_set = 2
    elif sampler == 'nuts':
        init_fn, _, run_fn = nuts.make_nuts_sampler(target, max_tree_depth=3)

        def call(gen):
            return run_fn(init_fn(x0), gen, 1, n_warmup=1)
        per_set = 6
    else:
        init_fn, run_fn = smc.make_smc_sampler(target, target, n_temps=2,
                                               n_mcmc_moves=1)

        def call(gen):
            return run_fn(init_fn(x0), gen)
        per_set = 1
    first, second = torch.Generator(), torch.Generator()
    for gen in (first, first, second, first):
        call(gen)
    alive = [w for w in HeldGraph.windows if w.graph is not None]
    assert len(alive) == per_set
    # the second call at one key replays; each change of key captures anew
    assert EagerGraph.captures == 3 * per_set


@pytest.mark.parametrize('sampler', ['hmc', 'nuts', 'smc'])
def test_counted_figures_equal_the_eager_run(sampler, eager_graphs):
    """The example's figures on the graph path: ``Counted`` adds to device
    counters inside the body, which a replay repeats, so the density
    calls, gradient calls and rows equal the eager run's."""
    ex = _example()
    kw = dict(n_train=24, n_test=16, n_chains=2, n_steps=2, n_warmup=2,
              hmc_leapfrog=2, nuts_depth=2, n_particles=4, n_temps=3,
              n_mcmc_moves=2, device='cpu', verbose=False)
    eager = ex.run_posterior(sampler, graph=False, **kw)
    assert EagerGraph.captures == 0
    graphed = ex.run_posterior(sampler, **kw)
    assert EagerGraph.captures == {'hmc': 2, 'nuts': 6, 'smc': 1}[sampler]
    keys = ('density_calls', 'grad_calls', 'n_draws', 'accept')
    if sampler == 'nuts':
        keys += ('mean_tree_depth', 'calls_per_step', 'host_reads_per_step')
    for key in keys:
        assert graphed[key] == eager[key], key
    assert graphed['density_calls'] > 0
    assert (graphed['grad_calls'] > 0) == (sampler != 'smc')


def test_graphed_continuation_refused_while_a_loss_is_kept(eager_graphs):
    """``train_density_model(model=...)`` graphed, while a loss from an
    eager forward still holds the parameters' autograd graph (whose grad
    accumulators a capture cannot wait on): RuntimeError before the first
    epoch, the parameters untouched; once the loss is dropped, it runs and
    equals the eager continuation, which may keep it, to the bit."""
    X = datasets.get_dataset('circles', 128)

    def fresh():
        return density.get_benchmark_model(
            'MFlow', **SMALL, generator=torch.Generator().manual_seed(5),
            device='cpu')

    def train(model, graph):
        return density.train_density_model(
            X, model=model, num_epochs=3, log_every=3, learning_rate=1e-3,
            n_model_sample=100, verbose=False, device='cpu', graph=graph,
            generator=torch.Generator().manual_seed(0))[1]['losses']

    eager, graphed = fresh(), fresh()
    x = torch.as_tensor(X)
    kept = [-m.log_pdf(x).mean() for m in (eager, graphed)]
    before = {k: v.clone() for k, v in graphed.state_dict().items()}
    with pytest.raises(RuntimeError, match='still alive'):
        train(graphed, None)
    for k, v in before.items():
        assert torch.equal(v, graphed.state_dict()[k]), k
    eager_losses = train(eager, False)
    kept.clear()
    assert train(graphed, None) == eager_losses
    assert EagerGraph.captures == 1
    for k, v in eager.state_dict().items():
        assert torch.equal(v, graphed.state_dict()[k]), k
