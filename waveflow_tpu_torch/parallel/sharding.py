"""Walker-sharded training and sampling.

Port of waveflow_tpu/parallel/sharding.py.  Every rank holds the whole
parameter vector and optimizer state and its own ``global_batch / world``
walkers, which it draws from its own generator (``walker_generator``: the
seed combined with the rank, where JAX splits one key per device; rank 0's
is the single-process stream, so a world of one is the unsharded run to
the bit).  Each rank computes ψ, the local energies and its gradient on its
walkers; the estimators average the loss and the gradients over the walker
axis (vmc/estimators.py, vmc/sr.py), so every rank applies the same
update and the parameters stay replicated without being sent anywhere.

Each ``make_sharded_*`` has the signature of its single-process
counterpart in the port, plus the ``WalkerMesh``; a global batch that the
world does not divide raises ValueError, as in JAX.  Under NCCL a window
runs as a replayed CUDA graph with its collectives inside it, as the
unsharded window does (vmc/graphs.py); under gloo, whose collectives cannot
be captured, it runs eagerly (``use_graph``).
"""

from __future__ import annotations

import torch

from waveflow_tpu_torch.parallel import mesh as mesh_lib
from waveflow_tpu_torch.parallel.mesh import WALKER_AXIS, WalkerMesh
from waveflow_tpu_torch.vmc import graphs


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s walker stream: ``seed`` itself on rank
    0, a stream 2³² apart on every other rank."""
    return seed + rank * 2 ** 32


def walker_generator(seed: int, mesh: WalkerMesh) -> torch.Generator:
    """This rank's walker generator on its device."""
    return torch.Generator(mesh.device).manual_seed(
        rank_seed(seed, mesh.rank))


def local_batch_size(global_batch: int, mesh: WalkerMesh) -> int:
    """Walkers per rank; ValueError unless the world divides the batch."""
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by the "
                         f"walker mesh of {mesh.size} ranks")
    return global_batch // mesh.size


def shard_batch(batch: torch.Tensor, mesh: WalkerMesh) -> torch.Tensor:
    """This rank's rows of a batch every rank holds whole."""
    n = local_batch_size(batch.shape[0], mesh)
    return batch[mesh.rank * n:(mesh.rank + 1) * n]


def psum_mean(x: torch.Tensor, axis=WALKER_AXIS) -> torch.Tensor:
    """The mean over the local batch and the walker axis."""
    return mesh_lib.pmean(x.mean(), axis)


def use_graph(graph: bool | None, mesh: WalkerMesh) -> bool:
    """A sharded window's ``graph`` argument: vmc/graphs.py::use_graph on
    the rank's device, except under gloo, whose collectives a CUDA graph
    cannot capture: there None means eager and True raises
    NotImplementedError."""
    if mesh.backend == 'gloo':
        if graph:
            raise NotImplementedError(
                "gloo's collectives cannot be captured in a CUDA graph: the "
                "windows of a gloo world run eagerly (graph=None)")
        return False
    return graphs.use_graph(graph, mesh.device)


def make_sharded_train_step(psi, h_fn, params, learning_rate: float,
                            mesh: WalkerMesh, **step_kw):
    """vmc/estimators.py::make_train_step with the loss and the gradients
    averaged over the walker axis: ``step(local_batch, baseline) -> loss``,
    the loss replicated."""
    from waveflow_tpu_torch.vmc.estimators import make_train_step
    return make_train_step(psi, h_fn, params, learning_rate,
                           pmean_axis=mesh.axis, **step_kw)


def make_sharded_sampler(sample_fn, mesh: WalkerMesh):
    """``make(num_samples) -> sharded_sample(generator)``: this rank's
    ``num_samples / world`` draws ``sample_fn(n, generator=generator)``
    from its own generator; exact sampling needs no collective."""
    def make(num_samples: int):
        n_local = local_batch_size(num_samples, mesh)

        def sharded_sample(generator=None):
            return sample_fn(n_local, generator=generator)
        return sharded_sample
    return make


def _window(step, sample_fn, local_batch: int, window: int,
            mesh: WalkerMesh, generators, graph):
    """``run(baseline) -> (losses (window,), next baseline)`` of ``step``
    on ``local_batch`` draws of ``sample_fn`` per epoch, graphed or eager
    (``use_graph``); ``run.step`` is the step."""
    from waveflow_tpu_torch.vmc.estimators import TrainWindow, run_window
    if use_graph(graph, mesh):
        graphed = TrainWindow(step, sample_fn, local_batch, mesh.device,
                              generators)

        def run(baseline):
            return graphed(window, baseline)
        run.reset = graphed.reset
    else:
        def run(baseline):
            return run_window(step, sample_fn, local_batch, window, baseline)
    run.step = step
    return run


def make_sharded_train_window(psi, h_fn, sample_fn, params,
                              learning_rate: float, global_batch: int,
                              window: int, mesh: WalkerMesh, generators=(),
                              graph: bool | None = None, **step_kw):
    """``window`` epochs of [this rank's draws ``sample_fn(global_batch /
    world)`` -> the sharded adam step]: ``run(baseline) -> (losses,
    next baseline)``, the losses replicated.  ``generators``: the CUDA
    generators ``sample_fn`` draws from (a graph registers them)."""
    step = make_sharded_train_step(psi, h_fn, params, learning_rate, mesh,
                                   **step_kw)
    return _window(step, sample_fn, local_batch_size(global_batch, mesh),
                   window, mesh, generators, graph)


def make_sharded_sr_window(model, h_fn, sample_fn, learning_rate: float,
                           global_batch: int, window: int, mesh: WalkerMesh,
                           damping: float = 1e-3, cg_iters: int = 20,
                           max_update_norm: float | None = None,
                           generators=(), graph: bool | None = None):
    """The SR window (vmc/sr.py::make_sr_train_window) on this rank's
    walkers, every batch expectation of the CG solve averaged over the
    walker axis: each CG iteration is one all-reduce of a parameter-sized
    vector, and every rank runs the same solve.  Graphed or eager as
    ``make_sharded_train_window``."""
    from waveflow_tpu_torch.vmc.sr import make_sr_train_step
    step = make_sr_train_step(model, h_fn, learning_rate, damping=damping,
                              cg_iters=cg_iters, pmean_axis=mesh.axis,
                              max_update_norm=max_update_norm)
    return _window(step, sample_fn, local_batch_size(global_batch, mesh),
                   window, mesh, generators, graph)


def make_sharded_spring_window(model, h_fn, sample_fn, learning_rate: float,
                               global_batch: int, window: int,
                               mesh: WalkerMesh, damping: float = 1e-3,
                               momentum: float = 0.99,
                               max_update_norm: float | None = None,
                               score_row_clip: float | None = 10.0,
                               score_row_clip_warmup: int | None = 1000,
                               generators=(), graph: bool | None = None):
    """The SPRING window on this rank's walkers: the global (B, B) Gram
    matrix from column-chunked all-gathers of the local score blocks,
    solved alike on every rank (vmc/sr.py); the state (previous update
    and counters) replicated.  Graphed or eager as
    ``make_sharded_train_window``."""
    from waveflow_tpu_torch.vmc.sr import make_spring_train_step
    step = make_spring_train_step(
        model, h_fn, learning_rate, damping=damping, momentum=momentum,
        pmean_axis=mesh.axis, max_update_norm=max_update_norm,
        score_row_clip=score_row_clip,
        score_row_clip_warmup=score_row_clip_warmup)
    return _window(step, sample_fn, local_batch_size(global_batch, mesh),
                   window, mesh, generators, graph)


def make_sharded_mcmc_window(step, log_pdf, box_length: float,
                             mesh: WalkerMesh, n_sweeps: int = 10,
                             target_accept: float = 0.5,
                             sort_fermions: bool | str = True,
                             train_step=None, graph: bool | None = None):
    """The Metropolis window (vmc/metropolis.py::make_mcmc_train_window) on
    this rank's walkers: one collective step size (the accept fraction of
    each sweep averaged over the walker axis); ``step`` (or ``train_step``)
    must be a sharded step over ``mesh``.  Returns (init_fn, window); the
    walker state a rank holds is its own rows, the step size replicated."""
    from waveflow_tpu_torch.vmc.metropolis import make_mcmc_train_window
    return make_mcmc_train_window(
        step, log_pdf, box_length, n_sweeps=n_sweeps,
        target_accept=target_accept, pmean_axis=mesh.axis,
        sort_proposals=sort_fermions, train_step=train_step,
        graph=use_graph(graph, mesh))


def make_sharded_mala_window(step, log_pdf, box_length: float,
                             mesh: WalkerMesh, n_sweeps: int = 10,
                             target_accept: float = 0.574,
                             sort_fermions: bool | str = True,
                             train_step=None, graph: bool | None = None):
    """The MALA window (vmc/mala.py::make_mala_train_window) on this rank's
    walkers, with one collective step size; graphed or eager as
    ``make_sharded_mcmc_window``."""
    from waveflow_tpu_torch.vmc.mala import make_mala_train_window
    return make_mala_train_window(
        step, log_pdf, box_length, n_sweeps=n_sweeps,
        target_accept=target_accept, pmean_axis=mesh.axis,
        sort_fermions=sort_fermions, train_step=train_step,
        graph=use_graph(graph, mesh))
