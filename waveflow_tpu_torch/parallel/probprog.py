"""Sharded probprog drivers: HMC / NUTS chains and SMC particles over the
walker axis.

Port of waveflow_tpu/parallel/probprog.py.  Chains and particles shard
over the ranks as VMC walkers do; the collectives live in the samplers
(vmc/hmc.py, vmc/nuts.py: the acceptance statistic averaged over the ranks
for ONE step size; vmc/smc.py: weights normalised over every rank, the
ESS over the global count, the resample across ranks).  This module gives
each rank its rows and its random streams, and resolves a run's ``graph``
on the group's backend: under NCCL the collectives are captured with the
step (HMC, NUTS's warm-up end, SMC), under gloo the runs are eager
(``sharding.use_graph``).
JAX's ``chain_state_spec`` (which fields of a state shard and which
replicate) has no counterpart: a rank's state holds its own chains and the
replicated step size alike.
"""

from __future__ import annotations

from waveflow_tpu_torch.parallel.mesh import WalkerMesh
from waveflow_tpu_torch.parallel.sharding import shard_batch, use_graph


def make_sharded_chain_sampler(make_sampler, log_prob_fn, mesh: WalkerMesh,
                               **sampler_kw):
    """Shard an HMC or NUTS sampler's chains over ``mesh``.

    make_sampler: vmc.hmc.make_hmc_sampler or vmc.nuts.make_nuts_sampler.
    Returns (sharded_init, make_run):
      sharded_init(positions (B, D), step_size) -> this rank's state of
        its B / world rows (every rank passes the same global chains);
      make_run(n_steps, n_warmup=0, graph=None) -> run(state, generator,
        return_info=False) -> (state, this rank's trace (n_steps,
        B / world, D)), as the sampler's ``run_fn``.  ``generator`` is
        the rank's own (``sharding.walker_generator``), so the chains are
        independent while the warm-up's step size is collective.
        ``graph``: as the sampler's, under gloo None is eager and True
        raises NotImplementedError."""
    init_fn, _, run_fn = make_sampler(log_prob_fn, axis_name=mesh.axis,
                                      **sampler_kw)

    def sharded_init(positions, step_size=0.1):
        return init_fn(shard_batch(positions, mesh), step_size)

    def make_run(n_steps: int, n_warmup: int = 0, graph: bool | None = None):
        if mesh.backend == 'gloo':
            # under NCCL the sampler resolves None itself
            graph = use_graph(graph, mesh)

        def run(state, generator, return_info: bool = False):
            return run_fn(state, generator, n_steps, n_warmup=n_warmup,
                          return_info=return_info, graph=graph)
        return run

    return sharded_init, make_run


def make_sharded_smc(log_prior_fn, log_like_fn, mesh: WalkerMesh,
                     **smc_kw):
    """Shard an SMC sampler's particle population over ``mesh``.

    Returns (sharded_init, run):
      sharded_init(particles (N, D)) -> this rank's SMCState of its N /
        world rows (every rank passes the same population);
      run(state, generator, shared_generator, return_accept=False,
          graph=None) -> (state, ess_trace) as vmc/smc.py's ``run_fn``:
        the rejuvenation noise from the rank's own ``generator``, each
        resample uniform from ``shared_generator``, which must be in the
        same state on every rank (the decision and the global index set
        must agree); ``graph`` as ``make_run``'s."""
    from waveflow_tpu_torch.vmc.smc import make_smc_sampler
    init_fn, run_fn = make_smc_sampler(log_prior_fn, log_like_fn,
                                       axis_name=mesh.axis, **smc_kw)

    def sharded_init(particles):
        return init_fn(shard_batch(particles, mesh))

    def run(state, generator, shared_generator, return_accept: bool = False,
            graph: bool | None = None):
        return run_fn(state, generator, return_accept=return_accept,
                      shared_generator=shared_generator,
                      graph=use_graph(graph, mesh))

    return sharded_init, run

