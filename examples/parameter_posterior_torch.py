"""Bayesian posterior over FLOW PARAMETERS on the PyTorch/CUDA port
(cf. examples/parameter_posterior.py).

An MFlow density model's parameters θ get a Gaussian prior, the circles
dataset supplies the likelihood through the flow's own log_pdf (kernel K4
and its backward kernel on the card, one launch each for all chains), and
NUTS (or HMC / SMC with --sampler) samples p(θ | X).  Reports the held-out
log-likelihood at the random init, of the best single posterior draw and
of the posterior predictive (Bayesian model average over the draws).

Usage:
  python examples/parameter_posterior_torch.py [--sampler nuts|hmc|smc]
      [--n-train 300] [--n-steps 200] [--n-warmup 150] [--device cuda]
      [--seed 0] [--sharded] [--eager]
  torchrun --nproc-per-node N examples/parameter_posterior_torch.py --sharded

On the card HMC's steps, NUTS's trajectory bodies (a step's start, a
subtree's start, a leaf, a merge, a step's end) and SMC's temperatures
replay as CUDA graphs, as the JAX example jits its scans (vmc/hmc.py,
vmc/nuts.py, vmc/smc.py; under gloo they run eagerly); --eager runs them
op by op.

--sharded splits the chains (SMC: the particles) over the ranks of the
process group (parallel/probprog.py; without torchrun, a world of one
process): each rank samples its own rows with its own generator, the
warm-up adapts one step size (SMC: weights, ESS and resample over every
rank), and the draws are gathered for the evaluation.  Rates and K4
launches are each rank's own.

The last line is one JSON object of the run's figures: the card, the
posterior dimension, the sampling wall time, gradient evaluations per
second, the adapted step size and acceptance, NUTS's mean tree depth and
its body calls (replays on the card) and host reads per step, K4 launches
per gradient, and the three held-out log-likelihoods.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch
from torch.func import functional_call, vmap

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.benchmark import get_dataset
from waveflow_tpu_torch.benchmark.density import get_benchmark_model
from waveflow_tpu_torch.ops import cuda_spline
from waveflow_tpu_torch.parallel import (
    all_gather, make_sharded_chain_sampler, make_sharded_smc,
    make_walker_mesh, rank_seed, walker_generator,
)
from waveflow_tpu_torch.vmc import (
    make_hmc_sampler, make_nuts_sampler, make_parameter_posterior,
    make_smc_sampler,
)

# the small MFlow of the JAX example, so the posterior dimension stays
# NUTS-friendly (D = 10,816)
MODEL = dict(spline_reg=0.1, n_flow_layers=1, spline_degree=3, n_knots=6,
             n_mesh_points=800, prior_spline_degree=3, prior_n_knots=6)
SMC = dict(n_particles=128, n_temps=30, n_mcmc_moves=5)
N_DRAWS = 64


class Counted:
    """A log density that counts its batched calls, the gradient
    evaluations among them, and their rows, in device tensors that each
    call adds to: a replayed CUDA graph calls nothing in Python, and
    repeats the additions it captured."""

    def __init__(self, fn, device):
        self.fn = fn
        self.calls, self.grad_calls, self.grad_rows = (
            torch.zeros((), dtype=torch.int64, device=device)
            for _ in range(3))

    def __call__(self, theta):
        self.calls.add_(1)
        if torch.is_grad_enabled():
            self.grad_calls.add_(1)
            self.grad_rows.add_(theta.shape[0])
        return self.fn(theta)


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def posterior_target(n_train=300, n_test=1000, prior_scale=2.0,
                     device=None, seed=0):
    """(model, log_prob (chains, D) -> (chains,), unravel, flat0, X_test):
    the example MFlow, its weights from ``seed``, and the posterior over
    its parameters given ``n_train`` circles points."""
    X = get_dataset('circles', n_samples=n_train + n_test)
    X_train = torch.as_tensor(X[:n_train], device=device)
    X_test = torch.as_tensor(X[n_train:], device=device)
    model = get_benchmark_model('MFlow', **MODEL, device=device,
                                generator=torch.Generator().manual_seed(seed))
    log_prob, unravel, flat0 = make_parameter_posterior(
        model, X_train, prior_scale=prior_scale)
    return model, log_prob, unravel, flat0, X_test


def run_posterior(sampler='nuts', n_train=300, n_test=1000, n_chains=8,
                  n_steps=200, n_warmup=150, prior_scale=2.0,
                  step_size=2e-3, nuts_depth=6, hmc_leapfrog=16,
                  n_particles=SMC['n_particles'], n_temps=SMC['n_temps'],
                  n_mcmc_moves=SMC['n_mcmc_moves'], device=None, seed=0,
                  verbose=True, profile=None, sharded=False,
                  graph=None) -> dict:
    """Sample the posterior over the example MFlow's parameters and
    evaluate it on held-out points; returns the run's figures.
    ``profile(run)``, where given, is handed a stretch of two more steps
    (SMC: the ``n_temps`` temperatures again, from the final state) after
    the timed run, on the same samplers (replays, where they are graphed),
    and its result goes into the figures as 'profile'.  ``sharded``: the
    chains or particles split over the walker group (``make_walker_mesh``).
    ``graph``: the samplers' (None replays them as CUDA graphs on the
    card, False runs them eagerly)."""
    device = resolve_device(device)
    mesh = make_walker_mesh(device) if sharded else None
    if mesh is not None:
        device = mesh.device
    model, log_prob, unravel, flat0, X_test = posterior_target(
        n_train, n_test, prior_scale, device, seed)
    log_prob = Counted(log_prob, device)
    D = flat0.numel()
    if verbose:
        print(f"posterior dimension: {D} flow parameters", flush=True)

    gen = torch.Generator(device).manual_seed(seed + 1)
    run_gen = gen
    if mesh is not None and mesh.size > 1:
        # the initial chains from a stream every rank shares, the moves from
        # each rank's own (one stream, gen, over one rank)
        gen = torch.Generator(device).manual_seed(rank_seed(seed + 1,
                                                            mesh.size))
        run_gen = walker_generator(seed + 1, mesh)
    figures = {}
    sync(device)
    k4 = (cuda_spline.launches, cuda_spline.launches_bwd)
    t0 = time.perf_counter()
    if sampler == 'smc':
        def log_prior(th):
            return -0.5 * (th ** 2).sum(-1) / prior_scale ** 2

        def log_like(th):
            return log_prob(th) - log_prior(th)

        particles = flat0[None] + 0.1 * torch.randn(
            (n_particles, D), generator=gen, device=device)
        smc_kw = dict(n_temps=n_temps, n_mcmc_moves=n_mcmc_moves,
                      mcmc_step_size=step_size)
        if mesh is None:
            init_fn, run_fn = make_smc_sampler(log_prior, log_like,
                                               **smc_kw)
            state, ess, acc = run_fn(init_fn(particles), gen,
                                     return_accept=True, graph=graph)
        else:
            init_fn, run_fn = make_sharded_smc(log_prior, log_like, mesh,
                                               **smc_kw)
            state, ess, acc = run_fn(init_fn(particles), run_gen, gen,
                                     return_accept=True, graph=graph)
        draws = (state.particles if mesh is None
                 else all_gather(state.particles, mesh.axis))
        figures.update(accept=float(acc.mean()), ess_min=float(ess.min()),
                       n_resamples=int((ess < 0.5).sum()))
        n_iter = n_temps

        def stretch():
            if mesh is None:
                return run_fn(state, gen, graph=graph)
            return run_fn(state, run_gen, gen, graph=graph)
    else:
        chains = flat0[None] + 0.01 * torch.randn(
            (n_chains, D), generator=gen, device=device)
        maker, kw = ((make_nuts_sampler, dict(max_tree_depth=nuts_depth))
                     if sampler == 'nuts' else
                     (make_hmc_sampler, dict(n_leapfrog=hmc_leapfrog)))
        if mesh is None:
            init_fn, _, run_fn = maker(log_prob, **kw)
            state = init_fn(chains, step_size=step_size)
            state, trace, info = run_fn(
                state, gen, n_steps, n_warmup=n_warmup, return_info=True,
                graph=graph)
            keep = trace[n_steps // 2:]
        else:
            init_fn, make_run = make_sharded_chain_sampler(maker, log_prob,
                                                           mesh, **kw)
            state = init_fn(chains, step_size=step_size)
            state, trace, info = make_run(n_steps, n_warmup, graph)(
                state, run_gen, return_info=True)
            # every rank's chains over the kept half: (steps, chains, D)
            keep = all_gather(trace[n_steps // 2:].transpose(0, 1),
                              mesh.axis).transpose(0, 1)
        keep = keep.reshape(-1, D)
        draws = keep[::max(1, keep.shape[0] // N_DRAWS)][:N_DRAWS]
        figures.update(step_size=float(state.step_size),
                       accept=float(info['accept'][n_warmup:].mean()))
        if sampler == 'nuts':
            figures['mean_tree_depth'] = float(
                info['depth'][n_warmup:].float().mean())
            figures['max_tree_depth'] = int(info['depth'].max())
            figures['calls_per_step'] = float(info['calls'].float().mean())
            figures['host_reads_per_step'] = float(
                info['host_reads'].float().mean())
        n_iter = n_warmup + n_steps

        def stretch():
            if mesh is None:
                return run_fn(state, gen, 2, graph=graph)
            return make_run(2, graph=graph)(state, run_gen)
    sync(device)
    wall = time.perf_counter() - t0
    k4 = (cuda_spline.launches - k4[0], cuda_spline.launches_bwd - k4[1])
    calls, grad_calls = int(log_prob.calls), int(log_prob.grad_calls)
    figures.update(
        sampler=sampler, D=D, ranks=1 if mesh is None else mesh.size,
        sampling_s=wall, ms_per_step=1e3 * wall / n_iter,
        density_calls=calls, grad_calls=grad_calls,
        grad_evals_per_s=int(log_prob.grad_rows) / wall,
        grad_calls_per_s=grad_calls / wall, n_draws=draws.shape[0])
    # kernel launches (a CPU run runs K4's plain version and counts none)
    figures.update(k4_per_density_call=k4[0] / max(calls, 1),
                   k4_bwd_per_grad_call=k4[1] / max(grad_calls, 1))
    if verbose:
        print(f"{sampler} sampling: {wall:.1f}s, {draws.shape[0]} posterior "
              f"draws", flush=True)
    if profile is not None:
        figures['profile'] = profile(stretch)

    # posterior-predictive held-out LL (Bayesian model average)
    with torch.no_grad():
        per_draw = vmap(lambda th: functional_call(
            model, unravel(th), (X_test,)))(draws)      # (n_draws, n_test)
        init_ll = float(model.log_pdf(X_test).mean())
    bma = torch.logsumexp(per_draw.double(), 0) - math.log(draws.shape[0])
    figures.update(init_ll=init_ll, best_draw_ll=float(per_draw.mean(1).max()),
                   bma_ll=float(bma.mean()),
                   finite=bool(torch.isfinite(per_draw).all()))
    if verbose:
        print(f"held-out LL  init(random): {figures['init_ll']:.4f}   "
              f"best single draw: {figures['best_draw_ll']:.4f}   "
              f"posterior BMA: {figures['bma_ll']:.4f}", flush=True)
    return figures


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--sampler', default='nuts', choices=['nuts', 'hmc', 'smc'])
    p.add_argument('--n-train', type=int, default=300)
    p.add_argument('--n-test', type=int, default=1000)
    p.add_argument('--n-chains', type=int, default=8)
    p.add_argument('--n-steps', type=int, default=200)
    p.add_argument('--n-warmup', type=int, default=150)
    p.add_argument('--prior-scale', type=float, default=2.0)
    p.add_argument('--step-size', type=float, default=2e-3)
    p.add_argument('--sharded', action='store_true',
                   help='shard chains/particles over the ranks of the '
                        'process group (torchrun), or a world of one')
    p.add_argument('--eager', action='store_true',
                   help='run the samplers op by op, not as replayed CUDA '
                        'graphs')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    p.add_argument('--seed', type=int, default=0,
                   help='seeds the initial weights and the draws')
    args = p.parse_args()
    device = resolve_device(args.device)
    figures = run_posterior(
        args.sampler, args.n_train, args.n_test, args.n_chains, args.n_steps,
        args.n_warmup, args.prior_scale, args.step_size, device=device,
        seed=args.seed, sharded=args.sharded,
        graph=False if args.eager else None)
    figures['device'] = (torch.cuda.get_device_name(device)
                         if device.type == 'cuda' else 'cpu')
    print(json.dumps(figures), flush=True)


if __name__ == '__main__':
    main()
