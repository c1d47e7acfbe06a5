"""Sequential Monte Carlo with likelihood tempering.

Port of waveflow_tpu/vmc/smc.py: anneal from the prior to
the target along π_β ∝ prior · exp(β · log-likelihood) over a fixed ladder
of temperatures, reweight the particles at each one, resample them
systematically when the effective sample size falls below a threshold,
and rejuvenate them with random-walk Metropolis moves.  The resample
decision is a mask (the identity index set when no resample is due), so
no value is read back to the host.

The particles' log-likelihood is carried: the resample gathers it and an
accepted move takes the proposal's, so a move evaluates the likelihood of
its proposals only (JAX evaluates current and proposed particles; the
values are the same function of the same rows).

A population sharded over ranks (``axis_name``, parallel/probprog.py)
normalises its weights over every rank (an all-gather of the local
logsumexps), takes the ESS over the global count, and resamples the global
population (parallel/resample.py) from a uniform every rank shares, so that
the decision and the index set agree; the rejuvenation noise is each
rank's own.  The resample stays a mask: every rank makes the same
collectives at every temperature.

Random draws come from an explicit ``torch.Generator``, or from a list of
``SMCDraws`` per temperature, so a test can feed the draws of the JAX
package's own key.

JAX runs the temperatures as one ``lax.scan``.  On a CUDA device a run that
draws from generators replays one captured temperature (vmc/graphs.py)
over a static state written in place; each temperature's β is copied into
a static slot before its replay, device to device.  Elsewhere, and for a
run fed explicit ``draws`` (copied into static draw slots before each
temperature), the same temperature runs eagerly.  The capture is kept for
the next call at the same shape and generators, one at a time.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from waveflow_tpu_torch.parallel import mesh
from waveflow_tpu_torch.vmc import graphs


class SMCState(NamedTuple):
    particles: torch.Tensor     # (N, D)
    log_weights: torch.Tensor   # (N,)
    log_like: torch.Tensor      # (N,) cached log-likelihood
    beta: torch.Tensor          # () current temperature
    ess: torch.Tensor           # () effective sample size fraction


class SMCDraws(NamedTuple):
    """The random numbers of one temperature."""
    u_resample: torch.Tensor    # () the systematic resample's offset
    noise: torch.Tensor         # (n_moves, N, D) proposal normals
    u_accept: torch.Tensor      # (n_moves, N) accept uniforms


def systematic_resample(u: torch.Tensor, log_weights: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Systematic resampling: the indices (N,) of the positions (u + k) / n
    in the weights' CDF.  An f32 CDF can end below the last position (its
    cumulative sum short of 1): that index is n − 1.  JAX's searchsorted
    returns n there and its gather clamps it to n − 1; torch's gather
    would raise, so the index is clamped here."""
    w = torch.softmax(log_weights, 0)
    positions = (u + torch.arange(n, device=log_weights.device)) / n
    cdf = torch.cumsum(w, 0)
    return torch.clamp(torch.searchsorted(cdf, positions), max=n - 1)


def draw(generator: torch.Generator, n_moves: int, N: int, D: int,
         device) -> SMCDraws:
    """One temperature's random numbers for N particles of dimension D."""
    return SMCDraws(torch.rand((), generator=generator, device=device),
                    torch.randn((n_moves, N, D), generator=generator,
                                device=device),
                    torch.rand((n_moves, N), generator=generator,
                               device=device))


def make_smc_sampler(log_prior_fn: Callable, log_like_fn: Callable,
                     n_temps: int = 20, n_mcmc_moves: int = 5,
                     mcmc_step_size: float = 0.1,
                     ess_threshold: float = 0.5, axis_name=None):
    """(init_fn, run_fn) for tempered SMC; ``log_prior_fn`` and
    ``log_like_fn``: (N, D) -> (N,).

    init_fn(particles) -> SMCState;
    run_fn(state, generator=None, draws=None, return_accept=False,
           shared_generator=None, graph=None)
        -> (state, ess_trace (n_temps,)) (and the mean move acceptance per
        temperature, (n_temps,)); ``draws`` is a sequence of n_temps
        SMCDraws, else they come from ``generator``, and each resample
        uniform from ``shared_generator`` when it is given (a generator in
        the same state on every rank, which a sharded run without
        ``draws`` needs).  ``graph`` (default: on a CUDA device, without
        ``draws``) replays each temperature as a CUDA graph; True on the
        CPU or with ``draws`` raises ValueError.

    ``axis_name``: the axis the population is sharded over; each rank
    passes its own particles, and draws whose ``u_resample`` is the same on
    every rank (parallel/probprog.py::make_sharded_smc)."""
    if axis_name is not None:
        mesh.check_axis(axis_name)

    def global_lse(x: torch.Tensor) -> torch.Tensor:
        """logsumexp over this rank's entries and, sharded, every rank's."""
        local = torch.logsumexp(x, 0)
        if axis_name is None:
            return local
        return torch.logsumexp(mesh.all_gather(local, axis_name,
                                               tiled=False), 0)

    @torch.no_grad()
    def init_fn(particles: torch.Tensor) -> SMCState:
        n = particles.shape[0]
        f32 = dict(dtype=torch.float32, device=particles.device)
        return SMCState(particles, torch.zeros(n, **f32),
                        log_like_fn(particles), torch.zeros((), **f32),
                        torch.ones((), **f32))

    def global_count(N: int) -> int:
        return N if axis_name is None else N * mesh.axis_size(axis_name)

    @torch.no_grad()
    def temp_step(state: SMCState, beta_new: torch.Tensor, d: SMCDraws,
                  log_n: torch.Tensor):
        """One temperature; ``log_n`` is log of the global particle count,
        a device scalar made outside the window's body (a host copy
        cannot be captured)."""
        n = global_count(state.particles.shape[0])
        # reweight by the likelihood increment, normalised over the GLOBAL
        # population
        log_w = state.log_weights + (beta_new - state.beta) * state.log_like
        log_w = log_w - global_lse(log_w)
        ess = 1.0 / torch.exp(global_lse(2 * log_w)) / n

        # resample when the ESS is low (the identity index set otherwise)
        do_resample = ess < ess_threshold
        if axis_name is None:
            arange = torch.arange(n, device=log_w.device)
            idx = torch.where(do_resample,
                              systematic_resample(d.u_resample, log_w, n),
                              arange)
            particles, log_like = state.particles[idx], state.log_like[idx]
        else:
            from waveflow_tpu_torch.parallel.resample import (
                resample_walkers_sharded)
            # the log-likelihood travels with its particle, one gather
            rows = torch.cat([state.particles, state.log_like[:, None]], 1)
            moved, _ = resample_walkers_sharded(rows, log_w, d.u_resample,
                                                axis_name)
            rows = torch.where(do_resample, moved, rows)
            particles, log_like = rows[:, :-1], rows[:, -1]
        log_w = torch.where(do_resample, -log_n, log_w)

        # rejuvenate with random-walk Metropolis sweeps at beta_new
        accepts = []
        for noise, u in zip(d.noise, d.u_accept):
            lp = log_prior_fn(particles) + beta_new * log_like
            prop = particles + mcmc_step_size * noise
            ll_prop = log_like_fn(prop)
            lp_prop = log_prior_fn(prop) + beta_new * ll_prop
            accept = torch.log(u) < lp_prop - lp
            particles = torch.where(accept[:, None], prop, particles)
            log_like = torch.where(accept, ll_prop, log_like)
            accepts.append(accept.float().mean())
        acc = torch.stack(accepts).mean() if accepts else ess.new_zeros(())
        return SMCState(particles, log_w, log_like, beta_new, ess), acc

    def run_fn(state: SMCState, generator: torch.Generator | None = None,
               draws=None, return_accept: bool = False,
               shared_generator: torch.Generator | None = None,
               graph: bool | None = None):
        if axis_name is not None and draws is None \
                and shared_generator is None:
            raise ValueError("a sharded SMC run draws its resample uniform "
                             "from shared_generator: pass one")
        dev = state.particles.device
        if graph and draws is not None:
            raise ValueError("a run with explicit draws is eager: pass "
                             "graph=False with them")
        static, beta, slots, temperature = window(
            state, generator, shared_generator, draws,
            draws is None and graphs.use_graph(graph, dev))
        betas = torch.linspace(0.0, 1.0, n_temps + 1, dtype=torch.float32,
                               device=dev)[1:]
        graphs.copy_into(static, state)
        ess, acc = [], []
        for t in range(n_temps):
            beta.copy_(betas[t])
            if draws is not None:
                graphs.copy_into(slots, draws[t])
            e, a = temperature.window(1)
            ess.append(e)
            acc.append(a)
        state = SMCState(*(f.clone() for f in static))
        if return_accept:
            return state, torch.cat(ess), torch.cat(acc)
        return state, torch.cat(ess)

    captured = {}       # the graphed run's window, for one key at a time

    def window(state, generator, shared_generator, draws, graph: bool):
        """(the static state, the β slot, the draw slots or None, one
        temperature over them as a window, eager or replayed (``graph``)).
        The temperature draws from ``generator`` (the resample uniform
        from ``shared_generator`` where it is given), or reads the draw
        slots, which the caller fills from ``draws`` before each call.  A
        capture is kept for the next call at the same shape, device and
        generators, and dropped at the next call with others."""
        N, D = state.particles.shape
        dev = state.particles.device
        key = ((N, D), dev, generator, shared_generator)
        if graph and key in captured:
            return captured[key]
        static = SMCState(*(f.clone() for f in state))
        beta, accept = (torch.zeros((), device=dev) for _ in range(2))
        slots = (None if draws is None
                 else SMCDraws(*(torch.empty_like(x) for x in draws[0])))
        log_n = torch.log(torch.tensor(float(global_count(N)), device=dev))

        def body():
            d = slots if slots is not None else draw(
                generator, n_mcmc_moves, N, D, dev)
            if shared_generator is not None:
                d = d._replace(u_resample=torch.rand(
                    (), generator=shared_generator, device=dev))
            new, a = temp_step(static, beta, d, log_n)
            graphs.copy_into(static, new)
            accept.copy_(a)
        gens = tuple(g for g in (generator, shared_generator)
                     if g is not None)
        out = (static, beta, slots,
               graphs.make_window(body, (static.ess, accept), gens, graph))
        if graph:
            captured.clear()
            captured[key] = out
        return out

    return init_fn, run_fn
