"""Hamiltonian Monte Carlo over flattened chains, and the Bayesian posterior
over a flow's parameters.

Port of waveflow_tpu/vmc/hmc.py.  Fixed-length leapfrog with
a Metropolis correction, and the dual-averaging step-size warm-up of
Hoffman & Gelman (2014, Alg. 6) that NUTS shares (γ = 0.05, κ = 0.75,
t₀ = 10, the anchor μ = log(10·ε₀) fixed at init from the caller's step
size).  The sampler reads no value back to the host: the adaptation state
lives on the device as 0-d tensors.  Chains sharded over ranks
(``axis_name``, parallel/probprog.py) adapt one step size: the batch's
mean acceptance statistic is ``pmean``-reduced over the ranks in every
step, the step's only collective.  Every rank must make the same
collectives in the same order: a rank that skips one deadlocks the world.

``make_parameter_posterior`` turns a density module into a log density
over batches of its flattened parameters θ: ``torch.func.vmap`` over the
chains of ``functional_call(model, unravel(θ), data).sum()`` plus a
Gaussian prior, so that HMC, NUTS (vmc/nuts.py) and SMC (vmc/smc.py)
reuse the flow's own log-prob path — for an MFlow, kernel K4 and its
backward kernel, each launched once for all chains (the vmap rules of
ops/spline_eval.py).

Random draws come from an explicit ``torch.Generator``; ``step_fn`` takes
its momentum and accept uniforms as tensors, so a test can feed it the
draws of the JAX package's own key.

JAX runs the warm-up and the kept steps each as one ``lax.scan``.  On a
CUDA device ``run_fn`` replays one captured warm-up step and one captured
kept step (vmc/graphs.py) over a static state written in place, the
switch of the step size between them outside the graphs; elsewhere the
same two steps run eagerly.  The captures are kept for the next call at
the same shape and generator, and one set of them at a time.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import functional_call, vmap

from waveflow_tpu_torch.convert import ravel_layout
from waveflow_tpu_torch.parallel import mesh
from waveflow_tpu_torch.vmc import graphs

# dual averaging (Hoffman & Gelman 2014, Alg. 6), as in the JAX package
DA_GAMMA, DA_KAPPA, DA_T0 = 0.05, 0.75, 10


class HMCState(NamedTuple):
    position: torch.Tensor      # (B, D) flattened chains
    log_prob: torch.Tensor      # (B,)
    step_size: torch.Tensor     # ()
    # dual-averaging state
    log_step_bar: torch.Tensor  # ()
    h_bar: torch.Tensor         # ()
    iteration: torch.Tensor     # () float, as in JAX
    mu: torch.Tensor            # () anchor log(10 · ε₀)


def value_and_grad(log_prob_fn: Callable, q: torch.Tensor):
    """(log_prob_fn(q), ∂/∂q) for a chain batch q (B, D).

    The gradient is that of the SUMMED log density of the batch: one
    backward pass for every chain.  For a target whose rows are
    independent — every target on these paths: a Gaussian, walkers of a
    wavefunction, the vmapped parameter posterior — it equals JAX's
    per-row ``vmap(grad(...))``.  The backward runs on the calling thread
    (vmc/estimators.py::make_train_step says why)."""
    with torch.enable_grad(), \
            torch.autograd.set_multithreading_enabled(False):
        q = q.detach().requires_grad_(True)
        lp = log_prob_fn(q)
        (g,) = torch.autograd.grad(lp.sum(), q)
    return lp.detach(), g


def init_adaptation(step_size, like: torch.Tensor) -> tuple:
    """(ε₀, log ε̄, h̄, t, μ) for the dual-averaging warm-up, f32 0-d
    tensors on ``like``'s device."""
    eps0 = torch.as_tensor(step_size, dtype=torch.float32, device=like.device)
    zero = torch.zeros((), dtype=torch.float32, device=like.device)
    return eps0, torch.log(eps0), zero, zero.clone(), torch.log(10.0 * eps0)


def dual_averaging(state, accept_prob: torch.Tensor, target_accept: float):
    """One Nesterov dual-averaging update of a HMC / NUTS state's step size
    from the batch's mean acceptance statistic: log ε_t = μ − √t/γ · h̄_t,
    log ε̄_t = t^−κ log ε_t + (1 − t^−κ) log ε̄_{t−1}."""
    t = state.iteration + 1
    h_bar = (1 - 1 / (t + DA_T0)) * state.h_bar + \
        (target_accept - accept_prob) / (t + DA_T0)
    log_step = state.mu - torch.sqrt(t) / DA_GAMMA * h_bar
    eta = t ** -DA_KAPPA
    log_step_bar = eta * log_step + (1 - eta) * state.log_step_bar
    return state._replace(step_size=torch.exp(log_step),
                          log_step_bar=log_step_bar, h_bar=h_bar,
                          iteration=t)


def make_hmc_sampler(log_prob_fn: Callable, n_leapfrog: int = 16,
                     target_accept: float = 0.8, axis_name=None):
    """(init_fn, step_fn, run_fn) for HMC on ``log_prob_fn(x (B, D)) ->
    (B,)``, differentiable in x.

    init_fn(position, step_size=0.1) -> HMCState;
    step_fn(state, momentum (B, D), u (B,), warmup=False,
            return_info=False) -> HMCState (and the mean accept statistic);
    run_fn(state, generator, n_steps, n_warmup=0, return_info=False,
           graph=None)
        -> (state, trace (n_steps, B, D)) (and a dict of per-step figures);
        ``graph`` (default: on a CUDA device) replays each step as a CUDA
        graph, True on the CPU raises ValueError.

    A step costs n_leapfrog + 1 gradient evaluations of the batch: the
    gradient at the end of one leapfrog step starts the next.  ``axis_name``:
    the chain axis the batch is sharded over; the acceptance statistic is
    averaged over it, so the warm-up adapts one step size on every rank."""
    if axis_name is not None:
        mesh.check_axis(axis_name)

    @torch.no_grad()
    def init_fn(position: torch.Tensor, step_size=0.1) -> HMCState:
        eps0, log_bar, h_bar, it, mu = init_adaptation(step_size, position)
        return HMCState(position, log_prob_fn(position), eps0, log_bar,
                        h_bar, it, mu)

    def leapfrog(q, p, step_size):
        _, g = value_and_grad(log_prob_fn, q)
        lp = None
        for _ in range(n_leapfrog):
            p = p + 0.5 * step_size * g
            q = q + step_size * p
            lp, g = value_and_grad(log_prob_fn, q)
            p = p + 0.5 * step_size * g
        return q, p, lp

    @torch.no_grad()
    def step_fn(state: HMCState, momentum: torch.Tensor, u: torch.Tensor,
                warmup: bool = False, return_info: bool = False):
        """One HMC transition of every chain from the momentum ``momentum``
        (standard normals) and the accept uniforms ``u``; with ``warmup``,
        one dual-averaging update of the step size."""
        q_new, p_new, lp_new = leapfrog(state.position, momentum,
                                        state.step_size)
        h_old = state.log_prob - 0.5 * (momentum ** 2).sum(-1)
        h_new = lp_new - 0.5 * (p_new ** 2).sum(-1)
        # a NaN energy (a trajectory that left the target's domain) is a
        # rejection with acceptance statistic 0; JAX's NaN would poison the
        # shared step size for the rest of the run (ROADMAP Queue 3)
        log_accept = torch.nan_to_num(torch.clamp(h_new - h_old, max=0.0),
                                      nan=-torch.inf)
        accept = torch.log(u) < log_accept
        position = torch.where(accept[:, None], q_new, state.position)
        log_prob = torch.where(accept, lp_new, state.log_prob)
        accept_prob = torch.exp(log_accept).mean()
        if axis_name is not None:
            accept_prob = mesh.pmean(accept_prob, axis_name)
        state = state._replace(position=position, log_prob=log_prob)
        if warmup:
            state = dual_averaging(state, accept_prob, target_accept)
        return (state, accept_prob) if return_info else state

    def run_fn(state: HMCState, generator: torch.Generator, n_steps: int,
               n_warmup: int = 0, return_info: bool = False,
               graph: bool | None = None):
        """``n_warmup`` adapting steps, then the step size set to exp(log ε̄)
        and ``n_steps`` kept steps; draws from ``generator``."""
        static, warm, kept = windows(
            state, generator, graphs.use_graph(graph, state.position.device))
        graphs.copy_into(static, state)
        warm_accepts, = warm.window(n_warmup)
        if n_warmup > 0:
            static.step_size.copy_(torch.exp(static.log_step_bar))
        trace, kept_accepts = kept.window(n_steps)
        state = HMCState(*(f.clone() for f in static))
        if return_info:
            accepts = torch.cat([warm_accepts, kept_accepts])
            return state, trace, {'accept': accepts if accepts.numel()
                                  else None}
        return state, trace

    captured = {}       # the graphed run's windows, for one key at a time

    def windows(state, generator, graph: bool):
        """(the static state, the warm-up step, the kept step): windows
        over a copy of ``state``'s tensors that their steps write in place,
        eager or replayed (``graph``).  The captures are kept for the next
        call at the same shape, device and generator, and dropped at the
        next call with another."""
        key = (tuple(state.position.shape), state.position.device, generator)
        if graph and key in captured:
            return captured[key]
        static = HMCState(*(f.clone() for f in state))
        accept = torch.zeros((), device=static.position.device)

        def step(warmup):
            def body():
                new, acc = step_fn(
                    static,
                    torch.randn(static.position.shape, generator=generator,
                                device=static.position.device),
                    torch.rand(static.position.shape[:1],
                               generator=generator,
                               device=static.position.device),
                    warmup, True)
                graphs.copy_into(static, new)
                accept.copy_(acc)
            return body
        out = (static,
               graphs.make_window(step(True), (accept,), (generator,), graph),
               graphs.make_window(step(False), (static.position, accept),
                                  (generator,), graph))
        if graph:
            captured.clear()
            captured[key] = out
        return out

    return init_fn, step_fn, run_fn


def make_parameter_posterior(model: torch.nn.Module, data: torch.Tensor,
                             prior_scale: float = 1.0):
    """The posterior over a density model's parameters θ given data X:

        log p(θ | X) = Σ_x log p_θ(x) − ½ ‖θ‖² / prior_scale²

    (the Gaussian prior's constant dropped, as in JAX).  ``model``'s
    ``forward(x (N, d)) -> (N,)`` is its log density (MFlow.forward is its
    ``log_pdf``).  Returns (log_prob_fn, unravel, flat0):
    ``log_prob_fn(θ (C, D)) -> (C,)`` is ``torch.func.vmap`` over the chains,
    ``unravel(θ (D,))`` the dict of the model's parameter names to views
    of θ, ``flat0`` the model's own parameters flattened.  The flat layout
    is JAX's (every ``zero_params`` included), so a θ from the JAX package
    lands on the same parameters."""
    names, params = ravel_layout(model)
    shapes = [p.shape for p in params]
    sizes = [p.numel() for p in params]
    flat0 = torch.cat([p.detach().reshape(-1) for p in params])
    data = torch.as_tensor(data, dtype=torch.float32, device=flat0.device)

    def unravel(theta: torch.Tensor) -> dict:
        return {n: t.view(s) for n, t, s in zip(names, theta.split(sizes),
                                                shapes)}

    def single(theta: torch.Tensor) -> torch.Tensor:
        ll = functional_call(model, unravel(theta), (data,)).sum()
        lp = -0.5 * (theta ** 2).sum() / prior_scale ** 2
        return ll + lp

    return vmap(single), unravel, flat0
