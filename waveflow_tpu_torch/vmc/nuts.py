"""No-U-Turn Sampler: dynamic trajectory lengths, chains batched by masks.

Port of waveflow_tpu/vmc/nuts.py: the iterative NUTS of
Hoffman & Gelman (2014, Alg. 3) in its checkpointed form —

* the trajectory doubles, in a random direction, up to ``max_tree_depth``
  times;
* progressive **multinomial** sampling of the proposal within each
  subtree, and biased progressive sampling across subtrees;
* the **full dyadic U-turn criterion**: every balanced block of a subtree
  that ends at leaf i (i + 1 ≡ 0 mod 2^k) is checked against its start
  leaf s = i + 1 − 2^k, kept in checkpoint slot ``_slot(s)`` (its trailing
  zeros; ``top`` for leaf 0), which no interior leaf overwrites;
* the divergence guard (energy error above 1000, or NaN: ROADMAP Queue 3)
  and the same dual-averaging warm-up as vmc/hmc.py.

The chains of a batch step in lockstep: every chain's subtree is at the
same leaf index, so the leaf's slot and the blocks that end at it are host
integers, and a chain whose tree has stopped keeps its state under a mask,
as a lane of JAX's vmapped ``while_loop`` does.  Every leaf evaluates the
gradient of the whole batch, as that loop evaluates every lane; whether
any chain still builds is read on the host at most once per leaf
(``live.any()``), only to end the step once every chain has stopped.  A
step costs one gradient evaluation of the batch at its start and one per
leaf: the gradient at a leaf starts the next.

Chains sharded over ranks (``axis_name``): the mean acceptance statistic
of a step is ``pmean``-reduced over the ranks after the tree, the step's
only collective, as in JAX, whose per-device ``while_loop``s run
independently.  The ``live.any()`` reads stay rank-local, so ranks build
trees of their own lengths; every rank then makes that one collective per
step, and must: a rank that skips one deadlocks the world.

Every random number of a step is drawn up front (``draw``): the momentum,
the direction bits, one uniform per leaf and one per merge, so a test can
replay the JAX package's key tree into it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from waveflow_tpu_torch.parallel import mesh
from waveflow_tpu_torch.vmc.hmc import (
    dual_averaging, init_adaptation, value_and_grad,
)

DIVERGENCE_THRESHOLD = 1000.0


class NUTSState(NamedTuple):
    position: torch.Tensor      # (B, D) chains
    log_prob: torch.Tensor      # (B,)
    step_size: torch.Tensor     # ()
    # dual-averaging state (shared across chains)
    log_step_bar: torch.Tensor
    h_bar: torch.Tensor
    iteration: torch.Tensor
    mu: torch.Tensor            # anchor log(10 · ε₀)


class NUTSDraws(NamedTuple):
    """The random numbers of one step of B chains."""
    momentum: torch.Tensor      # (B, D) standard normals
    go_right: torch.Tensor      # (B, max_depth) bool: doubling j's direction
    leaf_u: torch.Tensor        # (B, 2^max_depth) uniforms: leaf i of
                                # doubling j at 2^j − 1 + i
    merge_u: torch.Tensor       # (B, max_depth) uniforms: doubling j's merge


class NUTSInfo(NamedTuple):
    depth: torch.Tensor         # (B,) doublings built
    n_leaves: torch.Tensor      # (B,) leaves built
    accept: torch.Tensor        # (B,) mean acceptance statistic of them


def _slot(i: int, top: int) -> int:
    """Checkpoint slot of leaf i: the trailing zeros of i, ``top`` for
    i = 0."""
    return top if i == 0 else (i & -i).bit_length() - 1


def _is_turning(dz, r_a, r_b):
    return ((dz * r_a).sum(-1) < 0.0) | ((dz * r_b).sum(-1) < 0.0)


def draw(generator: torch.Generator, B: int, D: int, max_tree_depth: int,
         device) -> NUTSDraws:
    """One step's random numbers for B chains of dimension D."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)
    momentum = torch.randn((B, D), generator=generator, device=device)
    return NUTSDraws(momentum, u(B, max_tree_depth) < 0.5,
                     u(B, 2 ** max_tree_depth), u(B, max_tree_depth))


def make_nuts_sampler(log_prob_fn: Callable, max_tree_depth: int = 8,
                      target_accept: float = 0.8, axis_name=None):
    """(init_fn, step_fn, run_fn) for NUTS on ``log_prob_fn(x (B, D)) ->
    (B,)``, with the contract of vmc/hmc.py:

    init_fn(position, step_size=0.1) -> NUTSState;
    step_fn(state, draws: NUTSDraws, warmup=False, return_info=False)
        -> NUTSState (and a NUTSInfo);
    run_fn(state, generator, n_steps, n_warmup=0, return_info=False)
        -> (state, trace (n_steps, B, D)) (and a dict of per-step figures:
        'depth' (steps, B), 'n_leaves' (steps, B), 'accept' (steps,)).

    ``axis_name``: the chain axis the batch is sharded over (the mean
    acceptance statistic averaged over it: one collective step size)."""
    if axis_name is not None:
        mesh.check_axis(axis_name)
    max_slots = max_tree_depth + 1
    top = max_slots - 1

    def where(mask, a, b):
        return torch.where(mask.view(mask.shape + (1,) * (a.ndim - 1)), a, b)

    def trajectory(z0, draws: NUTSDraws, eps):
        """Build every chain's tree from z0; returns (proposal, its log
        density, NUTSInfo)."""
        B = z0.shape[0]
        r0 = draws.momentum
        lp0, g0 = value_and_grad(log_prob_fn, z0)
        h0 = lp0 - 0.5 * (r0 * r0).sum(-1)
        # the two ends of the trajectory: (z, r, gradient, log density)
        minus = plus = (z0, r0, g0, lp0)
        z_prop, lp_prop = z0, lp0
        logw_sum = torch.zeros_like(lp0)          # the initial leaf: logw 0
        sum_alpha = torch.zeros_like(lp0)
        n_alpha = torch.zeros_like(lp0)
        depth = torch.zeros(B, dtype=torch.int32, device=z0.device)
        active = torch.ones(B, dtype=torch.bool, device=z0.device)
        for j in range(max_tree_depth):
            go_right = draws.go_right[:, j]
            z, r, g, lp = (where(go_right, a, b) for a, b in zip(plus, minus))
            step = torch.where(go_right, eps, -eps)[:, None]
            n_leaves = 2 ** j

            # ---- the subtree of 2^j leaves, every chain in lockstep ----
            live = active.clone()                 # building, not stopped
            sub_stop = torch.zeros_like(active)
            sub_z_prop, sub_lp_prop = z, lp
            logw_sub = torch.full_like(lp0, -torch.inf)
            sub_alpha = torch.zeros_like(lp0)
            sub_n = torch.zeros_like(lp0)
            ckpt_z = z0.new_zeros((max_slots,) + z0.shape)
            ckpt_r = z0.new_zeros((max_slots,) + z0.shape)
            for i in range(n_leaves):
                r_n = r + 0.5 * step * g
                z_n = z + step * r_n
                lp_n, g_n = value_and_grad(log_prob_fn, z_n)
                r_n = r_n + 0.5 * step * g_n
                # a NaN energy (a trajectory that left the target's
                # domain) is a divergence: JAX's NaN poisons the shared
                # step size of every chain for the rest of the run
                logw = torch.nan_to_num(lp_n - 0.5 * (r_n * r_n).sum(-1) - h0,
                                        nan=-torch.inf)
                diverged = logw < -DIVERGENCE_THRESHOLD
                logw_sub_n = torch.logaddexp(logw_sub, logw)
                take = live & (torch.log(draws.leaf_u[:, n_leaves - 1 + i])
                               < logw - logw_sub_n)
                sub_z_prop = where(take, z_n, sub_z_prop)
                sub_lp_prop = torch.where(take, lp_n, sub_lp_prop)
                ckpt_z[_slot(i, top)] = z_n
                ckpt_r[_slot(i, top)] = r_n
                turning = torch.zeros_like(active)
                for k in range(1, j + 1):         # blocks of 2^k <= 2^j
                    if (i + 1) % 2 ** k == 0:
                        s = _slot(i + 1 - 2 ** k, top)
                        turning |= _is_turning(z_n - ckpt_z[s], ckpt_r[s],
                                               r_n)
                alpha = torch.clamp(torch.exp(logw), max=1.0)
                z, r, g = (where(live, a, b)
                           for a, b in ((z_n, z), (r_n, r), (g_n, g)))
                lp = torch.where(live, lp_n, lp)
                logw_sub = torch.where(live, logw_sub_n, logw_sub)
                sub_alpha = sub_alpha + torch.where(live, alpha, 0.0)
                sub_n = sub_n + live
                stop = turning | diverged
                sub_stop = sub_stop | (live & stop)
                live = live & ~stop
                if i + 1 < n_leaves and not live.any():   # the host read
                    break

            # ---- merge the subtree into the trajectory ----
            ok = active & ~sub_stop
            accept_sub = torch.log(draws.merge_u[:, j]) < logw_sub - logw_sum
            z_prop = where(ok & accept_sub, sub_z_prop, z_prop)
            lp_prop = torch.where(ok & accept_sub, sub_lp_prop, lp_prop)
            logw_sum = torch.where(ok, torch.logaddexp(logw_sum, logw_sub),
                                   logw_sum)
            end = (z, r, g, lp)
            plus = tuple(where(ok & go_right, a, b) for a, b in zip(end, plus))
            minus = tuple(where(ok & ~go_right, a, b)
                          for a, b in zip(end, minus))
            turning_all = _is_turning(plus[0] - minus[0], minus[1], plus[1])
            sum_alpha = torch.where(active, sum_alpha + sub_alpha, sum_alpha)
            n_alpha = torch.where(active, n_alpha + sub_n, n_alpha)
            depth = depth + active
            active = active & ~(sub_stop | turning_all)
            if j + 1 < max_tree_depth and not active.any():
                break
        accept = sum_alpha / torch.clamp(n_alpha, min=1.0)
        return z_prop, lp_prop, NUTSInfo(depth, n_alpha, accept)

    @torch.no_grad()
    def init_fn(position: torch.Tensor, step_size=0.1) -> NUTSState:
        eps0, log_bar, h_bar, it, mu = init_adaptation(step_size, position)
        return NUTSState(position, log_prob_fn(position), eps0, log_bar,
                         h_bar, it, mu)

    @torch.no_grad()
    def step_fn(state: NUTSState, draws: NUTSDraws, warmup: bool = False,
                return_info: bool = False):
        """One NUTS transition of every chain from ``draws``; with
        ``warmup``, one dual-averaging update of the step size from the
        chains' mean acceptance statistic."""
        position, log_prob, info = trajectory(state.position, draws,
                                              state.step_size)
        state = state._replace(position=position, log_prob=log_prob)
        accept_prob = info.accept.mean()
        if axis_name is not None:
            accept_prob = mesh.pmean(accept_prob, axis_name)
        if warmup:
            state = dual_averaging(state, accept_prob, target_accept)
        return (state, info) if return_info else state

    def run_fn(state: NUTSState, generator: torch.Generator, n_steps: int,
               n_warmup: int = 0, return_info: bool = False,
               graph: bool | None = None):
        """``n_warmup`` adapting steps, then the step size set to exp(log ε̄)
        and ``n_steps`` kept steps; draws from ``generator``.  Eager
        always: a trajectory ends on a host read (``live.any()``), which a
        CUDA graph cannot hold, so ``graph=True`` raises
        NotImplementedError (None and False are eager)."""
        if graph:
            raise NotImplementedError(
                "NUTS ends its trajectories on host reads, which a CUDA "
                "graph cannot capture: it runs eagerly (graph=None)")
        B, D = state.position.shape
        dev = state.position.device
        infos = []

        def one(state, warmup):
            draws = draw(generator, B, D, max_tree_depth, dev)
            state, info = step_fn(state, draws, warmup, True)
            infos.append(info)
            return state

        for _ in range(n_warmup):
            state = one(state, True)
        if n_warmup > 0:
            state = state._replace(step_size=torch.exp(state.log_step_bar))
        trace = state.position.new_empty((n_steps, B, D))
        for i in range(n_steps):
            state = one(state, False)
            trace[i] = state.position
        if return_info:
            return state, trace, {
                'depth': torch.stack([i.depth for i in infos]),
                'n_leaves': torch.stack([i.n_leaves for i in infos]),
                'accept': torch.stack([i.accept.mean() for i in infos])}
        return state, trace

    return init_fn, step_fn, run_fn
