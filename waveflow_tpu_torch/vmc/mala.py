"""Metropolis-adjusted Langevin (MALA) walkers and the MALA training window.

Port of waveflow_tpu/vmc/mala.py.  Proposals

    x' = x + (ε²/2) ∇log p(x) + ε ξ

with the drift clipped elementwise at ±``grad_clip`` and the full
asymmetric-kernel Metropolis correction; proposals outside the box get
log-prob −inf; the step size adapts by Robbins-Monro toward a target
acceptance rate (over ranks, ``axis_name`` / ``pmean_axis``: one
collective step size, as in vmc/metropolis.py).  Plain PyTorch, as in the
reference: the kernels on this
path are the ones inside ``log_pdf`` (K3 under ``eval_backend='poly_pallas'``,
whose backward supplies the drift).

Walkers are independent, so one backward pass of the SUMMED log-density
gives every walker's ∇ₓ log p.  Random draws come from an explicit
``torch.Generator``; every step also takes its proposal noise and accept
uniforms explicitly, so a test can feed it the draws of the JAX package's
own key.  On a CUDA device the training window runs as a replayed CUDA
graph of one epoch (``MALATrainWindow``, vmc/graphs.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from waveflow_tpu_torch.parallel import mesh
from waveflow_tpu_torch.vmc.metropolis import (
    MCMCTrainWindow, sector_projection,
)

# the drift's elementwise clip (the JAX sampler's default)
GRAD_CLIP = 1e3


class MALAState(NamedTuple):
    positions: torch.Tensor     # (B, D)
    log_prob: torch.Tensor      # (B,)
    grad: torch.Tensor          # (B, D) clipped ∇ log p at positions
    step_size: torch.Tensor     # () proposal scale ε
    accept_rate: torch.Tensor   # () running acceptance estimate


def log_prob_and_drift(log_pdf, grad_clip: float = GRAD_CLIP):
    """``lp_grad(x (B, D)) -> (log p(x) (B,), ∇ₓ log p(x) clipped at
    ±grad_clip (B, D))``, both detached: one backward pass of the summed
    log-density."""
    def lp_grad(x: torch.Tensor):
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            lp = log_pdf(xr)
            (g,) = torch.autograd.grad(lp.sum(), xr)
        return lp.detach(), torch.clamp(g, -grad_clip, grad_clip)
    return lp_grad


def make_mala_sampler(log_pdf, target_accept: float = 0.574,
                      adapt_rate: float = 0.05,
                      axis_name: str | None = None,
                      bounds: tuple[float, float] | None = None,
                      grad_clip: float = GRAD_CLIP):
    """(init_fn, step_fn, run_fn) for MALA on ``log_pdf(x (B, D)) -> (B,)``.

    ``grad_clip`` bounds the drift elementwise: near a node of ψ the
    gradient of log ψ² diverges, and the accept test keeps the chain exact
    whatever the clip does to the proposal.  ``axis_name``: the walker
    axis the batch is sharded over; each sweep's accept fraction is
    ``pmean``-reduced over it, so every rank adapts the same step size."""
    if axis_name is not None:
        mesh.check_axis(axis_name)
    lp_grad = log_prob_and_drift(log_pdf, grad_clip)

    def init_fn(positions: torch.Tensor, step_size=0.1) -> MALAState:
        lp, g = lp_grad(positions)
        return MALAState(
            positions, lp, g,
            torch.as_tensor(step_size, dtype=lp.dtype, device=lp.device),
            torch.tensor(target_accept, dtype=lp.dtype, device=lp.device))

    def step_fn(state: MALAState, generator=None, noise=None, u=None,
                adapt: bool = True) -> MALAState:
        """One sweep.  ``noise`` (B, D) standard normals and ``u`` (B,)
        uniforms on [0, 1) are drawn from ``generator`` unless given;
        ``adapt=False`` keeps the step size (a frozen kernel)."""
        pos = state.positions
        if noise is None:
            noise = torch.randn(pos.shape, generator=generator,
                                dtype=pos.dtype, device=pos.device)
        if u is None:
            u = torch.rand(state.log_prob.shape, generator=generator,
                           dtype=pos.dtype, device=pos.device)
        eps = state.step_size
        mean_fwd = pos + 0.5 * eps ** 2 * state.grad
        proposal = mean_fwd + eps * noise
        lp_prop, grad_prop = lp_grad(proposal)
        if bounds is not None:
            lo, hi = bounds
            inside = ((proposal >= lo) & (proposal <= hi)).all(-1)
            lp_prop = torch.where(inside, lp_prop, float('-inf'))
        # asymmetric-kernel correction log q(x | x') − log q(x' | x); a
        # non-finite drift at the proposal makes the ratio NaN, which
        # rejects, and torch.where keeps it out of the state
        mean_rev = proposal + 0.5 * eps ** 2 * grad_prop
        log_q_fwd = -((proposal - mean_fwd) ** 2).sum(-1) / (2 * eps ** 2)
        log_q_rev = -((pos - mean_rev) ** 2).sum(-1) / (2 * eps ** 2)
        log_ratio = lp_prop - state.log_prob + log_q_rev - log_q_fwd
        accept = torch.log(u) < log_ratio
        new_pos = torch.where(accept[:, None], proposal, pos)
        new_lp = torch.where(accept, lp_prop, state.log_prob)
        new_grad = torch.where(accept[:, None], grad_prop, state.grad)
        acc_frac = accept.to(pos.dtype).mean()
        if axis_name is not None:
            acc_frac = mesh.pmean(acc_frac, axis_name)
        new_step = (eps * torch.exp(adapt_rate * (acc_frac - target_accept))
                    if adapt else eps)
        new_rate = 0.9 * state.accept_rate + 0.1 * acc_frac
        return MALAState(new_pos, new_lp, new_grad, new_step, new_rate)

    def run_fn(state: MALAState, n_steps: int, generator=None,
               thin: int = 1, n_warmup: int = 0):
        """``n_warmup`` adaptive sweeps, then ``n_steps`` recorded sweeps —
        from the frozen kernel when ``n_warmup`` > 0, adapting throughout
        when it is 0 (the training mode).  Returns (final state, positions
        of the recorded sweeps 0, thin, 2·thin, ...)."""
        for _ in range(n_warmup):
            state = step_fn(state, generator)
        trace = []
        for _ in range(n_steps):
            state = step_fn(state, generator, adapt=n_warmup == 0)
            trace.append(state.positions)
        return state, torch.stack(trace)[::thin]

    return init_fn, step_fn, run_fn


def make_mala_train_window(step, log_pdf, box_length: float,
                           n_sweeps: int = 10, target_accept: float = 0.574,
                           pmean_axis: str | None = None,
                           sort_fermions: bool | str = True,
                           train_step=None, graph: bool | None = None):
    """MALA-driven VMC training: walkers persist across epochs (the
    contract of ``metropolis.make_mcmc_train_window``).

    Unlike random-walk Metropolis, the chain runs in the FULL coordinate
    space on the permutation-symmetrised density log_pdf(proj(x)), proj =
    ``sector_projection(sort_fermions)`` (a sort carries the gradient back
    to the unsorted coordinates); walkers are projected only when handed to
    the update ``step(batch, baseline) -> loss`` (the port's adam step, or
    the SR / SPRING step of vmc/sr.py; ``train_step`` replaces ``step`` when
    given).
    After each update the walkers' log-probs AND drifts are recomputed under
    the new parameters.  ``pmean_axis``: the walker axis (the sampler's
    collective step size; the update must be built with the same axis).

    Returns (init_fn, run_window): ``run_window(mstate, n_epochs, baseline,
    generator=None, noise=None, u=None) -> (losses (n_epochs,), the next
    baseline losses.mean(), accept_rates (n_epochs,), mstate)``, left on
    the device (no host read
    inside the window); ``noise`` (n_epochs, n_sweeps, B, D) and ``u``
    (n_epochs, n_sweeps, B) replace the generator's draws when given.
    ``graph`` (default: on a CUDA device) runs the epochs as a replayed
    CUDA graph (``MALATrainWindow``); explicit draws take ``graph=False``."""
    if train_step is not None:
        step = train_step
    proj = sector_projection(sort_fermions)
    to_sector = proj if proj is not None else (lambda x: x)

    def density(x):
        return log_pdf(to_sector(x))
    init_fn, step_fn, _ = make_mala_sampler(
        density, target_accept=target_accept, axis_name=pmean_axis,
        bounds=(-box_length, box_length))
    return init_fn, MALATrainWindow(step, step_fn, log_prob_and_drift(density),
                                    to_sector, n_sweeps, graph)


class MALATrainWindow(MCMCTrainWindow):
    """The MALA window of ``make_mala_train_window``: the eager loop and the
    graphed epoch of vmc/metropolis.py::MCMCTrainWindow over the five
    fields of ``MALAState``.  The update takes the walkers projected into
    the sector; the refresh after it recomputes log-prob and drift by
    ``lp_grad`` alone — a reverse pass inside the captured epoch, through
    K3's backward rule under 'poly_pallas' — and builds no constant from
    the host, which a capture would refuse."""
    state_type = MALAState

    def __init__(self, step, step_fn, lp_grad, to_sector, n_sweeps: int,
                 graph: bool | None = None):
        super().__init__(step, step_fn, None, n_sweeps, graph)
        self.lp_grad, self.to_sector = lp_grad, to_sector

    def batch(self, mstate):
        return self.to_sector(mstate.positions)

    def refresh(self, mstate):
        """Log-prob and drift under the updated parameters."""
        lp, grad = self.lp_grad(mstate.positions)
        return mstate._replace(log_prob=lp, grad=grad)
