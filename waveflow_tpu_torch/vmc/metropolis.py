"""Random-walk Metropolis walkers and the Metropolis-driven training window.

Port of waveflow_tpu/vmc/metropolis.py: ``sector_projection``,
``MetropolisState``, ``make_metropolis_sampler`` and
``make_mcmc_train_window``.  Gaussian proposals, projected into the
fermionic sector, scored by the model's ``log_pdf`` (parameters live in
the module), rejected with ``-inf`` outside the box, accepted when
``log(u) < lp_prop − lp``; the step size adapts by Robbins-Monro toward a
target acceptance rate.  Walkers sharded over ranks (``axis_name`` /
``pmean_axis``, parallel/mesh.py) adapt ONE step size: each sweep's accept
fraction is averaged over the ranks, so the step size stays replicated
while the walkers stay local.  All of it is plain PyTorch, as in the
reference (plain ``jnp`` outside any Pallas kernel): the kernels on this
path are the ones inside ``log_pdf`` (K3 under
``eval_backend='poly_pallas'``).

Random draws come from an explicit ``torch.Generator``; every step also
takes its proposal noise and accept uniforms explicitly, so a test can feed
it the draws of the JAX package's own key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from waveflow_tpu_torch.parallel import mesh
from waveflow_tpu_torch.vmc import graphs


def sector_projection(sort_mode):
    """Proposal projection onto the fermionic sector.

    sort_mode: True / '1d' — coordinate sort (identical 1D fermions);
    'paired2d' — sort electron (x, y) pairs by x (interleaved layout);
    False / None — no projection (returns None)."""
    if sort_mode in (True, '1d'):
        return lambda x: torch.sort(x, dim=-1).values
    if sort_mode == 'paired2d':
        def sort_pairs(x):
            xe = x.reshape(x.shape[0], -1, 2)
            order = torch.argsort(xe[:, :, 0], dim=1, stable=True)
            xe = torch.gather(xe, 1, order[:, :, None].expand_as(xe))
            return xe.reshape(x.shape[0], -1)
        return sort_pairs
    return None


def sector_mode(xu_coord_type: str) -> bool | str:
    """The sector projection of a resolved coordinate map, as the JAX
    trainer picks it (``trainer.py:390-391``): 'paired2d' sorts the
    electrons' (x, y) pairs by x, 'independent' projects nothing, the 1D
    maps sort the coordinates."""
    if xu_coord_type == 'paired2d':
        return 'paired2d'
    return xu_coord_type != 'independent'


class MetropolisState(NamedTuple):
    positions: torch.Tensor     # (B, D)
    log_prob: torch.Tensor      # (B,)
    step_size: torch.Tensor     # ()
    accept_rate: torch.Tensor   # () running acceptance estimate


def make_metropolis_sampler(log_pdf, target_accept: float = 0.5,
                            adapt_rate: float = 0.1,
                            axis_name: str | None = None,
                            bounds: tuple[float, float] | None = None,
                            proposal_map=None):
    """(init_fn, step_fn, run_fn) for random-walk Metropolis on
    ``log_pdf(x (B, D)) -> (B,)``.

    bounds: optional (lo, hi) box; proposals outside get log-prob −inf.
    proposal_map: optional symmetric projection of every proposal (e.g.
    the coordinate sort of identical fermions: the Gaussian proposal summed
    over permutations is symmetric, so detailed balance holds on the
    sorted quotient).  ``axis_name``: the walker axis the batch is
    sharded over; the accept fraction of every sweep is ``pmean``-reduced
    over it (one collective per sweep), so every rank adapts the same
    step size."""
    if axis_name is not None:
        mesh.check_axis(axis_name)

    @torch.no_grad()
    def init_fn(positions: torch.Tensor, step_size=0.1) -> MetropolisState:
        if proposal_map is not None:
            positions = proposal_map(positions)
        lp = log_pdf(positions)
        return MetropolisState(
            positions, lp,
            torch.tensor(float(step_size), dtype=lp.dtype, device=lp.device),
            torch.tensor(target_accept, dtype=lp.dtype, device=lp.device))

    @torch.no_grad()
    def step_fn(state: MetropolisState, generator=None, noise=None,
                u=None) -> MetropolisState:
        """One sweep.  ``noise`` (B, D) standard normals and ``u`` (B,)
        uniforms on [0, 1) are drawn from ``generator`` unless given."""
        pos = state.positions
        if noise is None:
            noise = torch.randn(pos.shape, generator=generator,
                                dtype=pos.dtype, device=pos.device)
        if u is None:
            u = torch.rand(state.log_prob.shape, generator=generator,
                           dtype=pos.dtype, device=pos.device)
        proposal = pos + state.step_size * noise
        if proposal_map is not None:
            proposal = proposal_map(proposal)
        lp_prop = log_pdf(proposal)
        if bounds is not None:
            lo, hi = bounds
            inside = ((proposal >= lo) & (proposal <= hi)).all(-1)
            lp_prop = torch.where(inside, lp_prop, float('-inf'))
        accept = torch.log(u) < lp_prop - state.log_prob
        new_pos = torch.where(accept[:, None], proposal, pos)
        new_lp = torch.where(accept, lp_prop, state.log_prob)
        acc_frac = accept.to(pos.dtype).mean()
        if axis_name is not None:
            acc_frac = mesh.pmean(acc_frac, axis_name)
        # Robbins-Monro log-step adaptation toward the target acceptance
        new_step = state.step_size * torch.exp(
            adapt_rate * (acc_frac - target_accept))
        new_rate = 0.9 * state.accept_rate + 0.1 * acc_frac
        return MetropolisState(new_pos, new_lp, new_step, new_rate)

    def run_fn(state: MetropolisState, n_steps: int, generator=None,
               thin: int = 1):
        """``n_steps`` sweeps: (final state, positions after sweeps 0,
        thin, 2·thin, ... — the reference's ``trace[::thin]``)."""
        trace = []
        for _ in range(n_steps):
            state = step_fn(state, generator)
            trace.append(state.positions)
        return state, torch.stack(trace)[::thin]

    return init_fn, step_fn, run_fn


def make_mcmc_train_window(step, log_pdf, box_length: float,
                           n_sweeps: int = 10, target_accept: float = 0.5,
                           pmean_axis: str | None = None,
                           sort_proposals: bool | str = True,
                           train_step=None, graph: bool | None = None):
    """Metropolis-driven VMC training: walkers persist across epochs.

    Each epoch runs ``n_sweeps`` random-walk Metropolis sweeps on |ψ|²
    (proposals projected by ``sector_projection(sort_proposals)``), then one
    update ``step(mstate.positions, baseline)``, then refreshes the
    walkers' log-probs under the new parameters.  ``step`` is the port's
    train step
    (vmc/estimators.py::make_train_step — the JAX signature's psi, h_fn,
    optimizer, estimator and energy_clip are inside it); ``train_step`` (an
    SR / SPRING step of vmc/sr.py) replaces it when given, as in the JAX
    package.  ``pmean_axis``: the walker axis the walkers are sharded over
    (the sampler's collective step size); the update must be built with
    the same axis.

    Returns (init_fn, run_window): ``run_window(mstate, n_epochs, baseline,
    generator=None, noise=None, u=None) -> (losses (n_epochs,), the next
    baseline losses.mean(), accept_rates (n_epochs,), mstate)``, the
    losses, the baseline and the running accept rate after each epoch's
    sweeps left on the device (no host sync inside the window); ``noise``
    (n_epochs, n_sweeps, B, D) and ``u`` (n_epochs, n_sweeps, B) replace
    the generator's draws when given.  ``graph`` (default: on a CUDA
    device) runs the epochs as a replayed CUDA graph (``MCMCTrainWindow``);
    explicit draws take ``graph=False``."""
    if train_step is not None:
        step = train_step
    init_fn, step_fn, _ = make_metropolis_sampler(
        log_pdf, target_accept=target_accept, axis_name=pmean_axis,
        bounds=(-box_length, box_length),
        proposal_map=sector_projection(sort_proposals))
    return init_fn, MCMCTrainWindow(step, step_fn, log_pdf, n_sweeps, graph)


class MCMCTrainWindow:
    """The Metropolis window of ``make_mcmc_train_window``; on a CUDA
    device one epoch — the sweeps, the update, the log-prob refresh — is a
    CUDA graph over static walkers kept across windows (vmc/graphs.py).

    Each window copies the walkers it is handed and the baseline into the
    static tensors, replays one epoch per call, copies each epoch's loss
    and accept rate out of their slots, and returns copies of the static
    walkers (a state the caller holds is never written later).  A new
    generator or walker shape captures again; ``reset()`` drops the
    capture, as a swap of the optimizer's state tensors requires.

    A sampler's window states its walker state (``state_type``), the batch
    the update takes (``batch``) and the refresh after the update
    (``refresh``); vmc/mala.py::MALATrainWindow is the other one."""
    state_type = MetropolisState

    def __init__(self, step, step_fn, log_pdf, n_sweeps: int,
                 graph: bool | None = None):
        self.step, self.step_fn, self.log_pdf = step, step_fn, log_pdf
        self.n_sweeps, self.graph = n_sweeps, graph
        self.reset()

    def batch(self, mstate):
        return mstate.positions

    @torch.no_grad()
    def refresh(self, mstate):
        """The walkers' log-probs under the updated parameters."""
        return mstate._replace(log_prob=self.log_pdf(mstate.positions))

    def reset(self) -> None:
        self.static = self.epochs = self.key = None

    def __call__(self, mstate, n_epochs: int, baseline, generator=None,
                 noise=None, u=None):
        if graphs.use_graph(self.graph, mstate.positions.device):
            if noise is not None or u is not None:
                raise ValueError("explicit noise / u run eagerly: pass "
                                 "graph=False with them")
            return self._graphed(mstate, n_epochs, baseline, generator)
        losses, rates = [], []
        for e in range(n_epochs):
            for s in range(self.n_sweeps):
                mstate = self.step_fn(
                    mstate, generator,
                    None if noise is None else noise[e, s],
                    None if u is None else u[e, s])
            rates.append(mstate.accept_rate)
            losses.append(self.step(self.batch(mstate), baseline))
            mstate = self.refresh(mstate)
        losses = torch.stack(losses)
        return losses, losses.mean(), torch.stack(rates), mstate

    def _build(self, mstate, generator) -> None:
        """Static walkers, baseline and slots for the loss and the accept
        rate, and the epoch over them."""
        walkers = tuple(f.clone() for f in mstate)
        baseline, loss, rate = (torch.zeros((), device=mstate.positions.device)
                                for _ in range(3))

        def epoch():
            m = self.state_type(*walkers)
            for _ in range(self.n_sweeps):
                m = self.step_fn(m, generator)
            rate.copy_(m.accept_rate)
            loss.copy_(self.step(self.batch(m), baseline))
            graphs.copy_into(walkers, self.refresh(m))
        self.static = (walkers, baseline)
        self.epochs = graphs.EpochGraph(
            epoch, (loss, rate), () if generator is None else (generator,))

    def _graphed(self, mstate, n_epochs: int, baseline, generator):
        key = (tuple(mstate.positions.shape), generator)
        if self.key != key:
            self._build(mstate, generator)
            self.key = key
        walkers, static_baseline = self.static
        graphs.copy_into(walkers, mstate)
        static_baseline.copy_(baseline)
        losses, rates = self.epochs.window(n_epochs)
        out = self.state_type(*(f.clone() for f in walkers))
        return losses, losses.mean(), rates, out
