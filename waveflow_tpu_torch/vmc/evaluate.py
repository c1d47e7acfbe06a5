"""Frozen-parameter energy evaluation with blocked Monte Carlo error bars.

Port of waveflow_tpu/vmc/evaluate.py, the protocol behind every energy the
JAX package reports: freeze the parameters, run Metropolis chains on |ψ|²
from exact ancestral draws, warm up with step-size adaptation, then measure
with the step size frozen, and per block of sweeps record

    ⟨E_L⟩            the raw block mean,
    median(E_L),     robust location,
    clipped ⟨E_L⟩,   mean inside median ± clip_scale × mean|E_L − median|,

and the running accept rate; the blocked stderr, the 2× / 4× block-doubling
stderrs and the opt-in clip ladder come from the block arrays
(``block_statistics``, numpy float64 as in the reference).  The block
values stay on the device until the last block; the host reads them once.

``record_tail`` (the port's own) runs the same chain on past the
evaluation and keeps its largest local energies, each with the other
Laplacian forms' values there.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from waveflow_tpu_torch.vmc import graphs
from waveflow_tpu_torch.vmc.estimators import _median, _safe_psi
from waveflow_tpu_torch.vmc.metropolis import (
    MetropolisState, make_metropolis_sampler, sector_mode, sector_projection,
)

LADDER = (1.0, 2.0, 4.0, 8.0)


class EnergyEvaluation(NamedTuple):
    e_mean: float            # blocked ⟨E_L⟩ (raw)
    e_stderr: float          # stderr of block means
    e_median: float          # median of per-block medians
    e_clipped: float         # blocked clipped mean (median ± 5×meanAD)
    e_clipped_stderr: float
    accept_rate: float       # MEAN accept rate over measurement blocks
    n_samples: int           # total E_L evaluations entering the estimate
    block_means: np.ndarray  # (n_blocks,)
    # block-doubling check of the error bar: stderr after merging adjacent
    # blocks 2x / 4x; one that GROWS under doubling means residual
    # autocorrelation and an underestimated bar
    e_stderr_2x: float = float('nan')
    e_stderr_4x: float = float('nan')
    # opt-in clip ladder: blocked clipped means at clip_scale × (1, 2, 4, 8)
    # and their weighted linear extrapolation in 1/scale → 0
    clip_ladder_scales: tuple = ()
    clip_ladder_means: tuple = ()
    clip_ladder_stderrs: tuple = ()
    e_clip_extrapolated: float = float('nan')
    e_clip_extrapolated_stderr: float = float('nan')


def _doubled_stderr(m: np.ndarray, factor: int) -> float:
    k = (len(m) // factor) * factor
    if k < 2 * factor:
        return float('nan')
    merged = m[:k].reshape(-1, factor).mean(axis=1)
    return float(merged.std(ddof=1) / np.sqrt(len(merged)))


def block_statistics(means, medians, cmeans, rates, lads=None, *,
                     n_walkers: int, clip_scale: float = 5.0
                     ) -> EnergyEvaluation:
    """The reference's host-side post-processing of the per-block arrays
    (each (n_blocks,); ``lads`` (n_blocks, 4) or None without the clip
    ladder), in numpy, operation for operation: blocked means and
    stderrs, the median of block medians, block doubling, and the ladder's
    weighted fit.  The ladder's stderrs treat the nested winsorized means as
    independent, as the reference does."""
    means = np.asarray(means)
    cmeans = np.asarray(cmeans)
    n_blocks = len(means)
    ladder_kw = {}
    if lads is not None:
        lads = np.asarray(lads)                        # (n_blocks, n_scales)
        scales = clip_scale * np.asarray(LADDER)
        l_means = lads.mean(0)
        l_errs = lads.std(0, ddof=1) / np.sqrt(n_blocks)
        # weighted linear fit of mean(scale) against 1/scale; the intercept
        # is the scale → ∞ (unclipped) limit without the winsorization bias
        x = 1.0 / scales
        w = 1.0 / np.maximum(l_errs, 1e-12) ** 2
        sw, sx, sy = w.sum(), (w * x).sum(), (w * l_means).sum()
        sxx, sxy = (w * x * x).sum(), (w * x * l_means).sum()
        det = sw * sxx - sx * sx
        intercept = (sxx * sy - sx * sxy) / det
        var_int = sxx / det
        ladder_kw = dict(
            clip_ladder_scales=tuple(float(s) for s in scales),
            clip_ladder_means=tuple(round(float(v), 6) for v in l_means),
            clip_ladder_stderrs=tuple(round(float(v), 7) for v in l_errs),
            e_clip_extrapolated=float(intercept),
            e_clip_extrapolated_stderr=float(np.sqrt(var_int)))
    return EnergyEvaluation(
        e_mean=float(means.mean()),
        e_stderr=float(means.std(ddof=1) / np.sqrt(n_blocks)),
        e_median=float(np.median(np.asarray(medians))),
        e_clipped=float(cmeans.mean()),
        e_clipped_stderr=float(cmeans.std(ddof=1) / np.sqrt(n_blocks)),
        accept_rate=float(np.asarray(rates).mean()),
        n_samples=n_blocks * n_walkers,
        block_means=means,
        e_stderr_2x=_doubled_stderr(means, 2),
        e_stderr_4x=_doubled_stderr(means, 4),
        **ladder_kw)


def evaluate_energy(psi, h_fn, log_pdf, box_length: float,
                    positions: torch.Tensor, generator=None,
                    n_blocks: int = 64, sweeps_per_block: int = 25,
                    n_warmup_sweeps: int = 250, step_size: float = 0.4,
                    sort_fermions: bool | str = True,
                    clip_scale: float = 5.0,
                    clip_ladder: bool = False,
                    graph: bool | None = None) -> EnergyEvaluation:
    """Blocked Metropolis estimate of ⟨E_L⟩ at FROZEN parameters (those of
    the module behind ``psi`` / ``h_fn`` / ``log_pdf``).

    positions: (B, D) initial walkers — exact ancestral draws start the
    chain in stationarity (warmup then decorrelates the step-size
    adaptation, which is frozen before measurement).  Every draw comes from
    ``generator``.  sort_fermions: True / '1d', 'paired2d' or False, as in
    ``sector_projection``.  ``graph`` as in ``evaluation_windows``."""
    warmup, blocks = evaluation_windows(
        psi, h_fn, log_pdf, box_length, positions, generator,
        sweeps_per_block=sweeps_per_block, step_size=step_size,
        sort_fermions=sort_fermions, clip_scale=clip_scale,
        clip_ladder=clip_ladder, graph=graph)
    warmup.window(n_warmup_sweeps)
    del warmup                                 # a graph's memory pool with it
    table, = blocks.window(n_blocks)
    table = table.cpu().numpy()                         # one host read
    return block_statistics(
        table[:, 0], table[:, 1], table[:, 2], table[:, 3],
        table[:, 4:] if clip_ladder else None,
        n_walkers=int(positions.shape[0]), clip_scale=clip_scale)


def evaluation_windows(psi, h_fn, log_pdf, box_length: float,
                       positions: torch.Tensor, generator=None,
                       sweeps_per_block: int = 25, step_size: float = 0.4,
                       sort_fermions: bool | str = True,
                       clip_scale: float = 5.0, clip_ladder: bool = False,
                       graph: bool | None = None):
    """(warmup, blocks): JAX's two dispatches of ``evaluate_energy`` over
    one static Metropolis state started at ``positions`` (vmc/graphs.py).
    ``warmup.window(n)`` runs n adaptive sweeps; ``blocks.window(n)``
    returns the (n, columns) block values on the device, a block being
    ``sweeps_per_block`` frozen-step sweeps and the E_L pass: raw mean,
    median, clipped mean, accept rate, then the clip ladder's means.

    ``graph`` (default: on a CUDA device) replays each as a CUDA graph:
    one of a warmup sweep, one of a measurement block."""
    init_fn, step_fn, _ = make_metropolis_sampler(
        log_pdf, bounds=(-box_length, box_length),
        proposal_map=sector_projection(sort_fermions))
    walkers = tuple(f.clone() for f in init_fn(positions, step_size=step_size))
    row = torch.empty(4 + len(LADDER) * clip_ladder, device=positions.device)

    def sweep():
        graphs.copy_into(walkers, step_fn(MetropolisState(*walkers), generator))

    @torch.no_grad()
    def block():
        state = MetropolisState(*walkers)
        # adaptation frozen: the recorded chain uses a fixed kernel
        for _ in range(sweeps_per_block):
            state = step_fn(state, generator)._replace(
                step_size=state.step_size)
        x = state.positions
        e = h_fn(x)[:, 0] / _safe_psi(psi(x))
        center = _median(e)
        mad = (e - center).abs().mean()
        values = [e.mean(), center,
                  torch.clamp(e, center - clip_scale * mad,
                              center + clip_scale * mad).mean(),
                  state.accept_rate]
        if clip_ladder:
            values += [torch.clamp(e, center - clip_scale * m * mad,
                                   center + clip_scale * m * mad).mean()
                       for m in LADDER]
        row.copy_(torch.stack(values))
        graphs.copy_into(walkers, state)

    if graphs.use_graph(graph, positions.device):
        gens = () if generator is None else (generator,)
        return (graphs.EpochGraph(sweep, generators=gens),
                graphs.EpochGraph(block, (row,), gens))
    return graphs.Epochs(sweep), graphs.Epochs(block, (row,))


def evaluate_trainer(trainer, n_blocks: int = 64, sweeps_per_block: int = 25,
                     n_warmup_sweeps: int = 250, batch_size: int | None = None,
                     seed: int = 7, clip_ladder: bool = False,
                     graph: bool | None = None) -> EnergyEvaluation:
    """Frozen-parameter evaluation of a (possibly checkpoint-restored)
    VMCTrainer, warm-started from its model's draws (exact ancestral draws;
    for the antisym ansatz, draws from |φ|² under a random electron
    permutation each); every draw comes from one generator on the
    trainer's device seeded by ``seed``.  ``graph`` as in
    ``evaluate_energy``."""
    c = trainer.config
    B = batch_size or max(4096, c.batch_size)
    generator = torch.Generator(trainer.device).manual_seed(seed)
    positions = trainer.model.sample(B, generator=generator)
    # the trainer's RESOLVED coordinate map decides the sector
    sort_fermions = (int(trainer.n_particle) > 1
                     and sector_mode(trainer.xu_coord_type))
    return evaluate_energy(
        trainer.model.psi, trainer.h_fn, trainer.model.log_pdf,
        c.box_length, positions, generator, n_blocks=n_blocks,
        sweeps_per_block=sweeps_per_block, n_warmup_sweeps=n_warmup_sweeps,
        sort_fermions=sort_fermions, clip_ladder=clip_ladder, graph=graph)


def _distances(x: np.ndarray, n_el: int, dim: int, box_length: float):
    """(the least electron-electron distance, the least distance between
    two electrons' first coordinates, the distance to the nearer wall of
    the box [−L, L]^D) of each walker of x (k, n_el · dim)."""
    xe = x.reshape(len(x), n_el, dim)
    if n_el > 1:
        diff = xe[:, :, None, :] - xe[:, None, :, :]
        off = ~np.eye(n_el, dtype=bool)
        pair = np.sqrt((diff ** 2).sum(-1))[:, off].min(-1)
        xgap = np.abs(diff[..., 0])[:, off].min(-1)
    else:
        pair = xgap = np.full(len(x), np.inf)
    wall = np.minimum(x + box_length, box_length - x).min(-1)
    return pair, xgap, wall


def record_tail(trainer, k: int = 32, n_blocks: int = 8,
                skip_blocks: int = 64, sweeps_per_block: int = 25,
                n_warmup_sweeps: int = 250, batch_size: int | None = None,
                seed: int = 7, fd_eps: float = 0.05,
                evaluation: EnergyEvaluation | None = None,
                graph: bool | None = None) -> dict:
    """The ``k`` largest local energies met by ``evaluate_trainer``'s chain
    run on for ``n_blocks`` more blocks, each with where it sits and what
    the other Laplacian forms give there: a separate pass, so that the
    evaluation's own numbers are untouched.

    The chain is the evaluation's: the same draws (a generator seeded by
    ``seed``), step size, warm-up and ``skip_blocks`` blocks of frozen-step
    sweeps, with no E_L pass until the last of them, whose raw mean is
    held to ``evaluation.block_means[-1]`` when ``evaluation`` is given
    (``same_chain``: the pass continues the chain that made the figures).
    Then ``n_blocks`` blocks, each ``sweeps_per_block`` sweeps and an E_L
    pass through the trainer's own ``h_fn`` (``el``); the ``k`` largest of
    those ``n_blocks × B`` values are kept, largest first, with:

      x, log|ψ|; the least electron-electron distance and the distance to
      the nearer wall of [−L, L]^D (for two electrons in 1D the first is
      the gap x₂ − x₁);
      Hψ and E_L by the 'dense' Hessian trace and by the central finite
      difference of step ``fd_eps`` over every coordinate, and whether
      that stencil stays inside the box and the sorted sector
      (``fd_inside``; outside it the difference reads ψ where it is not
      defined) (the Laplacian
      forms chip_smoke.py's lap-forms phase holds to each other; at the
      default step the f32 difference on the flagship 100k checkpoint lies
      closer to the analytic form than at the gate's 0.1, where the O(ε²)
      term is most of the gap, or at 0.02, where the f32 rounding is);
      E_L in float64 through a float64 copy of the model ('fwd_batched'),
      where the model's backend is plain PyTorch (not 'poly_pallas' on a
      card).

    Also the pass's E_L quantiles, its raw and clipped means (the clip
    window as the evaluation's), and ``hpsi_scale``, max |Hψ| over the
    pass's last block, against which the forms' differences are read."""
    from waveflow_tpu_torch.physics.hamiltonian import (
        construct_hamiltonian_function, get_potential, laplacian_numerical,
    )
    c = trainer.config
    model, h_fn = trainer.model, trainer.h_fn
    B = batch_size or max(4096, c.batch_size)
    n_el, dim = int(trainer.n_particle), c.n_space_dimension
    generator = torch.Generator(trainer.device).manual_seed(seed)
    positions = model.sample(B, generator=generator)
    sort = n_el > 1 and sector_mode(trainer.xu_coord_type)
    init_fn, step_fn, _ = make_metropolis_sampler(
        model.log_pdf, bounds=(-c.box_length, c.box_length),
        proposal_map=sector_projection(sort))
    walkers = tuple(f.clone() for f in init_fn(positions, step_size=0.4))

    def sweep():
        graphs.copy_into(walkers, step_fn(MetropolisState(*walkers),
                                          generator))

    def frozen_block():
        state = MetropolisState(*walkers)
        for _ in range(sweeps_per_block):
            state = step_fn(state, generator)._replace(
                step_size=state.step_size)
        graphs.copy_into(walkers, state)

    use = graphs.use_graph(graph, positions.device)
    gens = () if generator is None else (generator,)
    graphs.make_window(sweep, generators=gens, graph=use).window(
        n_warmup_sweeps)
    blocks = graphs.make_window(frozen_block, generators=gens, graph=use)

    def local_energy(x):
        with torch.no_grad():
            return h_fn(x)[:, 0] / _safe_psi(model.psi(x))

    for _ in range(skip_blocks):
        blocks()
    out = {'k': k, 'n_blocks': n_blocks, 'skip_blocks': skip_blocks,
           'sweeps_per_block': sweeps_per_block, 'n_walkers': B,
           'seed': seed, 'fd_eps': fd_eps}
    if evaluation is not None and skip_blocks:
        last = float(local_energy(walkers[0]).mean())
        out['last_block_mean'] = last
        out['evaluation_last_block_mean'] = float(evaluation.block_means[-1])
        out['same_chain'] = bool(last == out['evaluation_last_block_mean'])
    values, xs = [], []
    for _ in range(n_blocks):
        blocks()
        x = walkers[0].clone()
        values.append(local_energy(x))
        xs.append(x)
    e, x = torch.cat(values), torch.cat(xs)
    center = _median(e)
    mad = (e - center).abs().mean()
    clip = 5.0 * mad
    q = torch.quantile(e.double().cpu(),
                       torch.tensor([0.5, 0.99, 0.999, 0.9999, 1.0],
                                    dtype=torch.float64))
    top_e, order = torch.topk(e, min(k, len(e)))
    top_x = x[order]
    with torch.no_grad():
        hpsi = h_fn(x[-B:])[:, 0]
        out['hpsi_scale'] = float(hpsi.abs().max())
    out.update(
        el_mean=float(e.mean()),
        el_clipped_mean=float(torch.clamp(e, center - clip,
                                          center + clip).mean()),
        el_clip_window=[float(center - clip), float(center + clip)],
        el_quantiles=dict(zip(('0.5', '0.99', '0.999', '0.9999', 'max'),
                              map(float, q))),
        above_clip=int((e > center + clip).sum()),
        top_k_share_of_raw_mean=float((top_e.sum()
                                       - len(top_e) * e.mean()) / len(e)))
    v_fn = get_potential(trainer.protons, n_space_dimensions=dim,
                         interactions=c.interactions)
    dense = construct_hamiltonian_function(
        model.psi, protons=trainer.protons, n_space_dimensions=dim,
        laplacian_mode='dense', interactions=c.interactions)
    lap_fd = laplacian_numerical(model.psi, eps=fd_eps,
                                 n_dims=top_x.shape[-1])
    with torch.no_grad():
        psi = model.psi(top_x)
        h_pass = h_fn(top_x)[:, 0]
        h_dense = dense(top_x)[:, 0]
        h_fd = -0.5 * lap_fd(top_x) + v_fn(top_x) * psi
    forms = {'': h_pass, '_dense': h_dense, '_fd': h_fd}
    columns = {f'hpsi{s}': h for s, h in forms.items()}
    columns.update({f'el{s}': h / _safe_psi(psi) for s, h in forms.items()})
    if c.eval_backend == 'poly' or top_x.device.type == 'cpu':
        m64 = copy.deepcopy(model).double()
        x64 = top_x.double()
        h64 = construct_hamiltonian_function(
            m64.psi, protons=trainer.protons, n_space_dimensions=dim,
            laplacian_mode='fwd_batched', interactions=c.interactions)
        with torch.no_grad():
            columns['el_float64'] = h64(x64)[:, 0] / _safe_psi(m64.psi(x64))
        del m64
    columns = {name: v.double().cpu().numpy() for name, v in columns.items()}
    xn = top_x.double().cpu().numpy()
    pair, xgap, wall = _distances(xn, n_el, dim, c.box_length)
    # the stencil x ± ε stays in the box, and in the sorted sector (no two
    # electrons' first coordinates closer than ε) where ψ is defined on it
    inside = (wall > fd_eps) & ((xgap > fd_eps) if sort else True)
    log_psi = np.log(np.abs(psi.double().cpu().numpy()))
    out['rows'] = [
        {'x': xn[i].tolist(), 'pair_distance': float(pair[i]),
         'wall_distance': float(wall[i]), 'log_abs_psi': float(log_psi[i]),
         'fd_inside': bool(inside[i]),
         **{name: float(v[i]) for name, v in columns.items()}}
        for i in range(len(xn))]
    return out
