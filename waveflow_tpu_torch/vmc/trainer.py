"""VMC training loop: the surface of the JAX VMCTrainer.

Port of waveflow_tpu/vmc/trainer.py: exact ancestral
walkers ('table' or exact 'poly' sampling density), or persistent
Metropolis or MALA walkers (``sampler='metropolis'`` / ``'mala'``, with the
periodic ancestral refresh); the 'clipped_score' (either clip statistic)
or 'reference' estimator with adam after an optax-form global norm clip,
or the SR / SPRING natural-gradient updates (``optimizer='sr'`` /
``'spring'``, vmc/sr.py); every Laplacian form; eval backends 'poly',
'poly_pallas' (the CUDA basis-jet kernel) and 'table' (the table-lerp
evaluation with its derivative chain, kernel K4 on the card); one or two
space dimensions with every coordinate map, and the antisymmetrized
ansatz (``ansatz='antisym'``, models/antisym.py) under the JAX trainer's
resolution (``resolve_ansatz``); checkpoint save / exact resume and
divergence recovery (or none, ``divergence_recovery=False``); walkers sharded over processes (``data_parallel``,
below); evaluation artifacts beside the checkpoints (``save_artifacts``,
vmc/artifacts.py).  The combinations the JAX trainer accepts and silently
ignores raise ``NotImplementedError`` (``_check_combination``).

``data_parallel`` (JAX's meanings): True shards the walker batch over
every rank of the world (parallel/mesh.py::make_walker_mesh), 'hosts' over
a hosts × chips grid (``make_host_chip_mesh``, the two-level reduction).
One process per device: rank r runs on ``cuda:{LOCAL_RANK}`` unless the
config names a device, holds the whole model and optimizer state and
``batch_size / world`` walkers drawn from its own generator
(parallel/sharding.py::rank_seed; rank 0's is the single-process stream),
and every estimator averages over the ranks, so every rank applies the
same update.  ``coordinator_address`` / ``num_processes`` / ``process_id``
join the process group first (``distributed_init``); without them a
trainer joins torchrun's group, or makes a world of one process.  Every
rank must build the trainer from the same config.  The MCMC warm start
and the walker refresh draw the full batch from a stream every rank
shares (``shared_generator``; at a world of one, the walker stream) and
keep their own rows; every decision (divergence, refresh) is taken from
replicated values, so every rank takes it.  A sharded epoch on the card
runs as a graph under NCCL, its collectives captured with it, and eagerly
under gloo (``graph_windows``).

The running baseline of the 'reference' estimator follows the JAX
trainer: zero at every ``train`` call, each good window's mean loss after
it, zero after a divergence recovery, and on the per-epoch path the host
mean of the last ``window`` losses whenever ``epoch % window == 0``.  It is
``self.baseline`` and, as in JAX, not checkpointed.

On a CUDA device every window — adam, SR or SPRING, with ancestral,
Metropolis or MALA walkers — runs as a replayed CUDA graph of one epoch
(``graph_windows``; vmc/graphs.py), as the JAX trainer jit-compiles every
window; the capture is made at the first window and kept across windows,
and a divergence recovery or a checkpoint load drops it.  The single epochs
after the last window run eagerly.

Every train step keeps its optimizer state behind ``step.optimizer``'s
``state_dict`` / ``load_state_dict`` (torch's Adam, or vmc/sr.py's
``StepState``).  Checkpoints: ``save_checkpoint`` writes
``<save_dir>/checkpoints`` (params, that state, the epoch, the walker
generator's state and the MCMC walkers, all as numpy) and ``loss.npy``;
resuming from one continues the run bit for bit.  Over more than one rank,
rank 0 writes those two with the shared stream's state in place of the
walker generator's and no walkers, and every rank writes
``checkpoints.shard{rank}``, its generator's state and its MCMC rows; a
resume reads both, bit for bit as well.  ``load_checkpoint`` also
reads the JAX trainer's checkpoints (params; flat Adam moments, a SPRING
state in either of its forms, or SR's ``()``; Metropolis or MALA walkers);
the JAX PRNG key is not carried across, so a resumed JAX run continues on
the port's stream seeded by ``config.seed``.  Unlike the JAX trainer,
``train`` writes only when ``config.save_dir`` is set
(``resolved_save_dir()`` gives the JAX package's default for callers that
want it).
"""

from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass, fields
from pathlib import Path

import numpy as np
import torch

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.convert import (
    adam_state_from_jax, mcmc_state_from_jax, params_from_jax,
)
from waveflow_tpu_torch.bijections.box_transform import COORD_TYPES
from waveflow_tpu_torch.models.antisym import get_antisym_waveflow_model
from waveflow_tpu_torch.models.factory import get_waveflow_model
from waveflow_tpu_torch.parallel import mesh as mesh_lib
from waveflow_tpu_torch.parallel import sharding
from waveflow_tpu_torch.physics import (
    construct_hamiltonian_function, system_catalogue,
)
from waveflow_tpu_torch.utils.checkpoint import (
    load_state, save_state, save_state_multihost,
)
from waveflow_tpu_torch.vmc import graphs
from waveflow_tpu_torch.vmc.artifacts import (
    artifact_generator, save_wavefunction_artifacts,
)
from waveflow_tpu_torch.vmc.estimators import (
    TrainWindow, make_train_step, run_window,
)
from waveflow_tpu_torch.vmc.mala import MALAState, make_mala_train_window
from waveflow_tpu_torch.vmc.metropolis import (
    MetropolisState, make_mcmc_train_window, sector_mode,
)
from waveflow_tpu_torch.vmc.sr import (
    make_spring_train_step, make_sr_train_step,
)


@dataclass
class VMCConfig:
    system_name: str = 'He'
    n_space_dimension: int = 1
    box_length: float = 10.0
    learning_rate: float = 1e-4
    num_epochs: int = 200_000
    batch_size: int = 128
    log_every: int = 2000
    window: int = 100                     # epochs per loss window
    xu_coord_type: str = 'mean'
    spline_degree: int = 6
    num_knots: int = 23
    n_flow_layers: int = 3
    i_spline_reg: float = 0.05
    # accepted and unused: the IMADE inverse is the exact table inverse
    i_spline_reverse_fun_tol: float = 1e-6
    n_spline_base_mesh_points: int = 2000
    # 'poly' (plain PyTorch basis jet), 'poly_pallas' (the CUDA basis-jet
    # kernel on the card; the name is the JAX package's) or 'table' (the
    # table lerp, K4 on the card; sampling_backend must then be 'table')
    eval_backend: str = 'poly'
    # ancestral density: 'table' (inverse CDF of the table interpolant, K1
    # on the card) or 'poly' (the exact polynomial density ψ evaluates)
    sampling_backend: str = 'table'
    # 'fwd_batched', 'fwd' (per walker; runs as 'fwd_batched' under
    # 'poly_pallas', as in JAX), 'hvp' or 'dense' (physics/hamiltonian.py)
    laplacian_mode: str = 'fwd_batched'
    seed: int = 2
    # where train() writes checkpoints, loss.npy and system_info.json;
    # None writes nothing
    save_dir: str | None = None
    # with every checkpoint of a single-process run, the ψ grid, density
    # slices and sample cloud of vmc/artifacts.py, drawn from a stream of
    # their own (seed and epoch), so the run itself is unchanged
    save_artifacts: bool = False
    # JAX's jax_default_matmul_precision, mapped onto the process-wide
    # torch.set_float32_matmul_precision: 'highest' -> 'highest' (the
    # package's pin); 'high' -> 'high'; 'default' / 'bfloat16' ->
    # 'medium'; None leaves the setting alone
    matmul_precision: str | None = 'highest'
    grad_clip: float | None = 10.0
    # 'clipped_score' or 'reference' (the custom-derivative local energy
    # with the running baseline; energy_clip clamps it to ±energy_clip)
    estimator: str = 'clipped_score'
    energy_clip: float | None = None
    # the clip window's deviation statistic: 'mean_abs' or 'median_abs'
    clip_stat: str = 'mean_abs'
    # 'ancestral' (exact draws from |ψ|² every epoch), 'metropolis' or
    # 'mala' (persistent walkers, warm-started from one exact draw)
    sampler: str = 'ancestral'
    mcmc_sweeps: int = 3                  # MCMC sweeps per update
    mcmc_step_size: float = 0.5           # initial proposal scale (adapts)
    mcmc_target_accept: float = 0.5
    # exact ancestral walker refresh for the MCMC samplers, in epochs
    # (rounded to whole windows; the adapted step size is kept): 'auto' =
    # once per window for >= 3 electrons under the sorted ansatz (trapping
    # in nodal pockets, Li), never otherwise (the He flagship, and the
    # antisym ansatz, which has no exact sampler); an int sets it (raises
    # under 'antisym'); None disables
    mcmc_refresh_every: int | None | str = 'auto'
    # 'adam', or the natural-gradient 'sr' (matrix-free CG) and 'spring'
    # (sample-space Cholesky with momentum), vmc/sr.py
    optimizer: str = 'adam'
    sr_damping: float = 1e-3
    sr_cg_iters: int = 20
    spring_momentum: float = 0.9
    # SPRING's score-row clip (rows above clip x median shrunk) for the
    # first `warmup` updates; None disables / keeps it always on
    score_row_clip: float | None = 10.0
    score_row_clip_warmup: int | None = 1000
    # trust region of the natural-gradient updates: ||lr*delta||_2 capped
    sr_max_update_norm: float | None = 0.3
    # 'sorted' (ψ on the sorted sector of the coordinate map) or 'antisym'
    # (the signed sum over electron permutations of a Waveflow on the
    # 'independent' map; Metropolis or MALA walkers only)
    ansatz: str = 'sorted'
    interactions: bool = True
    # on a non-finite loss window, restore the last good state (snapshot
    # every 10 windows) and continue with a reseeded walker stream; False
    # takes no snapshot and keeps such a window: its losses are recorded
    # and the run goes on from the state it left
    divergence_recovery: bool = True
    # shard the walker batch over processes: False (one process), True (a
    # 1-D walker group over the world) or 'hosts' (a hosts × chips grid,
    # LOCAL_WORLD_SIZE ranks per host); every rank builds the same config
    data_parallel: bool | str = False
    # the process group of a multi-process run (parallel/mesh.py::
    # distributed_init): rank 0's host:port, the world size and this
    # rank; None when torchrun (or the caller) made the group already
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    # accepted, no effect: there is no XLA executable cache to keep
    compilation_cache_dir: str | None = None
    # 'cuda' is cuda:{LOCAL_RANK} under data_parallel
    device: str = 'cuda'

    def resolved_save_dir(self) -> str:
        if self.save_dir is not None:
            return self.save_dir
        return (f"./results/{self.system_name}_{self.n_space_dimension}d"
                f"_L{self.box_length:g}box")


_ONLY = {
    'xu_coord_type': COORD_TYPES,
    'eval_backend': ('poly', 'poly_pallas', 'table'),
    'sampling_backend': ('table', 'poly'),
    'laplacian_mode': ('fwd_batched', 'fwd', 'hvp', 'dense'),
    'estimator': ('clipped_score', 'reference'),
    'sampler': ('ancestral', 'metropolis', 'mala'),
    'optimizer': ('adam', 'sr', 'spring'),
    'clip_stat': ('mean_abs', 'median_abs'),
    'divergence_recovery': (True, False),
    'data_parallel': (False, True, 'hosts'),
}

# VMCConfig.matmul_precision (JAX's names) -> torch's float32 matmul setting
MATMUL_PRECISION = {'highest': 'highest', 'high': 'high',
                    'default': 'medium', 'bfloat16': 'medium'}


def _check_combination(c: VMCConfig):
    """Refuse what the JAX trainer accepts and silently ignores: the SR and
    SPRING steps take no estimator, clip statistic or energy clip, and the
    JAX MCMC windows build their adam step without ``clip_stat``."""
    if c.optimizer != 'adam' and (c.estimator != 'clipped_score'
                                  or c.clip_stat != 'mean_abs'
                                  or c.energy_clip is not None):
        raise NotImplementedError(
            f"optimizer={c.optimizer!r} takes no estimator, clip_stat or "
            "energy_clip (the JAX trainer ignores them there)")
    if c.sampler != 'ancestral' and c.clip_stat != 'mean_abs':
        raise NotImplementedError(
            f"clip_stat={c.clip_stat!r} with sampler={c.sampler!r}: the JAX "
            "MCMC windows ignore clip_stat")
    if c.matmul_precision and c.matmul_precision not in MATMUL_PRECISION:
        raise ValueError(
            f"unknown matmul_precision {c.matmul_precision!r}; one of "
            f"{sorted(MATMUL_PRECISION)}")


def resolve_ansatz(config: VMCConfig, n_particle: int):
    """(ansatz, coordinate map) as the JAX trainer resolves them
    (``trainer.py:229-255``): 'antisym' with several electrons runs on the
    'independent' map (and raises ValueError with ancestral walkers: |ψ_A|²
    has no exact sampler); otherwise 'sorted', on 'paired2d' for several
    electrons in 2D, 'independent' for one electron in more than one
    dimension, the configured map in 1D; several electrons in more than 2
    dimensions raise NotImplementedError, as in JAX."""
    c = config
    if c.ansatz not in ('sorted', 'antisym'):
        raise ValueError(f"unknown ansatz {c.ansatz!r}")
    if c.ansatz == 'antisym' and n_particle > 1:
        if c.sampler == 'ancestral':
            raise ValueError(
                "ansatz='antisym' has no exact ancestral sampler (|ψ_A|² is "
                "unnormalized) — use sampler='metropolis' or 'mala'")
        return 'antisym', 'independent'
    if c.n_space_dimension == 2 and n_particle > 1:
        return 'sorted', 'paired2d'
    if c.n_space_dimension > 2 and n_particle > 1:
        raise NotImplementedError(
            "sorted-sector multi-electron systems are supported in 1D "
            "(coordinate sort) and 2D (paired2d x-sorted sector); for "
            "n_space_dimension > 2 use ansatz='antisym'")
    if c.n_space_dimension > 1:
        return 'sorted', 'independent'
    return 'sorted', c.xu_coord_type


def graph_windows(device, graph: bool | None = None, mesh=None) -> bool:
    """Whether a trainer runs its windows as replayed CUDA graphs, for every
    (optimizer, sampler) pair, ansatz and coordinate map: ``graph=None``
    means yes on a CUDA device; ``graph=True`` raises ValueError on the
    CPU; ``graph=False`` runs every window eagerly (the A/B of
    chip_smoke.py and bench_torch.py).  Walkers sharded over a ``mesh``:
    NCCL's collectives are captured with the epoch; gloo's cannot be, so
    under gloo ``graph=None`` means eager and ``graph=True`` raises
    NotImplementedError (a stated policy, not a fallback:
    parallel/sharding.py::use_graph)."""
    if mesh is not None:
        return sharding.use_graph(graph, mesh)
    return graphs.use_graph(graph, device)


def _to_numpy(tree):
    """Tensors -> numpy arrays inside an optimizer state dict."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree


def _to_tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree)
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_tensors(v) for v in tree]
    return tree


class VMCTrainer:
    """Builds the model + Hamiltonian and runs the sample/update loop.
    ``graph`` as in ``graph_windows``."""

    def __init__(self, config: VMCConfig | None = None, *,
                 graph: bool | None = None, **overrides):
        known = {f.name for f in fields(VMCConfig)}
        unported = sorted(set(overrides) - known)
        if unported:
            raise NotImplementedError(
                f"VMCConfig fields {unported} are not ported to the PyTorch "
                "trainer")
        config = config if config is not None else VMCConfig(**overrides)
        self.config = c = config
        for name, allowed in _ONLY.items():
            if getattr(c, name) not in allowed:
                raise NotImplementedError(
                    f"{name}={getattr(c, name)!r} is not ported; "
                    f"supported: {allowed}")
        _check_combination(c)
        if c.matmul_precision:
            torch.set_float32_matmul_precision(
                MATMUL_PRECISION[c.matmul_precision])
        # the walker axis: None, or the group this rank shards walkers over
        self.mesh = None
        if c.data_parallel:
            device = mesh_lib.local_device(c.device)
            resolve_device(device)
            mesh_lib.distributed_init(c.coordinator_address,
                                      c.num_processes, c.process_id,
                                      device=device)
            self.mesh = (mesh_lib.make_host_chip_mesh(device=device)
                         if c.data_parallel == 'hosts'
                         else mesh_lib.make_walker_mesh(device=device))
        elif (c.num_processes or c.coordinator_address
              or c.process_id is not None):
            # the JAX trainer joins the group and trains unsharded, the same
            # run in every process
            raise NotImplementedError(
                "num_processes / coordinator_address / process_id without "
                "data_parallel: every process would train the same walkers")
        self.walker_axis = None if self.mesh is None else self.mesh.axis
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self.local_batch = (c.batch_size if self.mesh is None else
                            sharding.local_batch_size(c.batch_size,
                                                      self.mesh))
        self.device = resolve_device(
            c.device if self.mesh is None else self.mesh.device)
        self.protons, self.n_particle = system_catalogue[
            c.n_space_dimension][c.system_name]
        self.input_dim = int(self.n_particle) * c.n_space_dimension
        # the RESOLVED ansatz and coordinate map (vmc/evaluate.py derives
        # the sector from the map)
        self.ansatz, self.xu_coord_type = resolve_ansatz(c, int(self.n_particle))
        model_kw = dict(
            base_spline_degree=c.spline_degree, i_spline_degree=c.spline_degree,
            n_prior_internal_knots=c.num_knots, n_i_internal_knots=c.num_knots,
            i_spline_reg=c.i_spline_reg,
            i_spline_reverse_fun_tol=c.i_spline_reverse_fun_tol,
            n_flow_layers=c.n_flow_layers, box_size=c.box_length,
            n_spline_base_mesh_points=c.n_spline_base_mesh_points,
            eval_backend=c.eval_backend, sampling_backend=c.sampling_backend,
            generator=torch.Generator().manual_seed(c.seed),
            device=self.device)
        if self.ansatz == 'antisym':
            self.model = get_antisym_waveflow_model(
                int(self.n_particle), c.n_space_dimension, **model_kw)
        else:
            self.model = get_waveflow_model(
                self.input_dim, xu_coord_type=self.xu_coord_type, **model_kw)
        # the per-walker 'fwd' runs at batch level under the kernel backend
        # (JAX trainer.py:281-283; the Hamiltonian itself keeps the mode)
        lap_mode = c.laplacian_mode
        if c.eval_backend == 'poly_pallas' and lap_mode == 'fwd':
            lap_mode = 'fwd_batched'
        self.laplacian_mode = lap_mode
        self.h_fn = construct_hamiltonian_function(
            self.model.psi, protons=self.protons,
            n_space_dimensions=c.n_space_dimension, eps=0.0,
            laplacian_mode=lap_mode, interactions=c.interactions)
        ng = dict(damping=c.sr_damping, max_update_norm=c.sr_max_update_norm,
                  pmean_axis=self.walker_axis)
        if c.optimizer == 'sr':
            self.step = make_sr_train_step(
                self.model, self.h_fn, c.learning_rate,
                cg_iters=c.sr_cg_iters, **ng)
        elif c.optimizer == 'spring':
            self.step = make_spring_train_step(
                self.model, self.h_fn, c.learning_rate,
                momentum=c.spring_momentum, score_row_clip=c.score_row_clip,
                score_row_clip_warmup=c.score_row_clip_warmup, **ng)
        else:
            self.step = make_train_step(
                self.model.psi, self.h_fn, self.model.parameters(),
                c.learning_rate, grad_clip=c.grad_clip,
                estimator=c.estimator, energy_clip=c.energy_clip,
                clip_stat=c.clip_stat, pmean_axis=self.walker_axis)
        # the walker stream of this rank, and the stream every rank shares
        # (the MCMC warm start, the refresh): one stream over one rank
        self.generator = torch.Generator(self.device).manual_seed(
            sharding.rank_seed(c.seed + 1, self.rank))
        self.shared_generator = self._shared_stream(c.seed + 1)
        self.graph = graph_windows(self.device, graph, self.mesh)
        # the windows that hold a CUDA graph (dropped by _drop_graphs)
        self._graphed = []
        self.mcmc_state = None
        sort = sector_mode(self.xu_coord_type)
        mcmc_kw = dict(n_sweeps=c.mcmc_sweeps,
                       target_accept=c.mcmc_target_accept,
                       pmean_axis=self.walker_axis)
        if c.sampler == 'mala':
            self.mcmc_init, self.mcmc_window = make_mala_train_window(
                self.step, self.model.log_pdf, c.box_length,
                sort_fermions=sort, graph=self.graph, **mcmc_kw)
            self._graphed.append(self.mcmc_window)
        elif c.sampler == 'metropolis':
            self.mcmc_init, self.mcmc_window = make_mcmc_train_window(
                self.step, self.model.log_pdf, c.box_length,
                sort_proposals=sort, graph=self.graph, **mcmc_kw)
            self._graphed.append(self.mcmc_window)
        elif self.graph:
            self.train_window = TrainWindow(
                self.step, self.sample, self.local_batch, self.device,
                (self.generator,))
            self._graphed.append(self.train_window)
        self.epoch = 0
        self.losses: list = []
        # the estimator's running baseline (JAX's life cycle; not saved)
        self.baseline = self._zero_baseline()
        # the MCMC sampler's running accept rate after each epoch's sweeps,
        # since construction (not checkpointed)
        self.accept_rates: list = []

    def _drop_graphs(self) -> None:
        """Forget the captured windows: the optimizer's state tensors were
        swapped for others, so the next window captures again."""
        for window in self._graphed:
            window.reset()

    def _zero_baseline(self) -> torch.Tensor:
        return torch.zeros((), device=self.device)

    @property
    def multiprocess(self) -> bool:
        """Walkers sharded over more than one rank."""
        return self.mesh is not None and self.mesh.size > 1

    def _shared_stream(self, seed: int) -> torch.Generator:
        """The stream every rank shares, seeded from ``seed``: the walker
        generator itself over one rank, else the stream of rank = world
        (``rank_seed``), which no rank's walker stream uses."""
        if not self.multiprocess:
            return self.generator
        return torch.Generator(self.device).manual_seed(
            sharding.rank_seed(seed, self.mesh.size))

    def _reseed(self, seed: int) -> None:
        """Restart the walker streams (and the shared one) from ``seed``."""
        self.generator.manual_seed(sharding.rank_seed(seed, self.rank))
        if self.multiprocess:
            self.shared_generator.manual_seed(
                sharding.rank_seed(seed, self.mesh.size))

    def sample(self, num_samples: int) -> torch.Tensor:
        """Exact ancestral walkers from |ψ|² on the trainer's stream."""
        return self.model.sample(num_samples, generator=self.generator)

    def _init_mcmc_state(self, step_size: float | None = None):
        """MCMC walkers from one exact ancestral draw of the full batch on
        the shared stream, this rank's rows of it; ``step_size`` overrides
        the configured initial scale (a refresh keeps the adapted one)."""
        walkers = self.model.sample(self.config.batch_size,
                                    generator=self.shared_generator)
        if self.mesh is not None:
            walkers = sharding.shard_batch(walkers, self.mesh)
        return self.mcmc_init(
            walkers, step_size=(self.config.mcmc_step_size
                                if step_size is None else step_size))

    def _refresh_stride(self) -> int | None:
        """Windows between exact walker refreshes, or None: 'auto' is one
        window for >= 3 electrons under the sorted ansatz, as in JAX
        (``trainer.py:708-721``); a refresh under 'antisym', which has no
        exact sampler, raises ValueError."""
        c = self.config
        if c.sampler == 'ancestral':
            return None
        every = c.mcmc_refresh_every
        if every == 'auto':
            every = (c.window if self.ansatz == 'sorted'
                     and int(self.n_particle) >= 3 else None)
        if not every:
            return None
        if self.ansatz == 'antisym':
            raise ValueError(
                "mcmc_refresh_every requires an exact ancestral sampler "
                "(ansatz='sorted'); the antisym ansatz has none")
        return max(1, round(every / c.window))

    def _snapshot(self):
        # MCMC states are never written in place: a reference is a copy
        return (copy.deepcopy(self.model.state_dict()),
                copy.deepcopy(self.step.optimizer.state_dict()),
                self.mcmc_state)

    # ---- checkpointing ----------------------------------------------------

    def _walkers_numpy(self):
        return (None if self.mcmc_state is None else
                [f.cpu().numpy().copy() for f in self.mcmc_state])

    def save_checkpoint(self, save_dir: str):
        """Write ``<save_dir>/checkpoints`` atomically and ``loss.npy``, the
        per-epoch loss trace.  Over several ranks, rank 0 writes those (the
        shared stream in place of the walker generator, no walkers), every
        rank its ``checkpoints.shard{rank}`` (its generator, its MCMC
        rows), and every rank returns once all are written.  With
        ``save_artifacts``, a single-process run first writes the epoch's
        artifacts (vmc/artifacts.py) from ``artifact_generator(seed,
        epoch)``; the JAX trainer splits its own key for them, which would
        change the run's later draws."""
        path = Path(save_dir)
        multi = self.multiprocess
        c = self.config
        if c.save_artifacts and not multi:
            save_wavefunction_artifacts(
                save_dir, self.model, self.epoch, c.box_length,
                int(self.n_particle), self.protons,
                artifact_generator(c.seed, self.epoch, self.device),
                n_space_dimension=c.n_space_dimension)
        if multi:
            save_state(path / f'checkpoints.shard{self.rank}', {
                'generator': self.generator.get_state().numpy().copy(),
                'mcmc_state': self._walkers_numpy()})
        (save_state_multihost if multi else save_state)(
            path / 'checkpoints', {
                'params': {k: v.detach().cpu().numpy().copy()
                           for k, v in self.model.state_dict().items()},
                'optimizer': _to_numpy(self.step.optimizer.state_dict()),
                'epoch': self.epoch,
                'generator':
                    self.shared_generator.get_state().numpy().copy(),
                'mcmc_state': None if multi else self._walkers_numpy(),
            })
        if self.rank == 0:
            np.save(path / 'loss.npy', np.asarray(self.losses))
        if multi:
            torch.distributed.barrier()

    def _load_optimizer(self, saved, epoch: int, jax_params=None):
        """A checkpoint's optimizer state into this trainer's step, read as
        ``waveflow_tpu/vmc/trainer.py::load_checkpoint`` reads the JAX
        forms: the port's own state dict, or (``jax_params`` given) the
        JAX trainer's flat Adam moments, SPRING dict or pre-round-4 flat
        delta.  An Adam trainer re-initialises its moments on any other
        form, with the JAX trainer's notice; a SPRING trainer raises
        ValueError on one it cannot take; SR keeps no state.

        Only the state is read, as optax's state holds only the moments
        and the count: the hyperparameters (Adam's ``lr``, ``betas``,
        ``eps``, ``capturable``; SPRING's and SR's are not in their state)
        stay those this trainer's config built, so a run resumed at
        another learning rate trains at it."""
        opt, kind = self.step.optimizer, self.config.optimizer
        if kind == 'adam':
            opt.state.clear()
            capturable = opt.defaults['capturable']
            try:
                if jax_params is not None:
                    moments = adam_state_from_jax(
                        saved, jax_params, self.model.named_parameters(),
                        capturable=capturable)
                    for name, p in self.model.named_parameters():
                        opt.state[p] = moments[name]
                elif isinstance(saved, dict) and 'param_groups' in saved:
                    # Adam's load_state_dict takes every hyperparameter
                    # from the saved groups: hand it this trainer's own,
                    # the saved parameter indices kept (the device's
                    # capturable decides where the step count lives)
                    saved = _to_tensors(saved)
                    own = opt.state_dict()['param_groups']
                    if len(own) != len(saved['param_groups']):
                        raise ValueError("not this trainer's Adam groups")
                    saved['param_groups'] = [
                        {**mine, 'params': g['params']}
                        for mine, g in zip(own, saved['param_groups'])]
                    opt.load_state_dict(saved)
                else:
                    raise ValueError("not an Adam state")
            except ValueError:
                print("load_checkpoint: optimizer state structure changed "
                      "(pre-flatten checkpoint?) — re-initializing adam "
                      "moments", flush=True)
        elif kind == 'spring':
            fresh = self.step.init_state()
            if isinstance(saved, dict) and 'delta' in saved:
                # the dict state; counters added since are filled in
                opt.load_state_dict({**fresh, **saved})
                return
            # before round 4 the JAX state was the flat delta alone:
            # migrated with step := epoch, so the row-clip warmup does not
            # run again
            n = self.step.n_params
            if not (isinstance(saved, np.ndarray) and saved.ndim == 1
                    and saved.size == n):
                raise ValueError(
                    "checkpoint optimizer state does not match the "
                    "configured 'spring' optimizer (expected a flat delta "
                    f"vector of size {n}, got {type(saved).__name__}) — was "
                    "this checkpoint written with a different optimizer "
                    "(e.g. adam)?")
            opt.load_state_dict({
                **fresh, 'delta': saved,
                'step': torch.tensor(epoch, dtype=torch.int32)})

    def _walkers_from_numpy(self, fields, whole: bool):
        """An MCMC state (Metropolis or MALA by its field count) from a
        checkpoint's arrays; ``whole``: the full batch, of which this rank
        keeps its rows (the step size and accept rate are replicated)."""
        if fields is None:
            return None
        kind = (MALAState if len(fields) == len(MALAState._fields)
                else MetropolisState)
        fields = [torch.as_tensor(f, device=self.device) for f in fields]
        if whole and self.mesh is not None:
            fields = [sharding.shard_batch(f, self.mesh) if f.ndim else f
                      for f in fields]
        return kind(*fields)

    def load_checkpoint(self, save_dir: str) -> bool:
        """Restore from ``<save_dir>/checkpoints``, written by this trainer
        or by the JAX trainer; False if there is none.

        The optimizer state is read by ``_load_optimizer`` (another
        optimizer's state re-initialises Adam and fails a SPRING trainer,
        as in the JAX trainer).  From a JAX checkpoint: params, the
        optimizer state, the epoch and the Metropolis or MALA walkers; the
        walker generator restarts from ``config.seed``, since the JAX PRNG
        key has no torch counterpart.  Over several ranks each reads its
        ``checkpoints.shard{rank}`` too; from a checkpoint without one (a
        single process's, or JAX's), each keeps its rows of the walkers."""
        state = load_state(Path(save_dir) / 'checkpoints')
        if state is None:
            return False
        mcmc = state.get('mcmc_state')
        if 'opt_state' in state:                       # the JAX trainer's
            self.model.load_state_dict(params_from_jax(state['params']))
            self._load_optimizer(state['opt_state'], int(state['epoch']),
                                 jax_params=state['params'])
            self._reseed(self.config.seed + 1)
            self.mcmc_state = (None if mcmc is None else
                               self._walkers_from_numpy(
                                   mcmc_state_from_jax(mcmc, self.device),
                                   True))
        else:
            self.model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in state['params'].items()})
            self._load_optimizer(state['optimizer'], int(state['epoch']))
            self.shared_generator.set_state(
                torch.as_tensor(state['generator']))
            shard = (load_state(Path(save_dir)
                                / f'checkpoints.shard{self.rank}')
                     if self.multiprocess else None)
            if shard is not None:
                self.generator.set_state(torch.as_tensor(shard['generator']))
                mcmc = shard['mcmc_state']
            self.mcmc_state = self._walkers_from_numpy(mcmc, shard is None)
        self._drop_graphs()
        self.epoch = int(state['epoch'])
        loss_path = Path(save_dir) / 'loss.npy'
        if loss_path.exists():
            self.losses = np.load(loss_path).tolist()
        return True

    # ---- training ---------------------------------------------------------

    def train(self, num_epochs: int | None = None, restart: bool = False,
              callback=None, verbose: bool = True):
        """Run ``num_epochs`` epochs as the JAX trainer does: whole windows
        of ``config.window`` epochs with the configured sampler, then the
        remainder — all of ``num_epochs`` when it is below one window, and
        every epoch when ``callback`` is given — as single epochs of exact
        ancestral walkers through the configured train step, whatever the
        sampler (exact draws from |ψ|² suit any); the MCMC walkers are left
        as they are by those epochs.  ``callback(trainer, epoch, loss)``
        runs after each such epoch.  Returns the per-epoch losses (batch
        energy estimates) so far.  ``restart`` first loads the checkpoint
        under ``config.save_dir``.

        The baseline starts at zero; a good window sets it to its mean
        loss, a dropped window back to zero, and a single epoch with
        ``epoch % window == 0`` to the mean of the last ``window`` losses.

        A window with a non-finite loss is dropped (parameters, optimizer
        state and walkers restored from the last snapshot, the walker stream
        reseeded), and after a good window the epoch is start + (w + 1) ×
        window, w the window's index in this call: a dropped window's epochs
        count once a later window succeeds, as in the JAX trainer; the loss
        trace keeps the good windows' losses only.  With
        ``divergence_recovery=False`` no snapshot is taken and every window
        is kept as a good one is, its non-finite losses and mean included.

        Checkpoints are written only when ``config.save_dir`` is set (the
        JAX trainer always writes, to ``resolved_save_dir()``): every
        ``round(log_every / window)`` windows, at single epochs with
        ``epoch % log_every == 0``, and once at the end."""
        c = self.config
        num_epochs = c.num_epochs if num_epochs is None else num_epochs
        save_dir = c.save_dir
        if restart:
            if save_dir is None:
                raise ValueError("restart=True needs config.save_dir")
            self.load_checkpoint(save_dir)
        verbose = verbose and self.rank == 0
        if save_dir is not None and self.rank == 0:
            Path(save_dir).mkdir(parents=True, exist_ok=True)
            with open(Path(save_dir) / 'system_info.json', 'w') as f:
                json.dump({
                    'system_name': c.system_name,
                    'box_length': c.box_length,
                    'n_particle': int(self.n_particle),
                    'n_space_dimension': c.n_space_dimension,
                    'window': c.window,
                    'batch_size': c.batch_size,
                }, f, indent=4)
        self.baseline = self._zero_baseline()
        start, t0 = self.epoch, time.time()
        n_windows, rem = divmod(num_epochs, c.window)
        if callback is not None:
            n_windows, rem = 0, num_epochs
        if n_windows:
            self._train_windows(n_windows, start, t0, verbose)
        for epoch in range(self.epoch + 1, self.epoch + rem + 1):
            self.epoch = epoch
            loss = float(self.step(self.sample(self.local_batch),
                                   self.baseline))
            self.losses.append(loss)
            if epoch % c.window == 0:
                self.baseline = torch.tensor(
                    np.mean(self.losses[-c.window:]), dtype=torch.float32,
                    device=self.device)
            if epoch % c.log_every == 0:
                if save_dir is not None:
                    self.save_checkpoint(save_dir)
                if verbose:
                    rate = (epoch - start) / (time.time() - t0)
                    print(f"epoch {epoch} | loss {loss:.3f} | {rate:.1f} "
                          "steps/s", flush=True)
            if callback is not None:
                callback(self, epoch, loss)
        if save_dir is not None:
            self.save_checkpoint(save_dir)
        return self.losses

    def _train_windows(self, n_windows: int, start: int, t0: float,
                       verbose: bool):
        c = self.config
        use_mcmc = c.sampler != 'ancestral'
        if use_mcmc and self.mcmc_state is None:
            self.mcmc_state = self._init_mcmc_state()
        refresh_stride = self._refresh_stride()
        log_stride = max(1, round(c.log_every / c.window))
        good = None
        for w in range(n_windows):
            # the refresh follows the run's window count, not this call's,
            # so a resumed run refreshes where an unbroken one does
            g = (start + w * c.window) // c.window
            if refresh_stride and g and g % refresh_stride == 0:
                self.mcmc_state = self._init_mcmc_state(
                    step_size=float(self.mcmc_state.step_size))
            if c.divergence_recovery and w % 10 == 0:
                good = self._snapshot()
            if use_mcmc:
                losses, baseline, rates, mstate = self.mcmc_window(
                    self.mcmc_state, c.window, self.baseline, self.generator)
            elif self.graph:
                losses, baseline = self.train_window(c.window, self.baseline)
            else:
                losses, baseline = run_window(self.step, self.sample,
                                              self.local_batch, c.window,
                                              self.baseline)
            losses = losses.cpu()
            if c.divergence_recovery and not bool(
                    torch.isfinite(losses).all()):
                if verbose:
                    print(f"window {w}: non-finite losses — restoring last "
                          "good state", flush=True)
                self.model.load_state_dict(good[0])
                self.step.optimizer.load_state_dict(good[1])
                self._drop_graphs()
                self._reseed(c.seed + 1 + 1000003 * (w + 1))
                if use_mcmc:
                    self.mcmc_state = (good[2] if good[2] is not None
                                       else self._init_mcmc_state())
                self.baseline = self._zero_baseline()
                continue
            self.baseline = baseline
            if use_mcmc:
                self.mcmc_state = mstate
                self.accept_rates.extend(rates.cpu().tolist())
            self.losses.extend(losses.tolist())
            self.epoch = start + (w + 1) * c.window
            if c.save_dir is not None and (w + 1) % log_stride == 0:
                self.save_checkpoint(c.save_dir)
            if verbose and ((w + 1) % log_stride == 0 or w == n_windows - 1):
                rate = (self.epoch - start) / (time.time() - t0)
                acc = (f" | accept {self.accept_rates[-1]:.3f}" if use_mcmc
                       else "")
                print(f"epoch {self.epoch} | loss {self.losses[-1]:.3f} | "
                      f"{rate:.1f} steps/s{acc}", flush=True)
