"""VMC training loop: the ancestral + adam subset of the JAX VMCTrainer.

Port of waveflow_tpu/vmc/trainer.py for the main path: exact ancestral
walkers, the 'clipped_score' estimator, adam after an optax-form global
norm clip, single device, eval backends 'poly' and 'poly_pallas' (the
latter runs the CUDA basis-jet kernel).  Everything else the JAX config
offers — MCMC samplers, SR/SPRING, meshes, checkpoint save/resume and
artifacts — raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, fields

import torch

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.models.factory import get_waveflow_model
from waveflow_tpu_torch.physics import (
    construct_hamiltonian_function, system_catalogue,
)
from waveflow_tpu_torch.vmc.estimators import make_train_step, run_window


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
    n_spline_base_mesh_points: int = 2000
    # 'poly' (plain PyTorch basis jet) or 'poly_pallas' (the CUDA basis-jet
    # kernel on the card; the name is the JAX package's)
    eval_backend: str = 'poly'
    sampling_backend: str = 'table'
    laplacian_mode: str = 'fwd_batched'
    seed: int = 2
    grad_clip: float | None = 10.0
    estimator: str = 'clipped_score'
    clip_stat: str = 'mean_abs'
    sampler: str = 'ancestral'
    optimizer: str = 'adam'
    ansatz: str = 'sorted'
    interactions: bool = True
    # on a non-finite loss window, restore the last good state (snapshot
    # every 10 windows) and continue with a reseeded walker stream; always
    # on (False is not ported)
    divergence_recovery: bool = True
    device: str = 'cuda'


_ONLY = {
    'n_space_dimension': (1,), 'xu_coord_type': ('mean',),
    'eval_backend': ('poly', 'poly_pallas'), 'sampling_backend': ('table',),
    'laplacian_mode': ('fwd_batched',), 'estimator': ('clipped_score',),
    'sampler': ('ancestral',), 'optimizer': ('adam',), 'ansatz': ('sorted',),
    'clip_stat': ('mean_abs',), 'divergence_recovery': (True,),
}


class VMCTrainer:
    """Builds the model + Hamiltonian and runs the sample/update loop."""

    def __init__(self, config: VMCConfig | None = None, **overrides):
        known = {f.name for f in fields(VMCConfig)}
        unported = sorted(set(overrides) - known)
        if unported:
            raise NotImplementedError(
                f"VMCConfig fields {unported} are not ported to the PyTorch "
                "trainer (ancestral + adam + clipped_score, single device)")
        config = config if config is not None else VMCConfig(**overrides)
        self.config = c = config
        for name, allowed in _ONLY.items():
            if getattr(c, name) not in allowed:
                raise NotImplementedError(
                    f"{name}={getattr(c, name)!r} is not ported; "
                    f"supported: {allowed}")
        self.device = resolve_device(c.device)
        self.protons, self.n_particle = system_catalogue[
            c.n_space_dimension][c.system_name]
        self.input_dim = int(self.n_particle) * c.n_space_dimension
        init_gen = torch.Generator().manual_seed(c.seed)
        self.model = get_waveflow_model(
            self.input_dim, base_spline_degree=c.spline_degree,
            i_spline_degree=c.spline_degree,
            n_prior_internal_knots=c.num_knots, n_i_internal_knots=c.num_knots,
            i_spline_reg=c.i_spline_reg, n_flow_layers=c.n_flow_layers,
            box_size=c.box_length, xu_coord_type=c.xu_coord_type,
            n_spline_base_mesh_points=c.n_spline_base_mesh_points,
            eval_backend=c.eval_backend, sampling_backend=c.sampling_backend,
            generator=init_gen, device=self.device)
        self.h_fn = construct_hamiltonian_function(
            self.model.psi, protons=self.protons,
            n_space_dimensions=c.n_space_dimension,
            laplacian_mode=c.laplacian_mode, interactions=c.interactions)
        self.step = make_train_step(
            self.model.psi, self.h_fn, self.model.parameters(),
            c.learning_rate, grad_clip=c.grad_clip, estimator=c.estimator)
        self.generator = torch.Generator(self.device).manual_seed(c.seed + 1)
        self.epoch = 0
        self.losses: list = []

    def sample(self, num_samples: int) -> torch.Tensor:
        """Exact ancestral walkers from |ψ|² on the trainer's stream."""
        return self.model.sample(num_samples, generator=self.generator)

    def _snapshot(self):
        return (copy.deepcopy(self.model.state_dict()),
                copy.deepcopy(self.step.optimizer.state_dict()))

    def train(self, num_epochs: int | None = None, verbose: bool = True):
        """Run ``num_epochs`` epochs in windows of ``config.window``; returns
        the per-epoch losses (clipped batch-mean energies) so far."""
        c = self.config
        num_epochs = c.num_epochs if num_epochs is None else num_epochs
        start, t0 = self.epoch, time.time()
        good = None
        n_windows = -(-num_epochs // c.window)
        for w in range(n_windows):
            length = min(c.window, num_epochs - w * c.window)
            if w % 10 == 0:
                good = self._snapshot()
            losses = run_window(self.step, self.sample, c.batch_size, length)
            losses = losses.cpu()
            if not bool(torch.isfinite(losses).all()):
                if verbose:
                    print(f"window {w}: non-finite losses — restoring last "
                          "good state", flush=True)
                self.model.load_state_dict(good[0])
                self.step.optimizer.load_state_dict(good[1])
                self.generator.manual_seed(c.seed + 1 + 1000003 * (w + 1))
                continue
            self.losses.extend(losses.tolist())
            self.epoch += length
            if verbose and (self.epoch % c.log_every < length
                            or w == n_windows - 1):
                rate = (self.epoch - start) / (time.time() - t0)
                print(f"epoch {self.epoch} | loss {self.losses[-1]:.3f} | "
                      f"{rate:.1f} steps/s", flush=True)
        return self.losses
