"""Density-estimation benchmark trainer.

Port of waveflow_tpu/benchmark/density.py: MLE training of Flow / IFlow /
MFlow / RQSFlow models on the 2D benchmark datasets with periodic metric
checkpoints
(KDE-KL, Hellinger², reconstruction distance, held-out log-likelihood).
Torch Adam, one full-batch step per epoch on a per-epoch permutation of
the training set drawn on the device.  The JAX package jits a ``lax.scan``
over each block of epochs; here one epoch over static tensors (the
parameters, Adam's state, a loss slot) is a replayed CUDA graph on the card
(``density_epochs``, vmc/graphs.py) and the eager twin elsewhere.  Losses
are read back once per block; the metric checkpoints run eagerly between
blocks, as JAX's do.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from waveflow_tpu_torch import resolve_device
from waveflow_tpu_torch.benchmark.metrics import (
    held_out_log_likelihood, kde_metrics, reconstruction_distance,
)
from waveflow_tpu_torch.bijections import (
    IMADE, MADE, NeuralSplineCoupling, Reverse, Serial, masked_conditioner,
    simple_masked_transform,
)
from waveflow_tpu_torch.models import Flow, get_model
from waveflow_tpu_torch.models.priors import Normal, Uniform
from waveflow_tpu_torch.vmc import graphs


def get_benchmark_model(model_name: str = 'MFlow', spline_reg: float = 0.02,
                        n_flow_layers: int = 3, spline_degree: int = 5,
                        n_knots: int = 23, n_mesh_points: int = 2000,
                        prior_spline_degree: int = 3,
                        prior_n_knots: int = 15, *, input_dim: int = 2,
                        generator: torch.Generator | None = None,
                        device=None):
    """Model zoo of the benchmark: 'MFlow', 'Flow', 'IFlow', 'RQSFlow'.

    The MFlow's M-spline *prior* stays at degree 3 with 15 knots whatever
    the I-spline settings, as in the JAX package."""
    device = resolve_device(device)
    if model_name == 'MFlow':
        return get_model(input_dim, base_spline_degree=prior_spline_degree,
                         i_spline_degree=spline_degree,
                         n_prior_internal_knots=prior_n_knots,
                         n_i_internal_knots=n_knots,
                         i_spline_reg=spline_reg,
                         n_flow_layers=n_flow_layers,
                         i_constraint_dict_left={0: 0.0},
                         i_constraint_dict_right={0: 1.0},
                         n_spline_base_mesh_points=n_mesh_points,
                         generator=generator, device=device)
    if model_name == 'Flow':
        # affine MADE + Normal(-0.5) prior
        layers = []
        for _ in range(n_flow_layers):
            layers.append(MADE(simple_masked_transform(), input_dim,
                               generator=generator, device=device))
            layers.append(Reverse())
        return Flow(Serial(*layers), input_dim, Normal(-0.5), device=device)
    if model_name == 'IFlow':
        # monotone I-spline MADE + Uniform prior
        layers = []
        for _ in range(n_flow_layers):
            layers.append(IMADE(masked_conditioner(), input_dim,
                                spline_degree=spline_degree,
                                n_internal_knots=n_knots,
                                spline_regularization=spline_reg,
                                constraints_dict_left={0: 0.0},
                                constraints_dict_right={0: 1.0},
                                n_spline_base_mesh_points=n_mesh_points,
                                generator=generator, device=device))
            layers.append(Reverse())
        return Flow(Serial(*layers), input_dim, Uniform(),
                    prior_support=(0.0, 1.0), device=device)
    if model_name == 'RQSFlow':
        # rational-quadratic-spline couplings over the affine Flow's prior
        layers = []
        for _ in range(n_flow_layers):
            layers.append(NeuralSplineCoupling(input_dim, n_bins=8,
                                               interval=3.0,
                                               generator=generator,
                                               device=device))
            layers.append(Reverse())
        return Flow(Serial(*layers), input_dim, Normal(-0.5), device=device)
    raise ValueError(f"unknown model {model_name!r}")


def density_optimizer(model, learning_rate: float) -> torch.optim.Adam:
    """The trainer's Adam: ``capturable`` on a CUDA device (its step count
    on the device, so that an update can be captured), graphed or not, so
    that the two compare like with like; torch refuses it on the CPU."""
    params = list(model.parameters())
    return torch.optim.Adam(params, lr=learning_rate, eps=1e-8,
                            capturable=params[0].is_cuda)


def density_step(model, opt: torch.optim.Optimizer,
                 batch: torch.Tensor) -> torch.Tensor:
    """One MLE step on ``batch``; returns the loss (a device scalar).  The
    backward runs on the calling thread, as the VMC step's does
    (vmc/estimators.py::make_train_step): on the autograd engine's worker
    thread the order of the gradient sums follows the process's history."""
    with torch.autograd.set_multithreading_enabled(False):
        opt.zero_grad(set_to_none=True)
        loss = -model.log_pdf(batch).mean()
        loss.backward()
        opt.step()
    return loss.detach()


def density_epochs(model, opt: torch.optim.Optimizer, X: torch.Tensor,
                   generator: torch.Generator, graph: bool | None = None):
    """The trainer's epochs as a window (vmc/graphs.py): ``window(n)``
    runs n epochs and returns ``[losses (n,)]`` on the device.  An epoch
    permutes ``X`` (on its device) by a draw from ``generator`` (on the
    same device) and takes one ``density_step`` on it.  ``graph`` (default:
    on a CUDA device) replays it as a CUDA graph; True on the CPU raises.
    Graphed, it raises RuntimeError at once while an autograd graph over
    the model's parameters made outside it is still alive
    (``graphs.check_leaves_free``)."""
    loss = torch.zeros((), device=X.device)

    def epoch():
        perm = torch.randperm(X.shape[0], generator=generator,
                              device=X.device)
        loss.copy_(density_step(model, opt, X[perm]))
    graph = graphs.use_graph(graph, X.device)
    if graph:
        graphs.check_leaves_free(model.parameters())
    return graphs.make_window(epoch, (loss,), (generator,), graph)


def metric_checkpoint(model, n_model_sample: int,
                      generator: torch.Generator | None = None,
                      X_test=None) -> dict:
    """The metrics of one checkpoint: KDE-KL and Hellinger² of
    ``n_model_sample`` model draws, their reconstruction distance and,
    with ``X_test``, the held-out mean log-likelihood."""
    model_samples, orig = model.sample(n_model_sample, generator=generator,
                                       return_original_samples=True)
    kl, hell = kde_metrics(model, model_samples)
    out = {'kl': kl, 'hellinger': hell,
           'reconstruction': reconstruction_distance(model, model_samples,
                                                     orig)}
    if X_test is not None:
        out['test_ll'] = held_out_log_likelihood(model, X_test)
    return out


def train_density_model(X: np.ndarray, model_name: str = 'MFlow',
                        num_epochs: int = 1000, learning_rate: float = 1e-4,
                        spline_reg: float = 0.02, n_flow_layers: int = 3,
                        spline_degree: int = 5, n_knots: int = 23,
                        log_every: int = 500, save_dir: str | None = None,
                        n_model_sample: int = 5000, seed: int = 5,
                        n_mesh_points: int = 2000, verbose: bool = True,
                        X_test: np.ndarray | None = None,
                        prior_spline_degree: int = 3,
                        prior_n_knots: int = 15, *, device=None,
                        generator: torch.Generator | None = None,
                        model=None, graph: bool | None = None):
    """MLE-train a density model; returns (model, history).

    ``generator`` (a CPU generator, default: seeded with ``seed``) draws
    the initial weights and the seeds of two device generators: the one
    the metric checkpoints sample with and the one the per-epoch
    permutations come from.  ``graph`` (default: on a CUDA device) runs
    each epoch as a replayed CUDA graph (``density_epochs``); False gives
    the eager twin, True on the CPU raises ValueError.  ``model``
    continues from an existing module instead of a fresh one; graphed,
    no autograd graph over its parameters may still be alive (a kept
    loss): that raises RuntimeError before the first epoch.  With
    ``X_test``, each metric checkpoint also records the held-out mean
    log-likelihood (history['test_ll'] / test_ll.txt) and the best
    snapshot is kept in history['best_params'] (a CPU state dict)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    if model is None:
        model = get_benchmark_model(
            model_name, spline_reg, n_flow_layers, spline_degree, n_knots,
            n_mesh_points, prior_spline_degree=prior_spline_degree,
            prior_n_knots=prior_n_knots, input_dim=X.shape[-1],
            generator=generator, device=device)
    sample_gen = torch.Generator(device).manual_seed(
        int(torch.randint(2 ** 62, (), generator=generator)))
    perm_gen = torch.Generator(device).manual_seed(
        int(torch.randint(2 ** 62, (), generator=generator)))
    X_dev = torch.as_tensor(X, dtype=torch.float32, device=device)
    epochs = density_epochs(model, density_optimizer(model, learning_rate),
                            X_dev, perm_gen, graph)

    def snapshot():
        return {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}

    # losses stay on the device within a block of epochs: one read-back per
    # block, not one host synchronisation per epoch
    block = max(1, min(100, log_every))
    history = {'losses': [], 'kl': [], 'hellinger': [], 'reconstruction': [],
               'test_ll': [], 'best_test_ll': -np.inf, 'best_epoch': 0}
    best_params = snapshot()
    epoch = 0
    while epoch < num_epochs:
        losses, = epochs.window(block)
        history['losses'].extend(losses.tolist())
        epoch += block
        if epoch % log_every == 0 or epoch >= num_epochs:
            m = metric_checkpoint(model, n_model_sample, sample_gen, X_test)
            history['kl'].append(m['kl'])
            history['hellinger'].append(m['hellinger'])
            history['reconstruction'].append(m['reconstruction'])
            msg = (f"epoch {epoch} | loss {history['losses'][-1]:.4f} | "
                   f"KL {m['kl']:.4f} | H² {m['hellinger']:.4f} | "
                   f"recon {m['reconstruction']:.2e}")
            if X_test is not None:
                tll = m['test_ll']
                history['test_ll'].append(tll)
                msg += f" | test-LL {tll:.4f}"
                # long schedules overfit the small train sets: track the
                # held-out-best snapshot so callers can early-stop post hoc
                if tll > history['best_test_ll']:
                    history['best_test_ll'] = tll
                    history['best_epoch'] = epoch
                    best_params = snapshot()
            if verbose:
                print(msg, flush=True)
            if save_dir:
                path = Path(save_dir)
                path.mkdir(parents=True, exist_ok=True)
                np.savetxt(path / 'losses.txt', history['losses'])
                np.savetxt(path / 'kl_divergences.txt', history['kl'])
                np.savetxt(path / 'hellinger_divergences.txt',
                           history['hellinger'])
                np.savetxt(path / 'reconstruction_distances.txt',
                           history['reconstruction'])
                if history['test_ll']:
                    np.savetxt(path / 'test_ll.txt', history['test_ll'])
    history['best_params'] = best_params
    return model, history
