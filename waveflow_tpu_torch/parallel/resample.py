"""Walker resampling across ranks.

Port of waveflow_tpu/parallel/resample.py: the walkers live sharded over a
walker axis; one all-gather brings every rank the whole population and its
log-weights, every rank computes the same systematic index set from a
uniform they share, and each keeps the rows of its own slice.
"""

from __future__ import annotations

import torch

from waveflow_tpu_torch.parallel import mesh


def systematic_indices(u: torch.Tensor, log_weights: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Systematic resampling indices of n draws from softmax(log_weights)
    at the offset ``u`` (a uniform on [0, 1), taken explicitly where JAX
    draws it from a key): vmc/smc.py::systematic_resample, whose index is
    clamped to the last row as JAX's gather clamps it."""
    from waveflow_tpu_torch.vmc.smc import systematic_resample
    return systematic_resample(u, log_weights, n)


def resample_walkers_sharded(positions: torch.Tensor,
                             log_weights: torch.Tensor, u: torch.Tensor,
                             axis=mesh.WALKER_AXIS):
    """Resample the GLOBAL walker population, on every rank of ``axis``.

    positions: (n_local, D) this rank's walkers; log_weights: (n_local,);
    u: the same uniform on every rank.  Returns (this rank's new walkers
    (n_local, D), uniform log-weights (zeros))."""
    all_pos = mesh.all_gather(positions, axis)
    all_lw = mesh.all_gather(log_weights, axis)
    n_local = positions.shape[0]
    idx = systematic_indices(u, all_lw, all_lw.shape[0])
    me = mesh.axis_index(axis)
    return (all_pos[idx[me * n_local:(me + 1) * n_local]],
            torch.zeros_like(log_weights))
