"""Evaluation artifacts written beside VMC checkpoints.

Port of waveflow_tpu/vmc/artifacts.py: the antisymmetrized ψ on a 2D grid,
one-electron density slices (anchored at a random draw and at the first
proton) and a cloud of walker draws, saved as .npy files under the JAX
package's names, shapes and dtypes for the figure pipeline
(utils/figures.py).  The sign of the sorting permutation comes from
physics/fermion.py on the model's device.

The port's idiom in place of JAX's ``(psi, params, sample)`` and key: a
model with ``psi(x)``, ``sample(n, generator=)`` and ``device`` (a
Waveflow or an AntisymWaveflow), and a ``torch.Generator`` that both the
anchor and the cloud are drawn from.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from waveflow_tpu_torch.physics.fermion import sort_and_parity


def eval_psi_antisymmetrized(psi, coords: torch.Tensor) -> np.ndarray:
    """ψ_A(x) = sign(sort) ψ(sorted x) for arbitrary (unsorted) coords:
    ``psi`` maps (B, n) sorted coordinates to (B,)."""
    xs, sgn = sort_and_parity(coords)
    return (sgn * psi(xs)).cpu().numpy()


def artifact_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The stream the trainer's artifacts of ``epoch`` are drawn from, made
    from the run's seed and the epoch alone, so that writing them leaves
    the walker streams untouched."""
    mixed = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)
    return torch.Generator(device).manual_seed(int(mixed[0] >> np.uint64(1)))


@torch.no_grad()
def save_wavefunction_artifacts(save_dir: str, model, epoch: int,
                                box_length: float, n_particle: int, protons,
                                generator: torch.Generator, ngrid: int = 100,
                                nsample: int = 250,
                                n_space_dimension: int = 1) -> None:
    """Write the ψ-grid, density-slice and sample-cloud artifacts of one
    epoch under ``<save_dir>/outputs``.

    Sort + parity antisymmetrization applies to identical 1D fermions
    only; for n_space_dimension > 1 (single-electron systems) ψ is
    evaluated directly and the 2D grid is the (x, y) plane of the one
    electron.  The model's parameters are only read."""
    base = Path(save_dir) / 'outputs'
    wf_dir = base / 'wavefunctions_2d'
    de_dir = base / 'density_1e'
    sp_dir = base / 'sample_points'
    for d in (wf_dir, de_dir, sp_dir):
        d.mkdir(parents=True, exist_ok=True)

    line = np.linspace(-box_length, box_length, ngrid)

    def eval_fn(c: np.ndarray) -> np.ndarray:
        coords = torch.as_tensor(np.asarray(c, np.float32),
                                 device=model.device)
        if n_space_dimension == 1:
            return eval_psi_antisymmetrized(model.psi, coords)
        return model.psi(coords).cpu().numpy()

    if (n_particle == 2 and n_space_dimension == 1) or \
            (n_particle == 1 and n_space_dimension == 2):
        # two 1D fermions with sort + parity, or one electron over its
        # (x, y) plane (2D multi-electron inputs have no 2D grid)
        X, Y = np.meshgrid(line, line)
        np.save(wf_dir / f'values_epoch{epoch}.npy',
                eval_fn(np.stack([X, Y], -1).reshape(-1, 2)))

    # one-electron density slice anchored at a random draw
    anchor = model.sample(1, generator=generator).cpu().numpy()
    x = np.repeat(anchor, ngrid, axis=0)
    x[:, 0] = line
    np.save(de_dir / f'random_values_epoch{epoch}.npy', eval_fn(x))
    np.save(de_dir / f'random_coord_epoch{epoch}.npy', x)

    # on-proton slice; protonless box systems have no anchor to slice.
    # Every particle sits at the full first-proton row (its y coordinate
    # too, in 2D)
    if np.asarray(protons).size:
        row = np.asarray(protons, dtype=np.float32)[0].ravel()
        x = np.tile(row, (ngrid, x.shape[1] // row.size))
        x[:, 0] = line
        np.save(de_dir / f'onproton_values_epoch{epoch}.npy', eval_fn(x))
        np.save(de_dir / f'onproton_coord_epoch{epoch}.npy', x)

    # walker sample cloud
    pts = model.sample(nsample, generator=generator).cpu().numpy()
    np.save(sp_dir / f'values_epoch{epoch}.npy', pts)
