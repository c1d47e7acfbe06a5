"""Exact-diagonalization reference solution for a catalogue system, on the
PyTorch/CUDA port's physics modules (cf. examples/exact_reference.py).
The eigensolve is scipy's on the host; nothing runs on the card.

Usage:
  python examples/exact_reference_torch.py --system He --box-length 10 \
      [--n-grid 140] [--plot out.png]

``--plot`` needs matplotlib.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveflow_tpu_torch.physics import system_catalogue
from waveflow_tpu_torch.physics.exact import (
    exact_ground_state_1p, exact_ground_state_2p,
)


def plot(path, system, E, psi, x, n_el):
    """ψ_0 of one electron as a line, of two as the antisymmetric (x1, x2)
    image of the pair amplitudes."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("--plot needs matplotlib, which is not installed")
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(5, 3.5))
    if n_el == 1:
        ax.plot(x, psi)
        ax.set_xlabel('$x$'); ax.set_ylabel(r'$\psi_0$')
    else:
        # scatter the pair amplitudes (i < j, row-major) into a dense image
        n = len(x)
        grid = np.zeros((n, n))
        iu = np.triu_indices(n, k=1)
        grid[iu] = psi
        grid[iu[::-1]] = -psi
        vmax = np.abs(grid).max()
        im = ax.imshow(grid.T, origin='lower', cmap='RdBu',
                       vmin=-vmax, vmax=vmax,
                       extent=[x[0], x[-1], x[0], x[-1]])
        fig.colorbar(im, ax=ax)
        ax.set_xlabel('$x_1$'); ax.set_ylabel('$x_2$')
    ax.set_title(f"{system}: $E_0$ = {E:.4f}")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--system', default='He')
    p.add_argument('--box-length', type=float, default=10.0)
    p.add_argument('--n-grid', type=int, default=None)
    p.add_argument('--plot', default=None)
    args = p.parse_args()

    protons, n_el = system_catalogue[1][args.system]
    protons = np.asarray(protons)
    if n_el == 1:
        E, psi, x = exact_ground_state_1p(protons, args.box_length,
                                          args.n_grid or 2000)
    elif n_el == 2:
        E, psi, x = exact_ground_state_2p(protons, args.box_length,
                                          args.n_grid or 140)
    else:
        raise SystemExit(f"{n_el} electrons unsupported")

    print(f"{args.system} 1d, L={args.box_length:g}: "
          f"exact ground-state energy = {E:.6f}")

    if args.plot:
        plot(args.plot, args.system, E, psi, x, n_el)
        print(f"wrote {args.plot}")


if __name__ == '__main__':
    main()
