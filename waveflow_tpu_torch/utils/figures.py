"""Host-side figure generation: offline reports from saved artifacts.

Port of waveflow_tpu/utils/figures.py, every function, with the same
figures from the same arrays.  All functions take saved arrays or result
directories and write matplotlib figures; nothing here touches the device.
matplotlib is imported only inside ``_mpl``, when a figure is drawn: the
rest of the package, and a machine without matplotlib, never need it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# publication style (role of plot_helpers.py:7-23 RcParams)
STYLE = {
    'font.family': 'serif',
    'mathtext.fontset': 'stix',
    'legend.fontsize': 'large',
    'axes.labelsize': 'x-large',
    'axes.titlesize': 'large',
    'xtick.labelsize': 'large',
    'ytick.labelsize': 'large',
    'axes.linewidth': 0.8,
    'figure.autolayout': True,
    'savefig.dpi': 300,
    'lines.linewidth': 1.2,
}


def _mpl(styled: bool = True):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    if styled:
        plt.rcParams.update(STYLE)
    return plt


def plot_wavefunction_2d(psi_grid: np.ndarray, box_length: float,
                         out_path: str, title: str = ''):
    """Heatmap of ψ(x1, x2) over the box (plot_helpers.py role)."""
    plt = _mpl()
    n = int(np.sqrt(psi_grid.size))
    fig, ax = plt.subplots(figsize=(5, 4))
    vmax = np.abs(psi_grid).max()
    im = ax.imshow(psi_grid.reshape(n, n).T, origin='lower',
                   extent=[-box_length, box_length, -box_length, box_length],
                   cmap='RdBu', vmin=-vmax, vmax=vmax)
    fig.colorbar(im, ax=ax)
    ax.set_xlabel('$x_1$'); ax.set_ylabel('$x_2$')
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_one_electron_density(coords: np.ndarray, values: np.ndarray,
                              out_path: str, title: str = ''):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.plot(coords, values ** 2)
    ax.set_xlabel('$x$'); ax.set_ylabel(r'$|\psi|^2$ slice')
    if title:
        ax.set_title(title)
    ax.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_pdf_grid(pdf_grid: np.ndarray, out_path: str,
                  samples: np.ndarray | None = None):
    """Benchmark density heatmap with optional sample scatter."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(4.5, 4))
    ax.imshow(pdf_grid, origin='lower', extent=[0, 1, 0, 1], cmap='viridis')
    if samples is not None:
        ax.scatter(samples[:, 0], samples[:, 1], s=1, c='w', alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_energy_trace(losses: np.ndarray, out_path: str, window: int = 100,
                      clip: float = 100.0,
                      exact_energy: float | None = None):
    from waveflow_tpu_torch.utils.observables import uniform_sliding_average
    plt = _mpl()
    losses = np.clip(np.asarray(losses, dtype=float).ravel(), -clip, clip)
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.plot(losses, alpha=0.25, lw=0.5, label='clipped $E_L$')
    if len(losses) > window:
        ax.plot(uniform_sliding_average(losses, window), lw=1.5,
                label=f'window-{window} mean')
    if exact_energy is not None:
        ax.axhline(exact_energy, color='k', ls='--', lw=1,
                   label=f'exact {exact_energy:.4f}')
        lo = min(exact_energy - 0.5, np.percentile(losses, 2))
        ax.set_ylim(lo, exact_energy + 2.0)
    ax.set_xlabel('epoch'); ax.set_ylabel(r'$\langle E_L \rangle$')
    ax.legend(); ax.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_wavefunction_2d_multi(psi_grids: dict[str, np.ndarray],
                               box_length: float, out_path: str):
    """Panel of ψ(x1, x2) heatmaps across models/epochs on one shared color
    scale (plot_helpers.py:144-208 role).  psi_grids: {label: flat grid}."""
    plt = _mpl()
    n_panels = len(psi_grids)
    fig, axes = plt.subplots(1, n_panels, figsize=(4.4 * n_panels, 3.6),
                             squeeze=False, layout='constrained')
    vmax = max(np.abs(g).max() for g in psi_grids.values()) or 1.0
    for ax, (label, grid) in zip(axes[0], psi_grids.items()):
        n = int(np.sqrt(grid.size))
        im = ax.imshow(grid.reshape(n, n).T, origin='lower',
                       extent=[-box_length, box_length,
                               -box_length, box_length],
                       cmap='RdBu', vmin=-vmax, vmax=vmax)
        ax.set_title(label)
        ax.set_xlabel('$x_1$')
    axes[0][0].set_ylabel('$x_2$')
    fig.colorbar(im, ax=list(axes[0]), shrink=0.85)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def two_particle_box_analytic(box_length: float, ngrid: int = 200):
    """Analytic two-fermion-in-a-box ground state on the grid: the Slater
    determinant of the two lowest levels (plot_helpers.py:25-53 role,
    with this repo's [-L, L] box convention)."""
    L = box_length
    x = np.linspace(-L, L, ngrid)
    k = np.pi / (2 * L)
    psi1 = lambda t: np.sin(k * (t + L))
    psi2 = lambda t: np.sin(2 * k * (t + L))
    X, Y = np.meshgrid(x, x)
    grid = (psi1(X) * psi2(Y) - psi1(Y) * psi2(X)) / (2 * L)  # ~normalized
    return grid, x


def plot_two_particle_box_comparison(model_psi_grid: np.ndarray,
                                     box_length: float, out_path: str,
                                     model_label: str = 'Waveflow'):
    """Side-by-side: trained model ψ vs the analytic two-fermion-in-box
    Slater determinant (the reference's visual oracle,
    plot_helpers.py:25-88)."""
    grid_exact, _ = two_particle_box_analytic(
        box_length, int(np.sqrt(model_psi_grid.size)))
    # align the arbitrary global sign of the model state with the oracle
    flat = model_psi_grid.ravel()
    if np.dot(flat, grid_exact.ravel()) < 0:
        flat = -flat
    plot_wavefunction_2d_multi(
        {model_label: flat, 'analytic': grid_exact.ravel()},
        box_length, out_path)


def create_vmc_report(save_dir: str, out_path: str, box_length: float,
                      window: int = 100):
    """Combined VMC report from a training run's saved artifacts: energy
    trace, latest ψ grid, latest one-electron density slice (wires
    vmc/artifacts.py outputs into one figure, the create_figures.py role
    for the VMC side)."""
    plt = _mpl()
    from waveflow_tpu_torch.utils.observables import uniform_sliding_average
    d = Path(save_dir)
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.4))

    losses = np.load(d / 'loss.npy') if (d / 'loss.npy').exists() else None
    if losses is not None and losses.size:
        clipped = np.clip(losses.ravel(), -100, 100)
        axes[0].plot(clipped, alpha=0.25, lw=0.4)
        if len(clipped) > window:
            axes[0].plot(uniform_sliding_average(clipped, window), lw=1.2)
        axes[0].set_xlabel('epoch')
        axes[0].set_ylabel(r'$\langle E_L \rangle$')
        axes[0].set_title('energy trace')

    def _latest(pattern, folder):
        files = sorted((d / 'outputs' / folder).glob(pattern),
                       key=lambda p: int(''.join(filter(str.isdigit, p.stem))
                                         or 0))
        return files[-1] if files else None

    wf = _latest('values_epoch*.npy', 'wavefunctions_2d') \
        if (d / 'outputs' / 'wavefunctions_2d').exists() else None
    if wf is not None:
        grid = np.load(wf)
        n = int(np.sqrt(grid.size))
        vmax = np.abs(grid).max() or 1.0
        axes[1].imshow(grid.reshape(n, n).T, origin='lower', cmap='RdBu',
                       vmin=-vmax, vmax=vmax,
                       extent=[-box_length, box_length,
                               -box_length, box_length])
        axes[1].set_title(r'$\psi(x_1, x_2)$')
        axes[1].set_xlabel('$x_1$')

    de = _latest('random_values_epoch*.npy', 'density_1e') \
        if (d / 'outputs' / 'density_1e').exists() else None
    if de is not None:
        vals = np.load(de)
        coords = np.load(str(de).replace('values', 'coord'))
        axes[2].plot(coords[:, 0], vals ** 2)
        axes[2].set_title(r'one-electron $|\psi|^2$ slice')
        axes[2].set_xlabel('$x$')

    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def create_report(result_dirs: list[str], out_path: str):
    """Loss/KL/Hellinger/reconstruction curves across benchmark model dirs
    (create_figures.py:6-90)."""
    plt = _mpl()
    metrics = ['losses', 'kl_divergences', 'hellinger_divergences',
               'reconstruction_distances', 'test_ll']
    fig, axes = plt.subplots(1, len(metrics), figsize=(4 * len(metrics), 3))
    for d in result_dirs:
        d = Path(d)
        for ax, m in zip(axes, metrics):
            f = d / f'{m}.txt'
            if f.exists():
                ax.plot(np.loadtxt(f), label=d.name)
                ax.set_title(m.replace('_', ' '))
                ax.grid(True)
    axes[0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
