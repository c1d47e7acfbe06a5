"""Oracle-validation sweep over the system catalogue on the PyTorch/CUDA port
(cf. benchmarks/catalogue_sweep.py).

Trains every system of ``SWEEP`` (1D) or ``SWEEP_2D`` (the 2D one-electron
systems) from scratch — ``VMCConfig(system_name, n_space_dimension,
box_length, batch_size=256, num_epochs=40_000, seed=2, **extra)``, every
other field at its default, each window a replayed CUDA graph on the card —
and compares the median tail energy (``median_energy_estimate``, the last
20% of the loss trace) against the matching exact oracle:

  * interacting 1D systems: the h²-Richardson grid ED
    (``richardson_ground_energy_1d``), with the single-grid
    ``exact_ground_state_1d`` figure printed beside it;
  * the protonless ``interactions=False`` boxes: the analytic free-fermion
    level sum (``exact_free_fermion_energy``);
  * 2D one-electron systems: the 200² grid ED (``exact_ground_state_2d_1e``).

The oracles are computed in worker processes while the card trains.  Each
row is printed as one JSON line: the median and its blocked stderr, the
oracle and its figure, the deviation, the JAX package's deviation for the
same system (``results/catalogue_sweep_r5.json`` /
``catalogue_sweep_2d_r5.json``, read only) and the gate
``[-3 stderr, max(3 dev_jax, dev_jax + 3e-3)]``, epochs/s and wall seconds
on this device, and the K1 (sampler) and K3 (basis jet) launches of the
run.  Writes files only to ``--out`` (all rows, one JSON object) and, when
``--save-dir`` is given, the trainers' checkpoints under it; nothing under
``results/``.

  python3 examples/catalogue_sweep_torch.py --dims 1 --systems H,He+ \\
      --out runs/sweep_1d.json
  python3 examples/catalogue_sweep_torch.py --dims 2
  python3 examples/catalogue_sweep_torch.py --device cpu --epochs 500 \\
      --systems H          # a CPU rehearsal (the estimate's tail needs
                           # 100 epochs or more)
"""

import argparse
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np
import torch

from waveflow_tpu_torch import ops
from waveflow_tpu_torch.ops import cuda_jet, cuda_sampler
from waveflow_tpu_torch.physics import (exact_free_fermion_energy,
                                        exact_ground_state_1d,
                                        exact_ground_state_2d_1e,
                                        richardson_ground_energy_1d,
                                        system_catalogue)
from waveflow_tpu_torch.utils import median_energy_estimate
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

# (system, box_length, extra config), as benchmarks/catalogue_sweep.py
# lists them
SWEEP = [
    ('H', 10.0, {}),
    ('He+', 10.0, {}),
    ('H2+', 10.0, {}),
    ('H2+_wide', 12.0, {}),
    ('He', 10.0, {}),
    ('He_off_center', 10.0, {}),
    ('H2', 10.0, {}),
    ('H2_wide', 12.0, {}),
    # lr 3e-4 for the two former outliers: the round-3 study
    # (results/outlier_study.json) showed their +0.02 deviations were
    # under-training at the 1e-4 default, not estimator/ansatz issues
    ('Laplacian_interactive_particles', 5.0, dict(learning_rate=3e-4)),
    ('box2', 5.0, dict(interactions=False, learning_rate=3e-4)),
    ('box3', 5.0, dict(interactions=False, learning_rate=3e-4)),
    ('Li', 10.0, dict(learning_rate=3e-4)),
]

# 2D single-electron systems (the reference's 2D entries were never
# runnable; He/H2 at n_el=2 need a permutation-equivariant 2D ansatz and
# are excluded by the trainer).  Oracle: exact_ground_state_2d_1e.
SWEEP_2D = [
    ('H', 5.0, dict(learning_rate=3e-4)),
    ('He+', 5.0, dict(learning_rate=3e-4)),
    ('H2+', 5.0, dict(learning_rate=3e-4)),
]

EPOCHS = 40_000
SEED = 2
TAIL_FRACTION = 0.2
# the JAX package's rows for the same systems (their deviations set the
# gate; their times were taken on a TPU and are not read)
JAX_ROWS = {1: REPO / 'results' / 'catalogue_sweep_r5.json',
            2: REPO / 'results' / 'catalogue_sweep_2d_r5.json'}


def sweep_of(dims: int):
    return SWEEP if dims == 1 else SWEEP_2D


def oracle(dims: int, name: str, box_length: float, extra: dict,
           n_grids=None):
    """(exact energy, oracle name, single-grid ED figure or None) of a
    sweep entry.  ``n_grids`` (two grid sizes) replaces the default grids:
    the Richardson pair in 1D (the second also the single grid), the
    second as the 2D grid."""
    protons, n_el = system_catalogue[dims][name]
    protons, n_el = np.asarray(protons), int(n_el)
    if dims == 2:
        kw = {} if n_grids is None else dict(n_grid=n_grids[1])
        return (float(exact_ground_state_2d_1e(protons, box_length, **kw)[0]),
                '2D grid ED', None)
    if not extra.get('interactions', True):
        return (float(exact_free_fermion_energy(n_el, box_length)),
                'analytic free-fermion', None)
    single = exact_ground_state_1d(
        protons, n_el, box_length,
        n_grid=None if n_grids is None else n_grids[1])
    kw = {} if n_grids is None else dict(n_grids=n_grids)
    return (float(richardson_ground_energy_1d(protons, n_el, box_length,
                                              **kw)),
            'richardson grid ED', float(single))


def gate(stderr: float, dev_jax: float):
    """The band a deviation must lie in: the variational principle below
    (3 stderr of slack), the JAX run's deviation above with room for
    another random stream over the same epochs."""
    return -3.0 * stderr, max(3.0 * dev_jax, dev_jax + 3e-3)


def make_row(name: str, dims: int, box_length: float, losses, exact,
             dev_jax: float) -> dict:
    """A sweep row from a loss trace, its oracle ``(exact, oracle name,
    single-grid figure)`` and the JAX run's deviation: the tail median and
    its stderr, the deviation, the gate and whether the row lies inside
    it."""
    energy, oracle_name, single = exact
    n_el = int(system_catalogue[dims][name][1])
    median, stderr = median_energy_estimate(np.asarray(losses),
                                            tail_fraction=TAIL_FRACTION)
    row = {'system': name, 'dims': dims, 'n_el': n_el,
           'box_length': box_length, 'vmc_median': median, 'stderr': stderr,
           'exact': energy, 'deviation': median - energy,
           'oracle': oracle_name}
    if single is not None:
        row['exact_single_grid'] = single
        row['deviation_single_grid'] = median - single
    lo, hi = gate(stderr, dev_jax)
    row.update(deviation_jax=dev_jax, gate=[lo, hi],
               in_gate=bool(lo <= median - energy <= hi))
    return row


def jax_deviations(dims: int) -> dict:
    """The JAX run's deviation from its oracle, by system."""
    rows = json.loads(JAX_ROWS[dims].read_text())
    return {k: v['deviation'] for k, v in rows.items()}


def train(name: str, dims: int, box_length: float, extra: dict, args):
    """One sweep training: (losses, wall s, train s, K1 and K3 launches)."""
    save_dir = (None if args.save_dir is None else
                str(Path(args.save_dir) / f'sweep_{name}_{dims}d'))
    t0 = time.time()
    cfg = VMCConfig(system_name=name, n_space_dimension=dims,
                    box_length=box_length, batch_size=256,
                    num_epochs=args.epochs, log_every=20_000,
                    save_dir=save_dir, seed=args.seed, device=args.device,
                    **extra)
    trainer = VMCTrainer(cfg)
    ops.set_launches((0,) * len(ops.LAUNCH_COUNTERS))
    t1 = time.time()
    losses = np.asarray(trainer.train(verbose=False))
    if args.device != 'cpu':
        torch.cuda.synchronize()
    t2 = time.time()
    launches = {'sampler': cuda_sampler.launches,
                'basis_jet': cuda_jet.launches}
    return losses, t2 - t0, t2 - t1, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--dims', type=int, default=1, choices=[1, 2])
    ap.add_argument('--systems', default=None,
                    help='comma list of the sweep entries to run (default: '
                         'all of the chosen dimension)')
    ap.add_argument('--epochs', type=int, default=EPOCHS)
    ap.add_argument('--seed', type=int, default=SEED)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--out', default=None,
                    help='also write the rows, as one JSON object, here')
    ap.add_argument('--save-dir', default=None,
                    help='write each trainer\'s checkpoints under '
                         '<save-dir>/sweep_<system>_<dims>d')
    args = ap.parse_args(argv)
    sweep = sweep_of(args.dims)
    if args.systems is not None:
        wanted = args.systems.split(',')
        unknown = sorted(set(wanted) - {name for name, _, _ in sweep})
        if unknown:
            ap.error(f"not in the {args.dims}D sweep: {unknown}")
        sweep = [entry for entry in sweep if entry[0] in wanted]
    if args.device != 'cpu':
        if not torch.cuda.is_available():
            print("catalogue_sweep_torch: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 1
        # the kernels are built before the first row, so that no row's wall
        # time holds nvcc
        from waveflow_tpu_torch.ops import cuda_build
        cuda_build.build()
    dev_jax = jax_deviations(args.dims)
    rows = {}
    # the oracles (grid EDs on the host) run beside the trainings
    with ProcessPoolExecutor(
            max_workers=min(3, len(sweep)),
            mp_context=multiprocessing.get_context('spawn')) as pool:
        exact = {name: pool.submit(oracle, args.dims, name, L, extra)
                 for name, L, extra in sweep}
        for name, L, extra in sweep:
            losses, wall, train_s, launches = train(name, args.dims, L,
                                                    extra, args)
            row = make_row(name, args.dims, L, losses, exact[name].result(),
                           dev_jax[name])
            row.update(seed=args.seed, epochs=args.epochs,
                       epochs_per_sec=args.epochs / wall, wall_s=wall,
                       train_s=train_s, finite=bool(np.isfinite(losses).all()),
                       launches=launches, device=args.device)
            rows[name] = row
            print(json.dumps(row), flush=True)
    if args.out is not None:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=2))
    return 0


if __name__ == '__main__':
    sys.exit(main())
