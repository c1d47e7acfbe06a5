"""The 2D two-electron frontier on the PyTorch/CUDA port (cf.
benchmarks/frontier_2d2e.py): He and H2 in the 2D box, two electrons,
trained from scratch on the 'paired2d' x-sorted sector (electron (x, y)
pairs ordered by x; ψ = 0 at x-coincidence) and scored against the 2D-2e
sparse-ED oracle.

The JAX script's jobs, one for one: ``VMCConfig(system_name=name,
n_space_dimension=2, box_length=5.0, batch_size=256, log_every=20_000,
window=100, seed=2, learning_rate=3e-4)`` for He and H2, 60,000 epochs from
scratch.  The trainer resolves the sorted ansatz with several electrons in
2D to the 'paired2d' map, as JAX's ``trainer.py:243`` does; the row states
the resolved map and refuses any other.  On the card every window replays
as a CUDA graph.  Each row carries the JAX script's fields: ``trace_median``
(``median_energy_estimate`` of the last 20% of the loss trace), the
frozen-parameter evaluation at the JAX protocol (4,096 walkers, 250 warm-up
sweeps, 64 blocks of 25, paired2d sector proposals), ``exact_richardson``
and ``deviation_eval`` (clipped energy less the oracle); and beside them
the fidelity against the 40-point ED (results/ed40_{He,H2}_2d2e.npz, read
only): ``fidelity_ed40`` against the ED's first vector, and for He, whose
ground level is doubly degenerate, ``fidelity_subspace_ed40`` and
``fidelity_components_ed40`` against both, with ``ed40_energy`` and
``ed40_degenerate_gap``.

The oracle's Richardson value comes from ``--oracle`` (the port's own
oracle_2d_2e.json, examples/oracle_2d2e_torch.py) or else from the committed
results/oracle_2d_2e.json; the row names the file.  Gate (the round-5 2D rule,
round5_quality_torch.py::gate): |dev − dev_jax| ≤ max(2 |dev_jax|, 3e-3)
against results/frontier_2d2e.json, and the fidelity — He's taken on the
subspace — at least 1 − 10 (1 − JAX's).  Each row is printed as one JSON
line with JAX's row beside it (without its TPU times), the gate and its
verdict, the K1 (sampler) and K3 (basis jet) launches of training and of
evaluation, the loss trace's chunk medians beside JAX's committed trace
(results/{He,H2}_2d2e/loss.npy), and the device (on a card its name and
power limit, as nvidia-smi gives them).  Rows go to
``<out-dir>/frontier_2d2e.json`` and checkpoints to ``<out-dir>/<name>_2d2e``;
a row already there is not run again.  Nothing is written under results/.

    python3 examples/frontier_2d2e_torch.py
    python3 examples/frontier_2d2e_torch.py --keys H2 \\
        --oracle runs/oracle_2d2e/oracle_2d_2e.json
    python3 examples/frontier_2d2e_torch.py --device cpu --epochs 4 \\
        --fidelity-grid 6 --out-dir runs/rehearsal        # CPU rehearsal
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'examples'))

import numpy as np
import torch

import round5_quality_torch as r5
from waveflow_tpu_torch.physics import exact_ground_state_2d_2e
from waveflow_tpu_torch.utils import median_energy_estimate
from waveflow_tpu_torch.utils.fidelity import fidelity_2d_2e
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer, evaluate_trainer

JAX_ROWS = REPO / 'results' / 'frontier_2d2e.json'
ORACLE = REPO / 'results' / 'oracle_2d_2e.json'
OUT_NAME = 'frontier_2d2e.json'

BOX_LENGTH = 5.0
EPOCHS = 60_000
RUNS = {
    'He': dict(learning_rate=3e-4),
    'H2': dict(learning_rate=3e-4),
}
# the ED states of each system's ground level (He's is doubly degenerate)
N_STATES = {'He': 2, 'H2': 1}
EVAL_BLOCKS = 64
EVAL_BATCH = 4096
FIDELITY_GRID = 40
SECTOR = 'paired2d'
# JAX's row fields that are TPU figures, left out of the row printed beside
TPU_FIELDS = ('epochs_per_sec', 'wall_s', 'fidelity_wall_s')


def config(name: str, args) -> VMCConfig:
    """The JAX script's trainer config for ``name`` on ``args.device``, its
    checkpoints under ``<out-dir>/<name>_2d2e``."""
    return VMCConfig(system_name=name, n_space_dimension=2,
                     box_length=BOX_LENGTH, batch_size=256, log_every=20_000,
                     window=100, seed=2, device=args.device,
                     save_dir=str(Path(args.out_dir) / f'{name}_2d2e'),
                     **RUNS[name])


def jax_row(name: str):
    """JAX's committed row, TPU times left out, or None."""
    row = json.loads(JAX_ROWS.read_text()).get(name)
    return None if row is None else {k: v for k, v in row.items()
                                     if k not in TPU_FIELDS}


def oracle_value(name: str, path: Path) -> float:
    return json.loads(path.read_text())[
        f"{name}_2d_L{BOX_LENGTH:g}"]['richardson_32_40']


def ed_states(name: str, grid: int, out_dir: Path):
    """(evals, psi (m, k), sites, x) of ``name``'s ground level: the
    committed 40-point ED (r5.ed_2d2e), or at another grid one computed
    here (rehearsals)."""
    if grid == FIDELITY_GRID:
        return r5.ed_2d2e(name, N_STATES[name], out_dir)
    res = exact_ground_state_2d_2e(np.asarray(r5.ED_PROTONS[name]),
                                   BOX_LENGTH, n_grid=grid,
                                   n_states=N_STATES[name])
    if N_STATES[name] == 1:
        return np.array([res[0]]), res[1][:, None], res[2], res[3]
    return res


def fidelity_fields(name: str, trainer, grid: int, out_dir: Path) -> dict:
    """The fidelity fields of JAX's row at the ``grid``-point ED: against
    the first ED vector, and for a degenerate level against each vector
    and the subspace (√ of the summed squares)."""
    t0 = time.time()
    evals, psi_ed, sites, x = ed_states(name, grid, out_dir)
    tag = f'ed{grid}'
    comps = [fidelity_2d_2e(trainer.model.psi, psi_ed[:, i], sites, x,
                            device=trainer.device)
             for i in range(psi_ed.shape[1])]
    out = {f'fidelity_{tag}': comps[0], f'{tag}_energy': float(evals[0])}
    if len(comps) > 1:
        out[f'fidelity_subspace_{tag}'] = float(np.sqrt(np.sum(
            np.square(comps))))
        out[f'fidelity_components_{tag}'] = comps
        out[f'{tag}_degenerate_gap'] = float(evals[1] - evals[0])
    out['fidelity_wall_s'] = time.time() - t0
    return out


def gate(name: str, row: dict, ref: dict | None, grid: int = FIDELITY_GRID):
    """The round-5 2D rule (``r5.gate``): the deviation against JAX's, and at
    the 40-point ED the fidelity (He's on its ground subspace) against
    JAX's; every check needs finite losses and evaluation."""
    if ref is None:
        return None
    key = ('fidelity_subspace_ed40' if N_STATES[name] > 1
           else 'fidelity_ed40')
    checks = ('deviation', 'fidelity') if grid == FIDELITY_GRID else (
        'deviation',)
    job = r5.Job('frontier', name, EPOCHS, {}, checks=checks)
    out = r5.gate(job, {**row, 'fidelity_ed40': row.get(key)},
                  {**ref, 'fidelity_ed40': ref.get(key)})
    if 'fidelity' in out['checks']:
        out['checks']['fidelity']['field'] = key
    return out


def run_row(name: str, args, oracle: Path) -> dict:
    """Train ``name`` from scratch, evaluate it at the JAX protocol and
    score it against the oracle and the ED: the row before the gate."""
    cfg = config(name, args)
    epochs = EPOCHS if args.epochs is None else args.epochs
    t0 = time.time()
    trainer = VMCTrainer(cfg)
    if trainer.xu_coord_type != SECTOR or trainer.ansatz != 'sorted':
        raise RuntimeError(f"{name}: the trainer resolved "
                           f"({trainer.ansatz!r}, {trainer.xu_coord_type!r}),"
                           f" not ('sorted', {SECTOR!r})")
    r5._zero_launches()
    losses = np.asarray(trainer.train(num_epochs=epochs, verbose=False))
    if torch.device(args.device).type == 'cuda':
        torch.cuda.synchronize()
    wall = time.time() - t0
    train_launches = r5._launches()
    # JAX's blocks of 100 epochs; a rehearsal's shorter tail is one block
    tail = len(losses) - int(len(losses) * 0.8)
    median, median_stderr = median_energy_estimate(
        losses, tail_fraction=0.2, block_size=max(1, min(100, tail)))
    r5._zero_launches()
    ev = evaluate_trainer(trainer, n_blocks=EVAL_BLOCKS,
                          batch_size=EVAL_BATCH, **r5.EVAL_KW)
    eval_launches = r5._launches()
    exact = oracle_value(name, oracle)
    row = {'box_length': BOX_LENGTH, 'epochs': trainer.epoch,
           'trace_median': median, 'trace_median_stderr': median_stderr,
           **r5._evaluation_row(ev),
           'exact_richardson': exact, 'oracle': str(oracle),
           'deviation_eval': ev.e_clipped - exact,
           'epochs_per_sec': len(losses) / wall, 'wall_s': wall,
           'ansatz': trainer.ansatz, 'sector': trainer.xu_coord_type,
           'finite': r5._finite(losses, ev), 'graph': bool(trainer.graph),
           'launches': dict(train=train_launches, eval=eval_launches),
           'launches_per_epoch': {k: v / max(len(losses), 1)
                                  for k, v in train_launches.items()}}
    row.update(fidelity_fields(name, trainer, args.fidelity_grid,
                               Path(args.out_dir)))
    row['trace_chunks'] = r5.trace_chunks(
        cfg.save_dir, name, r5.TRACE_CHUNK,
        jax_dir=REPO / 'results' / f'{name}_2d2e')
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', default=None,
                    help='run only rows whose key starts with this')
    ap.add_argument('--keys', default=None,
                    help='comma list of rows (He, H2)')
    ap.add_argument('--out-dir', default='runs/frontier_2d2e',
                    help=f'where {OUT_NAME} and the checkpoints go')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--oracle', default=None,
                    help='an oracle_2d_2e.json (examples/oracle_2d2e_torch.py'
                         '); default the committed results/oracle_2d_2e.json')
    ap.add_argument('--epochs', type=int, default=None,
                    help=f'training epochs (default {EPOCHS:,})')
    ap.add_argument('--fidelity-grid', type=int, default=FIDELITY_GRID,
                    help='the ED grid of the fidelity (default 40, the '
                         'committed files; another grid is computed, and '
                         'its fidelity is not gated)')
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    keys = None if args.keys is None else args.keys.split(',')
    unknown = sorted(set(keys or ()) - set(RUNS))
    if unknown:
        print(f"frontier_2d2e_torch: not a row: {unknown}", file=sys.stderr)
        return 2
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            print("frontier_2d2e_torch: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 1
        from waveflow_tpu_torch.ops import cuda_build
        cuda_build.build()
    oracle = Path(args.oracle) if args.oracle else ORACLE
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / OUT_NAME
    out = json.loads(path.read_text()) if path.exists() else {}
    info = r5.device_info(args.device)
    if 'card' in info:
        print(info['card'], flush=True)
    todo = [n for n in RUNS if n not in out
            and (keys is None or n in keys)
            and (args.only is None or n.startswith(args.only))]
    if todo:
        print(f"frontier_2d2e_torch: oracle {oracle}", flush=True)
    for name in todo:
        row = run_row(name, args, oracle)
        ref = jax_row(name)
        row['jax'] = ref
        row['gate'] = gate(name, row, ref, args.fidelity_grid)
        row.update(info)
        out[name] = row
        path.write_text(json.dumps(out, indent=2))
        print(json.dumps({'key': name, **row}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
