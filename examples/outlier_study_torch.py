"""The box2 / Laplacian_interactive_particles outlier study on the
PyTorch/CUDA port (cf. benchmarks/outlier_study.py): learning rate, budget,
lr decay, ansatz capacity and the clip statistic, isolated one at a time.

The JAX script's jobs, one for one: each of ``SYSTEMS`` (box2, free, and
the interacting pair, both at L = 5) with each of the six ``VARIANTS``,
``VMCConfig(system_name, box_length=5.0, batch_size=256, window=100,
log_every=100_000, seed=2, learning_rate, num_knots, n_flow_layers,
clip_stat, interactions)``; the decay variant's second trainer, at lr 3e-5,
loads the first run's checkpoint and trains 20,000 epochs more.  The
``median_abs`` rows take the median absolute deviation as the clip's
scale (vmc/estimators.py::_median inside the graphed window).

Each row holds the JAX script's fields — ``vmc_median`` (the median of the
last fifth of the loss trace), ``exact`` (the JAX script's oracles:
``exact_free_fermion_energy(2, 5.0)`` and ``exact_ground_state_2p(...,
n_grid=160)``) and ``deviation`` — and beside them JAX's row from
results/outlier_study.json (without its TPU ``wall_s``), this device's
epochs/s, the trace's length and non-finite losses, the K1 (sampler) and K3
(basis jet) launches of the training, the gate and its verdict, and the
device (on a card its name and power limit, as nvidia-smi gives them).
Gate: |dev − dev_jax| <= max(2 |dev_jax|, 3e-3) on the trace median.

Rows go to ``<out-dir>/outlier_study.json`` and checkpoints to
``<out-dir>/outlier_<key>``; a row already there is skipped on a rerun.
Nothing is written under results/.

  python3 examples/outlier_study_torch.py --only box2
  python3 examples/outlier_study_torch.py \\
      --keys box2__median_abs_lr3e-4_40k
  python3 examples/outlier_study_torch.py --device cpu --epochs 4 \\
      --decay-epochs 2 --out-dir runs/rehearsal   # a CPU rehearsal
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'examples'))

import numpy as np
import torch

import round5_quality_torch as r5
from waveflow_tpu_torch.physics import (exact_free_fermion_energy,
                                        exact_ground_state_2p)
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

JAX_ROWS = REPO / 'results' / 'outlier_study.json'
OUT_NAME = 'outlier_study.json'

SYSTEMS = {
    'box2': dict(interactions=False),
    'Laplacian_interactive_particles': dict(interactions=True),
}
VARIANTS = {
    'base_lr1e-4_40k': dict(learning_rate=1e-4, epochs=40_000),
    'lr3e-4_40k': dict(learning_rate=3e-4, epochs=40_000),
    'lr3e-4_80k': dict(learning_rate=3e-4, epochs=80_000),
    'decay_40k+20k@3e-5': dict(learning_rate=3e-4, epochs=40_000,
                               decay_epochs=20_000, decay_lr=3e-5),
    'big_31k4l_lr3e-4_40k': dict(learning_rate=3e-4, epochs=40_000,
                                 num_knots=31, n_flow_layers=4),
    'median_abs_lr3e-4_40k': dict(learning_rate=3e-4, epochs=40_000,
                                  clip_stat='median_abs'),
}
# JAX's row fields that are TPU figures
TPU_FIELDS = ('wall_s',)


def keys():
    """Every row, in the JAX script's order."""
    return [f"{s}__{v}" for s in SYSTEMS for v in VARIANTS]


def oracle(name: str) -> float:
    """The JAX script's oracle of a system."""
    if name == 'box2':
        return float(exact_free_fermion_energy(2, 5.0))
    return float(exact_ground_state_2p(np.zeros((0, 1)), 5.0,
                                       n_grid=160)[0])


def config(key: str, args) -> VMCConfig:
    """The JAX script's trainer config of row ``key`` on ``args.device``,
    its checkpoint under ``<out-dir>/outlier_<key>``."""
    sysname, vname = key.split('__')
    vkw = VARIANTS[vname]
    save = Path(args.out_dir) / f"outlier_{key.replace('+', '_')}"
    return VMCConfig(system_name=sysname, box_length=5.0, batch_size=256,
                     window=100, log_every=100_000, seed=2,
                     save_dir=str(save), device=args.device,
                     learning_rate=vkw['learning_rate'],
                     num_knots=vkw.get('num_knots', 23),
                     n_flow_layers=vkw.get('n_flow_layers', 3),
                     clip_stat=vkw.get('clip_stat', 'mean_abs'),
                     **SYSTEMS[sysname])


def jax_row(key: str):
    """JAX's committed row, its TPU time left out, or None."""
    row = json.loads(JAX_ROWS.read_text()).get(key)
    return None if row is None else {k: v for k, v in row.items()
                                     if k not in TPU_FIELDS}


def gate(row: dict, ref: dict | None):
    """|dev − dev_jax| <= max(2 |dev_jax|, 3e-3) on the trace median, dev_jax
    JAX's median less the same oracle; a non-finite median is out.  None
    without a JAX row."""
    if ref is None:
        return None
    dev, dev_jax = row['deviation'], ref['vmc_median'] - row['exact']
    margin = max(2.0 * abs(dev_jax), 3e-3)
    ok = math.isfinite(dev) and abs(dev - dev_jax) <= margin
    return dict(limits=[dev_jax - margin, dev_jax + margin],
                dev_jax=dev_jax, in_gate=bool(ok))


def run_row(key: str, exact: float, args) -> dict:
    """Train row ``key`` as the JAX script does; its row (without the JAX
    row, the gate and the device)."""
    vkw = VARIANTS[key.split('__')[1]]
    cfg = config(key, args)
    epochs = vkw['epochs'] if args.epochs is None else args.epochs
    decay = vkw.get('decay_epochs')
    if decay and args.decay_epochs is not None:
        decay = args.decay_epochs
    t0 = time.time()
    r5._zero_launches()
    t = VMCTrainer(cfg)
    t.train(num_epochs=epochs, verbose=False)
    if decay:
        cfg2 = VMCConfig(**{**cfg.__dict__, 'learning_rate': vkw['decay_lr']})
        t2 = VMCTrainer(cfg2)
        t2.load_checkpoint(cfg.save_dir)
        t2.train(num_epochs=decay, verbose=False)
        t = t2
    if t.device.type == 'cuda':
        torch.cuda.synchronize()
    wall = time.time() - t0
    losses = np.asarray(t.losses)
    med = float(np.median(losses[-len(losses) // 5:]))
    return {'vmc_median': med, 'exact': exact, 'deviation': med - exact,
            'wall_s': wall, 'epochs_per_sec': (epochs + (decay or 0)) / wall,
            'epochs': t.epoch, 'trace_len': len(losses),
            'nonfinite_losses': int((~np.isfinite(losses)).sum()),
            'clip_stat': cfg.clip_stat, 'graph': bool(t.graph),
            'launches': r5._launches()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', default=None,
                    help='run only rows whose key starts with this')
    ap.add_argument('--keys', default=None,
                    help='comma list of rows (default: all 12)')
    ap.add_argument('--out-dir', default='runs/outlier_study',
                    help=f'where {OUT_NAME} and the checkpoints go')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--epochs', type=int, default=None,
                    help='training epochs of every row (a rehearsal; not '
                         'gated)')
    ap.add_argument('--decay-epochs', type=int, default=None,
                    help='epochs of the decay (a rehearsal; not gated)')
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    wanted = None if args.keys is None else args.keys.split(',')
    unknown = sorted(set(wanted or ()) - set(keys()))
    if unknown:
        print(f"outlier_study_torch: not a row: {unknown}", file=sys.stderr)
        return 2
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            print("outlier_study_torch: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 1
        from waveflow_tpu_torch.ops import cuda_build
        cuda_build.build()
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / OUT_NAME
    out = json.loads(path.read_text()) if path.exists() else {}
    info = r5.device_info(args.device)
    if 'card' in info:
        print(info['card'], flush=True)
    rehearsal = args.epochs is not None or args.decay_epochs is not None
    exact = {}
    for key in keys():
        if (wanted is not None and key not in wanted) or (
                args.only is not None and not key.startswith(args.only)):
            continue
        if key in out:
            continue
        sysname = key.split('__')[0]
        if sysname not in exact:
            exact[sysname] = oracle(sysname)
        row = run_row(key, exact[sysname], args)
        ref = jax_row(key)
        row['jax'] = ref
        row['gate'] = (dict(rehearsal=True, in_gate=None) if rehearsal
                       else gate(row, ref))
        row.update(info)
        out[key] = row
        path.write_text(json.dumps(out, indent=2))
        print(json.dumps({'key': key, **row}), flush=True)
    verdicts = [r['gate']['in_gate'] for r in out.values() if r.get('gate')]
    print(f"outlier_study_torch: {sum(v is True for v in verdicts)} of "
          f"{len(verdicts)} rows in gate", flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
