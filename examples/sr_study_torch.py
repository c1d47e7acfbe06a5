"""SR and min-SR (SPRING) against adam on the PyTorch/CUDA port (cf.
benchmarks/sr_study.py), He-1d, on the flagship ansatz and on the big one.

The JAX script's jobs, one for one: each of ``ANSATZE`` (flagship: 23
knots, 3 layers; big: 31 knots, 4 layers) with each of the nine ``OPTS``
(adam at 1e-4 and 3e-4; SPRING and CG-SR with and without the 0.3 trust
region on ||lr·δ||₂), ``VMCConfig(system_name='He', box_length=10.0,
batch_size=256, log_every=100_000, window=100, seed=2, ...)``, trained to
each of ``BUDGETS`` (2,000 and 10,000 epochs).  The 10,000 budget continues
the 2,000 run's trainer in the same process; a rerun that finds the 2,000
figures resumes from that run's checkpoint (``<out-dir>/sr_study_<key>``;
the port's resume is exact).  The trainer's divergence recovery stays on,
as configured.  On the card every window replays as a CUDA graph.

Each row holds the JAX script's fields, ``median_at_{B}`` (the median of the
last fifth of the loss trace so far) and ``steps_per_sec_at_{B}`` (this
device's rate over the budget's epochs, the first window's capture
included), and beside them SPRING's skipped solves and fallbacks, the
trace's length and its non-finite losses, and the K1 (sampler) and K3
(basis jet) launches of each budget's training (there is no evaluation).
A non-finite median is written as null, with the count of non-finite
losses beside it.  Gate, at 10,000 epochs, for the rows whose JAX median
(results/sr_study.json) lies below GATE_BELOW: |port − JAX| ≤ GATE_TOL.  The
other rows — those without a trust region, which diverged or stalled in
JAX, and big_adam_1e-4 — are ``ungated``, with a ``diverged`` flag (a
median above DIVERGED_ABOVE, or none).  Each row is printed as one JSON
line with JAX's row beside it (without its TPU rates), the gate and its
verdict, and the device (on a card its name and power limit, as
nvidia-smi gives them).  Rows go to ``<out-dir>/sr_study.json``; a budget
already there is not run again.  Nothing is written under results/.

``--only PREFIX`` runs the rows whose key starts with it (``big_``,
``flagship_sr``), ``--keys`` a comma list of them, so the study splits
across calls:

    python3 examples/sr_study_torch.py --only flagship_adam
    python3 examples/sr_study_torch.py --keys big_sr_cg_0.05,big_sr_cg_0.05_tr
    python3 examples/sr_study_torch.py --device cpu --budgets 4,8 \\
        --keys flagship_adam_3e-4 --out-dir runs/rehearsal  # CPU rehearsal
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
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

JAX_ROWS = REPO / 'results' / 'sr_study.json'
OUT_NAME = 'sr_study.json'

ANSATZE = {
    'flagship': dict(num_knots=23, n_flow_layers=3),
    'big': dict(num_knots=31, n_flow_layers=4),
}
OPTS = {
    # the un-suffixed natural-gradient rows run with NO trust region
    # (sr_max_update_norm=None); the _tr rows cap ||lr·δ||₂ at 0.3
    'adam_1e-4': dict(optimizer='adam', learning_rate=1e-4),
    'adam_3e-4': dict(optimizer='adam', learning_rate=3e-4),
    'spring_0.02_m0.99': dict(optimizer='spring', learning_rate=0.02,
                              spring_momentum=0.99, sr_max_update_norm=None),
    'spring_0.05_m0.9': dict(optimizer='spring', learning_rate=0.05,
                             spring_momentum=0.9, sr_max_update_norm=None),
    'sr_cg_0.05': dict(optimizer='sr', learning_rate=0.05, sr_cg_iters=20,
                       sr_max_update_norm=None),
    'spring_0.02_m0.99_tr': dict(optimizer='spring', learning_rate=0.02,
                                 spring_momentum=0.99,
                                 sr_max_update_norm=0.3),
    'spring_0.05_m0.9_tr': dict(optimizer='spring', learning_rate=0.05,
                                spring_momentum=0.9,
                                sr_max_update_norm=0.3),
    'spring_0.1_m0.99_tr': dict(optimizer='spring', learning_rate=0.1,
                                spring_momentum=0.99,
                                sr_max_update_norm=0.3),
    'sr_cg_0.05_tr': dict(optimizer='sr', learning_rate=0.05,
                          sr_cg_iters=20, sr_max_update_norm=0.3),
}
BUDGETS = (2_000, 10_000)
# the gate: rows whose JAX median at the last budget lies below GATE_BELOW
# must come within GATE_TOL of it; a median above DIVERGED_ABOVE diverged
GATE_BELOW = -1.80
GATE_TOL = 5e-3
DIVERGED_ABOVE = -1.0
# JAX's row fields that are TPU figures, left out of the row printed beside
TPU_PREFIX = 'steps_per_sec_at_'


def keys():
    """Every row, in the JAX script's order."""
    return [f"{a}_{o}" for a in ANSATZE for o in OPTS]


def config(key: str, args) -> VMCConfig:
    """The JAX script's trainer config for row ``key`` on ``args.device``,
    its checkpoint under ``<out-dir>/sr_study_<key>``."""
    ansatz, opt = key.split('_', 1)
    return VMCConfig(system_name='He', box_length=10.0, batch_size=256,
                     log_every=100_000, window=100, seed=2,
                     device=args.device,
                     save_dir=str(Path(args.out_dir) / f'sr_study_{key}'),
                     **ANSATZE[ansatz], **OPTS[opt])


def tail_median(losses) -> tuple:
    """(median of the last fifth of the trace as the JAX script takes it,
    or None where it is not finite; the trace's non-finite losses)."""
    losses = np.asarray(losses, dtype=np.float64)
    tail = losses[-max(1, len(losses) // 5):]
    median = float(np.median(tail))
    return (median if math.isfinite(median) else None,
            int((~np.isfinite(losses)).sum()))


def jax_row(key: str):
    """JAX's committed row, its TPU rates left out, or None."""
    row = json.loads(JAX_ROWS.read_text()).get(key)
    return None if row is None else {k: v for k, v in row.items()
                                     if not k.startswith(TPU_PREFIX)}


def gate(rec: dict, ref: dict | None, budget: int = BUDGETS[-1]):
    """At ``budget``: gated where JAX's median lies below GATE_BELOW
    (|port − JAX| ≤ GATE_TOL, a null median out), else ``ungated`` with the
    ``diverged`` flag; None before the budget has run."""
    bkey = f'median_at_{budget}'
    if bkey not in rec:
        return None
    median = rec[bkey]
    diverged = median is None or median > DIVERGED_ABOVE
    ref_median = None if ref is None else ref.get(bkey)
    if ref_median is None or ref_median >= GATE_BELOW:
        return dict(verdict='ungated', diverged=diverged,
                    jax_median=ref_median)
    diff = None if median is None else median - ref_median
    ok = diff is not None and abs(diff) <= GATE_TOL
    return dict(verdict='in_gate' if ok else 'outside_gate', diff=diff,
                tol=GATE_TOL, jax_median=ref_median, diverged=diverged,
                in_gate=ok)


def run_row(key: str, rec: dict, args, budgets, save) -> dict:
    """Train row ``key`` to each budget not yet in ``rec`` (one trainer for
    the row, resumed from its checkpoint when an earlier budget is done),
    ``save()`` after each budget."""
    cuda = torch.device(args.device).type == 'cuda'
    cfg = config(key, args)
    t, trained = None, 0
    for budget in budgets:
        bkey = f'median_at_{budget}'
        if bkey in rec:
            trained = budget
            continue
        if t is None:
            t = VMCTrainer(cfg)
            if trained and not t.load_checkpoint(cfg.save_dir):
                raise FileNotFoundError(
                    f"{key}: median_at_{trained} is recorded but "
                    f"{cfg.save_dir} holds no checkpoint to resume from")
        n_new = budget - trained
        r5._zero_launches()
        t0 = time.time()
        t.train(num_epochs=n_new, verbose=False)
        if cuda:
            torch.cuda.synchronize()
        wall = time.time() - t0
        median, nonfinite = tail_median(t.losses)
        rec[bkey] = median
        rec[f'steps_per_sec_at_{budget}'] = n_new / max(wall, 1e-9)
        rec[f'wall_s_at_{budget}'] = wall
        rec[f'epochs_at_{budget}'] = t.epoch
        rec[f'trace_len_at_{budget}'] = len(t.losses)
        rec[f'nonfinite_losses_at_{budget}'] = nonfinite
        rec[f'launches_at_{budget}'] = r5._launches()
        opt = t.step.optimizer.state_dict()
        if isinstance(opt, dict) and 'skipped' in opt:
            rec[f'spring_skipped_at_{budget}'] = int(opt['skipped'])
            rec[f'spring_fallbacks_at_{budget}'] = int(opt['fallbacks'])
        rec['graph'] = bool(t.graph)
        trained = budget
        save()
        print(f"{key} {bkey} {json.dumps(median)} "
              f"({rec[f'steps_per_sec_at_{budget}']:.1f} epochs/s)",
              flush=True)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', default=None,
                    help='run only rows whose key starts with this')
    ap.add_argument('--keys', default=None,
                    help='comma list of rows (default: all 18)')
    ap.add_argument('--out-dir', default='runs/sr_study',
                    help=f'where {OUT_NAME} and the checkpoints go')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--budgets', default=None,
                    help="comma list of cumulative epoch budgets (default: "
                         "the JAX script's 2000,10000); a rehearsal's "
                         "budgets are not gated")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    wanted = None if args.keys is None else args.keys.split(',')
    unknown = sorted(set(wanted or ()) - set(keys()))
    if unknown:
        print(f"sr_study_torch: not a row: {unknown}", file=sys.stderr)
        return 2
    budgets = (tuple(int(b) for b in args.budgets.split(','))
               if args.budgets else BUDGETS)
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            print("sr_study_torch: no CUDA device (pass --device cpu)",
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
    for key in keys():
        if (wanted is not None and key not in wanted) or (
                args.only is not None and not key.startswith(args.only)):
            continue
        rec = out.setdefault(key, {})
        if all(f'median_at_{b}' in rec for b in budgets):
            continue

        def save():
            path.write_text(json.dumps(out, indent=2))
        run_row(key, rec, args, budgets, save)
        ref = jax_row(key)
        rec['jax'] = ref
        rec['gate'] = (gate(rec, ref) if budgets == BUDGETS
                       else dict(verdict='ungated', rehearsal=True))
        rec.update(info)
        save()
        print(json.dumps({'key': key, **rec}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
