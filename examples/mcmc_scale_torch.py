"""Metropolis and MALA VMC windows at scale on the PyTorch/CUDA port (cf.
benchmarks/mcmc_scale.py), He-1d flagship configuration.

Part A, ``throughput``: epochs/s and walkers/s of the MCMC training windows
for the JAX script's 20 cases, Metropolis at 1, 3 and 10 sweeps per epoch
and MALA at 1 and 3, each at batch 256, 4,096, 16,384 and 65,536; windows
of 100 epochs up to batch 4,096, else 20; two warm windows (the first
holds the capture on a card), then 3 timed windows up to batch 4,096, else
2.  The JAX script's window: the flagship model at initial parameters from
seed 0, 'fwd_batched', 'clipped_score', adam at lr 1e-4 with no norm
clip, walkers warm-started from one exact ancestral draw (K1 on the card)
at step size 0.5, the sampler's own target acceptance (0.5 Metropolis,
0.574 MALA), proposals in the sorted sector.

Part B, ``quality``: the JAX script's ``VMCConfig(system_name='He',
box_length=10.0, batch_size=256, learning_rate=1e-4, window=100,
sampler=..., mcmc_sweeps=max(sweeps, 1), seed=2)`` trained 10,000 epochs for
``metropolis_s1``, ``_s3``, ``_s10``, ``mala_s1``, ``_s3`` and
``ancestral_s0``; each row the median of the last 20% of the loss trace,
wall s and epochs/s, beside JAX's median from results/mcmc_scale.json (its
TPU times left out) and the difference.

On the card every window replays as a CUDA graph (vmc/graphs.py).  Each
case's warm losses must be finite before it is timed.  Rows carry, beyond
the JAX script's keys, ``finite``, the peak device memory and the memory
allocated before the row began (MiB), the K1 (sampler) and K3 (basis jet)
launches of the timed windows, and the device (on a card its name and
power limit, as nvidia-smi gives them).  Rows go to
``<out-dir>/mcmc_scale.json`` in the JAX file's layout; a row already there
is not run again; nothing is written under results/.

    python3 examples/mcmc_scale_torch.py
    python3 examples/mcmc_scale_torch.py --only quality
    python3 examples/mcmc_scale_torch.py --device cpu --batches 8 \\
        --window 2 --epochs 4 --out-dir runs/rehearsal    # CPU rehearsal
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

from batch_sweep_torch import (build, device_info, finite, release, timed)
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

JAX_ROWS = REPO / 'results' / 'mcmc_scale.json'
OUT_NAME = 'mcmc_scale.json'
PARTS = ('throughput', 'quality')
BATCHES = (256, 4096, 16384, 65536)
TARGET_ACCEPT = {'metropolis': 0.5, 'mala': 0.574}
QUALITY = (('metropolis', 1), ('metropolis', 3), ('metropolis', 10),
           ('mala', 1), ('mala', 3), ('ancestral', 0))
QUALITY_EPOCHS = 10_000
# a quality row whose median parts from JAX's by more than this is a finding
QUALITY_FINDING = 2e-3


def cases(batches=BATCHES):
    """The JAX script's throughput cases, (sampler, sweeps, batch), in its
    order."""
    out = [('metropolis', s, b) for s in (1, 3, 10) for b in batches]
    return out + [('mala', s, b) for s in (1, 3) for b in batches]


def window_of(batch: int) -> tuple:
    """(epochs per window, timed windows) of a batch, as the JAX script."""
    return (100, 3) if batch <= 4096 else (20, 2)


def throughput_row(sampler: str, sweeps: int, batch: int, window: int,
                   iters: int, device: str) -> dict:
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    trainer = build(batch, window, 'poly', device, sampler=sampler,
                    mcmc_sweeps=sweeps, mcmc_step_size=0.5,
                    mcmc_target_accept=TARGET_ACCEPT[sampler])
    res = timed(trainer, 2, iters, window)
    row = {'sampler': sampler, 'sweeps': sweeps, 'batch': batch,
           'window': window, 'timed_windows': iters,
           'finite': res['finite'], 'graph': bool(trainer.graph)}
    if res['dt'] is not None:
        row.update(epochs_per_sec=1.0 / res['dt'],
                   walkers_per_sec=batch / res['dt'],
                   launches=res['launches'])
    if cuda:
        # the process's peak, and what was allocated before the row began
        row['peak_memory_mib'] = torch.cuda.max_memory_allocated() / 2 ** 20
        row['start_memory_mib'] = start / 2 ** 20
    del trainer
    release(device)
    return row


def quality_row(sampler: str, sweeps: int, epochs: int, device: str,
                batch: int = 256, window: int = 100) -> dict:
    t0 = time.time()
    trainer = VMCTrainer(VMCConfig(
        system_name='He', box_length=10.0, batch_size=batch,
        learning_rate=1e-4, log_every=10 ** 9, window=window,
        sampler=sampler, mcmc_sweeps=max(sweeps, 1), seed=2, device=device))
    losses = np.asarray(trainer.train(num_epochs=epochs, verbose=False))
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
    wall = time.time() - t0
    tail = losses[-(len(losses) // 5):]
    row = {'median_last20pct': float(np.median(tail)), 'wall_s': wall,
           'epochs_per_sec': len(losses) / wall,
           'finite': finite(losses), 'epochs': len(losses)}
    del trainer
    release(device)
    return row


def jax_quality(key: str):
    """JAX's median for a quality row, its TPU times left out."""
    row = json.loads(JAX_ROWS.read_text())['quality_he1d_10k'].get(key)
    return None if row is None else {'median_last20pct':
                                     row['median_last20pct']}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', default=None,
                    help=f'run only the parts whose name starts with this '
                         f'({", ".join(PARTS)})')
    ap.add_argument('--out-dir', default='runs/mcmc_scale',
                    help=f'where {OUT_NAME} goes')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--batches', default=None,
                    help="comma list of throughput batches (default: the "
                         "JAX script's)")
    ap.add_argument('--window', type=int, default=None,
                    help='epochs per window of every case (default: the '
                         "JAX script's, by batch)")
    ap.add_argument('--iters', type=int, default=None,
                    help='timed windows of every case (default: by batch)')
    ap.add_argument('--epochs', type=int, default=QUALITY_EPOCHS,
                    help='training epochs of every quality row')
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            print("mcmc_scale_torch: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 1
        from waveflow_tpu_torch.ops import cuda_build
        cuda_build.build()
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / OUT_NAME
    out = json.loads(path.read_text()) if path.exists() else {}
    info = device_info(args.device)
    if 'card' in info:
        print(info['card'], flush=True)
    batches = (tuple(int(b) for b in args.batches.split(','))
               if args.batches else BATCHES)
    ok = True
    if args.only is None or 'throughput'.startswith(args.only):
        rows = out.setdefault('throughput', [])
        done = {(r['sampler'], r['sweeps'], r['batch']) for r in rows}
        for sampler, sweeps, batch in cases(batches):
            if (sampler, sweeps, batch) in done:
                continue
            window, iters = window_of(batch)
            row = {**throughput_row(sampler, sweeps, batch,
                                    args.window or window,
                                    args.iters or iters, args.device),
                   **info}
            rows.append(row)
            path.write_text(json.dumps(out, indent=2))
            print(json.dumps(row), flush=True)
        ok &= all(r['finite'] for r in rows)
    if args.only is None or 'quality'.startswith(args.only):
        qual = out.setdefault('quality_he1d_10k', {})
        for sampler, sweeps in QUALITY:
            key = f'{sampler}_s{sweeps}'
            if key in qual:
                continue
            row = quality_row(sampler, sweeps, args.epochs, args.device,
                              window=min(100, args.window or 100))
            ref = jax_quality(key)
            row['jax'] = ref
            if ref is not None:
                diff = row['median_last20pct'] - ref['median_last20pct']
                row['minus_jax'] = diff
                row['finding'] = bool(abs(diff) > QUALITY_FINDING)
            qual[key] = {**row, **info}
            path.write_text(json.dumps(out, indent=2))
            print(key, json.dumps(qual[key]), flush=True)
        ok &= all(r['finite'] for r in qual.values())
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
