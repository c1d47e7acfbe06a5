"""Batch scaling of VMC training on the PyTorch/CUDA port (cf.
benchmarks/batch_sweep.py): walkers/s against batch on one card, He-1d
flagship configuration.

The JAX script's jobs, one for one: batches 256, 1,024, 4,096, 16,384 and
65,536 with 5 / 5 / 3 / 2 / 1 timed windows of 100 epochs after one warm
window; the flagship model (3 × IMADE, degree-6 splines, 23 knots, L = 10)
at initial parameters from seed 0, ancestral walkers, 'fwd_batched',
'clipped_score', adam at lr 1e-4 with no norm clip (the JAX script's
``optax.flatten(optax.adam(1e-4))``).  Each batch runs under both eval
backends: 'poly' (the plain basis jet, JAX's default and what its script
ran) and 'poly_pallas' (the CUDA basis-jet kernel, K3).  On the card every
window replays as a CUDA graph (vmc/graphs.py), timed as bench_torch.py's
``time_windows`` times it (the warm window holds the capture).

The warm window's losses must be finite before a batch is timed, and the
timed windows' too.  One JSON row per (backend, batch): JAX's keys
(``batch``, ``walkers_per_sec``, ``epochs_per_sec``) and ``backend``,
``finite``, the peak device memory and the memory allocated before the
row began (MiB), the K1 (sampler) and K3 (basis jet) launches of the
timed windows and per epoch, and the device (on a card its name and power
limit, as nvidia-smi gives them).  The rows go to
``--out`` (default runs/batch_sweep_torch.json); a row already there is
not run again.  Nothing is written under results/, and results/
batch_sweep.json (TPU figures) is not read.

    python3 examples/batch_sweep_torch.py
    python3 examples/batch_sweep_torch.py --backends poly_pallas --batches 4096
    python3 examples/batch_sweep_torch.py --device cpu --batches 8 \\
        --window 2 --iters 1 --out runs/rehearsal.json     # CPU rehearsal
"""

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'examples'))

import torch

from round5_quality_torch import _launches as launches
from round5_quality_torch import _zero_launches as zero_launches
from round5_quality_torch import device_info
from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer

# (batch, timed windows): the JAX script's
BATCHES = ((256, 5), (1024, 5), (4096, 3), (16384, 2), (65536, 1))
WINDOW = 100
BACKENDS = ('poly', 'poly_pallas')
SEED = 0


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def config(batch: int, window: int, eval_backend: str, **overrides) -> dict:
    """The JAX script's trainer's VMCConfig fields: the flagship model at
    seed 0, adam 1e-4 without a norm clip; ``overrides`` set others."""
    return dict(dict(batch_size=batch, window=window, log_every=10 ** 9,
                     eval_backend=eval_backend, grad_clip=None, seed=SEED),
                **overrides)


def build(batch: int, window: int, eval_backend: str, device: str,
          graph=None, **overrides) -> VMCTrainer:
    """A trainer of ``config``'s fields on ``device``; ``graph`` as in
    ``VMCTrainer``."""
    return VMCTrainer(VMCConfig(device=device, **config(
        batch, window, eval_backend, **overrides)), graph=graph)


def finite(losses) -> bool:
    return all(math.isfinite(float(v)) for v in losses)


def timed(trainer: VMCTrainer, windows_first: int, windows: int,
          epochs: int) -> dict:
    """``windows_first`` warm windows, their losses checked finite, then
    ``windows`` timed ones of ``epochs`` epochs (the device synchronised
    on both sides).  Returns the seconds per epoch, whether every loss was
    finite, and the timed windows' launches."""
    dev = trainer.device
    warm = []
    for _ in range(windows_first):
        warm += list(trainer.train(num_epochs=epochs, verbose=False)[-epochs:])
    if not finite(warm):
        return {'finite': False, 'dt': None, 'launches': launches()}
    sync(dev)
    zero_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(windows):
        losses += list(trainer.train(num_epochs=epochs,
                                     verbose=False)[-epochs:])
    sync(dev)
    dt = (time.perf_counter() - t0) / (windows * epochs)
    return {'finite': finite(losses), 'dt': dt, 'launches': launches()}


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def sweep_row(backend: str, batch: int, iters: int, window: int,
              device: str) -> dict:
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    trainer = build(batch, window, backend, device)
    res = timed(trainer, 1, iters, window)
    row = {'backend': backend, 'batch': batch, 'window': window,
           'timed_windows': iters, 'finite': res['finite']}
    if res['dt'] is not None:
        epochs = iters * window
        row.update(walkers_per_sec=batch / res['dt'],
                   epochs_per_sec=1.0 / res['dt'],
                   launches=res['launches'],
                   launches_per_epoch={k: v / epochs for k, v
                                       in res['launches'].items()})
    row['graph'] = bool(trainer.graph)
    if cuda:
        # the process's peak, and what was allocated before the row began
        row['peak_memory_mib'] = torch.cuda.max_memory_allocated() / 2 ** 20
        row['start_memory_mib'] = start / 2 ** 20
    del trainer
    release(device)
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--backends', default=','.join(BACKENDS),
                    help="comma list of eval backends (default: both)")
    ap.add_argument('--batches', default=None,
                    help='comma list of batches (default: the JAX '
                         "script's; a batch not in it times one window)")
    ap.add_argument('--window', type=int, default=WINDOW)
    ap.add_argument('--iters', type=int, default=None,
                    help='timed windows of every batch (default: the JAX '
                         "script's count per batch)")
    ap.add_argument('--out', default='runs/batch_sweep_torch.json')
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            print("batch_sweep_torch: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 1
        from waveflow_tpu_torch.ops import cuda_build
        cuda_build.build()
    counts = dict(BATCHES)
    batches = ([int(b) for b in args.batches.split(',')] if args.batches
               else [b for b, _ in BATCHES])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = json.loads(out.read_text()) if out.exists() else []
    done = {(r['backend'], r['batch']) for r in rows}
    info = device_info(args.device)
    if 'card' in info:
        print(info['card'], flush=True)
    for backend in args.backends.split(','):
        for batch in batches:
            if (backend, batch) in done:
                continue
            iters = args.iters or counts.get(batch, 1)
            t0 = time.time()
            row = {**sweep_row(backend, batch, iters, args.window,
                               args.device), **info}
            rows.append(row)
            out.write_text(json.dumps(rows, indent=2))
            print(json.dumps(row) + f"  (total {time.time() - t0:.0f}s)",
                  flush=True)
    return 0 if all(r['finite'] for r in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
