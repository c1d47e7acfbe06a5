"""Benchmark of the PyTorch/CUDA port: VMC walker throughput on the He-1d
L=10 flagship config (the counterpart of bench.py, which stays the JAX
package's).

    python3 bench_torch.py                 # on the card
    python3 bench_torch.py --eager         # every window eager (the A/B)
    python3 bench_torch.py --device cpu --batch-size 8 --window 2 \
        --n-windows 1 --n-ref-windows 1

Prints ONE JSON line with bench.py's fields: {"metric", "value", "unit",
"vs_baseline"}.  value = walkers/s at batch 256 with
``eval_backend='poly_pallas'`` (the CUDA basis-jet kernel), timed over 5
windows of 100 epochs after one warmup window, as bench.py's time_windows
does; unit names the device.  On the card every window of both designs
is a replayed CUDA graph of one epoch (vmc/graphs.py); ``--eager`` runs
them op by op instead, for the graph-against-eager A/B in one call.

vs_baseline = dt(reference design) / dt(main path), both timed in this
call on the same device: the reference design is bench.py's fallback
baseline, the reference's algorithm (``laplacian_mode='dense'``, the
full-Hessian trace, and ``estimator='reference'``, the custom-derivative
local energy with its running baseline) on the same model, backend and
windows, timed over 3 windows after one warmup window.  vs_baseline > 1
means the main path is faster.  bench.py's first choice,
results/reference_anchor.json, is a figure taken on a TPU and no
baseline for this card; it is not read.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer


def build(batch_size=256, window=100, eval_backend='poly_pallas',
          device='cuda', laplacian_mode='fwd_batched',
          estimator='clipped_score', graph=None):
    """The flagship trainer (VMCConfig's defaults: He, L=10, 3 × IMADE,
    degree-6 splines with 23 knots, adam 1e-4 after a clip of 10);
    ``laplacian_mode='dense', estimator='reference'`` is the reference
    design; ``graph`` as in ``VMCTrainer``."""
    return VMCTrainer(VMCConfig(batch_size=batch_size, window=window,
                                eval_backend=eval_backend,
                                laplacian_mode=laplacian_mode,
                                estimator=estimator, device=device),
                      graph=graph)


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def time_windows(trainer, n_iters=5):
    """Seconds per epoch over ``n_iters`` windows after one warmup window,
    and the last loss."""
    c = trainer.config
    trainer.train(c.window, verbose=False)          # first calls + warmup
    _sync(trainer.device)
    t0 = time.perf_counter()
    losses = trainer.train(n_iters * c.window, verbose=False)
    _sync(trainer.device)
    return (time.perf_counter() - t0) / (n_iters * c.window), losses[-1]


def device_name(device) -> str:
    if torch.device(device).type != 'cuda':
        return 'cpu'
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ''
    return line or torch.cuda.get_device_name(device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--window', type=int, default=100)
    p.add_argument('--n-windows', type=int, default=5)
    p.add_argument('--n-ref-windows', type=int, default=3,
                   help="timed windows of the reference design")
    p.add_argument('--eager', action='store_true',
                   help="run every window op by op, not as a CUDA graph")
    args = p.parse_args(argv)
    graph = False if args.eager else None
    trainer = build(args.batch_size, args.window, device=args.device,
                    graph=graph)
    dt, _ = time_windows(trainer, args.n_windows)
    reference = build(args.batch_size, args.window, device=args.device,
                      laplacian_mode='dense', estimator='reference',
                      graph=graph)
    dt_ref, _ = time_windows(reference, args.n_ref_windows)
    print(json.dumps({
        "metric": "vmc_walker_steps_per_sec",
        "value": round(args.batch_size / dt, 1),
        "unit": (f"walkers/s (He-1d L=10, batch {args.batch_size}, "
                 "sample+train epoch, eval_backend poly_pallas, "
                 f"{'CUDA graph' if trainer.graph else 'eager'} windows; "
                 f"{device_name(trainer.device)})"),
        "vs_baseline": round(dt_ref / dt, 3),
    }))


if __name__ == '__main__':
    main()
