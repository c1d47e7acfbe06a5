"""The RQS benchmark row on the PyTorch/CUDA port (cf. benchmarks/rqs_row.py).

Trains 'RQSFlow' (3 × (NeuralSplineCoupling + Reverse) over Normal(-0.5))
on the circles split of benchmarks/circles_parity.py — ``get_dataset(
'circles', 3000, seed=42)``, the first 1,000 points to train and the last
2,000 held out — at lr 1e-4, one run per seed, and prints one JSON line
per run: the last training loss, the held-out mean log-likelihood (last
and best checkpoint, and at each metric checkpoint), KDE-KL and Hellinger² of 20,000 model draws
(bandwidth 0.01), the round trip's reconstruction distance, wall seconds
and training points per second.  ``--dataset`` / ``--model`` and the
spline options train another model of the zoo on the same kind of split
(the ``gaussian_mixtures`` MFlow: ``--dataset gaussian_mixtures --model
MFlow --spline-reg 0.05 --n-knots 15``).  Writes only to ``--out`` if given.

  python examples/rqs_row_torch.py --epochs 12000 --seeds 5,7,9
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from waveflow_tpu_torch.benchmark import (
    get_dataset, held_out_log_likelihood, kde_metrics, train_density_model)


def split(dataset: str, n_train: int = 1000, n_test: int = 2000):
    X = get_dataset(dataset, n_samples=n_train + n_test, margin=0.025,
                    seed=42)
    return X[:n_train], X[n_train:]


def run(X, X_test, args, seed: int) -> dict:
    t0 = time.perf_counter()
    model, hist = train_density_model(
        X, model_name=args.model, num_epochs=args.epochs,
        learning_rate=1e-4, spline_reg=args.spline_reg, n_flow_layers=3,
        spline_degree=args.spline_degree, n_knots=args.n_knots,
        log_every=max(2000, args.epochs // 4), seed=seed, X_test=X_test,
        verbose=False, device=args.device)
    if args.device == 'cuda':
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    samples = model.sample(20_000, generator=torch.Generator(
        args.device).manual_seed(9))
    kl, hell = kde_metrics(model, samples)
    return {'model': args.model, 'dataset': args.dataset,
            'epochs': args.epochs, 'seed': seed,
            'train_loss': hist['losses'][-1],
            'test_ll': held_out_log_likelihood(model, X_test),
            'test_ll_best': max(hist['test_ll']),
            'test_ll_hist': [float(v) for v in hist['test_ll']],
            'kde_kl': kl, 'kde_hellinger2': hell,
            'reconstruction': hist['reconstruction'][-1],
            'wall_s': time.perf_counter() - t0,
            'points_per_s': args.epochs * len(X) / train_s}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--epochs', type=int, default=12_000)
    p.add_argument('--seeds', default='5,7,9')
    p.add_argument('--dataset', default='circles')
    p.add_argument('--model', default='RQSFlow')
    p.add_argument('--spline-reg', type=float, default=0.02)
    p.add_argument('--spline-degree', type=int, default=5)
    p.add_argument('--n-knots', type=int, default=23)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    p.add_argument('--out', default=None,
                   help='also write the rows, as one JSON object, here')
    args = p.parse_args(argv)
    X, X_test = split(args.dataset)
    rows = {}
    for seed in (int(s) for s in args.seeds.split(',')):
        rows[f'{args.model}_{args.dataset}_{args.epochs}_seed{seed}'] = row \
            = run(X, X_test, args, seed)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == '__main__':
    main()
