"""2D density-estimation benchmark on the PyTorch/CUDA port
(cf. examples/run_benchmark.py).

Usage:
  python examples/run_benchmark_torch.py --dataset circles --model MFlow \
      --num-epochs 30000 [--eager]

On the card each epoch is a replayed CUDA graph, as the JAX example jits
its blocks of epochs; --eager runs it op by op.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveflow_tpu_torch.benchmark import get_dataset, train_density_model


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--dataset', default='circles',
                   choices=['halfmoon', 'circles', 'double_circles',
                            'gaussian_mixtures'])
    p.add_argument('--model', default='MFlow',
                   choices=['Flow', 'IFlow', 'MFlow', 'RQSFlow'])
    p.add_argument('--n-samples', type=int, default=20_000,
                   help='training-set size (reference example uses 20k)')
    p.add_argument('--num-epochs', type=int, default=30_000)
    p.add_argument('--learning-rate', type=float, default=1e-4)
    p.add_argument('--spline-reg', type=float, default=0.02)
    p.add_argument('--spline-degree', type=int, default=5)
    p.add_argument('--n-knots', type=int, default=23)
    p.add_argument('--n-flow-layers', type=int, default=3)
    p.add_argument('--log-every', type=int, default=2000)
    p.add_argument('--n-model-sample', type=int, default=20_000,
                   help='samples drawn for the KDE metrics '
                        '(reference example uses 20k)')
    p.add_argument('--save-dir', default=None)
    p.add_argument('--eager', action='store_true',
                   help='run each epoch op by op, not as a replayed CUDA '
                        'graph')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args()

    X = get_dataset(args.dataset, n_samples=args.n_samples)
    save_dir = args.save_dir or (
        f"./results/benchmarks/{args.dataset}/"
        f"{args.model}_{args.spline_reg}_{args.n_flow_layers}"
        f"_{args.spline_degree}_{args.n_knots}_torch")
    train_density_model(X, model_name=args.model,
                        num_epochs=args.num_epochs,
                        learning_rate=args.learning_rate,
                        spline_reg=args.spline_reg,
                        n_flow_layers=args.n_flow_layers,
                        spline_degree=args.spline_degree,
                        n_knots=args.n_knots, log_every=args.log_every,
                        n_model_sample=args.n_model_sample,
                        save_dir=save_dir, device=args.device,
                        graph=False if args.eager else None)


if __name__ == '__main__':
    main()
