"""VMC training on the PyTorch/CUDA port (cf. examples/run_vqmc.py).

Usage:
  python examples/run_vqmc_torch.py --system He --box-length 10 \
      --batch-size 256 --num-epochs 100000 --eval-backend poly_pallas
  python examples/run_vqmc_torch.py ... --restart       # resume --save-dir
  python examples/run_vqmc_torch.py ... --sampler mala --optimizer spring \
      --learning-rate 0.05 --spring-momentum 0.9
  python examples/run_vqmc_torch.py ... --estimator reference  # with baseline
  python examples/run_vqmc_torch.py --system He --n-space-dimension 2 \
      --box-length 5 --ansatz antisym --sampler metropolis \
      --learning-rate 3e-4                            # 2D, antisymmetrized
  torchrun --nproc-per-node 4 examples/run_vqmc_torch.py --data-parallel
      # the walker batch over 4 devices, one process each (alone: a world
      # of one process, every collective in the path)

Checkpoints go to --save-dir (default: the JAX package's
./results/<system>_<d>d_L<box>box) every --log-every epochs and at the end;
--restart resumes from it, from a checkpoint of this script or of the JAX
package's examples/run_vqmc.py (a JAX run continues on a fresh torch random
stream).  Runs on the card unless --device cpu.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--system', default='He')
    p.add_argument('--n-space-dimension', type=int, default=1,
                   help='2 trains systems in the 2D box (one electron: the '
                        "'independent' coordinate map; several: the "
                        "'paired2d' x-sorted sector, or --ansatz antisym)")
    p.add_argument('--box-length', type=float, default=10.0)
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--num-epochs', type=int, default=100_000)
    p.add_argument('--window', type=int, default=100,
                   help='epochs per window (the loss trace is read and '
                        'checked once per window)')
    p.add_argument('--learning-rate', type=float, default=1e-4)
    p.add_argument('--spline-degree', type=int, default=6)
    p.add_argument('--num-knots', type=int, default=23)
    p.add_argument('--n-flow-layers', type=int, default=3)
    p.add_argument('--log-every', type=int, default=2000)
    p.add_argument('--save-dir', default=None)
    p.add_argument('--restart', action='store_true')
    p.add_argument('--seed', type=int, default=2)
    p.add_argument('--estimator', default='clipped_score',
                   choices=['clipped_score', 'reference'])
    p.add_argument('--eval-backend', default='poly',
                   choices=['poly', 'poly_pallas', 'table'],
                   help="'poly' (plain PyTorch basis jet), 'poly_pallas' "
                        "(the CUDA basis-jet kernel) or 'table' (the table "
                        "lerp, the table-eval kernel on the card)")
    p.add_argument('--ansatz', default='sorted',
                   choices=['sorted', 'antisym'],
                   help="'antisym' = the signed sum over electron "
                        "permutations of a square-flow on the 'independent' "
                        "map (a learned nodal surface; needs --sampler "
                        "metropolis or mala)")
    p.add_argument('--sampler', default='ancestral',
                   choices=['ancestral', 'metropolis', 'mala'],
                   help='walker source: exact ancestral draws from |psi|^2, '
                        'or persistent Metropolis or MALA (Langevin) walkers')
    p.add_argument('--optimizer', default='adam',
                   choices=['adam', 'sr', 'spring'],
                   help="'sr' = stochastic reconfiguration by CG; 'spring' = "
                        "min-SR / SPRING (sample-space solve + momentum); "
                        "natural-gradient learning rates are typically "
                        "1e-2..1e-1")
    p.add_argument('--mcmc-sweeps', type=int, default=3,
                   help='Metropolis / MALA sweeps between parameter updates')
    p.add_argument('--spring-momentum', type=float, default=0.9,
                   help="momentum for --optimizer spring (SPRING's mu)")
    p.add_argument('--sr-max-update-norm', type=float, default=0.3,
                   help='trust region for sr / spring: cap ||lr*delta||_2 '
                        '(0 disables)')
    p.add_argument('--mcmc-refresh-every', type=int, default=-1,
                   help='refresh the Metropolis walkers with exact ancestral '
                        'draws every N epochs; -1 = auto (once per window '
                        'for >= 3 electrons), 0 disables')
    p.add_argument('--no-interactions', action='store_true')
    p.add_argument('--data-parallel', action='store_true',
                   help='shard the walker batch over the ranks of the '
                        'process group (torchrun; alone, a world of one)')
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    cfg = VMCConfig(system_name=args.system,
                    n_space_dimension=args.n_space_dimension,
                    box_length=args.box_length, ansatz=args.ansatz,
                    batch_size=args.batch_size, num_epochs=args.num_epochs,
                    window=args.window, learning_rate=args.learning_rate,
                    spline_degree=args.spline_degree, num_knots=args.num_knots,
                    n_flow_layers=args.n_flow_layers,
                    log_every=args.log_every, save_dir=args.save_dir,
                    seed=args.seed, estimator=args.estimator,
                    eval_backend=args.eval_backend, sampler=args.sampler,
                    optimizer=args.optimizer,
                    spring_momentum=args.spring_momentum,
                    sr_max_update_norm=args.sr_max_update_norm or None,
                    mcmc_sweeps=args.mcmc_sweeps,
                    mcmc_refresh_every=('auto' if args.mcmc_refresh_every < 0
                                        else (args.mcmc_refresh_every or None)),
                    interactions=not args.no_interactions,
                    data_parallel=args.data_parallel, device=args.device)
    cfg.save_dir = cfg.resolved_save_dir()
    trainer = VMCTrainer(cfg)
    trainer.train(restart=args.restart)


if __name__ == '__main__':
    main()
