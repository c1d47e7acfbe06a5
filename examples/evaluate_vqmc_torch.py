"""Evaluate a trained VMC run with the PyTorch/CUDA port: outlier-controlled
estimates from the loss trace, the exact oracle, and (--mcmc-eval) the
frozen-parameter blocked Metropolis energy (cf. examples/evaluate_vqmc.py).

Usage:
  python examples/evaluate_vqmc_torch.py --save-dir results/r5_flagship_fwd_batched_100k \
      --mcmc-eval --eval-backend poly_pallas
  python examples/evaluate_vqmc_torch.py --save-dir results/h_2d --system H \
      --n-space-dimension 2 --box-length 5 --ed-grid 120 --fidelity
  python examples/evaluate_vqmc_torch.py --save-dir results/r5_box2_2d_antisym \
      --system box2 --n-space-dimension 2 --box-length 5 --ansatz antisym \
      --no-interactions --mcmc-eval --eval-backend poly_pallas

--save-dir may hold a run of examples/run_vqmc_torch.py or of the JAX
package's examples/run_vqmc.py.  Oracles: 1D grid ED (or its Richardson
extrapolation); in 2D, the grid ED of one electron, the committed n_grid =
40 ED of two (results/ed40_<system>_2d2e.npz), or with --no-interactions
the analytic free-fermion energy.  --fidelity adds the overlap of ψ with
the ED state (2D: one electron, or the two-electron ED cache's ground
subspace).  The model runs on the card unless --device cpu.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from waveflow_tpu_torch.physics import (
    exact_free_fermion_energy, exact_free_fermion_energy_2d,
    exact_ground_state_1d, exact_ground_state_2d_1e,
    richardson_ground_energy_1d, system_catalogue)
from waveflow_tpu_torch.utils import (
    clipped_energy_estimate, median_energy_estimate, uniform_sliding_average,
    uniform_sliding_stdev)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--save-dir', required=True)
    p.add_argument('--system', default='He')
    p.add_argument('--n-space-dimension', type=int, default=1,
                   help='2 selects the 2D oracles: grid ED of one electron, '
                        'the committed ED40 cache of two, the analytic '
                        'free-fermion energy with --no-interactions')
    p.add_argument('--box-length', type=float, default=10.0)
    p.add_argument('--clip', type=float, default=100.0)
    p.add_argument('--tail-fraction', type=float, default=0.2)
    p.add_argument('--no-interactions', action='store_true',
                   help='compare against the analytic free-fermion energy '
                        '(protonless box systems, any n)')
    p.add_argument('--oracle', default='ed', choices=['ed', 'richardson'],
                   help="'ed': exact diagonalization on one grid (carries "
                        "O(h^2) over-binding); 'richardson': the two-grid "
                        "h^2 extrapolation (slower)")
    p.add_argument('--ed-grid', type=int, default=200,
                   help='grid points per side of the 2D one-electron ED')
    p.add_argument('--ed-cache', default=None,
                   help='2D two-electron ED cache (.npz with evals, psi, '
                        'sites, x); default results/ed40_<system>_2d2e.npz')
    p.add_argument('--mcmc-eval', action='store_true',
                   help='frozen-params blocked Metropolis estimate (runs the '
                        'model; pass the training hyperparameters)')
    p.add_argument('--fidelity', action='store_true',
                   help='|<psi|psi_ED>| on the ED grid (2D: one electron, '
                        'or two with the ED cache)')
    p.add_argument('--ansatz', default='sorted', choices=['sorted', 'antisym'],
                   help="the run's ansatz ('antisym' evaluates on "
                        "Metropolis walkers)")
    p.add_argument('--num-knots', type=int, default=23)
    p.add_argument('--spline-degree', type=int, default=6)
    p.add_argument('--n-flow-layers', type=int, default=3)
    p.add_argument('--eval-backend', default='poly',
                   choices=['poly', 'poly_pallas', 'table'])
    p.add_argument('--eval-batch', type=int, default=4096)
    p.add_argument('--eval-blocks', type=int, default=64)
    p.add_argument('--eval-sweeps-per-block', type=int, default=25)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    save_dir = Path(args.save_dir)
    trace = np.load(save_dir / 'loss.npy')
    # blocks of 100 epochs, fewer where the tail is shorter
    block = max(1, min(100, len(trace) - int(len(trace)
                                             * (1 - args.tail_fraction))))
    median, med_stderr = median_energy_estimate(
        trace, tail_fraction=args.tail_fraction, block_size=block)
    mean, stderr = clipped_energy_estimate(trace, clip=args.clip,
                                           tail_fraction=args.tail_fraction,
                                           block_size=block)
    info = save_dir / 'system_info.json'
    window = json.loads(info.read_text())['window'] if info.exists() else 100
    window = min(window, len(trace))
    sliding = uniform_sliding_average(trace, window)[-1]
    sliding_sd = uniform_sliding_stdev(trace, window)[-1]

    dim = args.n_space_dimension
    protons, n_el = system_catalogue[dim][args.system]
    ed_state = None
    if args.no_interactions:
        if np.asarray(protons).size:
            raise SystemExit('--no-interactions oracle requires a protonless '
                             'box system (box2/box3)')
        free = exact_free_fermion_energy_2d if dim == 2 \
            else exact_free_fermion_energy
        exact, oracle = free(n_el, args.box_length), 'free fermions, analytic'
    elif dim == 2 and n_el == 1:
        exact, psi_grid, x = exact_ground_state_2d_1e(
            np.asarray(protons), args.box_length, n_grid=args.ed_grid)
        ed_state = ('2d_1e', psi_grid, x)
        oracle = f'2D ED, {args.ed_grid}^2 grid'
    elif dim == 2 and n_el == 2:
        cache = Path(args.ed_cache or Path(__file__).resolve().parent.parent
                     / 'results' / f'ed40_{args.system}_2d2e.npz')
        if not cache.exists():
            raise SystemExit(f"no 2D two-electron ED cache at {cache}")
        ed = np.load(cache)
        exact = float(ed['evals'][0])
        ed_state = ('2d_2e', ed['psi'], ed['sites'], ed['x'])
        oracle = (f"2D ED, {len(ed['x'])}^2 grid ({cache.name}, "
                  f"{ed['psi'].shape[1]} state(s))")
    elif dim == 2:
        raise SystemExit('the 2D oracles cover one or two electrons, or '
                         'protonless box systems with --no-interactions')
    else:
        fn = (richardson_ground_energy_1d if args.oracle == 'richardson'
              else exact_ground_state_1d)
        try:
            exact = fn(np.asarray(protons), n_el, args.box_length)
        except NotImplementedError as e:
            raise SystemExit(
                f"{e}\nHint: for protonless box systems pass "
                "--no-interactions; for interacting n>3 systems no exact "
                "oracle exists.") from e
        oracle = ('ED, h^2 Richardson over two grids'
                  if args.oracle == 'richardson' else 'ED, one grid')

    n_sigma = abs(median - exact) / med_stderr if med_stderr > 0 else float('inf')
    print(f"epochs:             {len(trace)}")
    print(f"VMC energy (median): {median:.4f} +/- {med_stderr:.4f} "
          f"(last {args.tail_fraction:.0%})")
    print(f"clip-mean [biased on heavy tails]: {mean:.4f} +/- {stderr:.4f} "
          f"(clip ±{args.clip:g})")
    print(f"sliding mean over the last {window} epochs: {sliding:.4f} "
          f"(stdev {sliding_sd:.4f})")
    print(f"exact ({oracle}): {exact:.5f}")
    print(f"deviation (median): {median - exact:+.4f}  "
          f"(variational gap = {n_sigma:.1f}x stat. err)")

    if not (args.mcmc_eval or args.fidelity):
        return
    import evaluate_flagship_torch as ef
    from waveflow_tpu_torch.vmc import VMCConfig
    cfg = VMCConfig(system_name=args.system, n_space_dimension=dim,
                    box_length=args.box_length, num_knots=args.num_knots,
                    spline_degree=args.spline_degree,
                    n_flow_layers=args.n_flow_layers,
                    interactions=not args.no_interactions, ansatz=args.ansatz,
                    sampler='metropolis' if args.ansatz == 'antisym'
                    else 'ancestral',
                    eval_backend=args.eval_backend, device=args.device)
    try:
        trainer = ef.load_run(cfg, save_dir)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from e
    if args.fidelity:
        from waveflow_tpu_torch.utils import fidelity_2d_1e, fidelity_2d_2e
        if ed_state is None:
            raise SystemExit('--fidelity needs a 2D ED state (one electron, '
                             'or two with the ED cache)')
        kind, *state = ed_state
        fn = fidelity_2d_1e if kind == '2d_1e' else fidelity_2d_2e
        fid = fn(trainer.model.psi, *state, device=trainer.device)
        print(f"fidelity |<psi|psi_ED>| = {fid:.6f} ({oracle}; ED energy "
              f"{exact:.6f})")
    if args.mcmc_eval:
        ev, _, _ = ef.evaluate(trainer, n_blocks=args.eval_blocks,
                               sweeps_per_block=args.eval_sweeps_per_block,
                               batch_size=args.eval_batch)
        print("--- frozen-params MCMC evaluation (trace-independent) ---")
        print(f"<E_L>          = {ev.e_mean:.6f} +/- {ev.e_stderr:.6f} "
              f"({ev.n_samples} samples, {args.eval_blocks} blocks; block "
              f"doubling 2x {ev.e_stderr_2x:.6f}, 4x {ev.e_stderr_4x:.6f})")
        print(f"clipped <E_L>  = {ev.e_clipped:.6f} +/- "
              f"{ev.e_clipped_stderr:.6f}")
        print(f"median E_L     = {ev.e_median:.6f}")
        print(f"accept rate    = {ev.accept_rate:.3f}")
        print(f"deviation <E_L> - exact = {ev.e_mean - exact:+.6f}")


if __name__ == '__main__':
    main()
