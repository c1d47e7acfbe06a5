"""Round-4 quality studies on the PyTorch/CUDA port (cf.
benchmarks/round4_quality.py): the JAX script's four stages, job for job.

Stages (``--only PREFIX`` runs the stages whose name starts with it,
``--keys`` a comma list of rows, so that a stage can be split across
calls):

  spring — the He-1d flagship on SPRING (lr 0.05, momentum 0.9, the 0.3
      trust region) for 30,000 and 100,000 epochs, and 2,000 epochs at
      batch 4,096.  Done criterion of the JAX script: a frozen-parameter
      clipped energy at or below SPRING_DONE with zero skipped solves from
      a cold start.
  li — Li-1d at lr 3e-4 with a decay (40,000 epochs, then a second trainer
      at lr 3e-5 resumes from the first run's checkpoint for 20,000), the
      big ansatz (31 knots, 4 layers) at lr 3e-4, SPRING on both ansatze.
  he2d2e — He in 2D (two electrons, L = 5) at lr 3e-4 with the decay, on
      both ansatze, and on SPRING.
  sweeps — Metropolis walkers at 1 against 3 sweeps per epoch, lr 3e-4,
      20,000 epochs, on H2_wide (L = 12), Li and He in 2D.

Each row is trained as the JAX script's ``run_vmc`` trains it
(round5_quality_torch.run_vmc: ``train(epochs)``, the decay's second
trainer, then ``evaluate_trainer(n_blocks=64, sweeps_per_block=25,
n_warmup_sweeps=250)`` at max(4,096, batch) walkers) and printed as one
JSON line: the JAX script's fields (SPRING's skipped solves and fallbacks
among them), JAX's row from results/round4_quality.json beside them
(without its TPU times), ``trace_chunks`` (the loss trace's 10,000-epoch
medians, its last 2,000's and its last fifth's, beside JAX's committed
results/r4_<key>/loss.npy where there is one), ``--eval-seeds`` /
``--tail-k``'s evaluations as round5_quality_torch.py makes them, the
oracle and both deviations, the combined σ of
the raw and of the clipped means, the gate and its verdict, the K1
(sampler) and K3 (basis jet) launches, and the device (on a card its name
and power limit, as nvidia-smi gives them).

Gate (``gate``), every row: ``deviation``, |dev − dev_jax| <= max(2
|dev_jax|, 3e-3), dev the clipped energy less the oracle (the same oracle
for both packages, ``oracle_of``); the SPRING rows of the spring stage also
``done``, the JAX script's criterion.  Rows go to
``<out-dir>/round4_quality.json`` and checkpoints to ``<out-dir>/r4q_<key>``;
a row already there is skipped on a rerun.  Nothing is written under
results/.

  python3 examples/round4_quality_torch.py --only spring
  python3 examples/round4_quality_torch.py --keys li_spring_20k,sweeps_Li_s1
  python3 examples/round4_quality_torch.py --keys spring100k \\
      --eval-seeds 7,8,9 --tail-k 32   # a saved row again, no training
  python3 examples/round4_quality_torch.py --device cpu --epochs 4 \\
      --decay-epochs 2 --tiny-eval --keys li_lr3e-4_decay \\
      --out-dir runs/rehearsal          # a CPU rehearsal, not gated
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'examples'))

import torch

import catalogue_sweep_torch
import evaluate_flagship_torch as ef
import round5_quality_torch as r5

JAX_ROWS = REPO / 'results' / 'round4_quality.json'
OUT_NAME = 'round4_quality.json'
ORACLE_2D = REPO / 'results' / 'oracle_2d_2e.json'

SPRING = dict(optimizer='spring', learning_rate=0.05, spring_momentum=0.9,
              sr_max_update_norm=0.3)
FLAG = dict(system_name='He', box_length=10.0, batch_size=256, window=100,
            seed=2)
# the JAX script's done criterion of the SPRING flagship rows
SPRING_DONE = -1.8157
SPRING_DONE_KEYS = ('spring30k', 'spring100k', 'spring4k_2k')
# JAX's row fields that are TPU figures
TPU_FIELDS = ('epochs_per_sec', 'wall_s')
STAGES = ('spring', 'li', 'he2d2e', 'sweeps')


def plan():
    """Every job of the four stages, in the order they run, with the
    JAX script's configs."""
    Job = r5.Job
    jobs = [Job('spring', 'spring30k', 30_000, {**FLAG, **SPRING}),
            Job('spring', 'spring100k', 100_000, {**FLAG, **SPRING}),
            Job('spring', 'spring4k_2k', 2_000,
                {**FLAG, 'batch_size': 4096, **SPRING})]
    li = dict(system_name='Li', box_length=10.0, batch_size=256, window=100,
              seed=2)
    big = dict(num_knots=31, n_flow_layers=4)
    jobs += [Job('li', 'li_lr3e-4_decay', 40_000,
                 dict(learning_rate=3e-4, **li), decay=(20_000, 3e-5)),
             Job('li', 'li_big_lr3e-4', 40_000,
                 dict(learning_rate=3e-4, **big, **li)),
             Job('li', 'li_spring_20k', 20_000, {**li, **SPRING}),
             Job('li', 'li_big_spring_20k', 20_000, {**big, **li, **SPRING})]
    he = dict(system_name='He', n_space_dimension=2, box_length=5.0,
              batch_size=256, window=100, seed=2)
    jobs += [Job('he2d2e', 'he2d2e_lr3e-4_decay', 40_000,
                 dict(learning_rate=3e-4, **he), decay=(20_000, 3e-5)),
             Job('he2d2e', 'he2d2e_big_lr3e-4_decay', 40_000,
                 dict(learning_rate=3e-4, **big, **he),
                 decay=(20_000, 3e-5)),
             Job('he2d2e', 'he2d2e_spring_20k', 20_000, {**he, **SPRING})]
    for name, L, n_dim in (('H2_wide', 12.0, 1), ('Li', 10.0, 1),
                           ('He', 5.0, 2)):
        base = dict(system_name=name, n_space_dimension=n_dim, box_length=L,
                    batch_size=256, window=100, seed=2,
                    sampler='metropolis', learning_rate=3e-4)
        for sweeps in (1, 3):
            jobs.append(Job('sweeps', f'sweeps_{name}_s{sweeps}', 20_000,
                            dict(mcmc_sweeps=sweeps, **base)))
    return jobs


def oracle_of(cfg: dict) -> float:
    """The oracle of a job's system, the same for both packages: He-1d and
    Li the JAX flagship script's Richardson figures
    (evaluate_flagship_torch.EXACT), H2_wide the catalogue sweep's
    Richardson ED, He in 2D results/oracle_2d_2e.json's Richardson 32 → 40
    figure."""
    name = cfg['system_name']
    if cfg.get('n_space_dimension', 1) == 2:
        rows = json.loads(ORACLE_2D.read_text())
        return float(rows[f"{name}_2d_L{cfg['box_length']:g}"]
                     ['richardson_32_40'])
    if name in ef.EXACT and cfg['box_length'] == 10.0:
        return ef.EXACT[name]
    return catalogue_sweep_torch.oracle(1, name, cfg['box_length'], {})[0]


def jax_row(key: str):
    """JAX's committed row for ``key``, its TPU times left out, or None."""
    row = json.loads(JAX_ROWS.read_text()).get(key)
    return None if row is None else {k: v for k, v in row.items()
                                     if k not in TPU_FIELDS}


def gate(key: str, row: dict, ref: dict | None):
    """The row's checks and its verdict; None without a JAX row.

      finite     every loss and evaluation figure finite;
      deviation  |dev − dev_jax| <= max(2 |dev_jax|, 3e-3) on the clipped
                 energy;
      done       (SPRING_DONE_KEYS) clipped <= SPRING_DONE and no skipped
                 solve."""
    if ref is None:
        return None
    checks = {'finite': bool(row.get('finite'))}
    dev, dev_jax = row['deviation_eval'], row['deviation_eval_jax']
    margin = max(2.0 * abs(dev_jax), 3e-3)
    checks['deviation'] = dict(limits=[dev_jax - margin, dev_jax + margin],
                               ok=bool(abs(dev - dev_jax) <= margin))
    if key in SPRING_DONE_KEYS:
        checks['done'] = dict(
            most=SPRING_DONE, skipped=row.get('spring_skipped'),
            ok=bool(row['eval_clipped'] <= SPRING_DONE
                    and row.get('spring_skipped') == 0))
    ok = all(v if isinstance(v, bool) else v['ok'] for v in checks.values())
    return dict(checks=checks, in_gate=ok)


class Run(r5.Run):
    out_name = OUT_NAME
    prefix = 'r4q_'


def run_job(job, run: Run) -> dict:
    """Train, evaluate and gate one job; the row, kept and printed."""
    key = run.key(job)
    row, trainer = r5.run_vmc(job, run, need_trainer=r5.wants_trainer(run))
    if trainer is not None:
        r5.evaluate_seeds(job, row, trainer, run)
    row['trace_chunks'] = r5.trace_chunks(
        run.config(job, key).save_dir, key,
        jax_dir=JAX_ROWS.parent / f'r4_{key}')
    exact = oracle_of(job.cfg)
    ref = jax_row(key)
    row['exact'] = exact
    row['deviation_eval'] = row['eval_clipped'] - exact
    row['jax'] = ref
    if ref is not None:
        row['deviation_eval_jax'] = ref['eval_clipped'] - exact
        row['sigma_raw'] = r5.combined_sigma(
            row['eval_mean'], row['eval_stderr'], ref['eval_mean'],
            ref['eval_stderr'])
        row['sigma_clipped'] = r5.combined_sigma(
            row['eval_clipped'], row['eval_clipped_stderr'],
            ref['eval_clipped'], ref['eval_clipped_stderr'])
    a = run.args
    rehearsal = (a.epochs is not None or a.decay_epochs is not None
                 or a.tiny_eval)
    row['gate'] = (dict(rehearsal=True, in_gate=None) if rehearsal
                   else gate(key, row, ref))
    row.update(run.info)
    run.out[key] = row
    run.save()
    print(json.dumps({'key': key, **row}), flush=True)
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', default=None,
                    help='run only stages whose name starts with this')
    ap.add_argument('--keys', default=None,
                    help='comma list of rows to run (default: every row of '
                         'the chosen stages)')
    ap.add_argument('--out-dir', default='runs/round4_quality',
                    help=f'where {OUT_NAME} and the checkpoints go')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--epochs', type=int, default=None,
                    help='training epochs of every row (a rehearsal; not '
                         'gated)')
    ap.add_argument('--decay-epochs', type=int, default=None,
                    help='epochs of every decay (a rehearsal; not gated)')
    ap.add_argument('--tiny-eval', action='store_true',
                    help='a rehearsal\'s evaluation: '
                         'evaluate_flagship_torch.TINY_EVAL (not gated)')
    ap.add_argument('--eval-seeds', default=None,
                    type=lambda v: [int(s) for s in v.split(',')],
                    help='evaluate the weights again at each of these '
                         'evaluation seeds, from the saved checkpoint when '
                         'the row is already there (no training)')
    ap.add_argument('--tail-k', type=int, default=0,
                    help='after each such evaluation the tail pass keeps '
                         'the K largest local energies of its chain '
                         '(vmc/evaluate.py::record_tail; 0: no pass)')
    ap.set_defaults(seed=None, init_from=None)
    return ap, ap.parse_args(argv)


def main(argv=None) -> int:
    ap, args = parse_args(argv)
    keys = None if args.keys is None else args.keys.split(',')
    jobs = plan()
    if args.tiny_eval:
        tiny = ef.TINY_EVAL
        jobs = [dataclasses.replace(j, eval_blocks=tiny['n_blocks'],
                                    eval_batch=tiny['batch_size'])
                for j in jobs]
        r5.EVAL_KW.update(sweeps_per_block=tiny['sweeps_per_block'],
                          n_warmup_sweeps=tiny['n_warmup_sweeps'])
    if keys is not None:
        unknown = sorted(set(keys) - {j.key for j in jobs})
        if unknown:
            ap.error(f"not in the plan: {unknown}")
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            print("round4_quality_torch: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 1
        from waveflow_tpu_torch.ops import cuda_build
        cuda_build.build()
    run = Run(args)
    if 'card' in run.info:
        print(run.info['card'], flush=True)
    for stage in STAGES:
        if args.only is not None and not stage.startswith(args.only):
            continue
        todo = [j for j in jobs
                if j.stage == stage and (keys is None or j.key in keys)]
        if todo:
            print(f"=== stage {stage} ===", flush=True)
        for job in todo:
            if run.key(job) in run.out and not r5.wants_trainer(run):
                continue
            run_job(job, run)
    rows = [run.out[j.key] for j in jobs if j.key in run.out]
    verdicts = [r['gate']['in_gate'] for r in rows if r.get('gate')]
    print(f"round4_quality_torch: {sum(v is True for v in verdicts)} of "
          f"{len(verdicts)} gated rows in gate", flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
