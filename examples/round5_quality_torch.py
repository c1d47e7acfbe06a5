"""Round-5 quality studies on the PyTorch/CUDA port (cf.
benchmarks/round5_quality.py): the JAX script's five stages, job for job,
and the flagship 100k from scratch.

Stages (``--only PREFIX`` runs the stages whose name starts with it,
``--keys`` a comma list of rows, so that a stage can be split across
calls):

  flagship — ``flagship_fwd_batched_100k``: the He-1d flagship,
      ``VMCConfig(system_name='He', box_length=10.0, batch_size=256,
      window=100, seed=2)`` with every other field at its default, 100,000
      epochs (the recipe of results/r5_flagship_fwd_batched_100k).  Gate:
      the clipped energy in the converged band [−1.81600, −1.81570] of
      results/flagship_fwdbatched_100k.log.
  antisym — He and H2 in 2D, two electrons, the antisymmetrized ansatz on
      Metropolis walkers: 40,000 epochs at lr 3e-4, then a second trainer
      at lr 3e-5 resumes from the first run's checkpoint for 20,000 more.
      Fidelity against the 40-point ED (results/ed40_{He,H2}_2d2e.npz, read
      only; He's doubly degenerate ground subspace; computed into
      ``--out-dir`` where a file is absent).
  li_refresh — Li-1d on Metropolis walkers, 3 or 1 sweeps, an exact
      ancestral refresh every 1,000 or 100 epochs, 20,000 epochs.
  box4 — box4 free fermions (analytic oracle) at the default and at the
      big ansatz (31 knots, 4 layers), and the interacting Be.
  ng_scale — adam, SR and SPRING at batch 16,384, adam and SR at 65,536,
      on the flagship: whole windows of 20 epochs for 180 s after a first
      one, then an evaluation at 4,096 walkers.  ``ng_spring_65k`` is not
      run (the grid is the JAX script's five runs); its row states the
      SPRING Gram's bytes beside the device's memory.
  antisym2d_free — box2 and box3 in 2D, free, antisym, with the decay,
      against the analytic level filling.

Every row is evaluated with frozen parameters at the JAX protocol
(``evaluate_trainer(n_blocks=64, sweeps_per_block=25, n_warmup_sweeps=250,
batch_size=eval_batch)``, 4,096 walkers unless the job sets its own) and
printed as one JSON line: the JAX script's fields, JAX's row from
results/round5_quality.json beside them (without its TPU times), the
combined σ = (port − JAX) / √(σ² + σ_jax²) of the raw and of the clipped
means, the row's gate and its verdict, the K1 (sampler) and K3 (basis jet)
launches of its training and of its evaluation, and the device (on a card
its name and power limit, as nvidia-smi gives them).  Rows go to
``<out-dir>/round5_quality.json`` and checkpoints to
``<out-dir>/r5_<key>``; a row already there is skipped on a rerun.  Nothing
is written under results/.

The flagship and antisym rows also carry ``trace_chunks``: the medians of
each 10,000 epochs of the loss trace beside those of JAX's committed trace.
``--tail-k K`` adds the tail pass after the evaluation
(vmc/evaluate.py::record_tail: the K largest local energies of 8 more
blocks of the evaluation's own chain, each walker with its place and the
'dense', finite-difference and float64 local energies there) as the row's
``tail``; ``--eval-seeds 7,8,9`` evaluates the weights again at each
evaluation seed (each with its tail under ``--tail-k``), from the saved
checkpoint when the row is already there, without training again.

  python3 examples/round5_quality_torch.py --only flagship
  python3 examples/round5_quality_torch.py \\
      --keys he2d2e_antisym,h2_2d2e_antisym --out-dir runs/antisym
  python3 examples/round5_quality_torch.py --only ng_scale
  python3 examples/round5_quality_torch.py \\
      --keys flagship_fwd_batched_100k,h2_2d2e_antisym --seed 4 --tail-k 32
  python3 examples/round5_quality_torch.py --keys flagship_fwd_batched_100k \\
      --out-dir runs/r5 --eval-seeds 7,8,9 --tail-k 32   # no training
  python3 examples/round5_quality_torch.py --device cpu \\
      --keys box2_2d_antisym --epochs 200 --decay-epochs 100 \\
      --out-dir runs/rehearsal         # a CPU rehearsal
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np
import torch

from waveflow_tpu_torch import ops
from waveflow_tpu_torch.ops import cuda_jet, cuda_sampler
from waveflow_tpu_torch.physics import (exact_free_fermion_energy,
                                        exact_free_fermion_energy_2d,
                                        exact_ground_state_2d_2e)
from waveflow_tpu_torch.utils.fidelity import fidelity_2d_2e
from waveflow_tpu_torch.vmc import (VMCConfig, VMCTrainer, evaluate_trainer,
                                   record_tail)
from waveflow_tpu_torch.vmc import graphs

# the JAX script's rows (read only); its 40-point EDs sit beside them
JAX_ROWS = REPO / 'results' / 'round5_quality.json'
OUT_NAME = 'round5_quality.json'

# grid-converged sector floor / exact targets (results/sector_bound.json,
# results/oracle_2d_2e.json; Richardson n32 -> n40), as the JAX script
HE2D_X_SECTOR_FLOOR = -1.25879
HE2D_EXACT = -1.26061
H2_2D_EXACT = -1.18652
FLAGSHIP_EXACT = -1.81604
# the r4 converged band of the flagship 100k's clipped energy
FLAGSHIP_BAND = (-1.81600, -1.81570)
BUDGET_S = 180.0
EVAL_KW = dict(sweeps_per_block=25, n_warmup_sweeps=250)
# the evaluation seed of every row (evaluate_trainer's default)
ROW_EVAL_SEED = 7
# the tail pass: blocks run on past the evaluation's
TAIL_BLOCKS = 8
# the loss trace's chunks set beside JAX's committed results/r5_<key>/loss.npy
TRACE_CHUNK = 10_000
# JAX's row fields that are TPU figures (times; the TPU's memory verdict on
# ng_spring_65k), left out of the row printed beside
TPU_FIELDS = ('epochs_per_sec', 'wall_s', 'walkers_per_sec',
              'epochs_in_budget', 'total_wall_s', 'fidelity_wall_s',
              'infeasible')
ED_PROTONS = {'He': [[0.0, 0.0], [0.0, 0.0]],
              'H2': [[-0.9, 0.0], [0.9, 0.0]]}


@dataclasses.dataclass(frozen=True)
class Job:
    """One row of the plan: ``cfg`` the VMCConfig fields the JAX script
    sets, ``epochs`` the training epochs (None for the timed ng runs),
    ``decay`` (epochs, learning rate) of the resumed second trainer,
    ``checks`` the gate's checks (``gate``), ``post`` what the stage adds
    to the row."""
    stage: str
    key: str
    epochs: int | None
    cfg: dict
    decay: tuple | None = None
    eval_blocks: int = 64
    eval_batch: int | None = None
    checks: tuple = ()
    post: dict = dataclasses.field(default_factory=dict)


def plan():
    """Every job of the six stages, in the order they run."""
    jobs = [Job('flagship', 'flagship_fwd_batched_100k', 100_000,
                dict(system_name='He', box_length=10.0, batch_size=256,
                     window=100, seed=2),
                checks=('band',), post=dict(exact=FLAGSHIP_EXACT))]
    base = dict(n_space_dimension=2, box_length=5.0, batch_size=256,
                window=100, seed=2, ansatz='antisym', sampler='metropolis',
                learning_rate=3e-4)
    for key, extra, name, n_states, exact, floor, checks in (
            ('he2d2e_antisym', dict(system_name='He'), 'He', 2,
             HE2D_EXACT, HE2D_X_SECTOR_FLOOR,
             ('floor', 'deviation', 'fidelity')),
            ('he2d2e_antisym_big', dict(system_name='He', num_knots=31,
                                        n_flow_layers=4), 'He', 2,
             HE2D_EXACT, HE2D_X_SECTOR_FLOOR, ()),
            ('h2_2d2e_antisym', dict(system_name='H2'), 'H2', 1,
             H2_2D_EXACT, None, ('deviation', 'fidelity'))):
        jobs.append(Job('antisym', key, 40_000, {**base, **extra},
                        decay=(20_000, 3e-5), eval_batch=4096, checks=checks,
                        post=dict(ed=name, n_states=n_states, exact=exact,
                                  floor=floor)))
    li = dict(system_name='Li', box_length=10.0, batch_size=256, window=100,
              seed=2, sampler='metropolis', learning_rate=3e-4)
    for sweeps, every, tag in ((3, 1000, '1k'), (1, 1000, '1k'),
                               (3, 100, '100'), (1, 100, '100')):
        jobs.append(Job('li_refresh', f'li_metro_refresh{tag}_s{sweeps}',
                        20_000, dict(mcmc_sweeps=sweeps,
                                     mcmc_refresh_every=every, **li),
                        post=dict(ancestral_ref=-3.3759,
                                  r4_norefresh={3: -3.24, 1: -3.34}[sweeps])))
    box = dict(box_length=5.0, batch_size=256, window=100, seed=2,
               learning_rate=3e-4)
    box4 = dict(exact=exact_free_fermion_energy(4, 5.0))
    jobs += [
        Job('box4', 'box4_free', 40_000,
            dict(system_name='box4', interactions=False, **box),
            checks=('catalogue',), post=box4),
        Job('box4', 'box4_free_big', 40_000,
            dict(system_name='box4', interactions=False, num_knots=31,
                 n_flow_layers=4, **box),
            checks=('catalogue',), post=box4),
        Job('box4', 'be4_interacting', 40_000,
            dict(system_name='Be', box_length=10.0, batch_size=256,
                 window=100, seed=2, learning_rate=3e-4))]
    for name, opt_kw, batch in (
            ('adam_16k', dict(optimizer='adam', learning_rate=1e-4), 16384),
            ('sr_16k', dict(optimizer='sr', learning_rate=0.05,
                            sr_cg_iters=20), 16384),
            ('spring_16k', dict(optimizer='spring', learning_rate=0.05,
                                spring_momentum=0.9), 16384),
            ('adam_65k', dict(optimizer='adam', learning_rate=1e-4), 65536),
            ('sr_65k', dict(optimizer='sr', learning_rate=0.05,
                            sr_cg_iters=20), 65536)):
        jobs.append(Job('ng_scale', f'ng_{name}', None,
                        dict(system_name='He', box_length=10.0,
                             batch_size=batch, window=20, seed=2,
                             sr_max_update_norm=0.3, **opt_kw),
                        eval_batch=4096, checks=('finite',),
                        post=dict(budget_s=BUDGET_S)))
    # not run: the grid is the JAX script's five runs
    jobs.append(Job('ng_scale', 'ng_spring_65k', None,
                    dict(optimizer='spring', batch_size=65536),
                    post=dict(not_run=True)))
    free = dict(n_space_dimension=2, box_length=5.0, batch_size=256,
                window=100, seed=2, ansatz='antisym', sampler='metropolis',
                interactions=False, learning_rate=3e-4)
    for name, n_el in (('box2', 2), ('box3', 3)):
        jobs.append(Job('antisym2d_free', f'{name}_2d_antisym', 40_000,
                        dict(system_name=name, **free), decay=(20_000, 3e-5),
                        eval_batch=4096, checks=('deviation',),
                        post=dict(exact=exact_free_fermion_energy_2d(
                            n_el, 5.0))))
    return jobs


STAGES = ('flagship', 'antisym', 'li_refresh', 'box4', 'ng_scale',
          'antisym2d_free')


def _trace_median(losses, frac=0.2):
    tail = np.asarray(losses)[int(len(losses) * (1 - frac)):]
    return float(np.median(tail))


def trace_chunks(save_dir, key: str, chunk: int = TRACE_CHUNK,
                 jax_dir=None):
    """The medians of each ``chunk`` epochs of the row's loss trace
    (``<save_dir>/loss.npy``) and of JAX's committed trace for the same
    row (``<jax_dir>/loss.npy``, by default results/r5_<key> with the seed
    suffix dropped), each with the median of its last 2,000 epochs and of
    its last 20%; None for a trace that is not there."""
    def medians(path):
        if not path.exists():
            return None
        losses = np.load(path)
        return {'chunks': [float(np.median(losses[i:i + chunk]))
                           for i in range(0, len(losses), chunk)],
                'last_2000': float(np.median(losses[-2000:])),
                'last_20pct': _trace_median(losses)}
    return {'chunk': chunk,
            'port': medians(Path(save_dir) / 'loss.npy'),
            'jax': medians(Path(jax_dir or JAX_ROWS.parent
                                / f"r5_{key.split('_seed')[0]}")
                           / 'loss.npy')}


def combined_sigma(value, stderr, ref, ref_stderr):
    """(value − ref) / √(stderr² + ref_stderr²), or None where a figure is
    missing."""
    if None in (value, stderr, ref, ref_stderr):
        return None
    return (value - ref) / math.sqrt(stderr ** 2 + ref_stderr ** 2)


def gate(job: Job, row: dict, jax_row: dict | None):
    """The row's checks and its verdict, or None for a job without a gate
    (the row then carries only its combined σ to JAX's): every check
    also needs finite losses and a finite evaluation.

      band       the clipped energy in FLAGSHIP_BAND;
      floor      clipped + 3 stderr below the x-sector floor;
      deviation  |dev − dev_jax| <= max(2 |dev_jax|, 3e-3), dev the
                 clipped energy less the oracle;
      fidelity   >= 1 − 10 (1 − JAX's fidelity);
      catalogue  dev in [−3 stderr, max(3 dev_jax, dev_jax + 3e-3)];
      finite     no failure, every loss and evaluation figure finite."""
    if not job.checks:
        return None
    checks = {'finite': bool(row.get('finite')) and 'failed' not in row}
    clipped, stderr = row.get('eval_clipped'), row.get('eval_clipped_stderr')
    for check in job.checks:
        if check == 'band':
            lo, hi = FLAGSHIP_BAND
            checks['band'] = dict(limits=[lo, hi],
                                  ok=bool(lo <= clipped <= hi))
        elif check == 'floor':
            floor = job.post['floor']
            checks['floor'] = dict(floor=floor,
                                   ok=bool(clipped + 3.0 * stderr < floor))
        elif check == 'deviation':
            dev, dev_jax = row['deviation_eval'], jax_row['deviation_eval']
            margin = max(2.0 * abs(dev_jax), 3e-3)
            checks['deviation'] = dict(
                limits=[dev_jax - margin, dev_jax + margin],
                ok=bool(abs(dev - dev_jax) <= margin))
        elif check == 'fidelity':
            least = 1.0 - 10.0 * (1.0 - jax_row['fidelity_ed40'])
            checks['fidelity'] = dict(least=least,
                                      ok=bool(row['fidelity_ed40'] >= least))
        elif check == 'catalogue':
            dev, dev_jax = row['deviation_eval'], jax_row['deviation_eval']
            lo, hi = -3.0 * stderr, max(3.0 * dev_jax, dev_jax + 3e-3)
            checks['catalogue'] = dict(limits=[lo, hi],
                                       ok=bool(lo <= dev <= hi))
    ok = all(v if isinstance(v, bool) else v['ok'] for v in checks.values())
    return dict(checks=checks, in_gate=ok)


def jax_row(key: str):
    """JAX's row for ``key`` (the seed suffix dropped), TPU times left
    out, or None."""
    rows = json.loads(JAX_ROWS.read_text())
    row = rows.get(key.split('_seed')[0])
    if row is None:
        return None
    return {k: v for k, v in row.items() if k not in TPU_FIELDS}


def device_info(device: str) -> dict:
    """The device the rows ran on: on a card its name and the
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` line,
    and its memory in bytes."""
    if torch.device(device).type != 'cuda':
        return {'device': 'cpu'}
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    props = torch.cuda.get_device_properties(torch.device(device))
    return {'device': props.name,
            'card': (smi.stdout.strip().splitlines() or [''])[0],
            'memory_bytes': int(props.total_memory)}


@contextlib.contextmanager
def capture_pools(device):
    """The device bytes that each ``EpochGraph`` capture made inside
    reserves (its private pool), appended to the list yielded: the
    caching allocator's reserved bytes on either side of the capture,
    after a collection and an emptied cache."""
    pools = []
    if torch.device(device).type != 'cuda':
        yield pools
        return
    real = graphs.EpochGraph._capture

    def measured(self):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        out = real(self)
        torch.cuda.synchronize()
        pools.append(torch.cuda.memory_reserved() - before)
        return out
    graphs.EpochGraph._capture = measured
    try:
        yield pools
    finally:
        graphs.EpochGraph._capture = real


class Run:
    """What every job reads: the options, the device, the rows so far and
    the file they are kept in."""

    def __init__(self, args):
        self.args = args
        self.out_dir = Path(args.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.out_dir / OUT_NAME
        self.out = (json.loads(self.path.read_text()) if self.path.exists()
                    else {})
        self.info = device_info(args.device)

    def save(self):
        self.path.write_text(json.dumps(self.out, indent=2))

    def sync(self):
        if torch.device(self.args.device).type == 'cuda':
            torch.cuda.synchronize()

    def config(self, job: Job, key: str, **kw) -> VMCConfig:
        cfg = dict(job.cfg, **kw)
        if self.args.seed is not None:
            cfg['seed'] = self.args.seed
        return VMCConfig(save_dir=str(self.out_dir / f'r5_{key}'),
                         log_every=10 ** 9, device=self.args.device, **cfg)

    def key(self, job: Job) -> str:
        seed = self.args.seed
        return (job.key if seed is None or seed == job.cfg.get('seed')
                else f'{job.key}_seed{seed}')


def _launches() -> dict:
    return {'sampler': cuda_sampler.launches, 'basis_jet': cuda_jet.launches}


def _zero_launches():
    ops.set_launches((0,) * len(ops.LAUNCH_COUNTERS))


def _evaluation_row(ev) -> dict:
    return {'eval_mean': ev.e_mean, 'eval_stderr': ev.e_stderr,
            'eval_clipped': ev.e_clipped,
            'eval_clipped_stderr': ev.e_clipped_stderr,
            'eval_stderr_2x': ev.e_stderr_2x,
            'eval_stderr_4x': ev.e_stderr_4x,
            'accept_rate': ev.accept_rate}


def _finite(losses, ev) -> bool:
    return bool(np.isfinite(np.asarray(losses, dtype=np.float64)).all()
                and all(math.isfinite(v) for v in (
                    ev.e_mean, ev.e_stderr, ev.e_clipped,
                    ev.e_clipped_stderr)))


def run_vmc(job: Job, run: Run, need_trainer: bool = False):
    """Train and evaluate one job as the JAX script's ``run_vmc`` does:
    ``train(epochs)``; for a decay a second trainer whose config differs
    only in ``learning_rate`` loads the first run's checkpoint and trains
    ``decay`` epochs more; then the frozen-params evaluation.  Returns
    (row, trainer); a finished row returns no trainer unless
    ``need_trainer`` (it is then rebuilt from its checkpoint)."""
    a = run.args
    key = run.key(job)
    cfg = run.config(job, key)
    if key in run.out:
        if not need_trainer:
            return run.out[key], None
        t = VMCTrainer(cfg)
        assert t.load_checkpoint(cfg.save_dir)
        return run.out[key], t
    epochs = job.epochs if a.epochs is None else a.epochs
    t0 = time.time()
    t = VMCTrainer(cfg)
    if a.init_from is not None and not t.load_checkpoint(a.init_from):
        raise FileNotFoundError(f"no checkpoint in {a.init_from}")
    _zero_launches()
    losses = t.train(num_epochs=epochs, verbose=False)
    decay_epochs, decay_lr = job.decay or (0, None)
    if a.decay_epochs is not None:
        decay_epochs = a.decay_epochs
    if job.decay and decay_epochs:
        cfg2 = VMCConfig(**{**cfg.__dict__, 'learning_rate': decay_lr})
        t2 = VMCTrainer(cfg2)
        assert t2.load_checkpoint(cfg.save_dir)
        losses = t2.train(num_epochs=decay_epochs, verbose=False)
        t = t2
    run.sync()
    wall = time.time() - t0
    train_launches = _launches()
    _zero_launches()
    ev = evaluate_trainer(t, n_blocks=job.eval_blocks, batch_size=job.eval_batch,
                          **EVAL_KW)
    row = {'trace_median': _trace_median(losses),
           **_evaluation_row(ev),
           'epochs_per_sec': len(losses) / wall,
           'wall_s': wall}
    opt = t.step.optimizer.state_dict()
    if isinstance(opt, dict) and 'skipped' in opt:
        row['spring_skipped'] = int(opt['skipped'])
    row.update(seed=cfg.seed, epochs=t.epoch, finite=_finite(losses, ev),
               learning_rate=t.step.optimizer.param_groups[0]['lr']
               if cfg.optimizer == 'adam' else cfg.learning_rate,
               launches=dict(train=train_launches, eval=_launches()))
    run.out[key] = row
    run.save()
    return row, t


def wants_trainer(run: Run) -> bool:
    """Whether the row's trainer is needed after its evaluation: for the
    evaluation seeds or the tail pass."""
    return bool(run.args.eval_seeds or run.args.tail_k)


def evaluate_seeds(job: Job, row: dict, trainer, run: Run):
    """The trained weights evaluated again at each of ``--eval-seeds`` (the
    JAX protocol, another evaluation chain each; the row's own seed, 7,
    reproduces the row's figures), each followed by the tail pass of
    ``--tail-k`` walkers on its chain (``record_tail``); kept in the row as
    ``eval_seeds`` by seed, and the tail of the row's own chain as
    ``tail``.  Seeds already in the row are not run again."""
    a = run.args
    seeds = a.eval_seeds or ([ROW_EVAL_SEED] if a.tail_k else [])
    done = row.setdefault('eval_seeds', {})
    for seed in seeds:
        if str(seed) in done and (not a.tail_k or 'tail' in done[str(seed)]):
            continue
        ev = evaluate_trainer(trainer, n_blocks=job.eval_blocks,
                              batch_size=job.eval_batch, seed=seed, **EVAL_KW)
        entry = {**_evaluation_row(ev), 'finite': _finite([], ev)}
        if a.tail_k:
            entry['tail'] = record_tail(
                trainer, k=a.tail_k, n_blocks=TAIL_BLOCKS,
                skip_blocks=job.eval_blocks, batch_size=job.eval_batch,
                seed=seed, evaluation=ev, **EVAL_KW)
        done[str(seed)] = entry
        run.save()
    own = done.get(str(ROW_EVAL_SEED), {})
    if 'tail' in own:
        row['tail'] = own['tail']


def finish(job: Job, row: dict, run: Run):
    """JAX's row, the combined σ, the gate and the device added to the
    row; the row kept and printed as one JSON line."""
    key = run.key(job)
    ref = jax_row(key)
    row['jax'] = ref
    if ref is not None and 'eval_clipped' in row:
        row['sigma_raw'] = combined_sigma(
            row['eval_mean'], row['eval_stderr'], ref.get('eval_mean'),
            ref.get('eval_stderr'))
        row['sigma_clipped'] = combined_sigma(
            row['eval_clipped'], row['eval_clipped_stderr'],
            ref.get('eval_clipped'), ref.get('eval_clipped_stderr'))
    row['gate'] = gate(job, row, ref)
    row.update(run.info)
    run.out[key] = row
    run.save()
    print(json.dumps({'key': key, **row}), flush=True)


def ed_2d2e(name: str, n_states: int, out_dir: Path):
    """The 40-point 2D two-electron ED (evals, psi, sites, x): the
    committed results/ed40_<name>_2d2e.npz, else one computed by
    ``exact_ground_state_2d_2e`` and kept in ``out_dir``."""
    file = f'ed40_{name}_2d2e.npz'
    for path in (JAX_ROWS.parent / file, out_dir / file):
        if path.exists():
            d = np.load(path)
            return d['evals'], d['psi'], d['sites'], d['x']
    res = exact_ground_state_2d_2e(np.asarray(ED_PROTONS[name]), 5.0,
                                   n_grid=40, n_states=n_states)
    if n_states == 1:
        evals, psi, sites, x = (np.array([res[0]]), res[1][:, None], res[2],
                                res[3])
    else:
        evals, psi, sites, x = res
    np.savez_compressed(out_dir / file, evals=evals, psi=psi, sites=sites,
                        x=x)
    return evals, psi, sites, x


def stage_flagship(jobs, run: Run):
    for job in jobs:
        row, trainer = run_vmc(job, run, need_trainer=wants_trainer(run))
        row['exact_richardson'] = job.post['exact']
        row['deviation_eval'] = row['eval_clipped'] - job.post['exact']
        row['trace_chunks'] = trace_chunks(run.config(job, run.key(job))
                                           .save_dir, run.key(job),
                                           run.args.trace_chunk)
        if trainer is not None and wants_trainer(run):
            evaluate_seeds(job, row, trainer, run)
        finish(job, row, run)


def stage_antisym(jobs, run: Run):
    for job in jobs:
        key = run.key(job)
        if (key in run.out and 'fidelity_ed40' in run.out[key]
                and not wants_trainer(run)):
            continue
        row, trainer = run_vmc(job, run, need_trainer=True)
        exact, floor = job.post['exact'], job.post['floor']
        row['exact_richardson'] = exact
        row['deviation_eval'] = row['eval_clipped'] - exact
        if floor is not None:
            row['x_sector_floor'] = floor
            row['below_floor'] = bool(row['eval_clipped'] < floor)
            row['below_floor_sigma'] = ((floor - row['eval_clipped'])
                                        / row['eval_clipped_stderr'])
        row['trace_chunks'] = trace_chunks(run.config(job, key).save_dir, key,
                                           run.args.trace_chunk)
        if 'fidelity_ed40' not in row:
            t0 = time.time()
            _, psi_ed, sites, x = ed_2d2e(job.post['ed'],
                                          job.post['n_states'], run.out_dir)
            fid = fidelity_2d_2e(trainer.model.psi,
                                 psi_ed[:, 0] if job.post['n_states'] == 1
                                 else psi_ed, sites, x,
                                 device=trainer.device)
            row['fidelity_ed40'] = float(fid)
            row['fidelity_wall_s'] = time.time() - t0
        if wants_trainer(run):
            evaluate_seeds(job, row, trainer, run)
        finish(job, row, run)


def stage_li_refresh(jobs, run: Run):
    for job in jobs:
        row, _ = run_vmc(job, run)
        row.update(job.post)
        finish(job, row, run)


def stage_box4(jobs, run: Run):
    for job in jobs:
        row, _ = run_vmc(job, run)
        if 'exact' in job.post:
            row['exact_analytic'] = job.post['exact']
            row['deviation_eval'] = row['eval_clipped'] - job.post['exact']
        finish(job, row, run)


def stage_antisym2d_free(jobs, run: Run):
    for job in jobs:
        row, _ = run_vmc(job, run)
        exact = job.post['exact']
        row['exact_analytic'] = exact
        row['deviation_eval'] = row['eval_clipped'] - exact
        row['deviation_mean'] = row['eval_mean'] - exact
        finish(job, row, run)


def _timed_train(trainer, budget_s, window):
    """Train whole windows until the wall budget is spent, after a first
    window (the warm-up epoch and the capture).  Returns (epochs_done,
    measure_wall_s)."""
    trainer.train(num_epochs=window, verbose=False)
    done = 0
    t0 = time.time()
    while time.time() - t0 < budget_s:
        trainer.train(num_epochs=window, verbose=False)
        done += window
    return done, time.time() - t0


def spring_65k_row(job: Job, run: Run) -> dict:
    """The row of the SPRING run the grid leaves out: the bytes of its
    dense (B, B) f32 Gram beside the device's memory, as
    torch.cuda.get_device_properties reads it."""
    B = job.cfg['batch_size']
    row = {'batch': B, 'not_run': "the grid is the JAX script's five runs",
           'gram_bytes': B * B * 4}
    if 'memory_bytes' in run.info:
        row['device_memory_bytes'] = run.info['memory_bytes']
        row['gram_share_of_device_memory'] = (row['gram_bytes']
                                              / run.info['memory_bytes'])
    return row


def stage_ng_scale(jobs, run: Run):
    """adam / CG-SR / SPRING at batch 16,384 and 65,536 on the flagship, at
    equal wall-clock budget: the frozen-params evaluation, walkers/s, the
    peak device memory and the graph pools."""
    a = run.args
    cuda = torch.device(a.device).type == 'cuda'
    for job in jobs:
        key = run.key(job)
        if key in run.out:
            continue
        if job.post.get('not_run'):
            finish(job, spring_65k_row(job, run), run)
            continue
        budget = job.post['budget_s'] if a.budget_s is None else a.budget_s
        batch = job.cfg['batch_size']
        cfg = run.config(job, key)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            with capture_pools(a.device) as pools:
                trainer = VMCTrainer(cfg)
                _zero_launches()
                epochs, measure_wall = _timed_train(trainer, budget,
                                                    cfg.window)
        except Exception as e:          # noqa: BLE001 — record OOM etc.
            row = {'batch': batch, 'failed': repr(e)[:300]}
            finish(job, row, run)
            continue
        train_launches = _launches()
        _zero_launches()
        ev = evaluate_trainer(trainer, n_blocks=job.eval_blocks,
                              batch_size=job.eval_batch, **EVAL_KW)
        row = {
            'batch': batch,
            'epochs_in_budget': epochs,
            'budget_s': budget,
            'epochs_per_sec': epochs / measure_wall,
            'walkers_per_sec': epochs * batch / measure_wall,
            **_evaluation_row(ev),
            'trace_median': _trace_median(trainer.losses),
            'total_wall_s': time.time() - t0,
            'finite': _finite(trainer.losses, ev),
            'epochs': trainer.epoch,
            'launches': dict(train=train_launches, eval=_launches()),
            'graph_pool_mib': [p / 2 ** 20 for p in pools],
        }
        if cuda:
            row['peak_memory_mib'] = torch.cuda.max_memory_allocated() / 2 ** 20
        opt = trainer.step.optimizer.state_dict()
        if isinstance(opt, dict) and 'skipped' in opt:
            row['spring_skipped'] = int(opt['skipped'])
        del trainer, ev
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        finish(job, row, run)


STAGE_FNS = {'flagship': stage_flagship, 'antisym': stage_antisym,
             'li_refresh': stage_li_refresh, 'box4': stage_box4,
             'ng_scale': stage_ng_scale,
             'antisym2d_free': stage_antisym2d_free}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', default=None,
                    help='run only stages whose name starts with this')
    ap.add_argument('--keys', default=None,
                    help='comma list of rows to run (default: every row of '
                         'the chosen stages)')
    ap.add_argument('--out-dir', default='runs/round5_quality',
                    help=f'where {OUT_NAME} and the checkpoints go')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--seed', type=int, default=None,
                    help="every job's seed (default: the plan's, 2); rows "
                         "at another seed are keyed <key>_seed<seed>")
    ap.add_argument('--epochs', type=int, default=None,
                    help='training epochs of every row (default: the plan)')
    ap.add_argument('--decay-epochs', type=int, default=None,
                    help='epochs of every decay (default: the plan; 0: no '
                         'decay)')
    ap.add_argument('--init-from', default=None,
                    help='a checkpoint directory (the port\'s or the JAX '
                         'trainer\'s) every trained row starts from: '
                         'tests/_jax_shared_init.py writes JAX\'s initial '
                         'state')
    ap.add_argument('--trace-chunk', type=int, default=TRACE_CHUNK,
                    help='epochs per median of trace_chunks (default '
                         f'{TRACE_CHUNK:,})')
    ap.add_argument('--budget-s', type=float, default=None,
                    help=f'the ng rows\' budget (default {BUDGET_S:g} s)')
    ap.add_argument('--eval-seeds', default=None,
                    type=lambda v: [int(s) for s in v.split(',')],
                    help='flagship and antisym rows: evaluate the weights '
                         'again at each of these evaluation seeds (e.g. '
                         '7,8,9), from the saved checkpoint when the row is '
                         'already there (no training)')
    ap.add_argument('--tail-k', type=int, default=0,
                    help='flagship and antisym rows: after each evaluation, '
                         'the tail pass keeps the K largest local energies '
                         'of its chain with the other Laplacian forms there '
                         '(vmc/evaluate.py::record_tail; 0: no pass)')
    return ap, ap.parse_args(argv)


def main(argv=None):
    ap, args = parse_args(argv)
    keys = None if args.keys is None else args.keys.split(',')
    jobs = plan()
    if keys is not None:
        unknown = sorted(set(keys) - {j.key for j in jobs})
        if unknown:
            ap.error(f"not in the plan: {unknown}")
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            print("round5_quality_torch: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 1
        # the kernels are built before the first row, so that no row's wall
        # time holds nvcc
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
            STAGE_FNS[stage](todo, run)
    return 0


if __name__ == '__main__':
    sys.exit(main())
