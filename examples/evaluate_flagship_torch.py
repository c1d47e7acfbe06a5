"""Re-report every committed VMC run with the PyTorch/CUDA port (cf.
benchmarks/evaluate_flagship.py): load each trained JAX checkpoint, run the
frozen-parameter blocked-Metropolis evaluation (vmc/evaluate.py) at the JAX
protocol, and record ⟨E_L⟩ ± stderr, the median and the clipped mean beside
the grid-converged ED oracle.

The JAX script's 19 ``RUNS``, each as ``VMCConfig(system_name,
box_length=10.0, batch_size=256, save_dir, **mkw)`` (``he1d_big`` and
``r4_li_big_lr3e-4`` take 31 knots and 4 layers), evaluated by
``evaluate_trainer(n_blocks=64, sweeps_per_block=25, n_warmup_sweeps=250,
batch_size=4096)``.  Each row holds the JAX script's fields (``exact_ed``
from ``physics.richardson_ground_energy_1d``) and beside them JAX's row from
results/final_energies_r4.json (without its TPU ``wall_s``), the combined σ
= (port − JAX) / √(σ² + σ_jax²) of the raw and of the clipped means, the K1
(sampler) and K3 (basis jet) launches of the evaluation, and the device (on
a card its name and power limit, as nvidia-smi gives them).

Gate (``gate``): raw with raw and clipped with clipped, each within
SIGMA_GATE combined σ of JAX's.  A run whose JAX energies are not finite
(``he1d_seed2``: every parameter NaN) is in gate when the port's are not
finite either.  A finite row that misses gets the tail pass
(vmc/evaluate.py::record_tail, ``--tail-k`` walkers) as its ``tail``, and
is reported as it is.

Rows go to ``<out-dir>/final_energies.json`` keyed by the run's directory; a
row already there is skipped on a rerun.  Nothing is written under
results/.

  python3 examples/evaluate_flagship_torch.py
  python3 examples/evaluate_flagship_torch.py --runs he1d_seed2,r4_spring100k
  python3 examples/evaluate_flagship_torch.py --device cpu --runs \\
      he1d_seed2 --tiny-eval                       # a CPU rehearsal
"""

import argparse
import functools
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
from waveflow_tpu_torch.physics import (richardson_ground_energy_1d,
                                        system_catalogue)
from waveflow_tpu_torch.vmc import (VMCConfig, VMCTrainer, evaluate_trainer,
                                   record_tail)

JAX_ROWS = REPO / 'results' / 'final_energies_r4.json'
OUT_NAME = 'final_energies.json'

# (save_dir, system, model hyperparameters): the JAX script's runs
RUNS = [
    ('results/he1d_score_seed2', 'He', dict()),
    ('results/he1d_score_seed7', 'He', dict()),
    ('results/he1d_score_seed13', 'He', dict()),
    ('results/he1d_score_seed42', 'He', dict()),
    ('results/he1d_seed2', 'He', dict()),
    ('results/he1d_seed7', 'He', dict()),
    ('results/he1d_metropolis', 'He', dict()),
    ('results/he1d_metropolis_seed7', 'He', dict()),
    ('results/he1d_metropolis_seed13', 'He', dict()),
    ('results/he1d_metropolis_seed42', 'He', dict()),
    ('results/he1d_big', 'He', dict(num_knots=31, n_flow_layers=4)),
    ('results/h2_1d_seed7', 'H2', dict()),
    ('results/h2_1d_seed13', 'H2', dict()),
    ('results/li_1d', 'Li', dict()),
    ('results/r4_spring30k', 'He', dict()),
    ('results/r4_spring100k', 'He', dict()),
    ('results/r4_spring4k_2k', 'He', dict()),
    ('results/r4_li_lr3e-4_decay', 'Li', dict()),
    ('results/r4_li_big_lr3e-4', 'Li', dict(num_knots=31, n_flow_layers=4)),
]
# the grid-converged (h² Richardson) oracles, as the JAX script rounds them
EXACT = {'He': -1.81604, 'H2': -1.71311, 'Li': -3.37751}
# the JAX protocol, and a rehearsal's cut of it (--tiny-eval)
EVAL = dict(n_blocks=64, sweeps_per_block=25, n_warmup_sweeps=250,
            batch_size=4096)
TINY_EVAL = dict(n_blocks=2, sweeps_per_block=2, n_warmup_sweeps=2,
                 batch_size=64)
SIGMA_GATE = 5.0
TAIL_K = 32
TAIL_BLOCKS = 8
# JAX's row fields that are TPU figures
TPU_FIELDS = ('wall_s',)
# the energies the gate reads, raw and clipped: (field, stderr field)
GATED = (('e_mean', 'e_stderr'), ('e_clipped', 'e_clipped_stderr'))


def config(system: str, save_dir, mkw: dict, device: str) -> VMCConfig:
    """The JAX script's trainer config of one run."""
    return VMCConfig(system_name=system, box_length=10.0, batch_size=256,
                     save_dir=str(save_dir), device=device, **mkw)


def load_run(cfg: VMCConfig, save_dir=None) -> VMCTrainer:
    """A trainer of ``cfg`` with the checkpoint of ``save_dir`` (by
    default ``cfg.save_dir``, a run of the port or of the JAX package)
    loaded; FileNotFoundError where there is none."""
    save_dir = cfg.save_dir if save_dir is None else save_dir
    trainer = VMCTrainer(cfg)
    if not trainer.load_checkpoint(str(save_dir)):
        raise FileNotFoundError(f"no checkpoint under {save_dir}")
    return trainer


def evaluate(trainer: VMCTrainer, **eval_kw):
    """``evaluate_trainer(trainer, **eval_kw)`` with the K1 / K3 launches it
    made: (evaluation, launches, wall s)."""
    r5._zero_launches()
    t0 = time.time()
    ev = evaluate_trainer(trainer, **eval_kw)
    if trainer.device.type == 'cuda':
        torch.cuda.synchronize()
    return ev, r5._launches(), time.time() - t0


def finite(*values) -> bool:
    return all(v is not None and math.isfinite(v) for v in values)


def energy_row(ev) -> dict:
    """The JAX script's fields of one evaluation, unrounded."""
    return {'e_mean': ev.e_mean, 'e_stderr': ev.e_stderr,
            'e_median': ev.e_median, 'e_clipped': ev.e_clipped,
            'e_clipped_stderr': ev.e_clipped_stderr,
            'accept_rate': ev.accept_rate, 'n_samples': ev.n_samples}


def jax_row(save_dir: str):
    """JAX's committed row for ``save_dir``, its TPU time left out, or
    None."""
    row = json.loads(JAX_ROWS.read_text()).get(save_dir)
    return None if row is None else {k: v for k, v in row.items()
                                     if k not in TPU_FIELDS}


def gate(row: dict, ref: dict | None):
    """Raw with raw and clipped with clipped within SIGMA_GATE combined σ
    of JAX's; where JAX's energies are not finite, in gate when the port's
    are not finite either.  None without a JAX row."""
    if ref is None:
        return None
    if not finite(*(ref.get(k) for k, _ in GATED)):
        ok = not finite(*(row[k] for k, _ in GATED))
        return dict(kind='non-finite in JAX', port_finite=not ok,
                    in_gate=ok)
    sig = {k: r5.combined_sigma(row[k], row[s], ref[k], ref[s])
           for k, s in GATED}
    ok = all(v is not None and math.isfinite(v) and abs(v) <= SIGMA_GATE
             for v in sig.values())
    return dict(kind='combined sigma', limit=SIGMA_GATE,
                sigma_raw=sig['e_mean'], sigma_clipped=sig['e_clipped'],
                in_gate=ok)


@functools.lru_cache(maxsize=None)
def oracle(system: str) -> float:
    """The Richardson ED of a 1D system at L = 10, computed once."""
    protons, n_el = system_catalogue[1][system]
    return float(richardson_ground_energy_1d(np.asarray(protons), n_el,
                                             10.0))


def run_row(save_dir: str, system: str, mkw: dict, args, info: dict) -> dict:
    """Load, evaluate and gate one committed run; the row."""
    eval_kw = TINY_EVAL if args.tiny_eval else EVAL
    t0 = time.time()
    trainer = load_run(config(system, REPO / save_dir, mkw, args.device))
    ev, launches, eval_wall = evaluate(trainer, **eval_kw)
    exact = oracle(system)
    row = {'system': system, **energy_row(ev), 'exact_ed': exact,
           'deviation_clipped': ev.e_clipped - exact,
           'finite': finite(ev.e_mean, ev.e_clipped),
           'wall_s': time.time() - t0, 'eval_wall_s': eval_wall,
           'epoch': trainer.epoch, 'launches': launches,
           'protocol': eval_kw}
    ref = jax_row(save_dir)
    row['jax'] = ref
    row['gate'] = gate(row, ref)
    if (args.tail_k and row['finite'] and row['gate'] is not None
            and not row['gate']['in_gate']):
        row['tail'] = record_tail(
            trainer, k=args.tail_k, n_blocks=TAIL_BLOCKS,
            skip_blocks=eval_kw['n_blocks'],
            sweeps_per_block=eval_kw['sweeps_per_block'],
            n_warmup_sweeps=eval_kw['n_warmup_sweeps'],
            batch_size=eval_kw['batch_size'],
            evaluation=ev)
    row.update(info)
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', default=None,
                    help='comma list of runs (their directory names, e.g. '
                         'he1d_seed2; default: all 19)')
    ap.add_argument('--out-dir', default='runs/evaluate_flagship',
                    help=f'where {OUT_NAME} goes')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--tiny-eval', action='store_true',
                    help='a rehearsal\'s evaluation: TINY_EVAL in place of '
                         'the JAX protocol')
    ap.add_argument('--tail-k', type=int, default=TAIL_K,
                    help='walkers the tail pass keeps on a finite row out '
                         f'of its gate (default {TAIL_K}; 0: no pass)')
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    names = {Path(d).name: (d, s, m) for d, s, m in RUNS}
    wanted = list(names) if args.runs is None else args.runs.split(',')
    unknown = sorted(set(wanted) - set(names))
    if unknown:
        print(f"evaluate_flagship_torch: not a run: {unknown}",
              file=sys.stderr)
        return 2
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            print("evaluate_flagship_torch: no CUDA device (pass --device "
                  "cpu)", file=sys.stderr)
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
    for name in wanted:
        save_dir, system, mkw = names[name]
        if save_dir in out:
            continue
        if not (REPO / save_dir / 'checkpoints').exists():
            print(f"skip {save_dir}: no checkpoint", flush=True)
            continue
        row = run_row(save_dir, system, mkw, args, info)
        out[save_dir] = row
        path.write_text(json.dumps(out, indent=2))
        print(json.dumps({'run': save_dir, **row}), flush=True)
    rows = [out[names[n][0]] for n in wanted if names[n][0] in out]
    n_in = sum(bool(r['gate'] and r['gate']['in_gate']) for r in rows)
    print(f"evaluate_flagship_torch: {n_in} of {len(rows)} rows in gate",
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
