"""Readings for the limits of a cell's correctness check (README.md): the
numbers checks.py compares, for each of many seeds, from sound runs of the
program, from the control, the program with its TF32 path switched on
(``matmul_precision='high'``), and from runs with each of faults.py's faults
planted, in one process on the card:

    python3 perfbench/calibrate.py --workload he1d-train-b256 \
        --seeds 101-112 --control-seeds 201-203 --fault-seeds 301-303

Each run is set-up and the first steps (no measured window).  One JSON
line per run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str):
    out = []
    for part in filter(None, text.split(',')):
        lo, _, hi = part.partition('-')
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--fault-seeds', default='',
                   help="seeds for each of faults.FAULTS, planted in turn")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import faults, harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json(ROOT / 'BENCHMARK.json'), args.workload)
    job = cell.job()
    device = torch.device('cuda', 0)
    runs = [(s, 'sound', {}) for s in seeds(args.seeds)]
    runs += [(s, 'control', {'matmul_precision': 'high'})
             for s in seeds(args.control_seeds)]
    runs += [(s, fault, {}) for fault in faults.FAULTS
             for s in seeds(args.fault_seeds)]
    for seed, kind, overrides in runs:
        t0 = time.perf_counter()
        undo = (faults.plant(kind) if kind in faults.FAULTS
                else (lambda: None))
        try:
            out = job.run(cell, seed, 0.0, False, device, t0, **overrides)
        finally:
            undo()
        numbers = {k: float(v) for k, v in out['numbers'].items()}
        print(json.dumps({'workload': cell.name, 'seed': seed, 'kind': kind,
                          'numbers': numbers,
                          'seconds': time.perf_counter() - t0}), flush=True)
        torch.set_float32_matmul_precision('highest')
    return 0


if __name__ == '__main__':
    sys.exit(main())
