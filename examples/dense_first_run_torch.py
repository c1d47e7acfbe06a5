"""Is the first 'dense' reference run of a process reproducible on the card?

    python3 examples/dense_first_run_torch.py [--warm train-256|none]
        [--epochs 20] [--multithreaded]

Builds the reference design (``estimator='reference'``,
``laplacian_mode='dense'``, adam, batch 256, the 'poly_pallas' backend)
from the committed 100k flagship checkpoint, optionally after the
ancestral adam window of the main path as chip_smoke.py's graph-train runs
it (eager, graph, graph, eager turns of 20 epochs), then:

  1. two runs of ``--epochs`` epochs from that state, each recorded op by
     op (a ``TorchDispatchMode`` that keeps every aten op's name, shapes,
     a hash of its inputs and outputs, and the thread that ran it);
  2. two more runs unrecorded;

and compares every run's losses, parameters and Adam state with the
others.  Where two recorded runs part, it prints the first op whose
outputs differ, with the ops around it in both runs.  The train step runs
its backward passes
on the calling thread (vmc/estimators.py::make_train_step);
``--multithreaded`` lets the autograd engine run them on its worker
thread again, as before that change, and shows the parting runs.

Needs a CUDA device; prints one JSON line of results last.
"""

import argparse
import contextlib
import json
import sys
import threading
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CHECKPOINT_RUN = ROOT / 'results' / 'r5_flagship_fwd_batched_100k'


def digest(t: torch.Tensor):
    """Two integer sums of a tensor's bits (plain and position-weighted):
    any one-ulp change moves them."""
    if t.numel() == 0 or t.device.type == 'meta':
        return (0, 0)
    v = t.detach().contiguous().reshape(-1)
    if v.dtype.is_floating_point:
        v = v.float().view(torch.int32)
    v = v.to(torch.int64)
    w = torch.arange(v.numel(), device=v.device) % 1021 + 1
    return (int(v.sum()), int((v * w).sum()))


class Recorder(TorchDispatchMode):
    """Every aten op run under it: (name, input shapes, input digests,
    output digests, the thread that ran it — the autograd engine runs a
    CUDA backward on a worker thread)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        in_dig = tuple(digest(a) for a in ins)
        out = func(*args, **kwargs)
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self.ops.append((str(func), tuple(tuple(a.shape) for a in ins),
                         in_dig, tuple(digest(o) for o in outs),
                         threading.get_ident()))
        return out


# ops whose outputs hold memory nobody has written yet
UNWRITTEN = {'empty', 'empty_like', 'empty_strided', 'new_empty',
             'new_empty_strided', 'set_', 'resize_'}


def first_split(a, b):
    """The first op whose outputs differ between two recordings (leaving
    out ops whose outputs are unwritten memory), and whether its inputs
    agreed there (then the op itself chose differently)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x[3] != y[3] and x[0].split('.')[1] not in UNWRITTEN:
            return dict(index=i, op=x[0], shapes=[list(s) for s in x[1]],
                        inputs_equal=x[2] == y[2], outputs_equal=x[3] == y[3],
                        other_op=y[0])
    if len(a) != len(b):
        return dict(index=min(len(a), len(b)), op='(length)',
                    inputs_equal=None, outputs_equal=None)
    return None


def state_of(t):
    out = {'losses': torch.tensor(t.losses, dtype=torch.float64)}
    out.update({f'param {k}': v.detach().cpu().clone()
                for k, v in t.model.state_dict().items()})
    for i, st in t.step.optimizer.state_dict()['state'].items():
        out.update({f'adam {i} {k}': v.detach().cpu().clone()
                    for k, v in st.items()})
    return out


def max_rel(a, b):
    worst = 0.0
    for k in a:
        x, y = a[k].double(), b[k].double()
        if x.numel():
            worst = max(worst, ((x - y).abs().max()
                                / x.abs().max().clamp_min(1e-30)).item())
    return worst


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--warm', default='train-256', choices=['train-256', 'none'])
    p.add_argument('--epochs', type=int, default=20)
    p.add_argument('--multithreaded', action='store_true',
                   help="run the train step's backward passes on the "
                        "autograd engine's worker thread")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from waveflow_tpu_torch.vmc import VMCConfig, VMCTrainer
    if args.multithreaded:
        # the step's set_multithreading_enabled(False) becomes a no-op
        torch.autograd.set_multithreading_enabled = (
            lambda mode: contextlib.nullcontext())

    def make(graph=False, **extra):
        t = VMCTrainer(VMCConfig(batch_size=256, window=10, log_every=10,
                                 eval_backend='poly_pallas', device='cuda',
                                 **extra), graph=graph)
        if not t.load_checkpoint(str(CHECKPOINT_RUN)):
            raise SystemExit(f"no checkpoint under {CHECKPOINT_RUN}")
        return t

    t0 = time.perf_counter()
    if args.warm == 'train-256':
        eager, graphed = make(False), make(None)
        for t in (eager, graphed, graphed, eager):
            t.train(20, verbose=False)
        torch.cuda.synchronize()
        print(f"warm: train-256 twins, eager {eager.losses[-1]:.6f}, graph "
              f"{graphed.losses[-1]:.6f}", flush=True)
    dense = dict(estimator='reference', laplacian_mode='dense')
    runs, records = {}, {}
    for name, record in (('recorded 1', True), ('recorded 2', True),
                         ('plain 3', False), ('plain 4', False)):
        t = make(False, **dense)
        if record:
            rec = Recorder()
            with rec:
                t.train(args.epochs, verbose=False)
            records[name] = rec.ops
        else:
            t.train(args.epochs, verbose=False)
        torch.cuda.synchronize()
        runs[name] = state_of(t)
        print(f"{name}: last loss {t.losses[-1]!r}", flush=True)
    names = list(runs)
    pairs = {f'{a} / {b}': max_rel(runs[a], runs[b])
             for i, a in enumerate(names) for b in names[i + 1:]}
    for k, v in pairs.items():
        print(f"{k}: largest relative difference {v:.3e}", flush=True)
    for name, ops in records.items():
        threads = {}
        switches = sum(1 for a, b in zip(ops, ops[1:]) if a[4] != b[4])
        for op in ops:
            threads[op[4]] = threads.get(op[4], 0) + 1
        print(f"{name}: ops per thread {sorted(threads.values())}, "
              f"{switches} switches between threads", flush=True)
    split = first_split(records['recorded 1'], records['recorded 2'])
    print(f"recorded ops per run: {len(records['recorded 1'])}; first split: "
          f"{split}", flush=True)
    if split is not None:
        i = split['index']
        for name in ('recorded 1', 'recorded 2'):
            print(f"{name}, ops {i - 12} to {i + 6}:", flush=True)
            for j in range(max(0, i - 12), i + 7):
                a = records[name][j]
                print(f"  op {j}: {a[0]} {list(map(list, a[1]))}, thread "
                      f"{a[4] % 10000}", flush=True)
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'warm': args.warm, 'epochs': args.epochs,
                      'multithreaded': args.multithreaded,
                      'max_rel': pairs, 'first_split': split,
                      'wall_s': time.perf_counter() - t0}), flush=True)


if __name__ == '__main__':
    main()
