"""The benchmark's core: finds a cell's files by name, checks for the
card, runs the cell's job, reads the per-layer metrics and prints the
result line.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
and a traffic mix.  Each is a data file found by name:

  * ``configs/<config>.json``: the model and its training recipe; keys that
    are fields of the port's ``VMCConfig`` are handed to it, the rest (the
    protons, the MLP width, the clip scale) serve the reference and the
    counts;
  * ``traffic/<traffic>.json``: the job (``"job"`` names ``jobs/<job>.py``)
    and its sizes; keys that are ``VMCConfig`` fields go to it too;
  * ``limits/<workload>.json``: the limit of each number the correctness
    check compares;
  * ``metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'waveflow_tpu')


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload with its configuration, traffic, limits (from its file
    unless given) and metrics."""

    def __init__(self, manifest: dict, name: str, root: Path = HERE.parent,
                 limits: dict | None = None):
        cells = {w['name']: w for w in manifest['workloads']}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                           f"{sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        self.chips = self.workload['chips']
        configs = {c['name']: c for c in manifest['configs']}
        self.cfg = load_json(root / configs[self.workload['config']]['file'])
        self.traffic = load_json(HERE / 'traffic' / f"{self.workload['traffic']}.json")
        self.limits = (load_json(HERE / 'limits' / f'{name}.json')
                       if limits is None else limits)
        self.end_to_end = [m for m in manifest['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in manifest['per_layer']
                          if name in m.get('workloads', [name])]

    def reader(self, metric: str):
        return load_module(HERE / 'metrics' / f'{metric}.py',
                           'perfbench_metric_' + metric.replace('.', '_'))

    def job(self):
        return load_module(HERE / 'jobs' / f"{self.traffic['job']}.py",
                           f"perfbench_job_{self.traffic['job']}")


def derive_seed(seed: int, tag: str) -> int:
    """A 62-bit seed for one stream of the run (weights, walkers), a function of the run's seed and the stream's tag only."""
    digest = hashlib.sha256(f'{seed}:{tag}'.encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> 2


class Spans:
    """Host-clock spans of the run, by name, in seconds (synchronised on
    the card where ``sync`` is given)."""

    def __init__(self, sync=None):
        self.seconds: dict = {}
        self.sync = sync or (lambda: None)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def make_weights(cfg: dict, seed: int, device):
    """The model's parameters from the seed, made on ``device`` in float32
    by one generator call: each leaf uniform on ±its bound (reference/
    waveflow.py::parameter_layout).  Returns {name: tensor}."""
    import torch

    from perfbench.reference.waveflow import parameter_layout
    layout = parameter_layout(cfg)
    total = sum(int(torch.Size(shape).numel()) for _, shape, _ in layout)
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 'weights'))
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, offset = {}, 0
    for name, shape, bound in layout:
        n = int(torch.Size(shape).numel())
        out[name] = (flat[offset:offset + n] * bound).reshape(shape)
        offset += n
    return out


def load_weights(module, weights: dict) -> None:
    """Copy ``weights`` into the module's parameters, name by name; the two
    sets of names and shapes must agree."""
    import torch
    own = dict(module.named_parameters())
    if set(own) != set(weights):
        raise KeyError("the model's parameters are not the configuration's: "
                       f"{sorted(set(own) ^ set(weights))}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(weights[name].reshape(p.shape))


def vmc_config(cell: Cell, seed: int, device, **overrides):
    """The port's trainer configuration of the cell."""
    from dataclasses import fields

    from waveflow_tpu_torch.vmc import VMCConfig
    known = {f.name for f in fields(VMCConfig)}
    kw = {k: v for k, v in {**cell.cfg, **cell.traffic}.items() if k in known}
    kw.update(seed=derive_seed(seed, 'init') >> 31, device=device, **overrides)
    return VMCConfig(**kw)


def power_limit() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'unknown'


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


def percentile(values, q: int) -> float:
    """The q-th percentile (statistics.quantiles, exclusive method), or the
    largest value when there are too few."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=100)[q - 1]


def judge(numbers: dict, limits: dict):
    """(correct, checks): each compared number beside its limit; a missing
    or non-finite number fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and value == value and value <= limit
        correct = correct and ok
        checks[name] = {'value': value, 'limit': limit}
    return correct, checks


def run(args, t0: float) -> int:
    manifest = load_json(HERE.parent / 'BENCHMARK.json')
    cell = Cell(manifest, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " — no result", file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    job = cell.job()
    out = job.run(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad} — no result", file=sys.stderr)
        return 3
    return emit(cell, out, bool(args.trace), device)


def emit(cell: Cell, out: dict, trace: bool, device) -> int:
    """Print the result line; ``out`` is what the job returned."""
    import torch
    correct, checks = judge(out['numbers'], cell.limits)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m['name']).read(out['context'])
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': out['metrics'][m['name']],
                               'unit': m['unit']} for m in cell.end_to_end}
    dev = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
           'count': cell.chips, 'memory_peak_bytes': out['memory_peak_bytes'],
           'power': power_limit()}
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics, 'device': dev}
    if trace and out['context'].trace is not None:
        tr = out['context'].trace
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result['breakdown'] = tr.breakdown()
    result['checks'] = checks
    print(json.dumps(result), flush=True)
    split = ' '.join(f'{k} {v:.3f}' for k, v in out['context'].spans.items())
    print(f"set-up split (s): {split}", file=sys.stderr)
    windows = ' '.join(f'{t:.4f}' for t in out['context'].windows)
    print(f"windows (s): {windows}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0
