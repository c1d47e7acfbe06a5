"""The PyTorch port stands alone: it imports neither JAX, optax,
scikit-learn nor the JAX package, and reads the JAX checkpoint without
them."""

import ast
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'optax', 'sklearn', 'waveflow_tpu', 'orbax')

SCRIPT = r"""
import sys
for name in ('jax', 'jaxlib', 'optax', 'sklearn', 'waveflow_tpu'):
    sys.modules[name] = None
import importlib, pkgutil
import torch
import waveflow_tpu_torch
for info in pkgutil.walk_packages(waveflow_tpu_torch.__path__,
                                  'waveflow_tpu_torch.'):
    importlib.import_module(info.name)
from waveflow_tpu_torch.convert import load_jax_checkpoint, params_from_jax
ck = load_jax_checkpoint(sys.argv[1])
sd = params_from_jax(ck['params'])
assert ck['epoch'] == 100000, ck['epoch']
assert len(sd) == 28 and sd['conditioner.zero_params'].shape == (2, 28)
from waveflow_tpu_torch.benchmark import get_dataset
assert get_dataset('circles', 64).shape == (64, 2)
assert get_dataset('gaussian_mixtures', 64).shape == (64, 2)
from waveflow_tpu_torch.benchmark.density import get_benchmark_model
rqs = get_benchmark_model('RQSFlow', device='cpu')
assert rqs.log_pdf(torch.rand(8, 2)).shape == (8,)
from waveflow_tpu_torch.convert import mcmc_state_from_jax
ck = load_jax_checkpoint(sys.argv[2])
assert ck['epoch'] == 100000, ck['epoch']
clip, (adam, scale) = ck['opt_state']
assert type(adam).__name__ == 'ScaleByAdamState', type(adam)
count, mu, nu = adam
assert int(count) == 100000 and mu.shape == nu.shape == (32588,)
assert [f.shape for f in ck['mcmc_state']] == [(256, 2), (256,), (), ()]
state = mcmc_state_from_jax(ck['mcmc_state'], 'cpu')
assert state.positions.shape == (256, 2) and state.step_size.ndim == 0
ck = load_jax_checkpoint(sys.argv[3])
state = mcmc_state_from_jax(ck['mcmc_state'], 'cpu')
assert type(state).__name__ == 'MALAState' and state.grad.shape == (256, 2)
print('ok')
"""


def test_imports_and_checkpoint_without_jax():
    """(i) With jax, optax, scikit-learn and waveflow_tpu made unimportable,
    every module of the port imports, the committed checkpoint loads, the
    circles and gaussian_mixtures datasets are generated (the latter's
    mixture fit without scikit-learn), an RQSFlow evaluates, and the
    Metropolis-trained checkpoint
    loads with its flat Adam moments and its MetropolisState, and the MALA
    run's 5-field MALAState."""
    ckpt = ROOT / 'results' / 'r5_flagship_fwd_batched_100k' / 'checkpoints'
    metro = ROOT / 'results' / 'he1d_metropolis_seed7' / 'checkpoints'
    mala = ROOT / 'results' / 'he1d_mala_s3' / 'checkpoints'
    out = subprocess.run([sys.executable, '-c', SCRIPT, str(ckpt), str(metro),
                          str(mala)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    """(i) No file of the port, nor chip_smoke.py, bench_torch.py or the
    port's example scripts, names jax, optax, sklearn or waveflow_tpu in an
    import (orbax neither: the port's OrbaxCheckpointer keeps its own
    files)."""
    files = sorted((ROOT / 'waveflow_tpu_torch').rglob('*.py'))
    files.extend([ROOT / 'chip_smoke.py', ROOT / 'bench_torch.py'])
    files.extend(sorted((ROOT / 'examples').glob('*_torch.py')))
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad


# the modules of the table backend and the density side: torch, numpy,
# scipy and the standard library only
NEW_MODULES = ('ops/spline_eval.py', 'ops/cuda_spline.py', 'ops/inverse.py',
               'bijections/rqs.py', 'bijections/core.py',
               'bijections/masks.py', 'models/priors.py', 'models/flow.py',
               'benchmark/datasets.py', 'benchmark/density.py')


def test_density_and_table_modules_import_torch_numpy_scipy_only():
    """The table evaluator's modules and the density side's import only
    torch, numpy, scipy, the standard library and the port itself."""
    allowed = {'torch', 'numpy', 'scipy', 'waveflow_tpu_torch', '__future__',
               'math', 'ctypes', 'functools', 'pathlib', 'warnings'}
    bad = [(name, m) for name in NEW_MODULES
           for m in _imported_roots(ROOT / 'waveflow_tpu_torch' / name)
           if m.split('.')[0] not in allowed]
    assert not bad, bad


# the last modules of the port: torch, numpy, scipy, the standard library
# and the port only; figures.py draws with matplotlib, which it imports
# inside ``_mpl`` alone, when a figure is drawn (a machine without
# matplotlib imports the whole port)
LAST_MODULES = ('compat.py', 'utils/profiling.py', 'utils/figures.py',
                'utils/checkpoint.py', 'vmc/artifacts.py')
STDLIB = {'__future__', 'contextlib', 'os', 'tempfile', 'time', 'pathlib',
          'importlib', 'pickle', 'typing', 'dataclasses'}


def _top_level_imports(path: Path):
    """The roots imported by statements outside any function body."""
    tree = ast.parse(path.read_text())
    in_fn = {id(n) for f in ast.walk(tree)
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(f) if n is not f}
    for node in ast.walk(tree):
        if id(node) in in_fn:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_last_modules_import_torch_numpy_scipy_only():
    """compat, profiling, figures, checkpoint and artifacts import only
    torch, numpy, scipy, the standard library and the port itself, with
    one stated exception: figures.py's matplotlib, imported inside a
    function only."""
    allowed = {'torch', 'numpy', 'scipy', 'waveflow_tpu_torch'} | STDLIB
    bad = [(name, m) for name in LAST_MODULES
           for m in _imported_roots(ROOT / 'waveflow_tpu_torch' / name)
           if m.split('.')[0] not in allowed
           and not (name == 'utils/figures.py'
                    and m.split('.')[0] == 'matplotlib')]
    assert not bad, bad
    figures = ROOT / 'waveflow_tpu_torch' / 'utils' / 'figures.py'
    assert any(m.startswith('matplotlib') for m in _imported_roots(figures))
    assert not [m for name in LAST_MODULES
                for m in _top_level_imports(ROOT / 'waveflow_tpu_torch' / name)
                if m.split('.')[0] == 'matplotlib']


def test_port_imports_without_matplotlib():
    """With matplotlib (and JAX) made unimportable, every module of the
    port imports, compat included, and figures.py says at draw time that
    it needs matplotlib."""
    script = (
        "import sys\n"
        "for name in ('matplotlib', 'jax', 'optax', 'sklearn', "
        "'waveflow_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, waveflow_tpu_torch\n"
        "for info in pkgutil.walk_packages(waveflow_tpu_torch.__path__, "
        "'waveflow_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "from waveflow_tpu_torch.utils import figures\n"
        "try:\n"
        "    figures.plot_pdf_grid([[0.0]], 'x.png')\n"
        "except ImportError:\n"
        "    print('ok')\n")
    out = subprocess.run([sys.executable, '-c', script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')
