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
FORBIDDEN = ('jax', 'jaxlib', 'optax', 'sklearn', 'waveflow_tpu')

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
    import."""
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
