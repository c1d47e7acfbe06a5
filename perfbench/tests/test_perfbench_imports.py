"""What a run loads: no module whose top-level name is jax, jaxlib, flax,
optax or waveflow_tpu (compared as whole names: the port's name begins
with the JAX package's), and a reference that imports nothing of the
program."""

import ast
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'waveflow_tpu'}

# everything a run imports: the harness, every job and reader, the
# reference, and the port's modules the jobs call into
PROBE = """
import sys, json
sys.path.insert(0, {root!r})
from perfbench import harness, calibrate, checks, trace
from perfbench.reference import vmc, waveflow
m = harness.load_json(harness.HERE.parent / 'BENCHMARK.json')
for w in m['workloads']:
    cell = harness.Cell(m, w['name'])
    cell.job()
    for metric in cell.per_layer:
        cell.reader(metric['name'])
from waveflow_tpu_torch.vmc import VMCTrainer, VMCConfig
from waveflow_tpu_torch.vmc.estimators import run_window
from waveflow_tpu_torch.vmc.metropolis import sector_mode
from waveflow_tpu_torch.ops import cuda_build
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
"""


def test_a_run_loads_nothing_of_jax():
    out = subprocess.run([sys.executable, '-c', PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         env={'PATH': '/usr/bin:/bin', 'HOME': str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(__import__('json').loads(out.stdout.strip().splitlines()[-1]))
    assert 'waveflow_tpu_torch' in top
    assert not (top & FORBIDDEN), top & FORBIDDEN


@pytest.mark.parametrize('name,bad', [
    ('waveflow_tpu_torch.vmc', False), ('waveflow_tpu', True),
    ('waveflow_tpu.ops', True), ('jaxlib.xla_client', True),
    ('jaxtyping', False), ('optax', True)])
def test_forbidden_by_whole_top_level_name(monkeypatch, name, bad):
    from perfbench import harness
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.forbidden_modules()) is bad


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ''


@pytest.mark.parametrize('path', sorted((ROOT / 'perfbench' / 'reference').glob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split('.')[0]
        assert top not in FORBIDDEN | {'waveflow_tpu_torch'}, name
        assert top in {'__future__', 'math', 'numpy', 'torch', 'perfbench'}, name


@pytest.mark.parametrize('path', sorted((ROOT / 'perfbench').rglob('*.py')),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax(path):
    for name in _imports(path):
        assert name.split('.')[0] not in FORBIDDEN, (path, name)
