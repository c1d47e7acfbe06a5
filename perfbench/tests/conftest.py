"""The benchmark's own tests (run from the repository root:
``python -m pytest perfbench/tests -q``).  They run on the CPU; those
marked ``card`` need a CUDA device and skip without one (decided inside a
fixture, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA device; skips without one')


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker('card') is not None:
        import torch
        if not torch.cuda.is_available():
            pytest.skip('needs a CUDA device')


@pytest.fixture
def manifest():
    from perfbench import harness
    return harness.load_json(ROOT / 'BENCHMARK.json')


def tiny_cell(manifest, workload: str, **traffic):
    """A cell at a CPU test's size: the configuration's widths but fewer
    knots, a coarser mesh, two flow layers and the plain basis jet."""
    from perfbench import harness
    cell = harness.Cell(manifest, workload)
    cell.cfg = dict(cell.cfg, spline_degree=4, num_knots=8,
                    n_spline_base_mesh_points=300, n_flow_layers=2,
                    eval_backend='poly')
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


TRAIN_TINY = dict(batch_size=32, window=4)
