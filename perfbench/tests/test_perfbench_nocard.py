"""Without a card the run refuses: an exit code other than 0 and no result
line; the same in a directory that holds only the benchmark's files."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT


def _run(cwd):
    return subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload', 'he1d-train-b256',
         '--seed', str(2 ** 31 + 9), '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={'PATH': '/usr/bin:/bin', 'HOME': str(cwd),
             'CUDA_VISIBLE_DEVICES': ''})


def _no_result(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_refuses_without_a_card():
    _no_result(_run(ROOT))


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'perfbench', tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    _no_result(_run(tmp_path))
