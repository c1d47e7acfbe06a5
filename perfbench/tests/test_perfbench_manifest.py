"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, and every file of a cell found by name."""

import json
import re

import pytest

from perfbench.tests.conftest import ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
TEXT = re.compile(r'^[^\t\n]{1,200}$')
ENTRY_KEYS = {
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


def test_top_level(manifest):
    assert set(manifest) == {'command', 'paths', 'run_seconds', 'configs',
                             'workloads', 'end_to_end', 'per_layer'}
    assert manifest['command'] == ['python3', 'perfbench/run.py']
    assert manifest['paths'] == ['perfbench']
    assert isinstance(manifest['run_seconds'], int)
    assert 1 <= manifest['run_seconds'] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


def test_check_budget_fits(manifest):
    """2 + 14 × 24 runs of run_seconds + 60 s, each of 24 cells 180 s more
    to compile, and 1200 s spare, inside 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (manifest['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize('section', sorted(ENTRY_KEYS))
def test_entries(manifest, section):
    names = [e['name'] for e in manifest[section]]
    assert len(names) == len(set(names))
    for e in manifest[section]:
        extra = {'workloads'} if section in ('end_to_end', 'per_layer') else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra
        assert NAME.match(e['name']), e['name']
        for key in ('why', 'layer', 'source'):
            if key in e and section != 'end_to_end' and section != 'per_layer':
                assert TEXT.match(e[key]), e[key]
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
            assert e['source'] in ('device_trace', 'program_span',
                                   'program_counter', 'host_clock')
        if 'layer' in e:
            assert TEXT.match(e['layer'])


def test_end_to_end(manifest):
    e2e = {m['name']: m for m in manifest['end_to_end']}
    assert {'train_walkers_per_s', 'setup_s'} <= set(e2e)
    assert e2e['setup_s']['bound'] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')


def test_cells_find_their_files(manifest):
    from perfbench import harness
    configs = {c['name']: c for c in manifest['configs']}
    used = set()
    for w in manifest['workloads']:
        assert w['chips'] in (1, 4)
        assert NAME.match(w['traffic']) and w['config'] in configs
        used.add(w['config'])
        cell = harness.Cell(manifest, w['name'])
        assert cell.job().run
        assert (ROOT / 'perfbench' / 'limits' / f"{w['name']}.json").exists()
        for m in cell.per_layer:
            assert callable(cell.reader(m['name']).read)
        reported = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in reported and len(reported) >= 2
        assert cell.per_layer
    assert used == set(configs)
    files = [c['file'] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c['file'].startswith('perfbench/')
        cfg = json.loads((ROOT / c['file']).read_text())
        assert cfg['reduced'] == c['reduced']
        assert len(c['reduced']) <= 16


def test_per_layer_cells_report_what_they_move(manifest):
    e2e = {m['name']: m for m in manifest['end_to_end']}
    all_cells = [w['name'] for w in manifest['workloads']]
    layers = {}
    for m in manifest['per_layer']:
        assert m['moves'] in e2e
        moved_in = e2e[m['moves']].get('workloads', all_cells)
        assert set(m.get('workloads', moved_in)) <= set(moved_in)
        layers.setdefault(m['layer'], []).append(m['name'])
    perf = (ROOT / 'PERF.md').read_text()
    for layer in layers:
        assert f'| {layer} |' in perf, layer
