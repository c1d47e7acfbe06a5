"""The 2D two-electron ED oracle on the PyTorch/CUDA port (cf.
benchmarks/oracle_2d2e.py): the exact ground energies of the catalogue's
2D two-electron entries, He and H2 (``system_catalogue[2]``, L = 5), at the
JAX script's grids 24, 32 and 40, and their Richardson value in h², h ∝
1/(n + 1), from the two finest grids.

The ED is the port's ``physics/exact.py::exact_ground_state_2d_2e``: sparse
float64 H in the antisymmetric site-pair basis, its lowest eigenvalue by
SciPy's ``eigsh(H, k=1, which='SA')`` at its default tolerance, tol=0
(ARPACK to machine precision), as in the JAX package.  It runs on the host,
as JAX's does (10-20 min on a CPU for both systems); there is no card in
it, so the rows name no device and ``--device`` takes only 'cpu'.

Rows go to ``<out-dir>/oracle_2d_2e.json`` with the JAX file's keys
(``protons``, ``box_length``, ``energies`` by grid, ``richardson_32_40``); a
grid already there is not computed again.  Nothing is written under
results/, which is read only: each row is printed as one JSON line with
the committed results/oracle_2d_2e.json row beside it and the gate, every
energy and the Richardson value within ORACLE_TOL of the committed ones.

    python3 examples/oracle_2d2e_torch.py
    python3 examples/oracle_2d2e_torch.py --keys H2_2d_L5 --out-dir runs/oracle
    python3 examples/oracle_2d2e_torch.py --grids 6,8 --out-dir runs/tiny
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

from waveflow_tpu_torch.physics import (exact_ground_state_2d_2e,
                                        system_catalogue)

JAX_ROWS = REPO / 'results' / 'oracle_2d_2e.json'
OUT_NAME = 'oracle_2d_2e.json'
BOX_LENGTH = 5.0
GRIDS = (24, 32, 40)
SYSTEMS = ('He', 'H2')
# |E_port − E_committed| allowed at every grid and for the Richardson value
ORACLE_TOL = 1e-6


def richardson(e_coarse, e_fine, n_coarse, n_fine):
    """O(h²) Richardson extrapolation, h ∝ 1/(n+1)."""
    r = ((n_coarse + 1) / (n_fine + 1)) ** -2
    return e_fine + (e_fine - e_coarse) / (r - 1)


def row_key(name: str) -> str:
    return f"{name}_2d_L{BOX_LENGTH:g}"


def extrapolate(energies: dict, grids) -> float:
    """The Richardson value from the two finest of ``grids``."""
    n_c, n_f = sorted(grids)[-2:]
    return richardson(energies[str(n_c)], energies[str(n_f)], n_c, n_f)


def gate(rec: dict, ref: dict | None):
    """|port − committed| at every grid both hold and for the Richardson
    value, against ORACLE_TOL; None where the committed file has no row or
    shares no grid."""
    if ref is None:
        return None
    diffs = {n: abs(e - ref['energies'][n]) for n, e in rec['energies'].items()
             if n in ref['energies']}
    if not diffs:
        return None
    if set(rec['energies']) == set(ref['energies']):
        diffs['richardson'] = abs(rec['richardson_32_40']
                                  - ref['richardson_32_40'])
    return dict(tol=ORACLE_TOL, abs_diff=diffs,
                in_gate=bool(max(diffs.values()) <= ORACLE_TOL))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', default=None,
                    help='run only rows whose key starts with this')
    ap.add_argument('--keys', default=None,
                    help='comma list of rows (He_2d_L5, H2_2d_L5)')
    ap.add_argument('--grids', default=None,
                    help="comma list of grids (default: the JAX script's "
                         "24,32,40)")
    ap.add_argument('--out-dir', default='runs/oracle_2d2e',
                    help=f'where {OUT_NAME} goes')
    ap.add_argument('--device', default='cpu', choices=('cpu',),
                    help='the ED runs on the host only')
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    grids = (tuple(int(n) for n in args.grids.split(','))
             if args.grids else GRIDS)
    keys = None if args.keys is None else args.keys.split(',')
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / OUT_NAME
    out = json.loads(path.read_text()) if path.exists() else {}
    committed = json.loads(JAX_ROWS.read_text())
    print("oracle_2d2e_torch: host ED (SciPy eigsh, tol=0), no card",
          flush=True)
    in_gate = True
    for name in SYSTEMS:
        key = row_key(name)
        if (keys is not None and key not in keys) or (
                args.only is not None and not key.startswith(args.only)):
            continue
        protons, n_el = system_catalogue[2][name]
        assert n_el == 2
        rec = out.get(key, {'protons': np.asarray(protons).tolist(),
                            'box_length': BOX_LENGTH, 'energies': {}})
        walls = {}
        for n in grids:
            if str(n) in rec['energies']:
                continue
            t0 = time.time()
            e, _, _, _ = exact_ground_state_2d_2e(protons, BOX_LENGTH,
                                                  n_grid=n)
            walls[str(n)] = time.time() - t0
            rec['energies'][str(n)] = e
            print(f"{key} n={n}: E={e:.10f} ({walls[str(n)]:.0f}s)",
                  flush=True)
            out[key] = rec
            path.write_text(json.dumps(out, indent=2))
        rec['richardson_32_40'] = extrapolate(
            rec['energies'], [int(n) for n in rec['energies']])
        out[key] = rec
        path.write_text(json.dumps(out, indent=2))
        ref = committed.get(key)
        verdict = gate(rec, ref)
        in_gate &= verdict is None or verdict['in_gate']
        print(json.dumps({'key': key, **rec, 'wall_s': walls, 'jax': ref,
                          'gate': verdict,
                          'host': 'cpu (SciPy eigsh, tol=0; no card)'}),
              flush=True)
    return 0 if in_gate else 1


if __name__ == '__main__':
    sys.exit(main())
