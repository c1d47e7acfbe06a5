"""Catalogue of few-electron systems (cf. utils/physics.py:6-26).

Each entry maps a system name to (proton coordinates, n_electrons) for a
given number of space dimensions.  Held as NumPy arrays; device transfer
happens where they are consumed.  Copy of waveflow_tpu/physics/systems.py
for the PyTorch port.
"""

from __future__ import annotations

import numpy as np

system_catalogue = {
    1: {
        'Laplacian_interactive_particles': (np.array([]), 2),
        'H': (np.array([[0.0]]), 1),
        'He+': (np.array([[0.0], [0.0]]), 1),
        'H2+': (np.array([[-0.9], [0.9]]), 1),
        'H2+_wide': (np.array([[-3.0], [3.0]]), 1),
        'He': (np.array([[0.0], [0.0]]), 2),
        'He_off_center': (np.array([[2.5], [2.5]]), 2),
        'H2': (np.array([[-0.9], [0.9]]), 2),
        'H2_wide': (np.array([[-3.0], [3.0]]), 2),
        # box fermions (no protons) — with interactions=False these are free
        # fermions whose exact ground energy is analytic (physics/exact.py),
        # the oracle for validating antisymmetric n>2 ansatze (new; the
        # reference's BoxTransform reverse is n=2-only, made.py:188)
        'box2': (np.array([]), 2),
        'box3': (np.array([]), 3),
        'box4': (np.array([]), 4),
        'Li': (np.array([[0.0], [0.0], [0.0]]), 3),
        # 4-electron soft-Coulomb "Be" (four protons at the origin) — no
        # grid-ED oracle exists at n=4 (C(n_grid,4) is intractable); judged
        # by the variational principle + the box4 free-fermion gate
        'Be': (np.array([[0.0], [0.0], [0.0], [0.0]]), 4),
    },
    2: {
        # 2D box fermions: with interactions=False the exact ground energy
        # is analytic (exact_free_fermion_energy_2d) — the oracle for the
        # antisym ansatz beyond n=2, where 2D pair-basis ED is intractable
        'box2': (np.array([]), 2),
        'box3': (np.array([]), 3),
        'H': (np.array([[0.0, 0.0]]), 1),
        'He+': (np.array([[0.0, 0.0], [0.0, 0.0]]), 1),
        'H2+': (np.array([[-0.9, 0.0], [0.9, 0.0]]), 1),
        'H2+_wide': (np.array([[-3.0, 0.0], [3.0, 0.0]]), 1),
        'He': (np.array([[0.0, 0.0], [0.0, 0.0]]), 2),
        'H2': (np.array([[-0.9, 0.0], [0.9, 0.0]]), 2),
        # 2D soft-Coulomb Li analog: 3 electrons, triple-charged center —
        # no oracle exists (2D ED is intractable at n=3); judged
        # variationally with the antisym ansatz
        'Li': (np.array([[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]), 3),
    },
}
