"""The port's oracles and fermion helpers against the JAX package's, on the
CPU: the exact-diagonalization / Richardson / free-fermion energies on small
grids (numpy on both sides), and the torch fermion functions against the
jnp ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse.linalg import eigsh

from waveflow_tpu.physics import exact as jexact
from waveflow_tpu.physics import fermion as jfermion
from waveflow_tpu.utils import observables as jobservables
from waveflow_tpu_torch.physics import exact, fermion
from waveflow_tpu_torch.utils import observables

torch.set_num_threads(2)

HE = np.array([[0.0]])
H2 = np.array([[-0.7], [0.7]])


def _same(a, b):
    """Equal to the bit, arrays and tuples of them included."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('name,args,kwargs', [
    ('exact_ground_state_1p', (HE, 6.0), dict(n_grid=300)),
    ('exact_ground_state_2p', (HE, 6.0), dict(n_grid=30)),
    ('exact_ground_state_2p', (H2, 6.0), dict(n_grid=24)),
    ('exact_ground_state_3p', (np.array([[0.0]]), 6.0), dict(n_grid=14)),
    ('exact_ground_state_3p', (np.zeros((0, 1)), 6.0),
     dict(n_grid=12, interactions=False)),
    ('exact_ground_state_1d', (HE, 2, 6.0), dict(n_grid=26)),
    ('richardson_ground_energy_1d', (HE, 2, 6.0), dict(n_grids=(20, 28))),
    ('richardson_ground_energy_1d', (HE, 1, 6.0), dict(n_grids=(200, 300))),
    ('exact_ground_state_2d_1e', (np.array([[0.0, 0.0]]), 5.0),
     dict(n_grid=20)),
    ('exact_ground_state_2d_2e', (np.array([[0.0, 0.0]]), 4.0),
     dict(n_grid=6)),
    ('exact_ground_state_2d_2e', (np.zeros((0, 2)), 4.0),
     dict(n_grid=6, interactions=False, n_states=2, x_sector=True)),
    ('exact_free_fermion_energy', (3, 10.0), {}),
    ('exact_free_fermion_energy_2d', (5, 10.0), {}),
])
def test_exact_matches_jax(monkeypatch, name, args, kwargs):
    """Each oracle of the port's physics/exact.py returns the JAX package's
    numbers, energies and states, to the bit.  ARPACK starts each solve
    from a random vector of its own (one call differs from the next by
    ~1e-13), so here both modules' eigsh start from the same vector."""
    def fixed_start(H, **kw):
        return eigsh(H, v0=np.ones(H.shape[0]), **kw)

    for module in (exact, jexact):
        monkeypatch.setattr(module, 'eigsh', fixed_start)

    def run(module):
        return getattr(module, name)(*args, **kwargs)

    _same(run(exact), run(jexact))


def test_exact_dispatch_raises_beyond_three():
    with pytest.raises(NotImplementedError):
        exact.exact_ground_state_1d(HE, 4, 6.0)


def test_fermion_matches_jax():
    """inversion_count, parity, sort_and_parity and abs2rel in torch
    against the jnp functions on the same rows (ties included): equal to the
    bit; rel2abs to one f32 ulp."""
    x = np.random.default_rng(0).normal(size=(200, 5)).astype(np.float32)
    x[:10, 3] = x[:10, 1]                                 # ties
    t = torch.as_tensor(x)
    _same(fermion.inversion_count(t).numpy(), jfermion.inversion_count(x))
    assert fermion.inversion_count(t).dtype == torch.int32
    _same(fermion.parity(t).numpy(), jfermion.parity(x))
    s, p = fermion.sort_and_parity(t)
    js, jp = jfermion.sort_and_parity(jnp.asarray(x))
    _same(s.numpy(), js)
    _same(p.numpy(), jp)
    rel = fermion.abs2rel(s)
    _same(rel.numpy(), jfermion.abs2rel(js))
    # XLA's cumsum adds in another order than torch's: one f32 ulp
    np.testing.assert_allclose(fermion.rel2abs(rel).numpy(),
                               np.asarray(jfermion.rel2abs(jfermion.abs2rel(js))),
                               rtol=2.5e-7, atol=1e-7)
    np.testing.assert_allclose(fermion.rel2abs(rel).numpy(), s.numpy(),
                               rtol=0, atol=1e-5)


def test_observables_match_jax():
    """The numpy copy of utils/observables.py gives the JAX package's
    numbers on a heavy-tailed trace, to the bit."""
    trace = -1.8 + 0.01 * np.random.default_rng(1).standard_t(2, size=5000)
    for name, kw in (('clipped_energy_estimate', dict(clip=2.0)),
                     ('median_energy_estimate', {})):
        _same(getattr(observables, name)(trace, **kw),
              getattr(jobservables, name)(trace, **kw))
    for name in ('uniform_sliding_average', 'uniform_sliding_stdev'):
        _same(getattr(observables, name)(trace, 100),
              getattr(jobservables, name)(trace, 100))
    assert observables.moving_average(1.0, 3.0, 0.25) == 1.5
