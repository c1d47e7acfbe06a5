"""The kernels' bytes and operations, the model FLOP count and the trace
reduction, against hand-worked values."""

import pytest

from perfbench.flops import waveflow as flops
from perfbench.kernels import bound_s, k1, k3, shapes
from perfbench.trace import Trace

FLAGSHIP = dict(spline_degree=6, num_knots=23, n_electrons=2,
                n_space_dimension=1, n_spline_base_mesh_points=2000,
                n_flow_layers=3, hidden_dim=64)
H100 = 'NVIDIA H100 80GB HBM3'


def test_shapes():
    assert shapes(FLAGSHIP) == dict(D=2, n_B=28, n_I=29, n_cells=22, ncoef=8,
                                    n_mesh=2000, layers=3, hidden=64)


def test_k1_launch():
    # 4 (256·28 coefficients + 2·256 uniforms and draws + 28·2000 table)
    # and 256 (2·28·2000 + 8·1999)
    assert k1.launch(256, 28, 2000) == (254_720, 32_765_952)
    # operations bound it at 67 TFLOP/s: 32,765,952 / 67e12 s, twice a draw
    assert k1.bound_per_draw(FLAGSHIP, 256, H100) == pytest.approx(
        2 * 32_765_952 / 67e12)


def test_k3_jet():
    # 116 outputs a site; A_jet 22·8 × 116; 4 (512 + 20,416 + 59,392) bytes
    assert k3.jet(512, 29, 22, 8) == (321_280, 950_272)
    # 3 I-spline jets and one OB jet at 512 sites, each bound by bytes
    ob = 4 * (512 + 22 * 8 * 112 + 512 * 112)
    assert k3.bound_per_site_set(FLAGSHIP, 256, H100) == pytest.approx(
        (3 * 321_280 + ob) / 3.35e12)


def test_unknown_card_has_no_bound():
    assert bound_s(1.0, 1.0, 'some other card') is None
    assert k3.bound_per_site_set(FLAGSHIP, 256, 'cpu') is None


def test_model_flops():
    s = shapes(FLAGSHIP)
    assert flops.n_params(s) == 32_588
    assert flops.n_params(shapes(dict(FLAGSHIP, n_space_dimension=2))) == 48_280
    # IMADE: MLP 128 + 4096 + 3712, projection 1682, polynomials 928, dots
    # 116 = 10,662 (× 3); prior: MLP 7808, projection and change 3136,
    # polynomial 448, dot 56 = 11,448
    assert flops.psi_forward(s) == 3 * 10_662 + 11_448
    # the prior's 2 coordinates: 7808 + 1568 + 56,000 + 8000; the 3 × 2
    # inversions: 7936 + 841 + 58,000 + 696
    assert flops.draw(s) == 2 * 73_376 + 6 * 67_473
    assert flops.train_epoch(FLAGSHIP, 256) == 2 * (
        256 * (551_590 + 11 * 43_434) + 5 * 32_588)


def test_trace_busy_idle_and_breakdown():
    # a 10 µs window: kernels [1, 3] and [2, 4] overlap, [6, 7] alone
    tr = Trace(units=2, window_s=10e-6, busy_s=4e-6, start_us=0.0, end_us=10.0,
               device=[('void k_a<1>(float*)', 1.0, 2.0),
                       ('void k_b(float*)', 2.0, 2.0),
                       ('Memcpy DtoH', 6.0, 1.0)],
               host=[('cudaGraphLaunch', 4.5, 5.5), ('aten::copy_', 0.0, 0.8),
                     ('python', 4.0, 9.0)])
    assert tr.kernel_count() == 2
    assert tr.kernels(r'\bk_a<') == (1, pytest.approx(2e-6))
    assert tr._gaps() == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    b = tr.breakdown()
    assert b['device_ops'][0] == ['void k_a<1>(float*)', pytest.approx(2e-6)]
    gaps = dict(b['idle_gaps'])
    # midpoints 0.5 (aten::copy_), 5.0 (cudaGraphLaunch, the shortest
    # around it), 8.5 (python)
    assert gaps == {'aten::copy_': pytest.approx(1e-6),
                    'cudaGraphLaunch': pytest.approx(2e-6),
                    'python': pytest.approx(3e-6)}
