"""Parity of the port's reference-API layer (waveflow_tpu_torch/compat.py)
with the JAX package's (waveflow_tpu/compat.py), on the CPU at
tests/test_compat.py's shapes.

JAX's ``initial`` spline parameters cross to the port as numpy; the
sampler entries are fed the uniforms that JAX's per-row keys give; the
density model's weights cross by convert.py.  On CPU tensors every kernel
wrapper runs its plain PyTorch version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu import compat as jcompat
from waveflow_tpu_torch import compat
from waveflow_tpu_torch.convert import mflow_params_from_jax

torch.set_num_threads(2)

RNG = jax.random.PRNGKey(8)
# test_compat.py's calls: (kind, factory args, rows)
CASES = {
    'I': (dict(k=5, n_internal_knots=15, reverse_fun_tol=1e-5,
               n_mesh_points=1000, constraints_dict_left={0: 0.0},
               constraints_dict_right={0: 1.0}), 64),
    'M': (dict(k=4, n_internal_knots=10, n_mesh_points=800,
               constraints_dict_left={0: 0.0},
               constraints_dict_right={0: 0.0}), 32),
    'B': (dict(k=5, n_internal_knots=12, n_mesh_points=800,
               constraints_dict_left={0: 0.0},
               constraints_dict_right={0: 0.0}), 32),
}
FACTORIES = {'I': 'ISpline_fun', 'M': 'MSpline_fun', 'B': 'BSpline_fun'}


@pytest.fixture(scope='module')
def splines():
    """Per kind: the JAX tuple, the port's tuple, and the constrained
    parameters (n rows of JAX's ``initial``, de-biased and projected by
    JAX) as JAX and as a CPU tensor."""
    out = {}
    for kind, (kw, n) in CASES.items():
        jt = getattr(jcompat, FACTORIES[kind])()(RNG, **kw)
        pt = getattr(compat, FACTORIES[kind])()(8, **kw, device='cpu')
        jp = jnp.tile(jt[0][None], (n, 1))
        if kind != 'B':
            jp = jt[6](jp)
        jp = jt[5](jp)
        out[kind] = (jt, pt, jp, torch.as_tensor(np.array(jp)))
    return out


@pytest.mark.parametrize('kind', 'IMB')
def test_factory_tuples_and_initial(splines, kind):
    """The reference's tuples (7 / 7 / 6 entries); the port's ``initial``
    has JAX's shape and normalisation (sum 1 for M / I, unit l2 for B),
    and its knots are JAX's."""
    jt, pt = splines[kind][:2]
    assert len(pt) == len(jt) == (6 if kind == 'B' else 7)
    initial = pt[0].numpy()
    assert initial.shape == np.asarray(jt[0]).shape
    norm = (np.sqrt((initial ** 2).sum()) if kind == 'B' else initial.sum())
    assert abs(norm - 1.0) < 1e-6
    if kind != 'B':
        assert (initial > 0).all()
    np.testing.assert_allclose(pt[4].numpy(), np.asarray(jt[4]), rtol=1e-7)


@pytest.mark.parametrize('kind', 'IMB')
def test_enforce_and_remove_bias(splines, kind):
    """``enforce`` and ``remove_bias`` on JAX's ``initial`` tiled: rtol
    1e-6 of JAX's."""
    jt, pt, _, _ = splines[kind]
    n = CASES[kind][1]
    p0 = np.tile(np.asarray(jt[0])[None], (n, 1))
    steps = [(5, 5)] if kind == 'B' else [(6, 6), (5, 5)]
    jp, p = jnp.asarray(p0), torch.as_tensor(p0)
    for j_i, p_i in steps:
        jp, p = jt[j_i](jp), pt[p_i](p)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize('kind', 'IMB')
def test_apply_fun_vec_and_its_grad(splines, kind):
    """``apply_fun_vec`` (K4 order 0 on the card) rtol 1e-5 / atol 1e-5
    and ``apply_fun_vec_grad`` (order 1) within 2e-5 of max|ref| of JAX's,
    on the constrained parameters at points across [0, 1]."""
    jt, pt, jp, p = splines[kind]
    n = CASES[kind][1]
    xx = np.linspace(0.0, 1.0, n).astype(np.float32)
    xx[1:-1] += np.random.default_rng(0).uniform(-0.3, 0.3, n - 2) / n
    y_ref = np.asarray(jt[1](jp, jnp.asarray(xx)))
    g_ref = np.asarray(jt[2](jp, jnp.asarray(xx)))
    y = pt[1](p, torch.as_tensor(xx)).numpy()
    g = pt[2](p, torch.as_tensor(xx)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g, g_ref, atol=2e-5 * np.abs(g_ref).max())


def test_reverse_fun_vec(splines):
    """The I-spline's ``reverse_fun_vec`` (the exact table inverse) at
    JAX's forward values: atol 1e-5 of JAX's inverse, and it inverts."""
    jt, pt, jp, p = splines['I']
    xx = jnp.linspace(0.01, 0.99, CASES['I'][1])
    ys = jt[1](jp, xx)
    ref = np.asarray(jt[3](jp, ys))
    got = pt[3](p, torch.as_tensor(np.asarray(ys))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xx), atol=1e-4)


@pytest.mark.parametrize('kind', 'MB')
def test_sample_fun_vec_from_jax_uniforms(splines, kind):
    """``sample_fun_vec`` (one K2 launch for 'M', one K1 for 'B', over all
    rows × samples) fed the uniforms JAX draws from its per-row keys:
    atol 6e-5 of JAX's draws (test_torch_ops.py::
    test_sample_squared_amplitude's tolerance); the port's own entry draws
    (B, num_samples) in [0, 1] from an int seed, and one row of params
    gives (1, num_samples)."""
    jt, pt, jp, p = splines[kind]
    n, s = CASES[kind][1], 3
    keys = jax.random.split(RNG, n)
    u = np.asarray(jax.vmap(lambda r: jax.random.uniform(r, (s,)))(keys))
    ref = np.asarray(jt[3](keys, jp, s))
    got = pt[3]._from_uniforms(p, torch.as_tensor(u)).numpy()
    assert got.shape == ref.shape == (n, s)
    np.testing.assert_allclose(got, ref, atol=6e-5)
    own = pt[3](3, p, s)
    assert own.shape == (n, s) and ((own >= 0) & (own <= 1)).all()
    assert pt[3](torch.Generator().manual_seed(3), p[0], 5).shape == (1, 5)


def _jax_config(trainer):
    """The VMCConfig JAX's ModelTrainer.start_training builds, captured in
    place of its trainer."""
    import waveflow_tpu.vmc as jvmc
    seen = {}

    class Capture:
        def __init__(self, cfg):
            seen['cfg'] = cfg

        def train(self, restart=False):
            return []

    real, jvmc.VMCTrainer = jvmc.VMCTrainer, Capture
    try:
        trainer.start_training()
    finally:
        jvmc.VMCTrainer = real
    return seen['cfg']


def test_model_trainer_config_equals_jax():
    """After the same attribute pokes, the port's ModelTrainer builds a
    VMCConfig equal to JAX's on every shared field, and JAX's fields are a
    subset of the port's.  Except compilation_cache_dir, which the port
    accepts with no effect: its default there is None, a directory JAX
    names under the home directory."""
    from dataclasses import asdict
    pokes = dict(num_knots=8, spline_degree=4, n_flow_layer=1, window=50,
                 xu_coord_type='first', save_dir='somewhere')
    jt = jcompat.ModelTrainer(system_name='Li', box_length=5, num_epochs=40,
                              batch_size=16, log_every=100)
    pt = compat.ModelTrainer(system_name='Li', box_length=5, num_epochs=40,
                             batch_size=16, log_every=100, device='cpu')
    for k, v in pokes.items():
        setattr(jt, k, v)
        setattr(pt, k, v)
    jcfg, cfg = asdict(_jax_config(jt)), asdict(pt.config())
    assert set(jcfg) <= set(cfg)
    assert cfg.pop('compilation_cache_dir') is None
    jcfg.pop('compilation_cache_dir')
    assert {k: cfg[k] for k in jcfg} == jcfg
    assert cfg['device'] == 'cpu'
    assert compat.ModelTrainer().config().device == 'cuda'


def test_model_trainer_start_training(tmp_path):
    """tests/test_compat.py's trainer on the CPU: 4 finite losses, and the
    checkpoint written under the poked save_dir."""
    trainer = compat.ModelTrainer(system_name='He', box_length=5,
                                  num_epochs=4, batch_size=16, log_every=100,
                                  device='cpu')
    trainer.num_knots = 8
    trainer.spline_degree = 4
    trainer.n_flow_layer = 1
    trainer.save_dir = str(tmp_path)
    losses = trainer.start_training()
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert (tmp_path / 'checkpoints').exists()


@pytest.mark.parametrize('rng', [None, jax.random.PRNGKey(3), 11])
def test_get_dataset_equals_jax(rng):
    """get_dataset reads the seed as JAX's compat does (the key's last
    element; 0 for None; an int as itself) and gives JAX's points, atol
    1e-6."""
    got = compat.get_dataset('circles', 200, 0.025, rng=rng)
    jrng = rng if not isinstance(rng, int) else np.array([0, rng])
    ref = jcompat.get_dataset('circles', 200, 0.025, rng=jrng)
    assert got.shape == (200, 2)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_get_model_log_pdf_and_sample():
    """get_model('MFlow')'s init_fun: ``params`` a dict of tensors;
    ``log_pdf`` under JAX's parameters crossed by convert.py equals JAX's
    log_pdf at rtol 1e-5 / atol 1e-5, and under the port's own parameters
    it is the module's; ``sample`` draws (n, 2) points in [0, 1] under
    either; an unknown model type raises ValueError."""
    kw = dict(spline_degree=3, num_knots=8, num_layers=1)
    jparams, jlog_pdf, _ = jcompat.get_model('MFlow', 0.05, **kw)(
        jax.random.PRNGKey(0), 2)
    params, log_pdf, sample = compat.get_model('MFlow', 0.05, **kw,
                                               device='cpu')(0, 2)
    assert all(isinstance(v, torch.Tensor) for v in params.values())
    crossed = mflow_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jparams))
    assert set(crossed) <= set(params)
    X = compat.get_dataset('circles', 64, 0.025)
    ref = np.asarray(jlog_pdf(jparams, jnp.asarray(X)))
    with torch.no_grad():
        got = log_pdf({**params, **crossed}, X).numpy()
        own = log_pdf(params, X)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert not np.allclose(own.numpy(), got)
    for p in (params, {**params, **crossed}):
        s = sample(4, p, 50)
        assert s.shape == (50, 2) and ((s >= 0) & (s <= 1)).all()
    assert torch.equal(sample(4, params, 50), sample(4, params, 50))
    with pytest.raises(ValueError):
        compat.get_model('RQSFlow', 0.05, device='cpu')


def test_train_model_files_equal_jax(tmp_path):
    """tests/test_compat.py's reference-style train_model call on both
    packages: the same run directory name, the same files with the same
    line counts (check_step 20 over 40 epochs: 2 metric checkpoints); the
    port returns (params, log_pdf, sample); an unknown keyword raises
    TypeError."""
    X = jcompat.get_dataset('circles', 200, 0.025)
    kw = dict(model_type='MFlow', dataset_name='circles', check_step=20,
              spline_reg=0.05, num_flow_layer=1, spline_degree=3,
              num_knots=8)
    jcompat.train_model(X, 40, 500, **kw, save_dir=str(tmp_path / 'jax'))
    params, log_pdf, sample = compat.train_model(
        X, 40, 500, **kw, save_dir=str(tmp_path / 'port'), device='cpu')
    jdir = tmp_path / 'jax' / 'circles' / 'MFlow_0.05_1_3_8'
    pdir = tmp_path / 'port' / 'circles' / 'MFlow_0.05_1_3_8'
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in pdir.iterdir()) == names
    assert 'losses.txt' in names and 'kl_divergences.txt' in names
    for name in names:
        assert (len(np.atleast_1d(np.loadtxt(pdir / name)))
                == len(np.atleast_1d(np.loadtxt(jdir / name)))), name
    assert len(np.loadtxt(pdir / 'losses.txt')) == 40
    assert len(np.loadtxt(pdir / 'kl_divergences.txt')) == 2
    with torch.no_grad():
        assert log_pdf(params, X[:8]).shape == (8,)
    assert sample(0, params, 8).shape == (8, 2)
    with pytest.raises(TypeError):
        compat.train_model(X, 10, 100, bogus_option=3, device='cpu')


def test_flow_save_dir_naming(tmp_path):
    """The 'Flow' model's run directory drops the spline fields, as in the
    reference."""
    X = compat.get_dataset('circles', 64, 0.025)
    compat.train_model(X, 2, 64, model_type='Flow', dataset_name='circles',
                       check_step=2, num_flow_layer=1,
                       save_dir=str(tmp_path), device='cpu')
    assert (tmp_path / 'circles' / 'Flow_1' / 'losses.txt').exists()


def test_reference_names():
    """The re-exported names and get_masked_transform's two factories."""
    from waveflow_tpu_torch import bijections, models
    from waveflow_tpu_torch.bijections.masks import (MaskedConditioner,
                                                     MaskedMLP)
    assert compat.BoxTransformLayer is bijections.BoxTransformLayer
    assert compat.MFlow is models.MFlow and compat.Waveflow is models.Waveflow
    assert isinstance(compat.get_masked_transform(True)(2), MaskedMLP)
    assert isinstance(compat.get_masked_transform()(2, 5), MaskedConditioner)
