"""Parity of the PyTorch port's density-estimation path (MADE, Flow, IFlow,
MFlow, the benchmark datasets, metrics and trainer) with the JAX package,
on the CPU at a small size.

Weights are initialised by the JAX package and cross over through
waveflow_tpu_torch.convert; inputs and uniforms are drawn with numpy and
handed to both packages.  On CPU tensors the port's kernel wrappers (K2
in MFlow.sample, K4 in MFlow.log_pdf) run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveflow_tpu.benchmark import datasets as jdatasets
from waveflow_tpu.benchmark import density as jdensity
from waveflow_tpu.benchmark import metrics as jmetrics
from waveflow_tpu.bijections import MADE as JMADE
from waveflow_tpu.bijections import simple_masked_transform as jsimple
from waveflow_tpu_torch.benchmark import datasets, density, metrics
from waveflow_tpu_torch.bijections import MADE, simple_masked_transform
from waveflow_tpu_torch.convert import (
    flow_params_from_jax, mflow_params_from_jax)

torch.set_num_threads(2)

SMALL = dict(spline_reg=0.05, n_flow_layers=2, spline_degree=4, n_knots=8,
             n_mesh_points=300)
B = 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(model_name, seed=5):
    """The JAX model (params, log_pdf, sample) initialised as
    train_density_model initialises it, and the port's module carrying the
    same parameters."""
    rng = jax.random.PRNGKey(seed)
    _, flow_rng = jax.random.split(rng)
    init = jdensity.get_benchmark_model(model_name, **SMALL)
    jparams, jlog_pdf, jsample = init(flow_rng, 2)
    model = density.get_benchmark_model(
        model_name, **SMALL, generator=torch.Generator().manual_seed(0),
        device='cpu')
    convert = (mflow_params_from_jax if model_name == 'MFlow'
               else flow_params_from_jax)
    model.load_state_dict(convert(_np(jparams)))
    return jparams, jlog_pdf, jsample, model


@pytest.fixture(scope='module')
def pairs():
    return {name: _pair(name) for name in ('MFlow', 'Flow', 'IFlow')}


def test_made_forward_inverse_and_log_det():
    """(d) The affine MADE layer on converted JAX parameters: forward,
    log-det, the column-sequential inverse and its true log-det; rtol 1e-5 /
    atol 1e-5."""
    jparams, jdirect, jinverse = JMADE(jsimple())(jax.random.PRNGKey(1), 2)
    layer = MADE(simple_masked_transform(), 2, device='cpu')
    layer.load_state_dict({k[len('transform.layers.0.'):]: v for k, v in
                           flow_params_from_jax([_np(jparams)]).items()})
    x = np.random.default_rng(0).normal(size=(B, 2)).astype(np.float32)
    y_ref, ld_ref = jdirect(jparams, jnp.asarray(x))
    x_ref, ild_ref = jinverse(jparams, y_ref)
    with torch.no_grad():
        y, ld = layer(torch.as_tensor(x))
        x_back, ild = layer.inverse(torch.as_tensor(np.asarray(y_ref)))
    for got, ref in ((y, y_ref), (ld, ld_ref), (x_back, x_ref), (ild, ild_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(x_back.numpy(), x, atol=1e-5)
    np.testing.assert_allclose((ld + ild).numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize('model_name', ['MFlow', 'Flow', 'IFlow'])
def test_log_pdf_on_converted_parameters(pairs, model_name):
    """(d) log_pdf and its prior-space point u on converted JAX parameters;
    rtol 1e-5 / atol 1e-5.  The points lie inside the unit square, where
    all three models have support."""
    jparams, jlog_pdf, _, model = pairs[model_name]
    x = np.random.default_rng(1).uniform(0.03, 0.97, (B, 2)).astype(np.float32)
    ref, u_ref = jlog_pdf(jparams, jnp.asarray(x), return_sample=True)
    with torch.no_grad():
        got, u = model.log_pdf(torch.as_tensor(x), return_sample=True)
        alone = model.log_pdf(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(alone.numpy(), got.numpy())


def test_log_pdf_gradient_of_the_parameters(pairs):
    """The MLE loss's gradient through the table-lerp prior (its x-gradient
    is the order-1 table evaluation) and the flow: every parameter's
    gradient against jax.grad; rtol 1e-4 / atol 1e-6."""
    jparams, jlog_pdf, _, model = pairs['MFlow']
    x = np.random.default_rng(2).uniform(0.03, 0.97, (B, 2)).astype(np.float32)
    jgrads = jax.grad(lambda p: -jlog_pdf(p, jnp.asarray(x)).mean())(jparams)
    ref = mflow_params_from_jax(_np(jgrads))
    model.zero_grad()
    (-model.log_pdf(torch.as_tensor(x)).mean()).backward()
    # a parameter off the path (zero_params without the cubed-input
    # product) has no gradient in torch and a zero one in JAX
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in model.named_parameters()}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    model.zero_grad()


def test_mflow_sample_with_the_same_uniforms(pairs):
    """(d) MFlow.sample fed the uniforms of JAX's key schedule (one split +
    uniform per column, models/mflow.py:70-71) reproduces JAX's draws in
    data and prior space (atol 1e-5), and log_pdf(..., return_sample=True)
    maps them back to the prior draws."""
    jparams, _, jsample, model = pairs['MFlow']
    rng = jax.random.PRNGKey(3)
    final_ref, orig_ref = jsample(rng, jparams, num_samples=B,
                                  return_original_samples=True)
    us = []
    for _ in range(2):
        rng, split = jax.random.split(rng)
        us.append(np.asarray(jax.random.uniform(split, (B,))))
    final, orig = model.sample(B, u=torch.as_tensor(np.stack(us)),
                               return_original_samples=True)
    np.testing.assert_allclose(orig.numpy(), np.asarray(orig_ref), atol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(final_ref), atol=1e-5)
    assert model.sample(B, u=torch.as_tensor(np.stack(us))).equal(final)
    with torch.no_grad():
        _, back = model.log_pdf(final, return_sample=True)
    np.testing.assert_allclose(back.numpy(), orig.numpy(), atol=1e-5)
    assert metrics.reconstruction_distance(model, final, orig) < 1e-5


@pytest.mark.parametrize('model_name', ['Flow', 'IFlow'])
def test_flow_sample_round_trip(pairs, model_name):
    """Flow.sample draws its prior from the given generator and inverts the
    stack: log_pdf(..., return_sample=True) maps the draws back (atol 1e-4),
    and the same seed gives the same draws."""
    model = pairs[model_name][3]
    final, orig = model.sample(B, generator=torch.Generator().manual_seed(4),
                               return_original_samples=True)
    again = model.sample(B, generator=torch.Generator().manual_seed(4))
    assert final.shape == orig.shape == (B, 2) and again.equal(final)
    with torch.no_grad():
        _, back = model.log_pdf(final, return_sample=True)
    np.testing.assert_allclose(back.numpy(), orig.numpy(), atol=1e-4)


@pytest.mark.parametrize('model_name', ['MFlow', 'Flow'])
def test_training_losses_match_jax(model_name, tmp_path):
    """(e) The slice as a whole: 5 epochs of train_density_model from the
    same initial parameters on the same data give the JAX losses to rtol
    1e-4 (full batch, so each package's own permutation only reorders a
    sum), finite metrics of the same kinds, and the same files."""
    X = datasets.get_dataset('circles', 256)
    X_test = datasets.get_dataset('circles', 64, seed=7)
    kw = dict(model_name=model_name, num_epochs=5, learning_rate=1e-3,
              log_every=5, n_model_sample=200, verbose=False, X_test=X_test,
              **SMALL)
    _, _, _, jhist = jdensity.train_density_model(X, seed=5, **kw)
    model = _pair(model_name, seed=5)[3]
    trained, hist = density.train_density_model(
        X, **kw, device='cpu', model=model, save_dir=str(tmp_path),
        generator=torch.Generator().manual_seed(0))
    assert trained is model and len(hist['losses']) == 5
    np.testing.assert_allclose(hist['losses'], jhist['losses'], rtol=1e-4)
    assert set(hist) == set(jhist)
    for key in ('kl', 'hellinger', 'reconstruction', 'test_ll'):
        assert len(hist[key]) == len(jhist[key]) == 1
        assert np.isfinite(hist[key][0])
    # held-out LL after the same 5 steps: Adam's sign-like first steps leave
    # the parameters equal only to ~lr, so this is looser than the losses
    np.testing.assert_allclose(hist['test_ll'], jhist['test_ll'], atol=2e-2)
    assert hist['best_epoch'] == 5
    assert hist['best_test_ll'] == hist['test_ll'][0]
    model.load_state_dict(hist['best_params'])
    assert abs(metrics.held_out_log_likelihood(model, X_test)
               - hist['best_test_ll']) < 1e-6
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'hellinger_divergences.txt', 'kl_divergences.txt', 'losses.txt',
        'reconstruction_distances.txt', 'test_ll.txt']
    np.testing.assert_allclose(np.loadtxt(tmp_path / 'losses.txt'),
                               hist['losses'])


@pytest.mark.parametrize('name,n', [('circles', 256), ('double_circles', 255),
                                    ('halfmoon', 256), ('halfmoon', 255)])
def test_datasets_equal_the_jax_package(name, n):
    """(f) The numpy generators reproduce the JAX package's scikit-learn
    datasets point for point: np.random.RandomState(seed) gives
    scikit-learn's draw order (one shuffle, then the noise); atol 1e-6."""
    for seed in (42, 7):
        got = datasets.get_dataset(name, n, seed=seed)
        ref = jdatasets.get_dataset(name, n, seed=seed)
        assert got.dtype == np.float32 and got.shape == (n, 2)
        np.testing.assert_allclose(got, ref, atol=1e-6)
    assert got.min() >= 0.025 - 1e-6 and got.max() <= 0.975 + 1e-6


def test_unported_names_are_refused():
    with pytest.raises(ValueError):
        datasets.get_dataset('spiral', 16)
    with pytest.raises(ValueError):
        density.get_benchmark_model('NoFlow', device='cpu')


@pytest.mark.parametrize('chunk', [2048, 37])
def test_kde_matches_sklearn_exact(chunk):
    """(f) The torch Gaussian KDE against scikit-learn's KernelDensity at
    rtol=0, at bandwidth 0.01, whatever the chunk size: the log-density to
    1e-5 wherever the density is above e^-18 (589 of the 900 grid points).
    Below that scikit-learn's tree sum is no longer exact (it reads up to
    e^+85 times a float64 direct sum there), so the rest is held as a
    density, to 1e-8 absolute."""
    from sklearn.neighbors import KernelDensity
    samples = datasets.get_dataset('circles', 256)
    x = np.linspace(0.0, 1.0, 30)
    grid = np.stack(np.meshgrid(x, x), -1).reshape(-1, 2).astype(np.float32)
    ref = KernelDensity(kernel='gaussian', bandwidth=0.01, rtol=0).fit(
        samples).score_samples(grid)
    got = metrics.gaussian_kde_log_density(
        torch.as_tensor(samples), torch.as_tensor(grid), 0.01, chunk=chunk)
    dense = ref > -18.0
    assert dense.sum() > 500
    np.testing.assert_allclose(got.numpy()[dense], ref[dense], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.exp(got.numpy()), np.exp(ref), rtol=1e-5,
                               atol=1e-8)
    exact = metrics.gaussian_kde_log_density(
        torch.as_tensor(samples).double(), torch.as_tensor(grid).double(), 0.01)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_kde_metrics_against_jax(pairs):
    """(f) kde_metrics, the bandwidth sweep, the grid and the held-out LL
    against the JAX package on the same model and samples.  The JAX KDE is
    scikit-learn's with rtol=0.1, and far from every sample its log-density
    is off by tens (see test_kde_matches_sklearn_exact); the KL of this
    untrained, broad model is a pdf-weighted mean of log ratios dominated by
    such points (KL ≈ 28), so KL is held to 5% and Hellinger² to 0.05
    absolute."""
    jparams, jlog_pdf, _, model = pairs['MFlow']
    samples = datasets.get_dataset('circles', 200, seed=3)
    lp, grid = metrics.pdf_grid_eval(model, ngrid=40)
    jlp, jgrid = jmetrics.pdf_grid_eval(jlog_pdf, jparams, ngrid=40)
    np.testing.assert_array_equal(grid.numpy(), jgrid)
    np.testing.assert_allclose(lp.numpy(), jlp, rtol=1e-5, atol=1e-5)
    kl, hell = metrics.kde_metrics(model, samples, ngrid=60)
    jkl, jhell = jmetrics.kde_metrics(jlog_pdf, jparams, samples, ngrid=60)
    assert abs(kl - jkl) <= 0.05 * abs(jkl) and abs(hell - jhell) <= 0.05
    sweep = metrics.kde_bandwidth_sweep(model, samples, (0.01, 0.05), ngrid=60)
    assert sweep[0.01] == (kl, hell) and set(sweep) == {0.01, 0.05}
    np.testing.assert_allclose(
        metrics.held_out_log_likelihood(model, samples),
        jmetrics.held_out_log_likelihood(jlog_pdf, jparams, samples),
        rtol=1e-5, atol=1e-5)
