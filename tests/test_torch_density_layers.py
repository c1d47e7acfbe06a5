"""Parity of the port's density-side layers with the JAX package, on the
CPU: the rational-quadratic spline and its coupling, the 'RQSFlow' model
and one MLE step of it, every core combinator (direct and inverse with
the log-det), ``batchnorm_update_stats``, the ``GMM`` prior, ``InvFlow``,
``masked_mlp`` and the ``gaussian_mixtures`` dataset (against
scikit-learn's fit and the JAX package's draws).  Parameters cross by
``convert.module_state_from_jax``; inputs are made with numpy from a
seed."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.nn.initializers import orthogonal

from waveflow_tpu import bijections as jbj
from waveflow_tpu.benchmark import datasets as jdatasets
from waveflow_tpu.benchmark import density as jdensity
from waveflow_tpu.models import GMM as JGMM
from waveflow_tpu_torch import bijections as bj
from waveflow_tpu_torch.benchmark import datasets, density
from waveflow_tpu_torch.convert import module_state_from_jax
from waveflow_tpu_torch.models import GMM, Flow, InvFlow

torch.set_num_threads(2)

RNG = jax.random.PRNGKey(0)
N, D = 32, 4


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _perturbed(tree, seed, scale=0.3):
    """Every leaf of a params tree plus N(0, scale²) noise: the couplings
    start as the identity, which would test nothing."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a))
                   ).astype(np.float32), tree)


def _inputs(seed=1, n=N, d=D, scale=1.5):
    return (scale * np.random.default_rng(seed).normal(size=(n, d))
            ).astype(np.float32)


@pytest.mark.parametrize('inverse', [False, True])
def test_rational_quadratic_spline_matches_jax(inverse):
    """The elementwise RQS (8 bins on [-3, 3]) on points inside and
    outside the interval against JAX's: outputs within 1e-5 and log-dets
    within 5e-5 (absolute, on values of order 1: a rational function, and
    its log, that XLA fuses in another order; 4.1e-6 and 1.1e-5 seen);
    outside, the identity and a zero log-det; the opposite map returns x
    within 1e-4 and the log-dets cancel to 1e-4."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-4.5, 4.5, size=(64, 3)).astype(np.float32)
    uw, uh = (rng.normal(size=(64, 3, 8)).astype(np.float32)
              for _ in range(2))
    ud = rng.normal(size=(64, 3, 7)).astype(np.float32)
    y, ld = bj.rational_quadratic_spline(*map(torch.as_tensor,
                                              (x, uw, uh, ud)),
                                         inverse=inverse)
    jy, jld = jbj.rational_quadratic_spline(*map(jnp.asarray,
                                                 (x, uw, uh, ud)),
                                            inverse=inverse)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), atol=5e-5)
    outside = np.abs(x) >= 3.0
    assert outside.any() and (~outside).any()
    assert np.array_equal(y.numpy()[outside], x[outside])
    assert (ld.numpy()[outside] == 0).all()
    back, ld_back = bj.rational_quadratic_spline(
        y, *map(torch.as_tensor, (uw, uh, ud)), inverse=not inverse)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)
    np.testing.assert_allclose((ld + ld_back).numpy(), 0.0, atol=1e-4)


def test_rqs_zero_parameters_are_the_identity():
    """Zero raw parameters: the identity with a zero log-det (the shift of
    the derivatives), as in JAX; a coupling at init is the identity."""
    x = torch.as_tensor(_inputs()[:, :2])
    zeros = torch.zeros(N, 2, 8)
    y, ld = bj.rational_quadratic_spline(x, zeros, zeros, zeros[..., :7])
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=2e-6)
    np.testing.assert_allclose(ld.numpy(), 0.0, atol=2e-6)
    layer = bj.NeuralSplineCoupling(D, generator=torch.Generator()
                                    .manual_seed(0), device='cpu')
    y, ld = layer(torch.as_tensor(_inputs()))
    np.testing.assert_allclose(y.detach().numpy(), _inputs(), atol=2e-6)


def test_neural_spline_coupling_matches_jax():
    """NeuralSplineCoupling (4 dims: 2 condition 2) with the JAX layer's
    parameters, perturbed: direct and inverse outputs within 1e-5 and
    log-dets within 1e-5 of JAX's; the round trip closes to 1e-4."""
    params, jdirect, jinverse = jbj.NeuralSplineCoupling()(RNG, D)
    params = _perturbed(_np(params), 3, scale=0.1)
    layer = bj.NeuralSplineCoupling(D, device='cpu')
    layer.load_state_dict(module_state_from_jax(layer, params))
    x = _inputs()
    for mine, theirs in ((layer, jdirect), (layer.inverse, jinverse)):
        y, ld = mine(torch.as_tensor(x))
        jy, jld = theirs(params, jnp.asarray(x))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   atol=1e-5)
        np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld),
                                   atol=1e-5)
    back, _ = layer.inverse(layer(torch.as_tensor(x))[0])
    np.testing.assert_allclose(back.detach().numpy(), x, atol=1e-4)


def _rqsflow_pair(seed=5):
    """JAX's 'RQSFlow' as train_density_model initialises it, its params
    perturbed, and the port's model carrying them."""
    _, flow_rng = jax.random.split(jax.random.PRNGKey(seed))
    jparams, jlog_pdf, _ = jdensity.get_benchmark_model('RQSFlow')(
        flow_rng, 2)
    jparams = _perturbed(_np(jparams), seed, scale=0.05)
    model = density.get_benchmark_model('RQSFlow', device='cpu')
    model.load_state_dict(module_state_from_jax(model.transform, jparams,
                                                'transform.'))
    return jparams, jlog_pdf, model


def test_rqsflow_log_pdf_matches_jax():
    """'RQSFlow' (3 × (coupling + Reverse) over Normal(-0.5)) log_pdf on
    circles points with converted parameters: within 1e-5 of JAX's."""
    jparams, jlog_pdf, model = _rqsflow_pair()
    X = datasets.get_dataset('circles', 128)
    got = model.log_pdf(torch.as_tensor(X)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jlog_pdf(jparams, X)),
                               atol=1e-5)


def test_rqsflow_mle_step_matches_jax():
    """One MLE step (Adam lr 1e-3) of 'RQSFlow' on a fixed batch: the loss
    within rtol 1e-6, the gradient's relative global-norm error 1e-5, the
    updated parameters within rtol 1e-4 where |g| is above float noise
    (Adam's first step is sign-like) and within 2 lr everywhere."""
    jparams, jlog_pdf, model = _rqsflow_pair(7)
    X = datasets.get_dataset('circles', 256)
    lr = 1e-3

    def loss_fn(p):
        return -jlog_pdf(p, jnp.asarray(X)).mean()

    j_loss, j_grads = jax.value_and_grad(loss_fn)(jparams)
    opt = optax.adam(lr)
    updates, _ = opt.update(j_grads, opt.init(jparams), jparams)
    j_new = optax.apply_updates(jparams, updates)

    adam = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    loss = density.density_step(model, adam, torch.as_tensor(X))
    assert loss.item() == pytest.approx(float(j_loss), rel=1e-6)
    ref_g = module_state_from_jax(model.transform, _np(j_grads), 'transform.')
    ref_p = module_state_from_jax(model.transform, _np(j_new), 'transform.')
    named = dict(model.named_parameters())
    g = torch.cat([named[k].grad.ravel() for k in ref_g])
    w = torch.cat([v.ravel() for v in ref_g.values()])
    assert ((g - w).norm() / w.norm()).item() <= 1e-5
    g_max = w.abs().max().item()
    for k, want in ref_p.items():
        defined = (ref_g[k].abs() > 1e-5 * g_max).numpy()
        got = named[k].detach().numpy()
        np.testing.assert_allclose(got[defined], want.numpy()[defined],
                                   rtol=1e-4, atol=1e-7, err_msg=k)
        assert np.abs(got - want.numpy()).max() <= 2 * lr + 1e-7, k


class _TanhNet(torch.nn.Module):
    """tanh(x @ W) + b, the network of JAX's coupling tests."""

    def __init__(self, d_in, d_out, *, generator=None, device=None):
        super().__init__()
        self.W = torch.nn.Parameter(torch.zeros(d_in, d_out, device=device))
        self.b = torch.nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x):
        return torch.tanh(x @ self.W) + self.b


def _jnet(rng, d_in, d_out):
    k1, k2 = jax.random.split(rng)
    return ((jax.random.normal(k1, (d_in, d_out)) * 0.3,
             jax.random.normal(k2, (d_out,)) * 0.1),
            lambda p, x: jnp.tanh(x @ p[0]) + p[1])


def _combinators(x):
    """name -> (JAX init_fun, a function making the port module); the
    latter takes what JAX keeps in closures (orthogonal matrices,
    permutations) from the same PRNG key."""
    W = np.asarray(orthogonal()(RNG, (D, D)))
    perm = np.asarray(jax.random.permutation(RNG, jnp.arange(D)))
    # Serial hands its first layer the second half of a split of the key
    perm_serial = np.asarray(jax.random.permutation(
        jax.random.split(RNG)[1], jnp.arange(D)))
    xt = torch.as_tensor(x)
    return {
        'ActNorm': (jbj.ActNorm(), lambda: bj.ActNorm(D, device='cpu')),
        'ActNorm_init': (
            lambda rng, d: jbj.ActNorm()(rng, d, init_inputs=jnp.asarray(x)),
            lambda: bj.ActNorm(D, init_inputs=xt, device='cpu')),
        'AffineCoupling': (jbj.AffineCoupling(_jnet),
                           lambda: bj.AffineCoupling(_TanhNet, D,
                                                     device='cpu')),
        'AffineCouplingSplit': (
            jbj.AffineCouplingSplit(_jnet, _jnet),
            lambda: bj.AffineCouplingSplit(_TanhNet, _TanhNet, D,
                                           device='cpu')),
        'BatchNorm_init': (
            lambda rng, d: jbj.BatchNorm()(rng, d,
                                           init_inputs=jnp.asarray(x)),
            lambda: bj.BatchNorm(D, init_inputs=xt, device='cpu')),
        'Invert': (jbj.Invert(jbj.ActNorm()),
                   lambda: bj.Invert(bj.ActNorm(D, device='cpu'))),
        'FixedInvertibleLinear': (
            jbj.FixedInvertibleLinear(),
            lambda: bj.FixedInvertibleLinear(D, W, device='cpu')),
        'InvertibleLinear': (
            jbj.InvertibleLinear(),
            lambda: bj.InvertibleLinear(D, W, device='cpu')),
        'Sigmoid': (jbj.Sigmoid(), lambda: bj.Sigmoid()),
        'Logit': (jbj.Logit(), lambda: bj.Logit()),
        'Shuffle': (jbj.Shuffle(), lambda: bj.Shuffle(D, perm,
                                                      device='cpu')),
        'Serial': (jbj.Serial(jbj.Shuffle(), jbj.ActNorm(), jbj.Reverse()),
                   lambda: bj.Serial(bj.Shuffle(D, perm_serial, device='cpu'),
                                     bj.ActNorm(D, device='cpu'),
                                     bj.Reverse()))}


COMBINATORS = ['ActNorm', 'ActNorm_init', 'AffineCoupling',
               'AffineCouplingSplit', 'BatchNorm_init', 'Invert',
               'FixedInvertibleLinear', 'InvertibleLinear', 'Sigmoid',
               'Logit', 'Shuffle', 'Serial']


@pytest.mark.parametrize('name', COMBINATORS)
def test_combinator_matches_jax(name):
    """Each core combinator with the JAX layer's parameters (perturbed
    where it has any, so that the identity init tests something): direct
    and inverse outputs and log-dets within 2e-5 of JAX's (2e-4 for the
    linear maps, whose inverses differ in rounding); the round trip closes
    to 2e-4.  Serial's params are one entry per layer, in order."""
    x = _inputs()
    if name == 'Logit':
        x = 1.0 / (1.0 + np.exp(-x))                 # the logit's domain
    jinit, build = _combinators(x)[name]
    params, jdirect, jinverse = jinit(RNG, D)
    params = _perturbed(_np(params), 4, scale=0.2)
    if name == 'BatchNorm_init':                     # keep var positive
        params = list(params)
        params[3] = np.abs(params[3]) + 0.1
    layer = build()
    layer.load_state_dict(module_state_from_jax(layer, params), strict=False)
    tol = 2e-4 if 'Linear' in name else 2e-5
    y, ld = layer(torch.as_tensor(x))
    jy, jld = jdirect(params, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=tol)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld),
                               atol=tol)
    xi, ldi = layer.inverse(y)
    jxi, jldi = jinverse(params, jy)
    np.testing.assert_allclose(xi.detach().numpy(), np.asarray(jxi),
                               atol=tol)
    np.testing.assert_allclose(ldi.detach().numpy(), np.asarray(jldi),
                               atol=tol)
    np.testing.assert_allclose(xi.detach().numpy(), x, atol=2e-4)


def test_batchnorm_update_stats_matches_jax():
    """``batchnorm_update_stats`` (momentum 0.9) folds a batch's moments
    into the stored statistics as JAX's does, within 1e-6; the direct map
    then normalizes by the new statistics."""
    x = _inputs()
    batch = _inputs(seed=5, scale=2.0) + 1.0
    params, jdirect, _ = jbj.BatchNorm()(RNG, D, init_inputs=jnp.asarray(x))
    new = jbj.batchnorm_update_stats(params, jnp.asarray(batch))
    layer = bj.BatchNorm(D, init_inputs=torch.as_tensor(x), device='cpu')
    assert bj.batchnorm_update_stats(layer, torch.as_tensor(batch)) is layer
    np.testing.assert_allclose(layer.mean.numpy(), np.asarray(new[2]),
                               atol=1e-6)
    np.testing.assert_allclose(layer.var.numpy(), np.asarray(new[3]),
                               rtol=1e-6)
    y, _ = layer(torch.as_tensor(batch))
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jdirect(new, jnp.asarray(batch))[0]),
                               atol=1e-5)


def _gmm_args():
    means = np.array([[0.0, 0.0], [2.0, -1.0], [-1.5, 1.0]])
    covs = np.array([[[1.0, 0.3], [0.3, 0.5]], [[0.4, -0.1], [-0.1, 0.3]],
                     [[0.2, 0.0], [0.0, 0.9]]])
    return means, covs, np.array([0.5, 0.2, 0.3])


def test_gmm_log_pdf_and_moments():
    """The GMM prior's log-density against JAX's within 1e-5; 200,000
    draws from a generator have the mixture's mean within 0.01 and its
    covariance within 0.02; ``InvFlow`` is ``Flow``, and a Flow over the
    GMM prior evaluates it."""
    means, covs, weights = _gmm_args()
    x = _inputs(d=2, n=256, scale=2.0)
    _, jlog_pdf, _ = JGMM(means, covs, weights)(RNG, 2)
    prior = GMM(means, covs, weights, device='cpu')
    np.testing.assert_allclose(prior.log_pdf(torch.as_tensor(x)).numpy(),
                               np.asarray(jlog_pdf((), jnp.asarray(x))),
                               atol=1e-5)
    s = prior.sample(200_000, 2, torch.Generator().manual_seed(0),
                     'cpu').double().numpy()
    mean = (weights[:, None] * means).sum(0)
    cov = sum(w * (c + np.outer(m - mean, m - mean))
              for w, m, c in zip(weights, means, covs))
    assert np.abs(s.mean(0) - mean).max() < 0.01
    assert np.abs(np.cov(s.T) - cov).max() < 0.02
    assert InvFlow is Flow
    flow = InvFlow(bj.Serial(bj.Reverse()), 2, prior, device='cpu')
    np.testing.assert_allclose(flow.log_pdf(torch.as_tensor(x)).numpy(),
                               prior.log_pdf(torch.as_tensor(x[:, ::-1]
                                                             .copy())).numpy())


def test_masked_mlp_matches_jax():
    """``masked_mlp`` with the JAX network's parameters gives its
    features within 1e-6, and output group g of dimension d depends on
    inputs < d only."""
    params, apply_fn = jbj.masked_mlp(RNG, D, 3)
    net = bj.masked_mlp(D, 3, device='cpu')
    state = {}
    for k, (W, b) in enumerate(_np(params)):
        state[f'W.{k}'], state[f'b.{k}'] = torch.as_tensor(W), \
            torch.as_tensor(b)
    net.load_state_dict(state)
    x = _inputs()
    np.testing.assert_allclose(net(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(apply_fn(params, jnp.asarray(x))),
                               atol=1e-6)
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda xx: net(xx[None])[0]))(torch.as_tensor(x))
    jac = jac.reshape(N, 3, D, D).detach().numpy()
    for d in range(D):
        assert np.abs(jac[:, :, d, d:]).max() == 0.0


def test_gaussian_mixture_fit_matches_sklearn():
    """The numpy EM fit of the blobs against scikit-learn's
    ``GaussianMixture(3, random_state=seed)`` at three seeds: weights,
    means and covariances within 1e-12, components in the same order."""
    from sklearn import mixture
    from sklearn.datasets import make_blobs
    blobs, _ = make_blobs(center_box=(-1, 1), cluster_std=0.1,
                          random_state=3)
    assert np.array_equal(datasets.make_blobs(), blobs)
    for seed in (42, 0, 7):
        ref = mixture.GaussianMixture(3, random_state=seed).fit(blobs)
        w, m, c = datasets.fit_gaussian_mixture(blobs, 3, random_state=seed)
        np.testing.assert_allclose(w, ref.weights_, atol=1e-12)
        np.testing.assert_allclose(m, ref.means_, atol=1e-12)
        np.testing.assert_allclose(c, ref.covariances_, atol=1e-12)


@pytest.mark.parametrize('seed,n', [(42, 3000), (7, 257)])
def test_gaussian_mixtures_equal_the_jax_package(seed, n):
    """'gaussian_mixtures' point for point against the JAX package's
    (scikit-learn's fit and ``sample``, then the permutation and the
    scale): the components come in scikit-learn's order, so the draws
    match within 1e-6."""
    got = datasets.get_dataset('gaussian_mixtures', n, seed=seed)
    ref = jdatasets.get_dataset('gaussian_mixtures', n, seed=seed)
    assert got.dtype == np.float32 and got.shape == (n, 2)
    np.testing.assert_allclose(got, ref, atol=1e-6)
