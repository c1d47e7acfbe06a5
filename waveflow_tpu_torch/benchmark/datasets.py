"""2D density-estimation benchmark datasets, generated with NumPy alone.

Port of waveflow_tpu/benchmark/datasets.py.  ``halfmoon`` and ``circles``
are the two-moons and concentric-circles constructions (points on the
curves, one shuffle, Gaussian noise of 0.05), drawn from
``np.random.RandomState(seed)`` in that order.  ``gaussian_mixtures`` is
the reference's construction without scikit-learn: 100 blobs points
(``make_blobs(center_box=(-1, 1), cluster_std=0.1, random_state=3)``), a
3-component full-covariance Gaussian mixture fitted to them by EM from a
k-means++ / Lloyd initialization (``GaussianMixture(3,
random_state=seed)``), ``n_samples`` draws from the fit as its ``sample``
draws them, and one permutation from ``np.random.default_rng(seed)``;
each step in scikit-learn's order of random draws and arithmetic.  Every
dataset is then min-max scaled into the unit square with a margin.
"""

from __future__ import annotations

import numpy as np

NOISE = 0.05
CIRCLES_FACTOR = 0.5      # inner radius over outer radius


def _minmax_scale(X: np.ndarray, margin: float) -> np.ndarray:
    lo, hi = X.min(0), X.max(0)
    X01 = (X - lo) / (hi - lo)
    return X01 * (1 - 2 * margin) + margin


def _two_curves(outer: np.ndarray, inner: np.ndarray, seed: int) -> np.ndarray:
    """Stack two (n, 2) point sets, shuffle the rows once and add the
    noise, in the draw order of the reference generators."""
    rng = np.random.RandomState(seed)
    X = np.concatenate([outer, inner], axis=0)
    order = np.arange(len(X))
    rng.shuffle(order)
    X = X[order]
    return X + rng.normal(scale=NOISE, size=X.shape)


def make_blobs(n_samples: int = 100, center_box=(-1.0, 1.0),
               cluster_std: float = 0.1, random_state: int = 3) -> np.ndarray:
    """scikit-learn's ``make_blobs`` at 3 centers in 2D: the centres
    uniform in the box, then each centre's points, then one shuffle, all
    from ``RandomState(random_state)``.  (n_samples, 2) float64."""
    rs = np.random.RandomState(random_state)
    centers = rs.uniform(center_box[0], center_box[1], size=(3, 2))
    counts = [n_samples // 3] * 3
    for i in range(n_samples % 3):
        counts[i] += 1
    X = np.concatenate([rs.normal(loc=c, scale=cluster_std, size=(k, 2))
                        for c, k in zip(centers, counts)])
    order = np.arange(n_samples)
    rs.shuffle(order)
    return X[order]


def _kmeans_labels(X: np.ndarray, k: int, rs) -> np.ndarray:
    """scikit-learn's ``KMeans(k, n_init=1)`` labels: k-means++ seeding
    (2 + ⌊ln k⌋ local trials) on the centred data, then Lloyd iterations
    to a fixed point."""
    Xc = X - X.mean(0)
    sq = (Xc * Xc).sum(1)
    n = len(Xc)
    weight = np.ones(n)

    def dist2(c):
        return np.maximum(sq - 2 * Xc @ c + c @ c, 0)

    first = rs.choice(n, p=weight / weight.sum())
    centers = [Xc[first]]
    closest = dist2(Xc[first])
    potential = closest @ weight
    for _ in range(1, k):
        r = rs.uniform(size=2 + int(np.log(k))) * potential
        cand = np.clip(np.searchsorted(np.cumsum(weight * closest), r),
                       None, n - 1)
        dist = np.minimum(closest, np.stack([dist2(Xc[c]) for c in cand]))
        cand_potential = dist @ weight
        best = np.argmin(cand_potential)
        closest, potential = dist[best], cand_potential[best]
        centers.append(Xc[cand[best]])
    C, labels = np.array(centers), None
    for _ in range(300):
        new = ((Xc[:, None] - C[None]) ** 2).sum(-1).argmin(1)
        if labels is not None and (new == labels).all():
            break
        labels = new
        C = np.array([Xc[labels == j].mean(0) for j in range(k)])
    return labels


def _gaussian_params(X: np.ndarray, resp: np.ndarray, reg: float = 1e-6):
    """The M step: (component masses, means, full covariances + reg·I)."""
    nk = resp.sum(0) + 10 * np.finfo(resp.dtype).eps
    means = resp.T @ X / nk[:, None]
    covs = np.empty((len(nk), X.shape[1], X.shape[1]))
    for j in range(len(nk)):
        diff = X - means[j]
        covs[j] = (resp[:, j] * diff.T) @ diff / nk[j]
        covs[j].flat[::X.shape[1] + 1] += reg
    return nk, means, covs


def _logsumexp(a: np.ndarray) -> np.ndarray:
    """log Σ exp over the last axis, shifted by the row maximum."""
    top = a.max(-1, keepdims=True)
    return np.log(np.exp(a - top).sum(-1)) + top[..., 0]


def _log_gaussians(X: np.ndarray, means, covs) -> np.ndarray:
    """(n, k) component log-densities, through the precision Cholesky
    factors as scikit-learn computes them."""
    out = []
    for m, c in zip(means, covs):
        prec_chol = np.linalg.solve(np.linalg.cholesky(c), np.eye(len(m))).T
        y = X @ prec_chol - m @ prec_chol
        out.append(-0.5 * (len(m) * np.log(2 * np.pi) + (y ** 2).sum(1))
                   + np.log(np.diag(prec_chol)).sum())
    return np.stack(out, 1)


def fit_gaussian_mixture(X: np.ndarray, n_components: int = 3,
                         random_state: int = 0, tol: float = 1e-3,
                         max_iter: int = 100):
    """scikit-learn's ``GaussianMixture(n_components, random_state=...)``
    fit (full covariances, k-means initialization, EM until the mean
    log-likelihood moves by less than ``tol``): (weights, means,
    covariances)."""
    rs = np.random.RandomState(random_state)
    labels = _kmeans_labels(X, n_components, rs)
    resp = np.zeros((len(X), n_components))
    resp[np.arange(len(X)), labels] = 1
    nk, means, covs = _gaussian_params(X, resp)
    weights = nk / len(X)
    bound = -np.inf
    for _ in range(max_iter):
        prev = bound
        weighted = _log_gaussians(X, means, covs) + np.log(weights)
        norm = _logsumexp(weighted)
        nk, means, covs = _gaussian_params(
            X, np.exp(weighted - norm[:, None]))
        weights = nk / len(X)
        weights /= weights.sum()
        bound = norm.mean()
        if abs(bound - prev) < tol:
            break
    return weights, means, covs


def sample_gaussian_mixture(weights, means, covs, n_samples: int,
                            random_state: int) -> np.ndarray:
    """``GaussianMixture.sample``: a multinomial count per component, then
    each component's draws in order, from ``RandomState(random_state)``."""
    rs = np.random.RandomState(random_state)
    counts = rs.multinomial(n_samples, weights)
    return np.vstack([rs.multivariate_normal(m, c, int(k))
                      for m, c, k in zip(means, covs, counts)])


def get_dataset(name: str = 'circles', n_samples: int = 1000,
                margin: float = 0.025, seed: int = 42) -> np.ndarray:
    """(n_samples, 2) float32 points in [margin, 1 − margin]²."""
    n_out = n_samples // 2
    n_in = n_samples - n_out
    if name == 'gaussian_mixtures':
        fit = fit_gaussian_mixture(make_blobs(), 3, random_state=seed)
        X = sample_gaussian_mixture(*fit, n_samples, random_state=seed)
        X = X[np.random.default_rng(seed).permutation(n_samples)]
        return _minmax_scale(np.asarray(X, dtype=np.float32), margin)
    if name == 'halfmoon':
        t_out = np.linspace(0, np.pi, n_out)
        t_in = np.linspace(0, np.pi, n_in)
        outer = np.stack([np.cos(t_out), np.sin(t_out)], -1)
        inner = np.stack([1 - np.cos(t_in), 1 - np.sin(t_in) - 0.5], -1)
    elif name in ('circles', 'double_circles'):
        t_out = np.linspace(0, 2 * np.pi, n_out, endpoint=False)
        t_in = np.linspace(0, 2 * np.pi, n_in, endpoint=False)
        outer = np.stack([np.cos(t_out), np.sin(t_out)], -1)
        inner = np.stack([np.cos(t_in), np.sin(t_in)], -1) * CIRCLES_FACTOR
    else:
        raise ValueError(f"unknown dataset {name!r}")
    X = _two_curves(outer, inner, seed)
    return _minmax_scale(np.asarray(X, dtype=np.float32), margin)
