"""Benchmark evaluation metrics.

Port of waveflow_tpu/benchmark/metrics.py: KDE-based KL and
squared-Hellinger distances between the model pdf and a kernel-density
estimate of its own samples on a grid, held-out log-likelihood, and the
round-trip reconstruction distance through ``log_pdf(...,
return_sample=True)``.  The KDE is an exact Gaussian one, computed on the
model's device in chunks of grid points.  A ``model`` is a module with
``log_pdf`` and a ``device`` (models/mflow.py, models/flow.py).
"""

from __future__ import annotations

import math

import torch

# grid points per KDE chunk: chunk × n_samples pair terms live at once
# (2,048 × 20,000 f32 = 164 MB per intermediate)
KDE_CHUNK = 2048


def _on(model, a) -> torch.Tensor:
    """A numpy array or tensor as f32 on the model's device."""
    return torch.as_tensor(a, dtype=torch.float32, device=model.device)


@torch.no_grad()
def pdf_grid_eval(model, ngrid: int = 300):
    """Model log-pdf on the unit-square grid: (ngrid, ngrid) and the flat
    (ngrid², 2) grid, both on the model's device."""
    x = torch.linspace(0.0, 1.0, ngrid, dtype=torch.float64)
    yv, xv = torch.meshgrid(x, x, indexing='ij')
    grid = torch.stack([xv.reshape(-1), yv.reshape(-1)], -1).to(
        dtype=torch.float32, device=model.device)
    return model.log_pdf(grid).reshape(ngrid, ngrid), grid


@torch.no_grad()
def gaussian_kde_log_density(samples: torch.Tensor, points: torch.Tensor,
                             bandwidth: float,
                             chunk: int = KDE_CHUNK) -> torch.Tensor:
    """Exact Gaussian KDE: log (1/n) Σ_j N(point − sample_j; bandwidth² I).

    samples (n, D), points (m, D) -> (m,).  The m × n pair terms are formed
    ``chunk`` points at a time, from coordinate differences (not from the
    expanded square, which cancels at small bandwidths)."""
    n, D = samples.shape
    log_norm = -math.log(n) - 0.5 * D * math.log(2.0 * math.pi * bandwidth ** 2)
    out = []
    for start in range(0, points.shape[0], chunk):
        p = points[start:start + chunk]
        d2 = torch.zeros((p.shape[0], n), dtype=p.dtype, device=p.device)
        for k in range(D):
            diff = p[:, k, None] - samples[None, :, k]
            d2.addcmul_(diff, diff)
        out.append(torch.logsumexp(d2.mul_(-0.5 / bandwidth ** 2), dim=1))
    return torch.cat(out) + log_norm


@torch.no_grad()
def kde_metrics(model, model_samples, ngrid: int = 300,
                bandwidth: float = 0.01):
    """(kde_kl, kde_hellinger²) on the unit-square grid."""
    log_pdf_grid, grid = pdf_grid_eval(model, ngrid)
    pdf_grid = torch.exp(log_pdf_grid)
    log_pdf_kde = gaussian_kde_log_density(
        _on(model, model_samples), grid, bandwidth).reshape(ngrid, ngrid)
    pdf_kde = torch.exp(log_pdf_kde)
    kl = (pdf_grid * (log_pdf_grid - log_pdf_kde)).mean()
    hellinger = ((torch.sqrt(pdf_grid) - torch.sqrt(pdf_kde)) ** 2).mean()
    return float(kl), float(hellinger)


@torch.no_grad()
def held_out_log_likelihood(model, X_test) -> float:
    """Mean log-likelihood on held-out data — the fit-quality metric the
    KDE self-consistency scores cannot provide (they compare the model
    against a KDE of its *own* samples)."""
    return float(model.log_pdf(_on(model, X_test)).mean())


def kde_bandwidth_sweep(model, model_samples,
                        bandwidths=(0.005, 0.01, 0.02, 0.05),
                        ngrid: int = 300):
    """kde_metrics at several bandwidths: how much of the KDE-KL/Hellinger
    score is bandwidth artifact and how much model mismatch."""
    return {float(bw): kde_metrics(model, model_samples, ngrid=ngrid,
                                   bandwidth=bw)
            for bw in bandwidths}


@torch.no_grad()
def reconstruction_distance(model, model_samples, original_samples) -> float:
    """Mean distance between prior samples and their round-trip
    reconstruction u = T(T^{-1}(u))."""
    _, reconstructed = model.log_pdf(_on(model, model_samples),
                                     return_sample=True)
    return float(torch.linalg.norm(
        _on(model, original_samples) - reconstructed, dim=-1).mean())
