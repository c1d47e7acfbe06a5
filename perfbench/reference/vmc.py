"""Plain reference of the VMC train step, on reference/waveflow.py, in
float64.

The steps are taken at given walkers: the program's own, whose first
draw the benchmark checks apart against the reference's (``Waveflow.
sample`` from the same uniforms).  A float32 draw can land a walker near a
wall, where the inverse CDF is steep, far enough from the float64 one to
move every gradient leaf by 0.1%; at the program's walkers the steps
compare the estimator, ψ, E_L and Adam alone.
"""

from __future__ import annotations

import torch

from perfbench.reference.waveflow import PSI_EPS, Waveflow


def median(x: torch.Tensor) -> torch.Tensor:
    """The mean of the two middle values of an even count."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def clip_window(e: torch.Tensor, clip_scale: float):
    center = median(e)
    mad = (e - center).abs().mean()
    return center - clip_scale * mad, center + clip_scale * mad, mad


def train_steps(model: Waveflow, params: dict, batches, cfg: dict):
    """The 'clipped_score' estimator with adam after a global-norm clip, one
    step per entry of ``batches`` (each (B, D) walkers).  Returns (the
    losses, the clip window's mean |E_L − median| of each step, the clipped
    gradient of the first step, the parameters after the last step)."""
    lr, clip = cfg['learning_rate'], cfg['grad_clip']
    b1, b2, eps = 0.9, 0.999, 1e-8
    params = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, mads, first = [], [], None
    for t, x in enumerate(batches, 1):
        x = x.to(model.dtype)
        e = model.local_energy(params, x)
        lo, hi, mad = clip_window(e, cfg['clip_scale'])
        e_c_mean = torch.clamp(e, lo, hi).mean()
        weights = torch.clamp(e, lo, hi) - e_c_mean
        leaves = {k: p.clone().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad():
            psi = model.psi(leaves, x)
            surrogate = 2.0 * (weights * torch.log(psi.abs() + PSI_EPS)).mean()
            grads = torch.autograd.grad(surrogate, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if norm >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        if first is None:
            first = grads
        for k, g in grads.items():
            m[k] = b1 * m[k] + (1 - b1) * g
            v2[k] = b2 * v2[k] + (1 - b2) * g * g
            denom = torch.sqrt(v2[k]) / (1 - b2 ** t) ** 0.5 + eps
            params[k] = params[k] - lr / (1 - b1 ** t) * m[k] / denom
        losses.append(float(e_c_mean))
        mads.append(float(mad))
    return losses, mads, first, params
